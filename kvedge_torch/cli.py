"""``python -m kvedge_torch
serve|train|eval|boot|corpus|render|notes|version|package``: the port's
entry points.

    serve   [--config x.toml] [--preset P] [--max-seq N] [--port P]
            [--bind H] [--device cuda|cpu] [--seed S] [--dtype D]
    train   --config x.toml [--preset P] [--device cuda|cpu] [--dtype D]
    eval    --config x.toml [--preset P] [--device cuda|cpu] [--dtype D]
    boot    --config x.toml [--once] [--device cuda|cpu]
    corpus  --out PATH (--from-tokens FILE | --random N [--vocab V]
            [--seed S]) [--holdout F]
    render  [--set K=V ...] [--set-file K=PATH ...] [--output-dir D]
    notes   [--set K=V ...] [--set-file K=PATH ...]
    version
    package [--chart-dir D] [--out-dir D]

``corpus`` writes a KVFEED01 token corpus for the ``train`` payload, as
the JAX package's ``corpus`` command does (the same sources, split,
checks and messages, byte-identical files). ``render``, ``notes``,
``version`` and ``package`` are the JAX package's deployment commands
(``kvedge_tpu/cli.py``) over the port's GPU chart:
``render`` writes the manifest set for ``kubectl apply -f`` (to stdout,
or one file a manifest under ``--output-dir``) and prints the NOTES;
``package`` writes ``deployment/gpu/helm`` (by default) as a
byte-reproducible ``<name>-<version>.tgz`` that honours its
``.helmignore``. They touch no device and import no torch.

Every one starts the runtime (``runtime/boot.start_runtime``): the
status server, the heartbeats with this boot's ``boot_count`` in the
state directory, then the payload. ``serve``, ``train`` and ``eval`` set
``[payload] kind`` to the payload they name (the TOML's kind does not
pick the command), run on the CUDA card unless ``--device cpu`` is
given (which also sets ``[tpu] platform = "cpu"``), and raise when
there is no card. ``serve`` decodes through the backend that
``[payload] serving`` names ("" = contiguous, or "paged", whose decode
loop ``[payload] serving_overlap`` picks and whose speculation
``serving_speculative``, ``serving_spec_window`` and
``serving_spec_sampled_window`` set; a draft length > 0 prints the boot
probe's decision), prints one JSON line and runs until SIGINT or
SIGTERM, beating every ``heartbeat_interval_s`` meanwhile; ``train``
and ``eval`` print their result as one JSON line and
exit 0 when it is ok, 1 when it is not. ``boot`` is ``kvedge-runtime
boot``: the TOML as written, any payload, a degraded boot keeps
answering ``/status``, and it beats until stopped (``--once``: one
cycle).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import signal
import sys

from kvedge_torch.runtime.config import RuntimeConfig


def _config(args, **overrides) -> RuntimeConfig:
    cfg = RuntimeConfig()
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            cfg = RuntimeConfig.parse(f.read())
    if args.device == "cpu":
        overrides["expected_platform"] = "cpu"
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items()
                                      if v is not None})
    cfg.validate()
    return cfg


def _start(args, cfg: RuntimeConfig, **kw):
    from kvedge_torch.runtime.boot import start_runtime
    from kvedge_torch.runtime.devicecheck import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise here
    return start_runtime(cfg, device=args.device, dtype=args.dtype, **kw)


def _serve(args) -> int:
    cfg = _config(args, payload="serve", preset=args.preset,
                  max_seq=args.max_seq, status_port=args.port,
                  status_bind=args.bind)
    handle = _start(args, cfg, seed=args.seed)
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: handle.writer.stop())
    doc = {"serving": f"http://{cfg.status_bind}:{handle.status_port}",
           "ok": handle.check.ok, "error": handle.check.error,
           "boot_count": handle.boot_count,
           "device_check": handle.check.to_dict()}
    runtime = getattr(handle.serve_fn, "runtime", None)
    if runtime is not None:
        doc.update({
            "backend": "paged" if runtime.paged else "contiguous",
            "overlap": cfg.serving_overlap if runtime.paged else None,
            "device": str(runtime.device),
            "restored_step": runtime.restored_step,
            "spec_decision": runtime.spec_decision,
            "model": dataclasses.asdict(runtime.tcfg)})
    print(json.dumps(doc), flush=True)
    handle.writer.run()  # heartbeats until SIGINT or SIGTERM
    handle.server.shutdown()
    if runtime is not None:
        runtime.close(drain=True)
    return 0 if handle.check.ok else 1


def _payload(args) -> int:
    cfg = _config(args, payload=args.cmd, preset=args.preset)
    handle = _start(args, cfg)
    handle.shutdown()
    if handle.result is None:  # the payload did not run
        doc = {"ok": False, "error": handle.check.error}
    else:
        doc = dataclasses.asdict(handle.result)
        doc.pop("losses")
    print(json.dumps({"payload": args.cmd, **doc}), flush=True)
    return 0 if handle.check.ok else 1


def _boot(args) -> int:
    from kvedge_torch.runtime.boot import boot

    boot(args.config, once=args.once, device=args.device)
    return 0


def _add_value_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--set", dest="sets", action="append", default=[],
        metavar="KEY=VALUE",
        help="override a chart value (helm --set analogue)")
    parser.add_argument(
        "--set-file", dest="set_files", action="append", default=[],
        metavar="KEY=PATH",
        help="set a chart value from a file (helm --set-file analogue)")


def _resolve_values(args):
    from kvedge_torch.config.values import (
        DEFAULT_VALUES,
        parse_set_file_flag,
        parse_set_flag,
    )

    values = DEFAULT_VALUES
    for assignment in args.sets:
        values = parse_set_flag(values, assignment)
    for assignment in args.set_files:
        values = parse_set_file_flag(values, assignment)
    return values


def _render(args) -> int:
    from kvedge_torch.render import render_all, to_multidoc_yaml, to_yaml

    chart = render_all(_resolve_values(args))
    if args.output_dir:
        out = pathlib.Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        for filename, doc in chart.ordered():
            (out / filename).write_text(to_yaml(doc))
        print(f"wrote {len(chart.manifests)} manifests to {out}",
              file=sys.stderr)
    else:
        print(to_multidoc_yaml([doc for _, doc in chart.ordered()]), end="")
    print(chart.notes, file=sys.stderr)
    return 0


def _notes(args) -> int:
    from kvedge_torch.render.manifests import render_notes

    print(render_notes(_resolve_values(args)), end="")
    return 0


def _version(args) -> int:
    from kvedge_torch.version import CHART_NAME, CHART_VERSION

    print(f"{CHART_NAME} {CHART_VERSION}")
    return 0


def _package(args) -> int:
    """Package a Helm chart as ``<name>-<version>.tgz`` (helm package
    analogue): ``Chart.yaml``'s name and version, every file of the tree
    but those ``.helmignore`` excludes (the dead prepopulated-volume
    template among them), and a byte-reproducible archive (zero mtimes
    in the tar and in the gzip header)."""
    import gzip
    import io
    import tarfile

    import yaml

    from kvedge_torch.render.helmlite import (
        helmignore_matches,
        load_helmignore,
    )

    chart_dir = pathlib.Path(args.chart_dir)
    chart_yaml = chart_dir / "Chart.yaml"
    if not chart_yaml.is_file():
        raise ValueError(f"{chart_dir} has no Chart.yaml")
    meta = yaml.safe_load(chart_yaml.read_text())
    try:
        name, version = meta["name"], str(meta["version"])
    except (TypeError, KeyError):
        raise ValueError(f"{chart_yaml} must declare name and version")
    patterns = load_helmignore(chart_dir)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{name}-{version}.tgz"

    members = []
    for path in sorted(chart_dir.rglob("*")):
        if not path.is_file():
            continue
        rel = path.relative_to(chart_dir).as_posix()
        if rel != ".helmignore" and helmignore_matches(rel, patterns):
            continue
        members.append((rel, path.read_bytes()))

    with open(out_path, "wb") as raw:
        with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as gz:
            with tarfile.open(fileobj=gz, mode="w") as tar:
                for rel, data in members:
                    info = tarfile.TarInfo(f"{name}/{rel}")
                    info.size = len(data)
                    info.mtime = 0
                    info.mode = 0o644
                    tar.addfile(info, io.BytesIO(data))
    print(f"wrote {out_path}", file=sys.stderr)
    return 0


def _corpus(args) -> int:
    """Write a KVFEED01 token corpus for the ``train`` payload.

    Sources, exactly one of: ``--from-tokens`` (a text file of integer
    token ids, whitespace/newline separated — the format any external
    tokenizer can emit) or ``--random N`` (a seeded synthetic corpus for
    smoke tests and demos).

    ``--holdout F`` (0 < F < 1) splits the stream's TAIL fraction into a
    second file ``<out>.eval`` — the held-out split for the ``eval``
    payload (``[payload] eval_corpus``). A sequential tail split, not a
    shuffle: the corpus is a token stream, and shuffling would leak
    training n-grams across the boundary.
    """
    import numpy as np

    from kvedge_torch.data.feeder import read_corpus_header, write_corpus

    if (args.from_tokens is None) == (args.random is None):
        raise ValueError(
            "exactly one of --from-tokens or --random is required"
        )
    if args.from_tokens is not None:
        # Whitespace/newline separated, no rectangularity requirement.
        try:
            words = pathlib.Path(args.from_tokens).read_text().split()
            # Python ints first: a huge id must become the friendly
            # error below, not an OverflowError from numpy.
            ids = [int(w) for w in words]
        except ValueError as e:
            raise ValueError(f"--from-tokens must contain integers: {e}")
        if not ids:
            raise ValueError(
                f"--from-tokens file {args.from_tokens} contains no "
                "tokens; an empty corpus would only fail later at pod "
                "boot"
            )
        if min(ids) < 0 or max(ids) > 2**31 - 1:
            raise ValueError("token ids must fit in int32 and be >= 0")
        tokens = np.array(ids, dtype=np.int32)
    else:
        if args.random <= 0:
            raise ValueError("--random needs a positive token count")
        rng = np.random.default_rng(args.seed)
        tokens = rng.integers(0, args.vocab, size=args.random,
                              dtype=np.int32)
    if args.holdout is not None:
        if not 0.0 < args.holdout < 1.0:
            raise ValueError("--holdout must be a fraction in (0, 1)")
        n_eval = int(len(tokens) * args.holdout)
        # A split too small to feed even one seq=128 eval batch row would
        # only fail later at pod boot (the feeder needs seq+1 tokens).
        if n_eval < 129 or len(tokens) - n_eval < 129:
            raise ValueError(
                f"--holdout {args.holdout} of {len(tokens)} tokens "
                f"leaves a split of {min(n_eval, len(tokens) - n_eval)} "
                "tokens — too small to feed one default-seq (128) batch "
                "row at pod boot; use more tokens or a different fraction"
            )
        eval_path = f"{args.out}.eval"
        write_corpus(args.out, tokens[:-n_eval])
        write_corpus(eval_path, tokens[-n_eval:])
        print(
            f"wrote {read_corpus_header(args.out)} tokens to {args.out} "
            f"and {read_corpus_header(eval_path)} held-out tokens to "
            f"{eval_path} (set [payload] eval_corpus to it)",
            file=sys.stderr,
        )
        return 0
    write_corpus(args.out, tokens)
    print(
        f"wrote {read_corpus_header(args.out)} tokens to {args.out}",
        file=sys.stderr,
    )
    return 0


GPU_CHART = pathlib.Path(__file__).resolve().parent.parent / "deployment" / \
    "gpu" / "helm"
DEPLOY_COMMANDS = {"render": _render, "notes": _notes, "version": _version,
                   "package": _package, "corpus": _corpus}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kvedge_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve", help="serve POST /generate")
    sp.add_argument("--config", help="runtime TOML ([runtime], [model], "
                    "[payload], [status], ...)")
    sp.add_argument("--max-seq", type=int)
    sp.add_argument("--port", type=int)
    sp.add_argument("--bind")
    sp.add_argument("--seed", type=int, default=0,
                    help="seed of the numpy-made weights (no checkpoint)")
    tp = sub.add_parser("train", help="train over [payload] corpus")
    ep = sub.add_parser("eval", help="loss of the latest checkpoint")
    bp = sub.add_parser("boot", help="boot the runtime as kvedge-runtime "
                        "boot does: the TOML's [payload] kind")
    for p in (tp, ep, bp):
        p.add_argument("--config", required=True, help="runtime TOML")
    bp.add_argument("--once", action="store_true",
                    help="one heartbeat cycle, then shut down")
    for p in (sp, tp, ep):
        p.add_argument("--preset", choices=("probe", "flagship"))
        p.add_argument("--dtype", choices=("bfloat16", "float32"),
                       default="bfloat16")
    for p in (sp, tp, ep, bp):
        p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    rp = sub.add_parser("render", help="render the GPU chart's manifest "
                        "set (helm template/install analogue)")
    _add_value_flags(rp)
    rp.add_argument("--output-dir",
                    help="write manifests here instead of stdout")
    np_ = sub.add_parser("notes", help="print post-install usage notes")
    _add_value_flags(np_)
    sub.add_parser("version", help="print chart/app version")
    pp = sub.add_parser("package", help="package a Helm chart as "
                        "<name>-<version>.tgz (honours .helmignore)")
    pp.add_argument("--chart-dir", default=str(GPU_CHART),
                    help="chart directory (default: the GPU chart)")
    pp.add_argument("--out-dir", default=".",
                    help="where to write the .tgz (default: cwd)")
    cp = sub.add_parser("corpus", help="write a KVFEED01 token corpus "
                        "for the `train` payload")
    cp.add_argument("--out", required=True, help="output corpus path")
    cp.add_argument("--from-tokens",
                    help="text file of integer token ids (whitespace "
                         "separated)")
    cp.add_argument("--random", type=int,
                    help="generate N random tokens instead (seeded; "
                         "smoke tests/demos)")
    cp.add_argument("--vocab", type=int, default=512,
                    help="vocab for --random (default 512, the train "
                         "payload's model vocab)")
    cp.add_argument("--seed", type=int, default=0)
    cp.add_argument("--holdout", type=float,
                    help="split this tail fraction (0 < F < 1) into "
                         "<out>.eval — the held-out corpus for the `eval` "
                         "payload")
    args = ap.parse_args(argv)
    if args.cmd in DEPLOY_COMMANDS:
        try:
            return DEPLOY_COMMANDS[args.cmd](args)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if args.cmd == "boot":
        return _boot(args)
    return _serve(args) if args.cmd == "serve" else _payload(args)
