"""``python -m kvedge_torch serve|train|eval|boot``: the port's entry points.

    serve  [--config x.toml] [--preset P] [--max-seq N] [--port P]
           [--bind H] [--device cuda|cpu] [--seed S] [--dtype D]
    train  --config x.toml [--preset P] [--device cuda|cpu] [--dtype D]
    eval   --config x.toml [--preset P] [--device cuda|cpu] [--dtype D]
    boot   --config x.toml [--once] [--device cuda|cpu]

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
import signal

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
    args = ap.parse_args(argv)
    if args.cmd == "boot":
        return _boot(args)
    return _serve(args) if args.cmd == "serve" else _payload(args)
