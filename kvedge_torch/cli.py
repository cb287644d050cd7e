"""``python -m kvedge_torch serve|train|eval``: the port's entry points.

    serve  [--config x.toml] [--preset P] [--max-seq N] [--port P]
           [--bind H] [--device cuda|cpu] [--seed S] [--dtype D]
    train  --config x.toml [--preset P] [--device cuda|cpu] [--dtype D]
    eval   --config x.toml [--preset P] [--device cuda|cpu] [--dtype D]

Each runs on the CUDA card unless ``--device cpu`` is given, and raises
when there is no card. ``serve`` decodes through the backend that
``[payload] serving`` names ("" = contiguous, or "paged", whose decode
loop ``[payload] serving_overlap`` picks and whose speculation
``serving_speculative``, ``serving_spec_window`` and
``serving_spec_sampled_window`` set; a draft length > 0 prints the boot
probe's decision) and runs until interrupted;
``train`` and ``eval`` print their result as one JSON line and exit 0
when it is ok, 1 when it is not. ``[payload] kind`` in the TOML does
not pick the command: the subcommand does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import threading

from kvedge_torch.runtime.config import RuntimeConfig


def _config(args, **overrides) -> RuntimeConfig:
    cfg = RuntimeConfig()
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            cfg = RuntimeConfig.parse(f.read())
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items()
                                      if v is not None})
    cfg.validate()
    return cfg


def _serve(args) -> int:
    from kvedge_torch.runtime.serve import ServeRuntime

    cfg = _config(args, preset=args.preset, max_seq=args.max_seq,
                  status_port=args.port, status_bind=args.bind)
    runtime = ServeRuntime(cfg, device=args.device, dtype=args.dtype,
                           seed=args.seed, port=cfg.status_port)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(json.dumps({"serving": f"http://{cfg.status_bind}:{runtime.port}",
                      "backend": "paged" if runtime.paged else "contiguous",
                      "overlap": cfg.serving_overlap if runtime.paged
                      else None,
                      "device": str(runtime.device),
                      "device_check": runtime.device_check.to_dict(),
                      "restored_step": runtime.restored_step,
                      "spec_decision": runtime.spec_decision,
                      "model": dataclasses.asdict(runtime.tcfg)}),
          flush=True)
    stop.wait()
    runtime.close(drain=True)
    return 0


def _payload(args) -> int:
    from kvedge_torch.runtime.train import run_eval_payload, run_train_payload

    cfg = _config(args, payload=args.cmd, preset=args.preset)
    run = run_train_payload if args.cmd == "train" else run_eval_payload
    result = run(cfg, device=args.device, dtype=args.dtype)
    doc = dataclasses.asdict(result)
    doc.pop("losses")
    print(json.dumps({"payload": args.cmd, **doc}), flush=True)
    return 0 if result.ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kvedge_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve", help="serve POST /generate")
    sp.add_argument("--config", help="runtime TOML ([runtime], [model], "
                    "[payload], [status])")
    sp.add_argument("--max-seq", type=int)
    sp.add_argument("--port", type=int)
    sp.add_argument("--bind")
    sp.add_argument("--seed", type=int, default=0,
                    help="seed of the numpy-made weights (no checkpoint)")
    tp = sub.add_parser("train", help="train over [payload] corpus")
    ep = sub.add_parser("eval", help="loss of the latest checkpoint")
    for p in (tp, ep):
        p.add_argument("--config", required=True, help="runtime TOML")
    for p in (sp, tp, ep):
        p.add_argument("--preset", choices=("probe", "flagship"))
        p.add_argument("--device", choices=("cuda", "cpu"), default=None)
        p.add_argument("--dtype", choices=("bfloat16", "float32"),
                       default="bfloat16")
    args = ap.parse_args(argv)
    return _serve(args) if args.cmd == "serve" else _payload(args)
