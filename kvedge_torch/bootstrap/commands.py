"""In-process handlers for the boot-document commands.

The port's copy of the JAX package's ``kvedge_tpu/bootstrap/commands.py``.
``bootcmd``/``runcmd`` entries name two virtual binaries:

* ``kvedge-bootstrap locate|apply`` — volume discovery, and config apply
  through the port's ``RuntimeConfig`` (parse, rebase the in-pod paths,
  write the canonical TOML);
* ``kvedge-runtime boot [--once] [--device cuda|cpu]`` — hand off to the
  port's runtime (:mod:`kvedge_torch.runtime.boot`), on the card unless
  the CPU is asked for.

Both are dispatched in-process (testable, no shell); any other argv is
executed as a subprocess so operators can extend the boot sequence from
the Secret without changing the image.

All absolute paths are resolved against a ``root`` prefix (``/`` in a
real pod), so the whole boot sequence can run against a scratch
directory in tests and local verification.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess

from kvedge_torch.bootstrap import mount
from kvedge_torch.runtime.config import RuntimeConfig, RuntimeConfigError


def rebase(path: str, root: str) -> str:
    """Resolve an absolute in-pod path against a test/verification root."""
    if root in ("", "/"):
        return path
    return os.path.join(root, path.lstrip("/"))


class CommandError(RuntimeError):
    """Raised when a boot command fails."""


def cmd_locate(argv: list[str], root: str) -> None:
    parser = argparse.ArgumentParser(prog="kvedge-bootstrap locate")
    parser.add_argument("--serial", required=True)
    parser.add_argument("--search-root", required=True)
    parser.add_argument("--link", required=True)
    args = parser.parse_args(argv)
    try:
        mount.locate(
            serial=args.serial,
            search_root=rebase(args.search_root, root),
            link=rebase(args.link, root),
        )
    except mount.MountError as e:
        raise CommandError(str(e)) from e


def cmd_apply(argv: list[str], root: str) -> None:
    parser = argparse.ArgumentParser(prog="kvedge-bootstrap apply")
    parser.add_argument("--source", required=True)
    parser.add_argument("--target", required=True)
    args = parser.parse_args(argv)
    source = rebase(args.source, root)
    try:
        with open(source, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError as e:
        raise CommandError(f"cannot read injected config {source}: {e}") from e
    try:
        cfg = RuntimeConfig.parse(text)
    except RuntimeConfigError as e:
        raise CommandError(f"injected config is invalid: {e}") from e
    # Rebase the in-pod paths too so `apply` stays inside the test root.
    cfg = dataclasses.replace(
        cfg,
        state_dir=rebase(cfg.state_dir, root),
        train_corpus=(
            rebase(cfg.train_corpus, root) if cfg.train_corpus else ""
        ),
        eval_corpus=(
            rebase(cfg.eval_corpus, root) if cfg.eval_corpus else ""
        ),
    )
    cfg.apply(config_path=rebase(args.target, root))


def cmd_runtime_boot(argv: list[str], root: str) -> None:
    from kvedge_torch.runtime import boot  # deferred: pulls in torch

    parser = argparse.ArgumentParser(prog="kvedge-runtime boot")
    parser.add_argument("--config", required=True)
    parser.add_argument("--once", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the payload runs (default: the card)")
    args = parser.parse_args(argv)
    boot.boot(config_path=rebase(args.config, root), once=args.once,
              root=root, device=args.device)


_BOOTSTRAP_COMMANDS = {"locate": cmd_locate, "apply": cmd_apply}
_RUNTIME_COMMANDS = {"boot": cmd_runtime_boot}


def run_command(argv: tuple[str, ...], root: str = "/") -> None:
    """Dispatch one boot-document command."""
    head, rest = argv[0], list(argv[1:])
    if head == "kvedge-bootstrap":
        table = _BOOTSTRAP_COMMANDS
    elif head == "kvedge-runtime":
        table = _RUNTIME_COMMANDS
    else:
        # Operator-extended command: execute as a subprocess.
        result = subprocess.run(argv)
        if result.returncode != 0:
            raise CommandError(
                f"command {argv!r} exited with {result.returncode}"
            )
        return
    if not rest or rest[0] not in table:
        raise CommandError(
            f"{head} expects a subcommand in {sorted(table)}, got {rest[:1]}"
        )
    table[rest[0]](rest[1:], root=root)
