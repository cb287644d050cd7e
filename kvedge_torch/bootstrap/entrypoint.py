"""Container entrypoint: execute the boot-config document — PID 1's cloud-init.

The port's copy of the JAX package's ``kvedge_tpu/bootstrap/entrypoint.py``
(its JAX virtual-device knob is not carried):

1. read + validate the boot-config document (header sentinel);
2. authorize SSH keys and start sshd if the image carries one;
3. run every ``bootcmd`` in order (config-volume discovery);
4. run every ``runcmd`` in order (config apply, then runtime boot —
   the final command typically never returns in a real pod).

Any step failing exits non-zero so Kubernetes restarts the pod.

    python -m kvedge_torch.bootstrap.entrypoint --boot-config <doc> [--root R]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from kvedge_torch.bootstrap.bootdoc import BootDocError, parse_boot_document
from kvedge_torch.bootstrap.commands import CommandError, rebase, run_command

SSH_DIR = "/home/kvedge/.ssh"


def _log(msg: str) -> None:
    print(f"[kvedge-bootstrap] {msg}", flush=True)


def authorize_ssh_keys(keys: tuple[str, ...], root: str) -> str | None:
    """Write authorized_keys (cloud-init ``ssh_authorized_keys`` analogue)."""
    if not keys:
        return None
    ssh_dir = rebase(SSH_DIR, root)
    os.makedirs(ssh_dir, mode=0o700, exist_ok=True)
    path = os.path.join(ssh_dir, "authorized_keys")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("".join(f"{key}\n" for key in keys))
    os.chmod(path, 0o600)
    return path


def start_sshd_if_present(root: str, have_keys: bool) -> bool:
    """Start sshd when the image ships one AND a public key was injected.

    External SSH is an optional capability gated by a chart value (the
    Service may not even exist, ``aziot-edge-vm-service.yaml:1``), so a
    missing sshd must not fail the boot — and without an authorized key
    there is nothing to serve, so no daemon is started at all.

    The runtime image ships without SSH host keys (shared baked-in host
    keys would let anyone who pulls the public image impersonate any
    deployment), so they are generated here on first start.
    """
    if root not in ("", "/"):
        return False  # never start a real daemon from a test root
    if not have_keys:
        return False
    sshd = shutil.which("sshd") or (
        "/usr/sbin/sshd" if os.path.exists("/usr/sbin/sshd") else None
    )
    if not sshd:
        _log("no sshd in image; skipping SSH access setup")
        return False
    os.makedirs("/run/sshd", exist_ok=True)  # privsep dir, absent in containers
    if not any(
        name.startswith("ssh_host_") for name in os.listdir("/etc/ssh")
    ):
        subprocess.run(["ssh-keygen", "-A"], check=False)
        _log("generated per-container SSH host keys")
    subprocess.Popen([sshd, "-D", "-e"])
    _log(f"started {sshd}")
    return True


def run_boot_sequence(boot_config_path: str, root: str = "/") -> None:
    with open(boot_config_path, "r", encoding="utf-8") as fh:
        document = parse_boot_document(fh.read())
    _log(f"boot document ok (hostname {document.hostname!r})")

    key_path = authorize_ssh_keys(document.ssh_authorized_keys, root)
    if key_path:
        _log(f"authorized {len(document.ssh_authorized_keys)} ssh key(s)")
    start_sshd_if_present(root, have_keys=bool(document.ssh_authorized_keys))

    for phase, commands in (("bootcmd", document.bootcmd),
                            ("runcmd", document.runcmd)):
        for argv in commands:
            _log(f"{phase}: {' '.join(argv)}")
            run_command(argv, root=root)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kvedge-entrypoint",
        description="Execute a #kvedge-boot-config document.",
    )
    parser.add_argument("--boot-config", required=True,
                        help="path to the mounted boot-config document")
    parser.add_argument("--root", default="/",
                        help="filesystem root to resolve in-pod paths against "
                             "(tests/local verification)")
    args = parser.parse_args(argv)
    try:
        run_boot_sequence(args.boot_config, root=args.root)
    except (BootDocError, CommandError, OSError) as e:
        _log(f"boot failed: {e}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
