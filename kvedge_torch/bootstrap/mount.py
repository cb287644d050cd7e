"""Identity-addressed config-volume discovery — the serial-disk analogue.

The port's copy of the JAX package's ``kvedge_tpu/bootstrap/mount.py``:
the chart mounts the config Secret under ``<search_root>/<serial>``;
:func:`locate` scans the search root for the serial-named volume,
verifies it carries a ``userdata`` file, and publishes it at a stable
path (``/mnt/app-secret``) via symlink.
"""

from __future__ import annotations

import os


class MountError(RuntimeError):
    """Raised when the serial-tagged config volume cannot be located."""


def locate(serial: str, search_root: str, link: str) -> str:
    """Find the serial-tagged volume and link it at a stable path.

    Returns the resolved volume directory. Idempotent: re-running replaces
    the link (cloud-init's bootcmd similarly re-runs on every boot).
    """
    if not serial:
        raise MountError("empty serial")
    candidate = os.path.join(search_root, serial)
    if not os.path.isdir(candidate):
        try:
            visible = sorted(os.listdir(search_root))
        except OSError:
            visible = []
        raise MountError(
            f"no volume with serial {serial!r} under {search_root} "
            f"(visible: {visible})"
        )
    userdata = os.path.join(candidate, "userdata")
    if not os.path.isfile(userdata):
        raise MountError(
            f"volume {candidate} has no 'userdata' payload — wrong Secret "
            "mounted into the config slot?"
        )
    os.makedirs(os.path.dirname(link) or "/", exist_ok=True)
    tmp = f"{link}.tmp"
    if os.path.islink(tmp) or os.path.exists(tmp):
        os.remove(tmp)
    # The target must be absolute: a relative symlink target resolves
    # against the LINK's directory, not the invoker's cwd, so a relative
    # search root (e.g. `entrypoint --root .`) would produce a dangling
    # link like mnt/app-secret -> mnt/disks/<serial>.
    os.symlink(os.path.abspath(candidate), tmp)
    os.replace(tmp, link)
    return os.path.abspath(candidate)
