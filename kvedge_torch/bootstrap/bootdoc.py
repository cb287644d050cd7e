"""Parse the ``#kvedge-boot-config`` document (cloud-init user-data analogue).

The port's copy of the JAX package's ``kvedge_tpu/bootstrap/bootdoc.py``,
with the header sentinel copied from its renderer
(``kvedge_tpu/render/bootconfig.py``). The document carries
``hostname``, ``ssh_authorized_keys``, ``bootcmd`` (runs first) and
``runcmd`` (runs after, in order).
"""

from __future__ import annotations

import dataclasses
import shlex

import yaml

# The first line of every boot-config document (the renderer's sentinel).
HEADER = "#kvedge-boot-config"


class BootDocError(ValueError):
    """Raised when the boot-config document is malformed."""


@dataclasses.dataclass(frozen=True)
class BootDocument:
    hostname: str
    ssh_authorized_keys: tuple[str, ...]
    bootcmd: tuple[tuple[str, ...], ...]
    runcmd: tuple[tuple[str, ...], ...]


def _parse_commands(doc: dict, key: str) -> tuple[tuple[str, ...], ...]:
    raw = doc.get(key, [])
    if not isinstance(raw, list):
        raise BootDocError(f"{key} must be a list of commands")
    commands = []
    for item in raw:
        if isinstance(item, str):
            argv = tuple(shlex.split(item))
        elif isinstance(item, list) and all(isinstance(a, str) for a in item):
            argv = tuple(item)
        else:
            raise BootDocError(f"{key} entries must be strings or string lists")
        if not argv:
            raise BootDocError(f"{key} contains an empty command")
        commands.append(argv)
    return tuple(commands)


def parse_boot_document(text: str) -> BootDocument:
    """Parse and validate a boot-config document.

    The header line is required — like cloud-init's ``#cloud-config``
    sentinel, it guards against mounting the wrong Secret into the
    boot-config slot.
    """
    first_line = text.split("\n", 1)[0].strip()
    if first_line != HEADER:
        raise BootDocError(
            f"not a boot-config document (first line {first_line!r}, "
            f"expected {HEADER!r})"
        )
    try:
        doc = yaml.safe_load(text)
    except yaml.YAMLError as e:
        raise BootDocError(f"invalid YAML: {e}") from e
    if not isinstance(doc, dict):
        raise BootDocError("boot-config document must be a mapping")

    keys = doc.get("ssh_authorized_keys", [])
    if not isinstance(keys, list) or not all(isinstance(k, str) for k in keys):
        raise BootDocError("ssh_authorized_keys must be a list of strings")

    return BootDocument(
        hostname=str(doc.get("hostname", "")),
        # Empty entries (no key injected) are dropped, never authorized.
        ssh_authorized_keys=tuple(k for k in keys if k.strip()),
        bootcmd=_parse_commands(doc, "bootcmd"),
        runcmd=_parse_commands(doc, "runcmd"),
    )
