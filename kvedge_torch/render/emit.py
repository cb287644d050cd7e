"""Stable YAML emission for rendered manifests."""

from __future__ import annotations

import yaml


def to_yaml(doc: dict) -> str:
    """Emit one manifest, insertion-ordered (byte-stable for golden tests)."""
    return yaml.safe_dump(doc, default_flow_style=False, sort_keys=False)


def to_multidoc_yaml(docs: list[dict]) -> str:
    """Emit a multi-document stream, `---`-separated like `helm template`."""
    return "---\n".join(to_yaml(d) for d in docs)
