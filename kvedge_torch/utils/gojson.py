"""JSON encoding matching Go's ``encoding/json`` (what Helm's ``toJson`` uses).

Go's ``json.Marshal`` HTML-escapes ``&``, ``<`` and ``>`` to ``\\u0026``,
``\\u003c``, ``\\u003e``. Anything we render through a template construct
that real Helm would render with ``toJson`` (the boot-config SSH key) must
use *this* encoder, or the shipped chart's output would silently differ from
the Python renderer's for keys containing those characters.
"""

from __future__ import annotations

import json

_GO_ESCAPES = {"&": "\\u0026", "<": "\\u003c", ">": "\\u003e"}


def go_json(value) -> str:
    text = json.dumps(value, ensure_ascii=True)
    for char, escape in _GO_ESCAPES.items():
        text = text.replace(char, escape)
    return text
