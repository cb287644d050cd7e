"""helmlite: a tiny Go-template/sprig subset interpreter for chart testing.

There is no ``helm`` binary in the test environment, yet the shipped chart
(``deployment/helm``) must provably render the same objects as the Python
renderer — the reference's only "renderer" was Helm itself, so template
drift here would be a silent capability break. helmlite interprets exactly
the template subset the chart uses:

* ``{{/* comments */}}``
* ``{{- define "name" -}}...{{ end -}}`` partials and ``include``
* ``.Values.* / .Chart.Name|Version|AppVersion / .Release.Service`` atoms
* pipelines with ``default``, ``trunc``, ``trimSuffix``, ``quote``,
  ``toJson``, ``b64enc``, ``indent``, ``mul``
* ``{{- if eq <atom> <atom> }}...{{- end }}`` conditionals
* ``{{-`` / ``-}}`` whitespace trimming

It is a test instrument, not a Helm replacement: anything outside the
subset raises so the consistency test fails loudly rather than render
something subtly different from what real Helm would produce.
"""

from __future__ import annotations

import base64
import fnmatch
import pathlib
import re
import shlex

import yaml

from kvedge_torch.utils.gojson import go_json

_ACTION_RE = re.compile(r"\{\{(-?)((?:.|\n)*?)(-?)\}\}")


class HelmLiteError(ValueError):
    """Raised on template constructs outside the supported subset."""


def load_helmignore(chart_dir) -> list[str]:
    """The chart's ``.helmignore`` patterns ([] if the file is absent).

    Shared by the renderer's template loader and the CLI's ``package``
    command so the two can never disagree about what the load-bearing
    exclusions are (reference ``.helmignore:23-24``).
    """
    ignore_file = pathlib.Path(chart_dir) / ".helmignore"
    patterns: list[str] = []
    if ignore_file.exists():
        for line in ignore_file.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                patterns.append(line)
    return patterns


def helmignore_matches(rel_path: str, patterns: list[str]) -> bool:
    """True if ``rel_path`` (chart-relative, '/'-separated) is ignored.

    Helm matches entries as shell globs against the relative path and
    against each basename; ``dir/`` patterns match everything under that
    directory.
    """
    name = rel_path.rsplit("/", 1)[-1]
    for pat in patterns:
        if pat.endswith("/"):
            # Directory pattern: ignore anything under a path segment
            # matching it, at any depth.
            if ("/" + pat) in ("/" + rel_path):
                return True
            continue
        if fnmatch.fnmatch(rel_path, pat) or fnmatch.fnmatch(name, pat):
            return True
    return False


def _strip_left(text: str) -> str:
    return text.rstrip(" \t\n")


def _strip_right(text: str) -> str:
    return text.lstrip(" \t\n")


class Chart:
    """A loaded chart directory: metadata, values, partials, templates."""

    def __init__(self, chart_dir: str):
        root = pathlib.Path(chart_dir)
        meta = yaml.safe_load((root / "Chart.yaml").read_text())
        self.chart = {
            "Name": meta["name"],
            "Version": str(meta["version"]),
            "AppVersion": str(meta["appVersion"]),
        }
        self.default_values = yaml.safe_load((root / "values.yaml").read_text())
        self.defines: dict[str, str] = {}
        self.templates: dict[str, str] = {}
        self._ignore_patterns = load_helmignore(root)
        self.ignored = set()
        for path in sorted((root / "templates").iterdir()):
            if self._is_ignored(path.name):
                self.ignored.add(path.name)
                continue
            if not path.is_file():
                raise HelmLiteError(
                    f"templates/{path.name} is not a plain file — "
                    "subdirectories are outside the supported subset"
                )
            text = path.read_text()
            if path.name.startswith("_"):
                self._collect_defines(text)
            else:
                self.templates[path.name] = text

    def _is_ignored(self, name: str) -> bool:
        return helmignore_matches(name, self._ignore_patterns)

    def _collect_defines(self, text: str) -> None:
        pos = 0
        while True:
            match = _ACTION_RE.search(text, pos)
            if not match:
                break
            body = match.group(2).strip()
            if body.startswith("define"):
                name = shlex.split(body)[1]
                start = match.end()
                if match.group(3):  # -}} trims following whitespace
                    while start < len(text) and text[start] in " \t\n":
                        start += 1
                # Find the define's own end: nested if/end (or with/range,
                # which also pair with end) must not terminate the body early.
                end_match = None
                depth = 0
                for m2 in _ACTION_RE.finditer(text, start):
                    inner = m2.group(2).strip()
                    if inner.split(" ", 1)[0] in ("if", "with", "range"):
                        depth += 1
                    elif inner == "end":
                        if depth == 0:
                            end_match = m2
                            break
                        depth -= 1
                if end_match is None:
                    raise HelmLiteError(f"define {name!r} has no end")
                define_body = text[start:end_match.start()]
                if end_match.group(1):  # {{- end trims preceding whitespace
                    define_body = _strip_left(define_body)
                self.defines[name] = define_body
                pos = end_match.end()
            else:
                pos = match.end()

    # ---- expression evaluation -------------------------------------------

    def _atom(self, token: str, ctx: dict):
        if token.startswith('"') and token.endswith('"'):
            return token[1:-1]
        if token == "true":
            return True
        if token == "false":
            return False
        if re.fullmatch(r"-?\d+", token):
            return int(token)
        if token == ".":
            return ctx
        if token.startswith(".Values."):
            key = token[len(".Values."):]
            if key not in ctx["Values"]:
                raise HelmLiteError(f"unknown value {key!r}")
            return ctx["Values"][key]
        if token.startswith(".Chart."):
            return self.chart[token[len(".Chart."):]]
        if token == ".Release.Service":
            return "Helm"
        raise HelmLiteError(f"unsupported atom {token!r}")

    def _call(self, func: str, args: list, ctx: dict):
        if func == "include":
            if len(args) != 2:
                raise HelmLiteError("include expects name and context")
            return self._render_text(self.defines[args[0]], ctx)
        if func == "default":
            default_value, given = args
            return given if given else default_value
        if func == "trunc":
            n, s = args
            return s[:n]
        if func == "trimSuffix":
            suffix, s = args
            return s[: -len(suffix)] if s.endswith(suffix) else s
        if func == "quote":
            (s,) = args
            escaped = str(s).replace("\\", "\\\\").replace('"', '\\"')
            return f'"{escaped}"'
        if func == "toJson":
            (v,) = args
            return go_json(v)  # Go/sprig HTML-escapes & < >; json.dumps doesn't
        if func == "b64enc":
            (s,) = args
            return base64.b64encode(str(s).encode("utf-8")).decode("ascii")
        if func == "indent":
            n, s = args
            pad = " " * n
            return "\n".join(pad + line for line in str(s).split("\n"))
        if func == "mul":
            # sprig mul: the product of its arguments as integers.
            out = 1
            for v in args:
                out *= int(v)
            return out
        if func == "eq":
            a, b = args
            return a == b
        if func == "ne":
            a, b = args
            return a != b
        if func == "toString":
            # sprig strval: fmt %v. Charts compare numeric values as
            # strings because Helm's values pipeline yields float64 from
            # values.yaml but int64 from --set — `eq`/`ne` on mixed Go
            # numeric kinds is a render error, while toString normalizes
            # both ("1"). Ints are ints here, so plain str() matches.
            (v,) = args
            if isinstance(v, bool):
                return "true" if v else "false"
            return str(v)
        raise HelmLiteError(f"unsupported function {func!r}")

    _SENTINEL = object()

    def _eval_segment(self, tokens: list[str], ctx: dict, piped=_SENTINEL):
        if len(tokens) == 1 and piped is self._SENTINEL:
            return self._atom(tokens[0], ctx)
        func, *arg_tokens = tokens
        args = [self._atom(t, ctx) for t in arg_tokens]
        if piped is not self._SENTINEL:
            args.append(piped)  # Go templates append the piped value last
        return self._call(func, args, ctx)

    def _eval(self, expr: str, ctx: dict):
        segments = [s.strip() for s in expr.split("|")]
        value = self._SENTINEL
        for segment in segments:
            tokens = shlex.split(segment, posix=False)
            value = self._eval_segment(tokens, ctx, piped=value)
        return value

    # ---- template rendering ----------------------------------------------

    def _render_text(self, text: str, ctx: dict) -> str:
        out: list[str] = []
        pos = 0
        skip_depth = 0  # inside a false if-block
        while True:
            match = _ACTION_RE.search(text, pos)
            if not match:
                if skip_depth == 0:
                    out.append(text[pos:])
                break
            literal = text[pos:match.start()]
            if match.group(1) == "-":
                literal = _strip_left(literal)
            if skip_depth == 0:
                out.append(literal)
            body = match.group(2).strip()
            if body.startswith("/*"):
                pass  # comment
            elif body.startswith("if "):
                if skip_depth or not self._eval(body[3:], ctx):
                    skip_depth += 1
            elif body == "end":
                if skip_depth:
                    skip_depth -= 1
            elif body.startswith("define"):
                raise HelmLiteError("nested define unsupported")
            elif skip_depth == 0:
                value = self._eval(body, ctx)
                out.append(value if isinstance(value, str) else str(value))
            pos = match.end()
            if match.group(3) == "-":
                next_pos = pos
                while next_pos < len(text) and text[next_pos] in " \t\n":
                    next_pos += 1
                pos = next_pos
        return "".join(out)

    def render(self, values_overrides: dict | None = None) -> dict[str, str]:
        """Render all (non-ignored) templates; empty outputs are dropped."""
        values = dict(self.default_values)
        values.update(values_overrides or {})
        ctx = {"Values": values}
        rendered: dict[str, str] = {}
        for name, text in self.templates.items():
            output = self._render_text(text, ctx)
            if output.strip():
                rendered[name] = output
        return rendered
