"""The port's lock analyzer (``kvedge_torch/analysis/locklint.py``): the
JAX package's analyzer, taught PyTorch's device syncs.

* On every source fixture of the reference's analyzer tests (none calls
  a PyTorch sync), and on the reference tests' inline sources, the
  port's analyzer reports exactly the reference's findings: rule, id,
  line, column, message and suppression.
* Each new L2 entry (``torch.cuda.synchronize()``, ``.synchronize()`` on
  an event or a stream, ``.item()``, ``.cpu()``, ``.tolist()``) is
  ``device-sync-under-lock`` under a ``with self._lock:`` and nothing
  outside it; a reasoned allow-pragma suppresses it, a reasonless one
  does not, and a pragma left without its finding is reported.
* ``python -m kvedge_torch.analysis.locklint kvedge_torch/`` exits 0 with
  no unsuppressed finding, and the analyzer imports without torch.
"""

import pathlib
import subprocess
import sys

import pytest

from kvedge_tpu.analysis import locklint as jlint
from kvedge_torch.analysis import locklint

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "locklint"

INLINE = {
    "pragma-in-string": (
        "import threading, time\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def tick(self):\n"
        "        doc = 'locklint: allow[sleep-under-lock] not a pragma'\n"
        "        with self._lock:\n"
        "            time.sleep(0.1)\n"
        "        return doc\n"),
    "reasonless-allow-all": (
        "import threading, time\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def tick(self):\n"
        "        with self._lock:\n"
        "            time.sleep(0.1)  # locklint: allow[all]\n"),
    "parse-error": "def broken(:\n",
    "jax-syncs": (
        "import threading, jax\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def read(self, x):\n"
        "        with self._lock:\n"
        "            y = jax.device_get(x)\n"
        "            x.block_until_ready()\n"
        "        return y\n"),
}


def _rows(findings):
    return [(f.rule, f.id, f.line, f.col, f.message, f.suppressed,
             f.suppress_reason) for f in findings]


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        FIXTURES.glob("*.py")))
def test_reference_fixtures_give_the_reference_findings(name):
    source = (FIXTURES / name).read_text()
    for method in ("synchronize", "item(", ".cpu(", "tolist"):
        assert method not in source, (name, method)
    for rules in (locklint.RULES, ("L2",), ("L1", "L3")):
        assert _rows(locklint.lint_source(source, name, rules)) == \
            _rows(jlint.lint_source(source, name, rules))


@pytest.mark.parametrize("name", sorted(INLINE))
def test_reference_inline_sources_give_the_reference_findings(name):
    source = INLINE[name]
    assert _rows(locklint.lint_source(source, name)) == \
        _rows(jlint.lint_source(source, name))


def test_rules_ids_and_pragma_syntax_are_the_references():
    assert locklint.RULES == jlint.RULES
    assert locklint.RULE_IDS == jlint.RULE_IDS
    assert locklint.ALLOW_SYNTAX == jlint.ALLOW_SYNTAX


TORCH_SYNCS = {
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
    "event.synchronize": "self._event.synchronize()",
    "stream.synchronize": "stream.synchronize()",
    "item": "total = x.sum().item()",
    "cpu": "host = x.cpu()",
    "tolist": "rows = x.tolist()",
}


def _source(call: str, locked: bool, pragma: str = "") -> str:
    body = (f"        with self._lock:\n            {call}{pragma}\n"
            if locked else f"        {call}{pragma}\n")
    return ("import threading\nimport torch\n"
            "class Server:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._event = torch.cuda.Event()\n"
            "    def read(self, x, stream):\n" + body)


@pytest.mark.parametrize("name", sorted(TORCH_SYNCS))
def test_torch_sync_flagged_under_the_lock_only(name):
    call = TORCH_SYNCS[name]
    locked = locklint.lint_source(_source(call, True))
    assert [(f.rule, f.id, f.line) for f in locked] == \
        [("L2", "device-sync-under-lock", 9)], [f.render() for f in locked]
    assert not locked[0].suppressed
    assert locklint.lint_source(_source(call, False)) == []
    # The reference's analyzer knows JAX's syncs only.
    assert jlint.lint_source(_source(call, True)) == []


@pytest.mark.parametrize("name", sorted(TORCH_SYNCS))
def test_reasoned_pragma_suppresses_a_torch_sync(name):
    pragma = ("  # locklint: allow[device-sync-under-lock] the batch "
              "waits on these tokens")
    findings = locklint.lint_source(_source(TORCH_SYNCS[name], True,
                                            pragma))
    assert len(findings) == 1 and findings[0].suppressed
    assert findings[0].suppress_reason == "the batch waits on these tokens"
    # Outside the lock the same pragma matches nothing: it is stale.
    stale = locklint.lint_source(_source(TORCH_SYNCS[name], False, pragma))
    assert [f.id for f in stale] == ["unused-suppression"]


def test_reasonless_pragma_leaves_a_torch_sync_standing():
    pragma = "  # locklint: allow[device-sync-under-lock]"
    findings = locklint.lint_source(_source("x.item()", True, pragma))
    ids = sorted((f.id, f.suppressed) for f in findings)
    assert ids == [("device-sync-under-lock", False),
                   ("missing-reason", False)]


def test_every_port_suppression_carries_a_reason():
    findings = locklint.lint_paths([REPO / "kvedge_torch"])
    assert [f.render() for f in findings if not f.suppressed] == []
    suppressed = [f for f in findings if f.suppressed]
    assert suppressed and all(f.suppress_reason for f in suppressed)
    assert {f.id for f in suppressed} >= {"device-sync-under-lock"}


def test_module_entry_point_and_no_torch_needed():
    proc = subprocess.run(
        [sys.executable, "-m", "kvedge_torch.analysis.locklint",
         "kvedge_torch/"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "locklint: 0 finding(s)" in proc.stdout
    code = ("import sys\n"
            "for name in ('torch', 'numpy', 'jax', 'kvedge_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from kvedge_torch.analysis import locklint\n"
            "print(len(locklint.lint_source('x = 1\\n')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "0", proc.stderr
