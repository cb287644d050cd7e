"""locklint — AST lock-discipline analyzer for the port's serving stack.

The port's copy of the JAX package's ``kvedge_tpu/analysis/locklint.py``
(the same rules, finding ids, pragma syntax and output), taught the
device syncs of PyTorch. Run it over the port with::

    python -m kvedge_torch.analysis.locklint kvedge_torch/

The paged serving stack keeps one invariant above all others: queue
order, slot state and page accounting mutate atomically under ONE lock,
and the ``*_locked`` methods across models/serving.py and
models/scheduler.py encode the "caller must hold the work lock"
contract in their names. This module walks the package's ASTs and
enforces four rules.

**L1 — locked-suffix calls need the lock.** A call to any ``*_locked``
method/function must come from a lock-holding context: syntactically
inside a with-block on a lock, or from a method the analyzer can prove
always runs locked. "Provably locked" is resolved interprocedurally
within each class by a fixpoint: a method whose name ends in
``_locked`` is locked by contract; a helper every one of whose
intra-class call sites is locked (and which is never taken as a bare
reference — a callback or thread target may be invoked from anywhere)
inherits the property. L1 also flags a with-block on the class's own
lock INSIDE a locked context: with a non-reentrant ``threading.Lock``
that is a guaranteed self-deadlock.

**L2 — no blocking under the lock.** While the lock is held,
``time.sleep``, a device sync, file / socket / subprocess I/O, thread
joins, and ``.wait()`` on a foreign event are lock convoys waiting to
happen: every submitter and the decode loop serialize behind them. The
device syncs are the JAX package's (``jax.device_get``,
``.block_until_ready()``) and PyTorch's: ``torch.cuda.synchronize()``,
``.synchronize()`` (a CUDA ``Event`` or ``Stream``), and ``.item()``,
``.cpu()`` and ``.tolist()``, each of which waits for the device when
its tensor lies there. The analyzer is static and cannot tell a CPU
tensor (or a numpy array) from a device one, so every such call under
the lock either moves out of it or carries an allow-pragma whose reason
says why the wait belongs there. (Cache device calls issued under the
lock are a documented design: admission parks on the queue anyway.
Those are method calls on the cache object, which the analyzer does not
confuse with the explicit blocking primitives above.) L2 additionally
flags a literal zero ``time.sleep`` in a loop that cycles a known lock:
a zero-sleep is never a poll interval — it is a GIL-yield scheduling
hack, and every such site must carry an audited suppression explaining
itself.

**L3 — condition-variable hygiene.** A condition's ``wait()`` must sit
inside a loop that re-checks its predicate (a bare if-then-wait misses
spurious wakeups and notify races by construction), and ``notify()`` /
``notify_all()`` must be issued while holding the owning lock (an
unlocked notify is a lost-wakeup race).

**L4 — guarded-field inference.** An instance attribute that any
method writes while holding the class's lock is inferred to be
lock-guarded; a write to the same attribute outside the lock (other
than in ``__init__``, where the object is not yet shared) is an
unguarded write — the classic "it's just a flag" data race.

Findings are suppressed inline, never globally, with a pragma comment
of the shape ``locklint: allow[id, id...] reason`` (see
``ALLOW_SYNTAX`` for the exact spelling) placed on the offending line
or alone on the line above it. The ids are finding ids (e.g.
``sleep-under-lock``), rule names (``L1``..``L4``), or ``all``; the
reason is MANDATORY — a reasonless pragma is itself a finding, and so
is a pragma that no longer suppresses anything (both unsuppressable:
the audit trail must stay honest). Pragmas are read from real comment
tokens only, so documentation strings — like this one — cannot
accidentally create suppressions.

The runtime complement is :mod:`kvedge_torch.runtime.debuglock`: an
ownership-asserting lock the ``serving_debug_locks`` knob swaps in, so
the suite *executes* the same L1 contract this module proves
statically.

Stdlib-only by design: importable (and runnable in CI) without torch.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import pathlib
import re
import sys
import tokenize

RULES = ("L1", "L2", "L3", "L4")

# The canonical pragma spelling (assembled so this module's own source
# never contains a parseable pragma outside a comment token test).
ALLOW_SYNTAX = "# locklint: " + "allow[<id>] <reason>"

# Finding ids per rule — the names an allow-pragma matches, next to
# the rule name itself and "all".
RULE_IDS = {
    "L1": ("unlocked-call", "relock"),
    "L2": ("sleep-under-lock", "device-sync-under-lock",
           "io-under-lock", "foreign-wait-under-lock"),
    "L3": ("wait-not-in-loop", "notify-without-lock"),
    "L4": ("unguarded-write",),
    # Suppression hygiene + parse failures: always on, never
    # suppressable (SUP is not accepted by allow-pragmas).
    "SUP": ("missing-reason", "unused-suppression", "parse-error"),
}

# A with-block on self.<attr> acquires a lock when <attr> was assigned
# a threading lock/condition factory — or, failing that, when its last
# name segment says lock. The name fallback keeps the analyzer honest
# across seams it cannot type (a lock received as a constructor
# parameter, e.g. AdmissionScheduler's shared server lock).
_LOCK_NAME_RE = re.compile(r"(?:^|_)(lock|work|mutex|cv)\d*$")

_LOCK_FACTORIES = {"Lock", "RLock", "DebugLock", "make_lock"}
_COND_FACTORIES = {"Condition", "DebugCondition", "make_condition"}
_EVENT_FACTORIES = {"Event"}
_THREAD_FACTORIES = {"Thread", "Timer"}

# Explicit blocking primitives for L2 (module-qualified call names).
_BLOCKING_QUALIFIED = {
    ("jax", "device_get"): "device-sync-under-lock",
    ("jax", "block_until_ready"): "device-sync-under-lock",
    ("subprocess", "run"): "io-under-lock",
    ("subprocess", "Popen"): "io-under-lock",
    ("subprocess", "call"): "io-under-lock",
    ("subprocess", "check_call"): "io-under-lock",
    ("subprocess", "check_output"): "io-under-lock",
    ("os", "system"): "io-under-lock",
    ("socket", "create_connection"): "io-under-lock",
    ("socket", "socket"): "io-under-lock",
    ("requests", "get"): "io-under-lock",
    ("requests", "post"): "io-under-lock",
    ("urllib", "urlopen"): "io-under-lock",
}
# Calls named by their whole dotted path (``torch.cuda.synchronize``).
_BLOCKING_DOTTED = {
    ("torch", "cuda", "synchronize"): "device-sync-under-lock",
}
_BLOCKING_METHODS = {
    "block_until_ready": "device-sync-under-lock",
    # PyTorch: a CUDA Event's or Stream's wait, and the reads that copy
    # a tensor to the host (each waits for the device when the tensor
    # lies there).
    "synchronize": "device-sync-under-lock",
    "item": "device-sync-under-lock",
    "cpu": "device-sync-under-lock",
    "tolist": "device-sync-under-lock",
}

_PRAGMA_RE = re.compile(
    r"locklint:\s*allow\[([^\]]*)\]\s*(.*?)\s*$"
)


@dataclasses.dataclass
class Finding:
    """One lock-discipline violation (or suppression-hygiene issue)."""

    rule: str      # "L1".."L4" or "SUP"
    id: str        # stable id an allow-pragma matches
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def render(self) -> str:
        mark = (f" (suppressed: {self.suppress_reason})"
                if self.suppressed else "")
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}[{self.id}] {self.message}{mark}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class _Suppression:
    __slots__ = ("line", "applies_to", "ids", "reason", "used")

    def __init__(self, line: int, applies_to: int, ids: tuple,
                 reason: str):
        self.line = line
        self.applies_to = applies_to
        self.ids = ids
        self.reason = reason
        self.used = False


def _parse_suppressions(source: str) -> list[_Suppression]:
    """Allow-pragmas from REAL comment tokens (tokenize, not a line
    regex — a pragma quoted inside a docstring is documentation, not a
    suppression). A pragma sharing its line with code covers that
    line; a comment-only pragma line covers the next code line."""
    out: list[_Suppression] = []
    lines = source.splitlines()
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline
        ))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out  # the AST pass reports the parse failure
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if not m:
            continue
        row, col = tok.start
        ids = tuple(s.strip() for s in m.group(1).split(",")
                    if s.strip())
        applies_to = row
        if not lines[row - 1][:col].strip():
            # Comment-only line: cover the next code line.
            for j in range(row, len(lines)):
                nxt = lines[j].strip()
                if nxt and not nxt.startswith("#"):
                    applies_to = j + 1
                    break
        out.append(_Suppression(row, applies_to, ids,
                                m.group(2).strip()))
    return out


def _call_name(func: ast.AST) -> str | None:
    """Trailing name of a call target (``x.y.z(...)`` -> ``z``)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _qualified(func: ast.AST) -> tuple[str, str] | None:
    """(module, name) for one-level dotted calls like ``time.sleep`` —
    the shape every explicit blocking primitive here takes."""
    if isinstance(func, ast.Attribute) and isinstance(func.value,
                                                      ast.Name):
        return (func.value.id, func.attr)
    return None


def _dotted(func: ast.AST) -> tuple[str, ...] | None:
    """The whole dotted path of a call target (``torch.cuda.synchronize``
    -> ``("torch", "cuda", "synchronize")``), None when it is not a
    chain of names."""
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if not isinstance(func, ast.Name):
        return None
    parts.append(func.id)
    return tuple(reversed(parts))


def _factory_kind(value: ast.AST) -> str | None:
    """lock / cond / event / thread when ``value`` constructs a
    recognized threading primitive, else None."""
    if not isinstance(value, ast.Call):
        return None
    name = _call_name(value.func)
    if name in _LOCK_FACTORIES:
        return "lock"
    if name in _COND_FACTORIES:
        return "cond"
    if name in _EVENT_FACTORIES:
        return "event"
    if name in _THREAD_FACTORIES:
        return "thread"
    return None


def _is_zero(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and not isinstance(node.value, bool)
            and node.value == 0)


def _self_method_refs(value: ast.AST) -> set:
    """Method names a value expression may alias (``self.m``, or an
    IfExp choosing between several) — resolves the decode loop's
    ``step = self._loop_once_overlap if ... else self._loop_once``."""
    out: set = set()
    for node in ast.walk(value):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            out.add(node.attr)
    return out


@dataclasses.dataclass
class _Deferred:
    """An observation whose verdict depends on the interprocedural
    fixpoint: held iff syntactically under a with-lock OR the
    enclosing unit is proven locked."""

    id: str
    node: ast.AST
    held: bool     # syntactic with-lock state at the site
    fn: str        # enclosing analyzable unit (fixpoint key)
    message: str


class _ScopeLint(ast.NodeVisitor):
    """Per-function walker: tracks the syntactic with-lock state and
    records observations for the class-level fixpoint."""

    def __init__(self, owner: "_ClassLint", fn_name: str,
                 locked_by_name: bool):
        self.owner = owner
        self.fn = fn_name
        self.held = locked_by_name
        self.loop_stack: list[ast.AST] = []
        self.local_kinds: dict[str, str] = {}    # name -> factory kind
        self.local_aliases: dict[str, set] = {}  # name -> method names

    # -- classification ------------------------------------------------

    def _expr_kind(self, expr: ast.AST) -> str | None:
        """lock/cond/event/thread classification of a receiver, via
        factory-tracked attrs and locals plus the lock-name fallback."""
        if isinstance(expr, ast.Name):
            k = self.local_kinds.get(expr.id)
            if k is not None:
                return k
            return "lock" if _LOCK_NAME_RE.search(expr.id) else None
        if isinstance(expr, ast.Attribute):
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"):
                k = self.owner.attr_kinds.get(expr.attr)
                if k is not None:
                    return k
                return ("lock" if _LOCK_NAME_RE.search(expr.attr)
                        else None)
            # Foreign attribute path: ticket.cond, server._lock —
            # classify by the trailing name alone.
            if expr.attr == "cond" or expr.attr.endswith("_cond"):
                return "cond"
            return ("lock" if _LOCK_NAME_RE.search(expr.attr)
                    else None)
        return None

    def _is_lockish(self, expr: ast.AST) -> bool:
        return self._expr_kind(expr) in ("lock", "cond")

    def _is_own_lock(self, expr: ast.AST) -> bool:
        return (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and self.owner.attr_kinds.get(expr.attr)
                in ("lock", "cond"))

    # -- assignments (factory tracking + L4 writes) ---------------------

    def _record_target(self, target: ast.AST, value: ast.AST | None,
                       node: ast.AST) -> None:
        kind = _factory_kind(value) if value is not None else None
        if isinstance(target, ast.Name):
            if kind is not None:
                self.local_kinds[target.id] = kind
            elif value is not None:
                methods = _self_method_refs(value)
                if methods:
                    self.local_aliases[target.id] = methods
        elif (isinstance(target, ast.Attribute)
              and isinstance(target.value, ast.Name)
              and target.value.id == "self"):
            if kind is not None:
                self.owner.attr_kinds.setdefault(target.attr, kind)
            self.owner.writes.append(
                (target.attr, node, self.held, self.fn)
            )
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, None, node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._record_target(target, node.value, node)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target, node.value, node)
            self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target, None, node)
        self.visit(node.value)

    # -- lock regions ---------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        took_lock = False
        for item in node.items:
            self.visit(item.context_expr)
            if self._is_lockish(item.context_expr):
                took_lock = True
                if self.held and self._is_own_lock(item.context_expr):
                    self.owner.deferred.append(_Deferred(
                        "relock", node, True, self.fn,
                        "re-acquiring the class's own non-reentrant "
                        "lock inside a locked context is a "
                        "self-deadlock",
                    ))
        if took_lock and not self.held:
            self.held = True
            for stmt in node.body:
                self.visit(stmt)
            self.held = False
        else:
            for stmt in node.body:
                self.visit(stmt)

    visit_AsyncWith = visit_With

    # -- nested scopes ----------------------------------------------------

    def visit_FunctionDef(self, node) -> None:
        # A nested def is its own execution context: it may run on
        # another thread, long after this frame released the lock. It
        # is analyzed separately with NO inherited lock state (unless
        # its own name claims the *_locked contract).
        self.owner.queue_nested(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # Lambdas in this codebase are immediate-use (sort/min keys):
        # they execute inside the expression that closes over them, so
        # they inherit the current lock state.
        self.visit(node.body)

    # -- loops (L3's while rule, the zero-sleep audit) --------------------

    def visit_While(self, node: ast.While) -> None:
        self.loop_stack.append(node)
        self.generic_visit(node)
        self.loop_stack.pop()

    def visit_For(self, node: ast.For) -> None:
        self.loop_stack.append(node)
        self.generic_visit(node)
        self.loop_stack.pop()

    # -- references (disqualify callback-passed methods) ------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and isinstance(node.ctx, ast.Load)):
            self.owner.referenced.add(node.attr)
        self.generic_visit(node)

    # -- calls -------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        qual = _qualified(node.func)
        on_self = (isinstance(node.func, ast.Attribute)
                   and isinstance(node.func.value, ast.Name)
                   and node.func.value.id == "self")

        if on_self:
            # The intra-class call graph for the fixpoint. A method
            # USED as a call target is not "referenced" (escaped).
            self.owner.self_calls.append(
                (node.func.attr, self.held, self.fn)
            )

        if name and name.endswith("_locked"):
            self.owner.deferred.append(_Deferred(
                "unlocked-call", node, self.held, self.fn,
                f"call to `{name}` from `{self.owner.name}."
                f"{self.fn}` without holding the lock: *_locked "
                f"callees require a with-block on the lock or a "
                f"provably locked caller",
            ))

        blocking = _BLOCKING_QUALIFIED.get(qual) if qual else None
        if blocking is None:
            blocking = _BLOCKING_DOTTED.get(_dotted(node.func))
        if blocking is None and name in _BLOCKING_METHODS:
            blocking = _BLOCKING_METHODS[name]
        if name == "open" and isinstance(node.func, ast.Name):
            blocking = "io-under-lock"
        if qual == ("time", "sleep"):
            self._record_sleep(node)
        elif blocking is not None:
            self.owner.deferred.append(_Deferred(
                blocking, node, self.held, self.fn,
                f"blocking call `{ast.unparse(node.func)}(...)` "
                f"while holding the lock stalls every waiter behind "
                f"it",
            ))

        if isinstance(node.func, ast.Attribute):
            recv = node.func.value
            kind = self._expr_kind(recv)
            if node.func.attr in ("notify", "notify_all") \
                    and kind == "cond":
                self.owner.deferred.append(_Deferred(
                    "notify-without-lock", node, self.held, self.fn,
                    f"`{ast.unparse(node.func)}()` must be issued "
                    f"while holding the condition's lock (an "
                    f"unlocked notify is a lost-wakeup race)",
                ))
            elif node.func.attr == "wait":
                if kind == "cond" and not self.loop_stack:
                    self.owner.direct.append(
                        ("L3", "wait-not-in-loop", node,
                         f"`{ast.unparse(node.func)}()` outside any "
                         f"predicate loop: spurious wakeups and "
                         f"notify races make a bare wait wrong by "
                         f"construction")
                    )
                elif kind in ("event", "thread"):
                    self.owner.deferred.append(_Deferred(
                        "foreign-wait-under-lock", node, self.held,
                        self.fn,
                        f"`{ast.unparse(node.func)}()` waits on a "
                        f"foreign primitive while the lock is held "
                        f"— whoever must set it may need this very "
                        f"lock",
                    ))
            elif node.func.attr == "join" and kind == "thread":
                self.owner.deferred.append(_Deferred(
                    "foreign-wait-under-lock", node, self.held,
                    self.fn,
                    f"`{ast.unparse(node.func)}()` joins a thread "
                    f"while the lock is held",
                ))

        # Visit children — but not the callee Attribute itself, so a
        # plain method CALL does not count as a bare reference for the
        # fixpoint (only passing `self.m` around escapes it).
        if isinstance(node.func, ast.Attribute):
            self.visit(node.func.value)
        elif not isinstance(node.func, ast.Name):
            self.visit(node.func)
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)

    def _record_sleep(self, node: ast.Call) -> None:
        zero = bool(node.args) and _is_zero(node.args[0])
        if self.held or not zero:
            self.owner.deferred.append(_Deferred(
                "sleep-under-lock", node, self.held, self.fn,
                "time.sleep under the lock convoys every waiter "
                "behind the sleeper",
            ))
        elif self._loop_cycles_lock():
            self.owner.direct.append(
                ("L2", "sleep-under-lock", node,
                 "zero-sleep GIL yield in a loop that cycles the "
                 "lock: a scheduling hack, not a poll interval — "
                 "audit it with an allow[sleep-under-lock] pragma "
                 "or remove it")
            )

    def _loop_cycles_lock(self) -> bool:
        """Does any enclosing loop's body (re)acquire a known lock —
        syntactically, or through a direct self-method / local-alias
        call one level deep? The lock-convoy shape: release, yield,
        re-acquire."""
        for loop in self.loop_stack:
            for sub in ast.walk(loop):
                if isinstance(sub, (ast.With, ast.AsyncWith)):
                    if any(self._is_lockish(i.context_expr)
                           for i in sub.items):
                        return True
                if isinstance(sub, ast.Call):
                    called = set()
                    if (isinstance(sub.func, ast.Attribute)
                            and isinstance(sub.func.value, ast.Name)
                            and sub.func.value.id == "self"):
                        called.add(sub.func.attr)
                    elif isinstance(sub.func, ast.Name):
                        called |= self.local_aliases.get(
                            sub.func.id, set()
                        )
                    if called & self.owner.acquiring_methods:
                        return True
        return False


class _ClassLint:
    """Analysis context for one class — or a module's top level, which
    behaves as an anonymous class whose methods are its functions."""

    def __init__(self, name: str):
        self.name = name
        self.attr_kinds: dict[str, str] = {}
        self.methods: dict[str, ast.AST] = {}
        self.deferred: list[_Deferred] = []
        self.direct: list[tuple] = []
        self.writes: list[tuple] = []     # (attr, node, held, fn)
        self.referenced: set = set()      # self.<attr> bare loads
        self.self_calls: list[tuple] = []  # (callee, held, fn)
        self.acquiring_methods: set = set()
        self._nested: list = []

    def queue_nested(self, node) -> None:
        self._nested.append(node)

    def analyze(self, body: list) -> None:
        # Pass 1: register methods; pre-scan for factory-assigned
        # lock/cond/event/thread attributes so classification holds
        # regardless of definition order.
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Assign):
                        continue
                    kind = _factory_kind(sub.value)
                    if kind is None:
                        continue
                    for t in sub.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            self.attr_kinds.setdefault(t.attr, kind)
        # Pass 2: which methods syntactically acquire a lock (feeds
        # the zero-sleep lock-cycle audit).
        probe = _ScopeLint(self, "<probe>", False)
        for name, fn in self.methods.items():
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.With, ast.AsyncWith)) and any(
                    probe._is_lockish(i.context_expr)
                    for i in sub.items
                ):
                    self.acquiring_methods.add(name)
                    break
        # Pass 3: walk each method, then every nested def (each an
        # independent execution context).
        for name, fn in self.methods.items():
            self._walk(fn, name, name.endswith("_locked"))
        while self._nested:
            node = self._nested.pop()
            self._walk(node, f"{node.name} [nested]",
                       node.name.endswith("_locked"))

    def _walk(self, fn, label: str, locked_by_name: bool) -> None:
        walker = _ScopeLint(self, label, locked_by_name)
        for default in (list(getattr(fn.args, "defaults", []))
                        + [d for d in getattr(fn.args, "kw_defaults",
                                              []) if d is not None]):
            walker.visit(default)
        for stmt in fn.body:
            walker.visit(stmt)

    def locked_fns(self) -> set:
        """Units proven to run with the lock held: named ``*_locked``,
        or helpers with >= 1 intra-class call site, ALL of them
        lock-held, never taken as a bare reference (a bare reference
        means unknown call sites — a callback, a thread target)."""
        locked = {n for n in self.methods if n.endswith("_locked")}
        edges: dict[str, list] = {}
        for callee, held, fn in self.self_calls:
            if callee in self.methods:
                edges.setdefault(callee, []).append((held, fn))
        changed = True
        while changed:
            changed = False
            for name in self.methods:
                if name in locked or name in self.referenced:
                    continue
                sites = edges.get(name)
                if not sites:
                    continue
                if all(held or fn in locked for held, fn in sites):
                    locked.add(name)
                    changed = True
        return locked

    def findings(self) -> list[tuple]:
        locked = self.locked_fns()
        out = list(self.direct)
        for d in self.deferred:
            is_held = d.held or d.fn in locked
            if d.id == "unlocked-call":
                if not is_held:
                    out.append(("L1", d.id, d.node, d.message))
            elif d.id == "relock":
                out.append(("L1", d.id, d.node, d.message))
            elif d.id == "notify-without-lock":
                if not is_held:
                    out.append(("L3", d.id, d.node, d.message))
            else:  # the L2 family: a finding only under the lock
                if is_held:
                    out.append(("L2", d.id, d.node, d.message))
        # L4 — only for classes that actually practice lock
        # discipline (own a lock/condition or have *_locked methods).
        has_discipline = (
            any(k in ("lock", "cond")
                for k in self.attr_kinds.values())
            or any(n.endswith("_locked") for n in self.methods)
        )
        if has_discipline:
            guarded: set = set()
            for attr, _node, held, fn in self.writes:
                if fn in ("__init__", "__post_init__"):
                    continue
                if held or fn in locked:
                    guarded.add(attr)
            for attr, node, held, fn in self.writes:
                if (attr not in guarded
                        or fn in ("__init__", "__post_init__")
                        or held or fn in locked):
                    continue
                out.append((
                    "L4", "unguarded-write", node,
                    f"`self.{attr}` is written under `{self.name}`'s "
                    f"lock elsewhere but written in `{self.name}."
                    f"{fn}` without it — an unguarded write to a "
                    f"guarded field",
                ))
        return out


def _lint_module(path: str, source: str,
                 rules: tuple) -> list[Finding]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("SUP", "parse-error", path, e.lineno or 1,
                        e.offset or 0, f"cannot parse: {e.msg}")]
    suppressions = _parse_suppressions(source)
    raw: list[tuple] = []

    # Module top level: an anonymous class whose methods are the
    # top-level functions (workload.py keeps locks in function locals
    # and module helpers).
    top = _ClassLint("<module>")
    top.analyze([s for s in tree.body
                 if not isinstance(s, ast.ClassDef)])
    raw.extend(top.findings())
    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef):
            cl = _ClassLint(stmt.name)
            cl.analyze(stmt.body)
            raw.extend(cl.findings())

    findings = [
        Finding(rule, fid, path, getattr(node, "lineno", 1),
                getattr(node, "col_offset", 0), message)
        for rule, fid, node, message in raw
        if rule == "SUP" or rule in rules
    ]

    by_line: dict[int, list] = {}
    for sup in suppressions:
        by_line.setdefault(sup.applies_to, []).append(sup)
        if sup.applies_to != sup.line:
            by_line.setdefault(sup.line, []).append(sup)
    for f in findings:
        if f.rule == "SUP":
            continue
        for sup in by_line.get(f.line, []):
            if not sup.reason:
                continue  # reasonless pragmas never suppress
            if ("all" in sup.ids or f.rule in sup.ids
                    or f.id in sup.ids):
                f.suppressed = True
                f.suppress_reason = sup.reason
                sup.used = True

    # Suppression hygiene: reasons are mandatory; and when the full
    # rule set ran, a pragma that suppressed nothing is stale (under a
    # rule subset a disabled rule legitimately strands its pragmas).
    for sup in suppressions:
        if not sup.reason:
            findings.append(Finding(
                "SUP", "missing-reason", path, sup.line, 0,
                f"suppression allow[{','.join(sup.ids)}] has no "
                f"reason — every suppression must say why",
            ))
        elif not sup.used and tuple(rules) == RULES:
            findings.append(Finding(
                "SUP", "unused-suppression", path, sup.line, 0,
                f"suppression allow[{','.join(sup.ids)}] matches no "
                f"finding — stale pragma, remove it",
            ))
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


# ---- public API -------------------------------------------------------


def lint_source(source: str, path: str = "<string>",
                rules: tuple = RULES) -> list[Finding]:
    """Lint one source string (the fixture-test entry point)."""
    return _lint_module(path, source, tuple(rules))


def lint_file(path: str | pathlib.Path,
              rules: tuple = RULES) -> list[Finding]:
    p = pathlib.Path(path)
    return lint_source(p.read_text(encoding="utf-8"), str(p), rules)


def iter_python_files(paths: list) -> list[pathlib.Path]:
    out: list[pathlib.Path] = []
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            out.extend(sorted(
                f for f in p.rglob("*.py")
                if "__pycache__" not in f.parts
            ))
        else:
            out.append(p)
    return out


def lint_paths(paths: list, rules: tuple = RULES) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(lint_file(f, rules))
    return findings


def to_report(findings: list[Finding]) -> dict:
    """The machine-readable report (``--json``): a stable schema, one
    object per finding, plus the counts a CI gate keys on."""
    unsuppressed = [f for f in findings if not f.suppressed]
    return {
        "version": 1,
        "tool": "locklint",
        "rules": list(RULES),
        "findings": [f.to_json() for f in findings],
        "summary": {
            "total": len(findings),
            "suppressed": len(findings) - len(unsuppressed),
            "unsuppressed": len(unsuppressed),
        },
    }


def main(argv: list | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m kvedge_torch.analysis.locklint",
        description="AST lock-discipline analyzer: L1 *_locked call "
                    "contexts, L2 blocking under the lock (JAX's and "
                    "PyTorch's device syncs among them), L3 condition "
                    "hygiene, L4 guarded-field inference.",
    )
    ap.add_argument("paths", nargs="+",
                    help="files or directories to lint")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report on stdout")
    ap.add_argument("--rules", default=",".join(RULES),
                    help="comma-separated rule subset "
                         "(default: L1,L2,L3,L4)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings (the audit "
                         "trail)")
    args = ap.parse_args(argv)

    rules = tuple(r.strip() for r in args.rules.split(",")
                  if r.strip())
    bad = [r for r in rules if r not in RULES]
    if bad:
        print(f"locklint: unknown rule(s) {bad}; known: "
              f"{list(RULES)}", file=sys.stderr)
        return 2

    findings = lint_paths(args.paths, rules)
    if args.json:
        print(json.dumps(to_report(findings), indent=2))
    else:
        for f in findings:
            if f.suppressed and not args.show_suppressed:
                continue
            print(f.render())
        unsup = sum(1 for f in findings if not f.suppressed)
        print(f"locklint: {unsup} finding(s), "
              f"{len(findings) - unsup} suppressed, "
              f"{len(iter_python_files(args.paths))} file(s)")
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    raise SystemExit(main())
