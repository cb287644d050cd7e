"""Ownership-asserting locks: the runtime half of lock discipline.

The port's copy of the JAX package's ``kvedge_tpu/runtime/debuglock.py``
(it imports only ``functools`` and ``threading``), unchanged below this
docstring. The JAX package's static analyzer (``tools/locklint.py``)
checks the ``*_locked`` contract in the source; with ``[payload]
serving_debug_locks = true`` the port's server builds its work lock and
condition from :class:`DebugLock` / :class:`DebugCondition` and wraps
every ``*_locked`` method of the server and its scheduler
(:func:`instrument_locked_methods`), so a call without the lock, a wait
or notify by a thread that does not own it, or a re-entrant acquire
raises :class:`LockDisciplineError` at the call. Off, the server holds
a plain ``threading.Lock``.
"""

from __future__ import annotations

import functools
import threading


class LockDisciplineError(AssertionError):
    """A ``*_locked`` contract violation caught at runtime.

    Subclasses AssertionError deliberately: this is an invariant
    breach in the calling code, never an operational condition to
    retry, so it must not be swallowed by handlers catching the
    runtime's typed :class:`ServingFailure` hierarchy.
    """


class DebugLock:
    """``threading.Lock`` semantics plus an introspectable owner.

    Non-reentrant like the real thing — but an owner re-acquiring
    raises :class:`LockDisciplineError` immediately instead of
    deadlocking silently (the dynamic twin of locklint's L1 relock
    finding).
    """

    def __init__(self) -> None:
        self._inner = threading.Lock()
        self._owner: int | None = None

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:
            raise LockDisciplineError(
                "re-acquiring a non-reentrant lock already held by "
                "this thread: guaranteed self-deadlock (locklint L1 "
                "relock)"
            )
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = me
        return got

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise LockDisciplineError(
                "releasing a lock this thread does not hold"
            )
        self._owner = None
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        """Condition protocol: does the CURRENT thread hold the lock?"""
        return self._owner == threading.get_ident()

    def assert_held(self, what: str = "") -> None:
        if not self._is_owned():
            label = f" `{what}`" if what else ""
            raise LockDisciplineError(
                f"lock-discipline violation{label}: caller does not "
                f"hold the lock (the *_locked contract — see "
                f"SERVING.md rung 19)"
            )

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = (f"held by {self._owner}" if self._owner is not None
                 else "unlocked")
        return f"<DebugLock {state}>"


class DebugCondition(threading.Condition):
    """A Condition that insists on an ownership-introspectable lock.

    Plain ``threading.Condition(DebugLock())`` already inherits the
    thread-accurate checks (see module docstring); this subclass only
    exists to fail fast when handed a lock that cannot report
    ownership, and to carry ``assert_held`` through to the lock.
    """

    def __init__(self, lock: DebugLock | None = None) -> None:
        if lock is None:
            lock = DebugLock()
        if not hasattr(lock, "_is_owned"):
            raise TypeError(
                "DebugCondition requires an ownership-introspectable "
                "lock (DebugLock or RLock-like)"
            )
        super().__init__(lock)

    def assert_held(self, what: str = "") -> None:
        assert_held(self._lock, what)


def make_lock(debug: bool = False):
    """The knob seam: a DebugLock when asserting, a real Lock when not."""
    return DebugLock() if debug else threading.Lock()


def make_condition(lock) -> threading.Condition:
    return threading.Condition(lock)


def assert_held(lock, what: str = "") -> None:
    """Assert ownership on any lock that can answer; no-op otherwise.

    Call sites stay unconditional — against a plain ``threading.Lock``
    (no ``_is_owned``, no owner concept) this degrades to nothing, so
    production pays zero and debug mode pays one attribute probe.
    """
    probe = getattr(lock, "assert_held", None)
    if probe is not None:
        probe(what)
        return
    owned = getattr(lock, "_is_owned", None)
    if owned is not None and not owned():
        label = f" `{what}`" if what else ""
        raise LockDisciplineError(
            f"lock-discipline violation{label}: caller does not hold "
            f"the lock"
        )


def instrument_locked_methods(obj, lock) -> int:
    """Wrap ``obj``'s bound ``*_locked`` methods to assert ownership.

    Instance-level setattr — the class is untouched, so two servers
    can run with and without assertions in one process. Returns the
    number of methods wrapped (so callers/tests can assert the
    contract surface is nonempty).
    """
    wrapped = 0
    for name in dir(type(obj)):
        if not name.endswith("_locked") or name.startswith("__"):
            continue
        fn = getattr(obj, name, None)
        if not callable(fn):
            continue

        def _make(fn, name):
            @functools.wraps(fn)
            def checked(*args, **kwargs):
                assert_held(lock, name)
                return fn(*args, **kwargs)
            return checked

        setattr(obj, name, _make(fn, name))
        wrapped += 1
    return wrapped
