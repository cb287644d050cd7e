"""Bounded host-side journal of resumable in-flight request state.

The port's copy of the JAX package's ``kvedge_tpu/runtime/journal.py``
(it imports only ``dataclasses`` and ``typing``), unchanged below this
docstring. Its pointers read for the port: the serving layer is
``kvedge_torch/models/serving.py``, the page bytes come from its
``PagedKVCache.swapout_pages`` (host tensors, sliced and copied per
entry so each entry owns exactly the bytes it counts), and the
recovery half is ``kvedge_torch/runtime/recovery.py``.

At quiescent boundaries the decode loop checkpoints each live request's
resumable state here — KV pages as the verbatim host bytes
``swapout_pages`` produces (including int8 scale slabs), the
emitted-token log, the sampler key, budgets, and the scheduler ticket —
so ``revive()`` can re-admit the journaled requests into fresh slots
instead of failing them, resuming decode from the checkpointed offset
bit-identically.

Design constraints:

* **Dumb container, one owner.** Every method is called with the
  serving work lock held. The journal itself takes no locks and runs
  no device ops.
* **Bounded.** ``max_bytes`` caps the sum of checkpointed KV bytes
  (0 = unbounded). A ``put`` that would blow the budget is refused —
  the caller counts it as a skipped checkpoint and the request simply
  keeps its previous (older but internally consistent) entry, or none.
* **Per-request transactional.** ``put`` replaces the request's entry
  atomically w.r.t. the budget: the old entry's bytes are released
  before the new entry is admitted, so a mid-checkpoint fault leaves a
  mix of newer/older entries, each individually resumable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Hashable


@dataclass
class JournalEntry:
    """One request's resumable state, as of a quiescent boundary.

    ``saved_len`` is ``len(prompt) + gen_len`` — the KV pool holds
    positions ``0..saved_len-1`` and ``next_token`` is the pending
    token to feed at position ``saved_len`` (exactly the preempt/resume
    contract of rung 17). ``arrays`` are the verbatim host pages from
    ``swapout_pages`` covering the first ``ceil(saved_len/page_size)``
    pages of the slot; ``emitted`` is the count of tokens delivered to
    the client's stream at checkpoint time (the exactly-once watermark
    — regenerated tokens below it are suppressed on resume).
    """

    req: Any
    pclass: str
    ticket_no: int
    admit_seq: int
    pages_reserved: int
    saved_len: int
    gen_len: int
    next_token: int
    emitted: int
    arrays: tuple = field(repr=False)
    nbytes: int = 0
    # Prefix refcounting (rung 24): a request whose table starts on
    # cached-prefix pages journals a REFERENCE to the shared bytes —
    # ``prefix_node`` is the trie node id whose shadow snapshot holds
    # the first ``prefix_pages_n`` pages (``prefix_tokens`` prompt
    # tokens), and ``arrays``/``nbytes`` then cover only the request's
    # OWN pages. None = self-contained full-bytes entry (the pre-rung
    # format; also the fallback when the shadow would blow the budget).
    prefix_node: int | None = None
    prefix_pages_n: int = 0
    prefix_tokens: int = 0


class RequestJournal:
    """request -> JournalEntry map with a byte budget. The key is any
    hashable request identity (the serving layer uses its ``_Request``
    object itself — request IDs can be absent or duplicated, the live
    object cannot). Caller holds the lock."""

    def __init__(self, max_bytes: int = 0):
        if max_bytes < 0:
            raise ValueError("max_bytes must be >= 0")
        self.max_bytes = int(max_bytes)
        self._entries: dict[Hashable, JournalEntry] = {}
        self._nbytes = 0
        self._extra = 0
        # Entry-drop observer (rung 24): called for each entry that
        # leaves the journal via replacement (``put`` over an old
        # entry) or ``pop`` — NOT via ``take_all``, whose caller takes
        # ownership of the drained entries and settles their prefix
        # references itself after restore. The serving layer hangs its
        # shadow-store refcount decrement here so a dropped reference
        # can release the shared bytes it billed.
        self.on_drop = None

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    @property
    def nbytes(self) -> int:
        return self._nbytes + self._extra

    @property
    def extra_bytes(self) -> int:
        return self._extra

    def adjust_extra(self, delta: int) -> None:
        """Bill (or release, negative) out-of-entry bytes against the
        budget — the shared prefix shadow snapshots, which back many
        entries but must count ONCE. The caller adjusts at shadow
        create/drop; ``put`` prices new entries against the total."""
        self._extra += int(delta)
        if self._extra < 0:
            raise ValueError("journal extra bytes went negative")

    def get(self, key: Hashable) -> JournalEntry | None:
        return self._entries.get(key)

    def put(self, key: Hashable, entry: JournalEntry,
            extra: int = 0) -> bool:
        """Replace ``key``'s entry. False (and no change) on budget.
        ``extra`` prices shadow bytes this entry would NEWLY pin (0
        when the shadow already exists); on success the caller then
        bills them via :meth:`adjust_extra`."""
        old = self._entries.get(key)
        freed = old.nbytes if old is not None else 0
        if self.max_bytes and (self._nbytes + self._extra - freed
                               + entry.nbytes + extra > self.max_bytes):
            return False
        self._nbytes += entry.nbytes - freed
        self._entries[key] = entry
        if old is not None and self.on_drop is not None:
            self.on_drop(old)
        return True

    def pop(self, key: Hashable) -> JournalEntry | None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._nbytes -= entry.nbytes
            if self.on_drop is not None:
                self.on_drop(entry)
        return entry

    def take_all(self) -> list[JournalEntry]:
        """Drain every entry, oldest ticket first (admission order).
        Ownership transfers: ``on_drop`` does NOT fire — the caller
        settles each entry's prefix references after restoring it."""
        entries = sorted(self._entries.values(),
                         key=lambda e: (e.admit_seq, e.ticket_no))
        self._entries.clear()
        self._nbytes = 0
        return entries

    def clear(self) -> None:
        self._entries.clear()
        self._nbytes = 0
