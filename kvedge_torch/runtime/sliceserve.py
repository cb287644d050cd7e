"""Serving across processes: the paged scheduler over a world of ranks.

The counterpart of the JAX package's ``runtime/sliceserve.py``, with its
design: the control plane is NOT distributed. Admission, slot
assignment, block tables, reservations, the prefix trie and the
scheduler stay host state on the leader (rank 0), exactly as on one
host. A :class:`SlicePagedKVCache` on the leader broadcasts each device
call (table sync, prefill chunk, decode step, window, spec window, swap,
page copy) as a fixed-shape ``[op, a, b, c]`` header plus its inputs;
then every rank runs the SAME device function on its own shard of the
model, and the ``model``-axis collectives (``parallel/sharding.py``)
span the ranks. Followers run :func:`follow_paged`: a loop that
receives the ops and replays them in order, holding no host state.

Why this is sound, as in the reference: every cache-state mutation of
the serving layer serializes on the server lock, so the leader's
broadcasts form ONE totally ordered op stream and the followers replay
it in that order; the device inputs (tables, lengths, tokens, masks,
sampler keys) arrive by value, so a follower's device state evolves as
the leader's does. A lost follower is bounded: every leader op runs
through a :class:`~kvedge_torch.runtime.failures.DeadlineRunner`, a
wedged op is orphaned on the op thread and surfaces as a typed
:class:`~kvedge_torch.runtime.failures.SliceFollowerLost`, the stream
latches dead and the server degrades; the recovery supervisor
(``runtime/recovery.py``) then calls :meth:`SlicePagedKVCache.reform`,
a fresh op stream and a deadline-bounded barrier SYNC that a rejoined
follower replays as its first op. Only when reformation keeps failing
does the StatefulSet reschedule the slice.

What is the port's:

* **Two planes.** The op stream rides a gloo group over the world made
  for it (``dist.new_group(backend="gloo")``): CPU tensors, the ``[4]``
  int64 header and then one packed byte buffer of the payload arrays,
  whose shapes follow from the header. It is separate from the device
  group, so a header never touches the card and never enters a CUDA
  graph. The device collectives (NCCL on the card, gloo on the CPU) run
  inside the replayed ops, in stream order, on every rank.
* **The sharding is written out.** Where XLA shards the reference's
  pools by ``out_shardings``, the port's cache holds this rank's
  ``K/tp`` K/V heads (``models/kvcache.PagedKVCache(mesh=)``) and the
  params are the rank's slices; a ``model`` axis that does not divide
  the heads is refused (``parallel/sharding.check_shardable``) where
  the reference replicates the pool.
* **B1 stays on.** The reference pins the slice to the gather path
  because a Pallas kernel has no partitioning rule; a per-rank CUDA
  kernel has no such limit, so the slice keeps
  ``kvcache._use_paged_kernel``'s resolution: B1 on the card's local
  heads, the gather math on the CPU.
* **Windows are always dispatches.** The port's windows are capped
  dispatches (``PagedKVCache.dispatch_window``; ``step_window`` is a
  dispatch and its harvest), so its leader sends every window as
  ``OP_WINDOWP`` / ``OP_WSAMPLEP`` (the sampled one carries its key
  data by value, as ``OP_WSAMPLE`` does); codes 4 (``OP_WINDOW``) and 6
  (``OP_WSAMPLE``) keep their numbers and are never sent.
* **OP_SYNC carries the spec mask.** A sync while spec windows are in
  flight keeps those slots' device lengths (``PagedKVCache._sync``); the
  mask rides the payload, so a follower needs no host state for it.
* **Swaps gather heads and layers.** A swap-out all-gathers each page's
  heads over the ``model`` group and then its layers over the ``stage``
  group, as stored (no dtype change); a swap-in carries every head of
  every layer and each rank scatters its own; a COW copies each rank's
  own shard. An ``expert`` rank holds the whole pool, as a data replica.
* **Stages and experts.** Under a ``stage`` axis a rank's pools hold its
  own ``L/S`` layers (the reference replicates them over ``stage``), and
  every device op runs the stages in turn, the hand-offs and the last
  stage's logits broadcast inside the op (``models/kvcache.py``); under
  an ``expert`` axis the MoE blocks sum each choice over the group. The
  op stream and its wire are unchanged: every rank runs the same ops.
* **Results are settled inside the op.** A prefill chunk's or a step's
  logits are waited for on the op thread, and the window harvests run
  there too, so a read that would block on a lost rank's collective is
  deadline-bounded like every other op.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kvedge_torch.models.kvcache import (
    PagedCacheError,
    PagedKVCache,
    _host_ids,
)
from kvedge_torch.parallel.mesh import NO_MESH
from kvedge_torch.runtime.failures import (
    DeadlineRunner,
    DeviceOpTimeout,
    OpBudgets,
    SliceFollowerLost,
)

# Op codes (header[0]); the numbering is wire protocol and keeps the
# reference's values. STOP ends the follower loop. WINDOWP / WSAMPLEP are
# the pipelined window pair: dispatched WITHOUT reading the result, and
# followers never read a window's tokens at all.
(OP_STOP, OP_SYNC, OP_PREFILL, OP_STEP, OP_WINDOW, OP_SPEC,
 OP_WSAMPLE, OP_WINDOWP, OP_WSAMPLEP, OP_SWAPOUT, OP_SWAPIN,
 OP_SPECW, OP_SPECWS, OP_MULTI, OP_COWP) = range(15)
_HEADER_LEN = 4  # [op, a, b, c]: meanings per op below.

# Names for the op spans and the per-kind broadcast bill.
_OP_NAMES = {
    OP_STOP: "stop", OP_SYNC: "sync", OP_PREFILL: "prefill",
    OP_STEP: "step", OP_WINDOW: "window", OP_SPEC: "spec",
    OP_WSAMPLE: "wsample", OP_WINDOWP: "windowp",
    OP_WSAMPLEP: "wsamplep", OP_SWAPOUT: "swapout",
    OP_SWAPIN: "swapin", OP_SPECW: "specw", OP_SPECWS: "specws",
    OP_MULTI: "multi", OP_COWP: "cowp",
}

# Ops whose payloads may ride a coalesced OP_MULTI frame: the deferred
# table sync, swap-in and page copy that precede a dispatch, and the
# pipelined dispatches themselves. Each has payload shapes derivable from
# its own header, which lets a follower carve a packed frame.
_COALESCABLE = frozenset((
    OP_SYNC, OP_SWAPIN, OP_WINDOWP, OP_WSAMPLEP, OP_SPECW, OP_SPECWS,
    OP_COWP,
))

# The wire carries each pool dtype as raw bytes of this numpy dtype
# (numpy has no bfloat16: its bits travel as int16).
_WIRE = {torch.bfloat16: np.int16, torch.float32: np.float32,
         torch.int8: np.int8}


def _to_wire(t) -> np.ndarray:
    """A host tensor (or array) as a numpy array of its raw bytes."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_wire(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.view(dtype) if dtype == torch.bfloat16 else t


class ControlPlane:
    """The op stream's transport: a gloo group over the joined world,
    made at construction (a collective creation: every rank constructs
    its planes at the same points, in the same order), or no group
    without a world, where a broadcast is a copy. Rank 0 is the
    source."""

    def __init__(self):
        import torch.distributed as dist

        from kvedge_torch.parallel.distributed import rank

        self.group = (dist.new_group(backend="gloo")
                      if dist.is_initialized() else None)
        self.is_leader = rank() == 0

    def bcast(self, tree):
        """Broadcast a numpy array, or a tuple of them, from the leader;
        a follower passes zero templates of the same shapes and dtypes
        and gets the leader's values. One gloo broadcast of the packed
        bytes; returns fresh arrays of the same structure."""
        import torch.distributed as dist

        single = not isinstance(tree, tuple)
        arrays = tuple(np.ascontiguousarray(a)
                       for a in ((tree,) if single else tree))
        total = sum(a.nbytes for a in arrays)
        if self.group is None or total == 0:
            out = tuple(a.copy() for a in arrays)
        else:
            buf = torch.empty((total,), dtype=torch.uint8)
            if self.is_leader:
                buf.numpy()[:] = np.frombuffer(
                    b"".join(a.tobytes() for a in arrays), np.uint8)
            dist.broadcast(buf, src=0, group=self.group)
            raw, off, out = buf.numpy(), 0, []
            for a in arrays:
                out.append(raw[off:off + a.nbytes].view(a.dtype)
                           .reshape(a.shape).copy())
                off += a.nbytes
            out = tuple(out)
        return out[0] if single else out


class SlicePagedKVCache(PagedKVCache):
    """A :class:`PagedKVCache` whose device calls span the world.

    Constructed identically on EVERY rank, in the same order (the
    control group is a collective creation). On the leader it is handed
    to a :class:`~kvedge_torch.models.serving.PagedGenerationServer`
    (``cache=``) and behaves like any cache: the base class's host
    bookkeeping runs as it is, and only the device seams broadcast
    first. On followers :func:`follow_paged` drives :meth:`_follow_op`
    until the leader broadcasts STOP. ``mesh`` is this rank's mesh
    (:data:`NO_MESH` without a world); the bucket is pinned to
    ``slots``, since the broadcast payloads are slot-shaped.

    With no world (or a world of one rank) the broadcast degenerates to
    a copy, which is how the single-process tests hold the leader path
    to the plain cache without subprocesses.
    """

    def __init__(self, cfg, *, slots: int, pages: int, page_size: int,
                 mesh=NO_MESH, max_pages_per_seq: int | None = None,
                 kv_dtype: str = "", op_budgets: OpBudgets | None = None,
                 device=None):
        self._plane = ControlPlane()
        self._stopped = False
        # Leader-side buffer of (header, payload, exec) triples whose
        # broadcast waits for the next dispatch seam, where everything
        # pending goes out as ONE framed OP_MULTI.
        self._pending_ops: list = []
        self.coalesced_flushes = 0
        self.coalesced_ops = 0
        # Cumulative [count, ms] per op kind of the leader's broadcasts
        # (header, payload and the op's run), mutated only on the op
        # thread under the server's lock; /metrics renders it.
        self.op_broadcast_ms: dict[str, list] = {}
        # The watchdog over the op stream. reform() builds each
        # replacement runner over the SAME budgets, so an op key seen
        # before a failure keeps its steady budget after the heal.
        self._op_budgets = (op_budgets if op_budgets is not None
                            else OpBudgets())
        self._ops = DeadlineRunner(self._op_budgets,
                                   failure=SliceFollowerLost,
                                   name="kvedge-slice-ops")
        super().__init__(cfg, slots=slots, pages=pages, page_size=page_size,
                         max_pages_per_seq=max_pages_per_seq,
                         kv_dtype=kv_dtype, min_bucket=0, device=device,
                         mesh=mesh)

    # ---- refused host I/O ------------------------------------------------

    def snapshot_pages(self, ids):
        """Prefix-cache persistence is single-host only: a leader-only
        device read would be a collective the followers never join."""
        raise PagedCacheError(
            "prefix-cache persistence is not supported on a slice cache")

    def read_pages(self, ids):
        raise PagedCacheError(
            "prefix-cache persistence is not supported on a slice cache")

    def write_pages(self, ids, k_vals, v_vals):
        raise PagedCacheError(
            "prefix-cache persistence is not supported on a slice cache")

    # ---- the control plane -----------------------------------------------

    def _bcast(self, tree):
        """The control plane's broadcast (:meth:`ControlPlane.bcast`);
        the one transport seam a test or a fault injector replaces."""
        return self._plane.bcast(tree)

    def _send_header(self, op: int, a: int = 0, b: int = 0, c: int = 0):
        self._bcast(np.array([op, a, b, c], np.int64))

    def _queue_op(self, hdr: tuple, payload: tuple, exec_thunk) -> None:
        """Buffer one coalescable op. The payload arrays are snapshots:
        the broadcast waits for the next flush, and the serving layer
        keeps mutating the host tables in between."""
        self._pending_ops.append((
            np.array(hdr, np.int64),
            tuple(np.ascontiguousarray(a) for a in payload),
            exec_thunk,
        ))

    def _flush_ops(self, key: tuple | None = None,
                   budget_s: float | None = None):
        """Broadcast and run everything pending, in queue order. One op
        goes out as its own header and payload; two or more pack into
        one OP_MULTI frame (a = op count, b = frame bytes: each op's
        header followed by its arrays' bytes), carved by the follower
        from the embedded headers (:meth:`_multi_templates`). The ops
        run after the frame's broadcast, in order, so every rank sees
        the same collective order. Returns the LAST op's result."""
        if not self._pending_ops:
            return None
        ops, self._pending_ops = self._pending_ops, []
        if key is None:
            key = ("multi", len(ops))
        if len(ops) == 1:
            hdr, payload, exec_thunk = ops[0]

            def op():
                self._bcast(hdr)
                self._bcast(payload)
                return exec_thunk()

            return self._traced_run(key, op, budget_s=budget_s)
        frame = np.frombuffer(
            b"".join(hdr.tobytes() + b"".join(a.tobytes() for a in payload)
                     for hdr, payload, _ in ops), np.uint8)

        def op():
            self._send_header(OP_MULTI, len(ops), frame.shape[0])
            self._bcast(frame)
            out = None
            for _, _, exec_thunk in ops:
                out = exec_thunk()
            return out

        self.coalesced_flushes += 1
        self.coalesced_ops += len(ops)
        return self._traced_run(key, op, budget_s=budget_s)

    def _discard_pending_ops(self) -> None:
        """Drop buffered ops unbroadcast (stop, reform): the followers
        are released, or rejoin at a barrier SYNC that re-syncs the
        tables anyway."""
        self._pending_ops.clear()

    def _multi_templates(self, op: int, a: int, b: int, c: int) -> tuple:
        """``(shape, dtype)`` of each payload array of a coalescable op,
        a pure function of its header: the one shape table for bare
        broadcasts and OP_MULTI carving alike."""
        n = self.slots
        if op == OP_SYNC:
            return (((n, self.max_pages_per_seq), np.int32),
                    ((n,), np.int32), ((n,), bool))
        if op == OP_SWAPIN:
            return self._swap_templates(a)
        if op == OP_COWP:
            # a = src, b = dst, carried again as the [2] payload.
            return (((2,), np.int32),)
        if op == OP_WINDOWP:
            # a = n_steps, b = carry flag.
            return (((n,), np.int32), ((n,), bool), ((n,), np.int32),
                    ((n,), np.int32))
        if op == OP_WSAMPLEP:
            # a = n_steps, b = key-data width, c = carry flag.
            return (((n,), np.int32), ((n,), bool), ((n, b), np.uint32),
                    ((n,), np.int32), ((n,), np.float32),
                    ((n,), np.float32), ((n,), bool), ((n,), np.int32),
                    ((n,), np.int32))
        if op == OP_SPECW:
            # a = n_passes, b = k_len, c = ctx width (0 = carry).
            width = c if c > 0 else 1
            return (((n,), np.int32), ((n,), bool), ((n,), np.int32),
                    ((n, width), np.int32), ((n,), np.int32))
        if op == OP_SPECWS:
            # a = n_passes, b = k_len * 256 + key-data width, c = ctx
            # width (0 = carry).
            kw = b % 256
            width = c if c > 0 else 1
            return (((n,), np.int32), ((n,), bool), ((n,), np.int32),
                    ((n, width), np.int32), ((n,), np.int32),
                    ((n, kw), np.uint32), ((n,), np.int32),
                    ((n,), np.float32), ((n,), np.float32), ((n,), bool))
        raise PagedCacheError(f"op {op} is not coalescable")

    def _swap_templates(self, n: int) -> tuple:
        """``(shape, dtype)`` of an OP_SWAPIN payload of ``n`` pages: the
        ids, then every head of every layer of the pages as stored
        (``[L, n, page, K, Dh]`` K and V, plus the fp32 ``[L, n, page,
        K]`` scales of an int8 pool), on the wire."""
        st = self.state
        tp, stages = self.mesh.size("model"), self.mesh.size("stage")
        shape = (st.pool_k_full.shape[0] * stages, n, self.page_size,
                 st.pool_k_full.shape[3] * tp, st.pool_k_full.shape[4])
        wire = _WIRE[st.pool_k_full.dtype]
        out = [((n,), np.int32), (shape, wire), (shape, wire)]
        if self.kv_quantized:
            out += [(shape[:-1], np.float32), (shape[:-1], np.float32)]
        return tuple(out)

    def _replay_packed(self, params, op: int, a: int, b: int, c: int,
                       payload: list) -> None:
        """Follower: replay one coalescable op through the same exec
        seams the leader's thunks use."""
        zeros = np.zeros((self.slots,), np.int32)
        if op == OP_SYNC:
            self._apply_sync(*payload)
        elif op == OP_SWAPIN:
            self._exec_swapin(payload[0], tuple(payload[1:]))
        elif op == OP_COWP:
            self._exec_cow(payload[0])
        elif op == OP_WINDOWP:
            self._exec_window(params, *payload, None, n_steps=a,
                              carry=bool(b))
        elif op == OP_WSAMPLEP:
            tokens, mask, *sampling, caps, stops = payload
            self._exec_window(params, tokens, mask, caps, stops, sampling,
                              n_steps=a, carry=bool(c))
        elif op in (OP_SPECW, OP_SPECWS):
            k_len = b if op == OP_SPECW else b // 256
            self._exec_spec_window(params, payload, zeros, n_passes=a,
                                   k_len=k_len, carry=c == 0)
        else:  # pragma: no cover - _multi_templates already refused
            raise PagedCacheError(f"op {op} is not coalescable")

    # ---- leader-side device seams ----------------------------------------

    def _traced_run(self, key: tuple, op, budget_s: float | None = None):
        """One leader op through the deadline runner, billed to its kind
        in ``op_broadcast_ms`` and stamped as a span (cat "slice") when
        the serving layer shared a tracer (``cache.tracer``)."""
        tr = getattr(self, "tracer", None)
        if tr is not None and self._ops.tracer is None:
            # Also re-shares after reform() swapped in a fresh runner.
            self._ops.tracer = tr
        t0 = time.perf_counter()
        try:
            return self._ops.run(key, op, budget_s=budget_s)
        finally:
            dt_ms = (time.perf_counter() - t0) * 1e3
            cell = self.op_broadcast_ms.setdefault(str(key[0]), [0, 0.0])
            cell[0] += 1
            cell[1] += dt_ms
            if tr is not None:
                tr.span(str(key[0]), "slice", t0,
                        args={"op": "/".join(str(k) for k in key)})

    def _check_live(self) -> None:
        if self._ops.dead is not None:
            raise SliceFollowerLost(
                f"slice op stream is dead (op {self._ops.dead} timed "
                "out: follower lost); the slice must re-form or be "
                "rescheduled", op=self._ops.dead)
        if self._stopped:
            raise PagedCacheError(
                "slice serve is stopped: the followers were released")

    @staticmethod
    def _settled(out):
        """``out`` once the device has computed it: a read of it after
        the op cannot block on another rank's collective."""
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        return out

    def _sync(self) -> None:
        if self._stopped or self._ops.dead is not None:
            # Teardown tail: a request unwinding after a hard close, or
            # after the stream died, still releases its slot; the
            # followers are gone, so the host books proceed alone.
            return
        # Deferred: it rides the next flush (at a page boundary, the
        # window dispatch a moment later) as one OP_MULTI frame. Copies:
        # the serving layer mutates the host tables before the flush.
        tables = np.array(self._host_tables, np.int32)
        lengths = np.array(self._host_lengths, np.int32)
        keep = np.asarray(self._spec_unharvested) > 0
        self._queue_op((OP_SYNC, 0, 0, 0), (tables, lengths, keep),
                       lambda: self._apply_sync(tables, lengths, keep))

    def _device_prefill_chunk(self, params, slot: int, tokens,
                              offset: int):
        self._check_live()
        self._flush_ops()
        toks = _host_ids(tokens).astype(np.int32)

        def op():
            self._send_header(OP_PREFILL, slot, offset, toks.shape[0])
            return self._exec_prefill(params, self._bcast(toks), slot,
                                      offset)

        return self._traced_run(("prefill", toks.shape[0]), op)

    def _exec_prefill(self, params, tokens: np.ndarray, slot: int,
                      offset: int):
        return self._settled(PagedKVCache._device_prefill_chunk(
            self, params, slot, tokens.astype(np.int64), offset))

    def _device_step(self, params, tokens, mask):
        self._check_live()
        self._flush_ops()
        toks = _host_ids(tokens).astype(np.int32)
        mask = np.asarray(mask, bool)

        def op():
            self._send_header(OP_STEP)
            return self._exec_step(params, *self._bcast((toks, mask)))

        return self._traced_run(("step",), op)

    def _exec_step(self, params, tokens: np.ndarray, mask: np.ndarray):
        return self._settled(PagedKVCache._device_step(
            self, params, tokens.astype(np.int64), mask))

    def _device_spec(self, params, tokens, mask, spec_mask):
        self._check_live()
        self._flush_ops()
        toks = _host_ids(tokens).astype(np.int32)
        mask = np.asarray(mask, bool)
        spec_mask = np.asarray(spec_mask, bool)

        def op():
            self._send_header(OP_SPEC, toks.shape[1] - 1)
            return self._exec_spec(
                params, *self._bcast((toks, mask, spec_mask)))

        return self._traced_run(("spec", toks.shape[1]), op)

    def _exec_spec(self, params, tokens, mask, spec_mask):
        # The base seam reads emitted and accepted back: settled.
        return PagedKVCache._device_spec(self, params,
                                         tokens.astype(np.int64), mask,
                                         spec_mask)

    def _device_window_dispatch(self, params, tokens, n_steps: int, active,
                                caps, stop_tokens, sampling):
        """Leader: broadcast and enqueue a capped window WITHOUT reading
        its result. ``tokens=None`` is the device carry (header flag),
        which every rank holds from its own previous window; a zero
        placeholder keeps the payload's shape. A buffered table sync
        rides the same frame."""
        self._check_live()
        carry = int(tokens is None)
        toks = (np.zeros((self.slots,), np.int32) if carry
                else _host_ids(tokens).astype(np.int32))
        mask = np.asarray(active, bool)
        caps = np.asarray(caps, np.int32)
        stops = np.asarray(stop_tokens, np.int32)
        if sampling is None:
            hdr = (OP_WINDOWP, n_steps, carry, 0)
            payload = (toks, mask, caps, stops)
            rows = None
        else:
            rows = (np.asarray(sampling["key_data"]).astype(np.uint32),
                    np.asarray(sampling["base_steps"], np.int32),
                    np.asarray(sampling["temps"], np.float32),
                    np.asarray(sampling["top_ps"], np.float32),
                    np.asarray(sampling["sampled_mask"], bool))
            hdr = (OP_WSAMPLEP, n_steps, rows[0].shape[1], carry)
            payload = (toks, mask, *rows, caps, stops)
        self._queue_op(hdr, payload, lambda: self._exec_window(
            params, toks, mask, caps, stops, rows, n_steps=n_steps,
            carry=bool(carry)))
        return self._flush_ops((_OP_NAMES[hdr[0]], n_steps))

    def _exec_window(self, params, tokens, mask, caps, stops, sampling, *,
                     n_steps: int, carry: bool):
        if sampling is not None:
            key_data, base_steps, temps, top_ps, smask = sampling
            sampling = {
                "key_data": np.asarray(key_data, np.uint32).astype(np.int64),
                "base_steps": np.asarray(base_steps, np.int64),
                "temps": np.asarray(temps, np.float32),
                "top_ps": np.asarray(top_ps, np.float32),
                "sampled_mask": np.asarray(smask, bool),
            }
        return PagedKVCache._device_window_dispatch(
            self, params, None if carry else tokens.astype(np.int64),
            n_steps, np.asarray(mask, bool), caps.astype(np.int64),
            stops.astype(np.int64), sampling)

    def harvest_window(self, handle):
        """Leader: a dispatched window's block. Not a broadcast (the
        followers never read tokens), but run on the op thread under the
        op budget: the wait covers the window's collectives."""
        self._check_live()
        self._flush_ops()
        return self._traced_run(
            ("wharvest",), lambda: PagedKVCache.harvest_window(self, handle))

    def _device_spec_window(self, params, tokens, n_passes: int,
                            k_len: int, active, budgets, ctx, ctx_len,
                            sampling, caps):
        """Leader: broadcast and enqueue one spec window WITHOUT reading
        its result. ``tokens=None`` rides the spec carry every rank holds;
        header ``c`` is the drafting context's width (0 = carry).
        ``sampling`` makes it OP_SPECWS, whose header ``b`` packs
        ``k_len * 256 + key-data width`` and whose payload appends the
        five sampler rows."""
        self._check_live()
        carry = tokens is None
        if carry:
            toks = np.zeros((self.slots,), np.int32)
            ctx_np = np.zeros((self.slots, 1), np.int32)
            ctx_len_np = np.zeros((self.slots,), np.int32)
            width = 0
        else:
            toks = _host_ids(tokens).astype(np.int32)
            ctx_np = _host_ids(ctx).astype(np.int32)
            ctx_len_np = _host_ids(ctx_len).astype(np.int32)
            width = int(ctx_np.shape[1])
        payload = (toks, np.asarray(active, bool),
                   np.asarray(budgets, np.int32), ctx_np, ctx_len_np)
        if sampling is None:
            hdr = (OP_SPECW, n_passes, k_len, width)
        else:
            key_data, base_steps, temps, top_ps, smask = sampling
            key_data = np.asarray(key_data).astype(np.uint32)
            payload += (key_data, np.asarray(base_steps, np.int32),
                        np.asarray(temps, np.float32),
                        np.asarray(top_ps, np.float32),
                        np.asarray(smask, bool))
            hdr = (OP_SPECWS, n_passes, k_len * 256 + key_data.shape[1],
                   width)
        self._queue_op(hdr, payload, lambda: self._exec_spec_window(
            params, payload, caps, n_passes=n_passes, k_len=k_len,
            carry=carry))
        return self._flush_ops((_OP_NAMES[hdr[0]], n_passes, k_len))

    def _exec_spec_window(self, params, payload, caps, *, n_passes: int,
                          k_len: int, carry: bool):
        tokens, mask, budgets, ctx, ctx_len, *sampling = payload
        return PagedKVCache._device_spec_window(
            self, params, None if carry else tokens, n_passes, k_len,
            np.asarray(mask, bool), np.asarray(budgets, np.int64),
            ctx, ctx_len, tuple(sampling) if sampling else None, caps)

    def harvest_spec_window(self, handle):
        """Leader: a spec window's outputs, on the op thread under the op
        budget, like :meth:`harvest_window`."""
        self._check_live()
        self._flush_ops()
        return self._traced_run(
            ("specwharvest",),
            lambda: PagedKVCache.harvest_spec_window(self, handle))

    def wait_device(self) -> None:
        """Leader: the device's queued work, waited for on the op thread
        (it may hold collectives a lost rank never joins)."""
        self._check_live()
        self._flush_ops()
        self._traced_run(("wait-device",),
                         lambda: PagedKVCache.wait_device(self),
                         budget_s=self._ops.steady_s)

    # ---- swaps and page copies -------------------------------------------

    def swapout_pages(self, ids):
        """Leader: broadcast the page ids; every rank gathers its heads
        of the pages and all-gathers them over ``model``, then the
        layers over ``stage``, so the leader holds every head of every
        layer as stored, on the host."""
        self._check_live()
        self._flush_ops()
        ids_np = np.asarray(ids, np.int32)

        def op():
            self._send_header(OP_SWAPOUT, ids_np.shape[0])
            return self._exec_swapout(self._bcast(ids_np))

        return self._traced_run(("swapout", ids_np.shape[0]), op)

    def _exec_swapout(self, ids: np.ndarray) -> tuple:
        import torch.distributed as dist

        snap = PagedKVCache.snapshot_pages(self, ids)
        for axis, dim in (("model", 3), ("stage", 0)):
            group, n = self.mesh.group(axis), self.mesh.size(axis)
            if group is None or n == 1:
                continue
            full = []
            for t in snap:
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t.contiguous(), group=group)
                full.append(torch.cat(parts, dim=dim))
            snap = tuple(full)
        return self._host_copy(snap)

    def swapin_pages(self, ids, arrays) -> None:
        """Leader: queue the ids and the snapshot's bytes (every head of
        every layer); each rank writes its own heads of its own layers
        back. Deferred: it rides the frame of the dispatch that needs
        the pages."""
        self._check_live()
        want = 4 if self.kv_quantized else 2
        if len(arrays) != want:
            raise PagedCacheError(
                f"swap snapshot carries {len(arrays)} arrays; this pool "
                f"needs {want} (kv_dtype mismatch between swap-out and "
                "swap-in?)")
        for src, dst in zip(arrays, self._slabs()):
            if isinstance(src, torch.Tensor) and src.dtype != dst.dtype:
                raise PagedCacheError(
                    f"swap snapshot holds {src.dtype}, the pool {dst.dtype}")
        ids_np = np.asarray(ids, np.int32)
        arrs = tuple(_to_wire(a) for a in arrays)
        self._queue_op((OP_SWAPIN, ids_np.shape[0], 0, 0), (ids_np,) + arrs,
                       lambda: self._exec_swapin(ids_np, arrs))

    def _exec_swapin(self, ids: np.ndarray, arrays: tuple) -> None:
        local = []
        for arr, slab in zip(arrays, self._slabs()):
            t = _from_wire(arr, slab.dtype)
            for axis, dim in (("model", 3), ("stage", 0)):
                width = t.shape[dim] // self.mesh.size(axis)
                t = t.narrow(dim, self.mesh.index(axis) * width, width)
            local.append(t.contiguous())
        PagedKVCache.swapin_pages(self, ids, tuple(local))

    def _device_cow(self, src: int, dst: int) -> None:
        """Leader: queue the (src, dst) pair; every rank copies its own
        shard of the page (its heads of its layers). Deferred like a
        swap-in."""
        self._check_live()
        pair = np.asarray([src, dst], np.int32)
        self._queue_op((OP_COWP, int(src), int(dst), 0), (pair,),
                       lambda: self._exec_cow(pair))

    def _exec_cow(self, pair: np.ndarray) -> None:
        PagedKVCache._device_cow(self, int(pair[0]), int(pair[1]))

    # ---- lifecycle -------------------------------------------------------

    def stop(self) -> None:
        """Leader: release the followers (end of serve). Idempotent; the
        server calls it from ``close()`` under its lock, after the decode
        loop exited. Deadline-bounded: skipped on a stream already dead,
        and a fresh wedge is swallowed after its budget (close() must
        return). After it, table syncs are local no-ops and device ops
        refuse."""
        if self._stopped:
            return
        self._stopped = True
        self._discard_pending_ops()
        if self._ops.dead is not None:
            return
        try:
            self._traced_run(("stop",), lambda: self._send_header(OP_STOP),
                             budget_s=self._ops.steady_s)
        except DeviceOpTimeout:
            pass

    def reform(self, *, budget_s: float | None = None) -> None:
        """Leader: replace a dead op stream and re-form the slice (the
        recovery supervisor's step 2).

        The dead runner's worker stays parked on the wedged op; a FRESH
        runner over the same budgets takes its place, and one
        deadline-bounded barrier SYNC flows through it: a follower that
        re-entered :func:`follow_paged` replays it as its first op, and
        its success proves every follower is back. On timeout the fresh
        runner latches dead and :class:`SliceFollowerLost` propagates,
        the state as before the call. ``budget_s`` bounds the barrier
        (None = the steady budget). Raises after :meth:`stop`: released
        followers are gone by contract."""
        if self._stopped:
            raise PagedCacheError(
                "slice serve is stopped: the followers were released, not "
                "lost; there is nothing to re-form")
        old, self._ops = self._ops, DeadlineRunner(
            self._op_budgets, failure=SliceFollowerLost,
            name="kvedge-slice-ops")
        old.shutdown()
        # Buffered ops never reached anyone, and the barrier re-syncs
        # from the host books; a carry died with the old stream.
        self._discard_pending_ops()
        self.drop_carry()
        tables = np.asarray(self._host_tables, np.int32)
        lengths = np.asarray(self._host_lengths, np.int32)
        keep = np.zeros((self.slots,), bool)

        def op():
            self._send_header(OP_SYNC)
            got = self._bcast((tables, lengths, keep))
            self._apply_sync(*got)

        self._ops.run(("reform-barrier",), op,
                      budget_s=(budget_s if budget_s is not None
                                else self._ops.steady_s))

    # ---- follower side ---------------------------------------------------

    def _follow_op(self, params) -> bool:
        """Receive and replay one op. Returns False on STOP."""
        hdr = self._bcast(np.zeros(_HEADER_LEN, np.int64))
        op, a, b, c = (int(v) for v in hdr)
        if op == OP_STOP:
            return False
        # The replay span starts once the header landed (the wait before
        # it is the leader's idle time, not this rank's work).
        tr = getattr(self, "tracer", None)
        t0 = tr.now() if tr is not None else 0.0
        if op in _COALESCABLE:
            payload = list(self._bcast(tuple(
                np.zeros(shape, dtype)
                for shape, dtype in self._multi_templates(op, a, b, c))))
            self._replay_packed(params, op, a, b, c, payload)
        elif op == OP_MULTI:
            # a = op count, b = frame bytes: carve [header | arrays]* by
            # the embedded headers, replay each in frame order.
            frame = self._bcast(np.zeros((b,), np.uint8))
            off = 0
            for _ in range(a):
                sop, sa, sb, sc = (int(v) for v in np.frombuffer(
                    frame.data, np.int64, count=_HEADER_LEN, offset=off))
                off += _HEADER_LEN * 8
                payload = []
                for shape, dtype in self._multi_templates(sop, sa, sb, sc):
                    count = int(np.prod(shape, dtype=np.int64))
                    arr = np.frombuffer(frame.data, dtype, count=count,
                                        offset=off).reshape(shape)
                    off += arr.nbytes
                    payload.append(arr)
                self._replay_packed(params, sop, sa, sb, sc, payload)
        elif op == OP_PREFILL:
            self._exec_prefill(params, self._bcast(np.zeros((c,), np.int32)),
                               a, b)
        elif op == OP_STEP:
            self._exec_step(params, *self._bcast((
                np.zeros((self.slots,), np.int32),
                np.zeros((self.slots,), bool))))
        elif op == OP_SPEC:
            self._exec_spec(params, *self._bcast((
                np.zeros((self.slots, a + 1), np.int32),
                np.zeros((self.slots,), bool),
                np.zeros((self.slots,), bool))))
        elif op == OP_SWAPOUT:
            # The gathered pages are the leader's snapshot; a follower
            # only joins the collectives.
            self._exec_swapout(self._bcast(np.zeros((a,), np.int32)))
        else:  # protocol corruption is slice-fatal
            raise PagedCacheError(f"unknown slice-serve op {op}")
        if tr is not None:
            tr.span(_OP_NAMES.get(op, str(op)), "slice-follower", t0,
                    args={"op": op})
        return True


def follow_paged(cache: SlicePagedKVCache, params) -> None:
    """Follower loop: replay the leader's op stream until STOP.

    An exception here means this follower fell out of the collective
    (the leader's watchdog types it SliceFollowerLost and degrades the
    pool). The caller (``runtime/serve.py``) re-enters this loop a
    bounded number of times: the rejoined follower's first op is the
    leader's reformation barrier SYNC, which restores its tables and
    lengths; when the rejoins are spent the pod exits and the
    StatefulSet restarts the slice."""
    while cache._follow_op(params):
        pass
