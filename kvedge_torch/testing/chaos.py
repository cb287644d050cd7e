"""Seeded multi-fault chaos campaigns for the durable serving stack.

The port's counterpart of the JAX package's ``testing/chaos.py``, over
the port's :class:`~kvedge_torch.models.serving.PagedGenerationServer`
and :class:`~kvedge_torch.testing.servingfaults.FaultyCache`.
``testing/servingfaults.py`` proves ONE fault terminates cleanly; a
campaign is the soak: it drives several ROUNDS of seeded traffic into
one long-lived server whose cache wears a fault plan, arms a fresh
seeded plan each round (so faults land mid-window, mid-spec-harvest,
mid-swap), heals every poison with ``revive()``, and checks the GLOBAL
invariants after every round:

1. **Page conservation** — the pool's books balance
   (``page_accounting``: ``free + live == pages_total``, no negative
   refcount, no page both free and live) and every page is free once
   the round's requests settle. The server's own ``debug_pages`` audit
   runs at every quiescent boundary during the round, so a transient
   leak poisons loudly instead of hiding. With the shared-prefix mix
   (``prefix_mix=True``) the check is REFCOUNT-AWARE: registry-pinned
   pages are legitimately live after settle, so conservation becomes
   ``free + |distinct pinned pages| == pages_total`` (a page shared by
   several entries counts ONCE), every pinned page's refcount must
   equal exactly the number of entries holding it, the journal's shadow
   store must be empty, and force-evicting the whole registry must
   return the pool to every-page-free.
2. **No stuck tickets** — every submission terminates (tokens or a
   typed error) within the round's deadline; the journal and the active
   set are empty once the round settles.
3. **Monotone emitted offsets** — a streamed consumer's token log only
   grows, and never beyond its ``n_new`` budget.
4. **Bit-identity vs the fault-free oracle** — every request that
   completes matches the tokens an uninterrupted greedy run produces
   (the port's ``models.decode.generate`` by default); with boundary
   checkpoints on, requests in flight when the pool poisoned complete,
   restored from the journal, rather than failing. Failures that do
   occur (a fault raising into the submit path before admission) must
   be typed.

The campaign's whole DECISION stream — server shape, prompts, consumer
mix, per-round plans (kind and ``fire_at``) — derives from
``random.Random(seed)`` exactly as the reference's does, and is
appended to ``trace``: the same seed draws the same decisions in both
packages.

**Where the port differs on purpose: when a fault fires.** The
reference's plan fires at the ``fire_at``-th seam crossing of the
round, and whether that index still falls inside the round, and on
which seam, depends on how the submitting threads interleave: three
requests decoded together cross a third of the seams they cross one
after another. The port's plan keeps the drawn kind and ``fire_at``
but weighs each crossing of the decode loop's seams (prefill chunks
excluded) by the rows in flight at it, so the count follows the
round's decode work, which the seed fixes, rather than its
interleaving; and it fires at the first crossing, once the count has
passed ``fire_at``, at which a journaled row is in flight. Both are
read at the seam, where the decode loop holds the server lock. So every
armed round fires — a ``"raise"`` poisons with journaled work to
restore, a ``"delay"`` stalls the loop — and a round whose plan never
fired is an invariant breach. The settle check reads the books under
the server lock once the loop has released every row: a streamed
consumer ends on its last token, before that release.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time

from kvedge_torch.runtime.failures import (
    PageAccountingError,
    ServingFailure,
)
from kvedge_torch.testing.faults import InvariantViolation
from kvedge_torch.testing.servingfaults import (
    FaultPlan,
    FaultyCache,
    InjectedFault,
)

__all__ = ["ChaosResult", "run_chaos_campaign"]


@dataclasses.dataclass
class ChaosResult:
    """One campaign's outcome (all invariants already enforced)."""

    seed: int
    config: dict
    rounds: int
    fired: list  # seam label per round
    completed: int
    failed: int
    revives: int
    restored_total: int
    trace: list


@dataclasses.dataclass
class _Sub:
    prompt: list
    n_new: int
    streaming: bool
    want: list
    tokens: list | None = None
    got: list = dataclasses.field(default_factory=list)
    over_emitted: bool = False
    error: Exception | None = None
    finished: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )


class _CampaignPlan(FaultPlan):
    """A round's plan: the reference's draw (``"raise"`` or ``"delay"``,
    ``fire_at`` in ``fire_window``), counted over the decode loop's
    seams by the rows in flight, fired at a crossing with a journaled
    row in flight (the module docstring). Both are read at the seam,
    under the server lock the decode loop holds there."""

    def __init__(self, seed: int, server, *, fire_window, delay_s: float):
        super().__init__(seed, kinds=("raise", "delay"),
                         fire_window=fire_window, delay_s=delay_s)
        self.server = server

    def weight(self, label: str) -> int:
        if label.startswith("prefill"):
            return 0
        return len(self.server._active)

    def may_fire(self, label: str) -> bool:
        return (not label.startswith("prefill")
                and len(self.server._journal) > 0)


def _draw_config(rng: random.Random) -> dict:
    """The campaign's server shape: checkpoints always ON (this is the
    durability soak), the rest drawn so the seeded fleet covers the
    serial loop, the overlapped pipeline, and windowed speculation."""
    spec = rng.choice([0, 0, 2])
    return {
        "checkpoint_every": rng.choice([1, 2]),
        "overlap": rng.choice(["off", "on"]),
        "window": rng.choice([1, 2, 4]),
        "speculative": spec,
        "spec_window": rng.choice([0, 2]) if spec else 0,
    }


def run_chaos_campaign(params, tcfg, seed: int, *, rounds: int = 2,
                       requests_per_round: int = 3, n_new: int = 8,
                       slots: int = 3, pages: int = 24,
                       page_size: int = 4, vocab: int | None = None,
                       prompt_len: tuple = (3, 7),
                       config: dict | None = None, oracle=None,
                       wound=None, prefix_mix: bool = False,
                       join_timeout_s: float = 180.0,
                       device=None) -> ChaosResult:
    """Run one seeded campaign against a fresh server; raise
    :class:`~kvedge_torch.testing.faults.InvariantViolation` (carrying
    the full decision trace) on any breach, else return the result.

    ``params`` are the port's weights (``models.weights
    .params_from_numpy``) on ``device`` (the card unless "cpu" is asked
    for). ``config`` pins the server shape instead of drawing it.
    ``oracle(prompt, n_new) -> tokens`` supplies the fault-free
    reference (tests memoize it across campaigns); None runs
    ``models.decode.generate`` per prompt. ``wound(round_i, server,
    cache, plan)`` runs after each round's plan is armed, to compose
    extra damage on top of the seam fault. ``prefix_mix`` turns the
    prefix cache ON and draws prompts from a small set of shared
    page-sized stems, so faults land on COW admissions, leased pages
    and journal-refcount checkpoints; the settle check then runs the
    refcount-aware conservation invariant (docstring point 1).
    ``join_timeout_s`` bounds each round.
    """
    from kvedge_torch.models.serving import (
        PagedGenerationServer,
        RequestCancelled,
        ServerBusy,
        ServerClosed,
    )
    from kvedge_torch.runtime.slo import SloObjectives

    rng = random.Random(seed)
    cfg_draw = dict(_draw_config(rng))
    if config:
        cfg_draw.update(config)
    trace = [f"[campaign] seed={seed} config={cfg_draw}"]
    allowed = (ServingFailure, ServerBusy, ServerClosed,
               RequestCancelled, InjectedFault)

    if oracle is None:
        from kvedge_torch.models.decode import generate

        def oracle(prompt, n):
            out = generate(params, [prompt], tcfg, n, device=device)
            return [int(t) for t in out[0].tolist()]

    vocab = vocab or tcfg.vocab
    # The default mix runs the prefix cache off (pinned prefix pages are
    # legitimately live across requests); ``prefix_mix`` turns it on and
    # the settle check becomes refcount-aware. The SLO engine and the
    # occupancy ring run in every campaign, so the flight bundle's
    # completeness is checked after every poison and revive.
    server = PagedGenerationServer(
        params, tcfg, slots=slots, pages=pages, page_size=page_size,
        prefix_cache=prefix_mix, debug_pages=True, slo=SloObjectives(),
        occupancy_ring=64, device=device, **cfg_draw,
    )
    FaultyCache.arm(server._cache, None)
    cache = server._cache
    stems = []
    if prefix_mix:
        # Two fixed page-multiple stems (full-block trie hits) the
        # seeded prompts share; suffixes diverge mid-page too, through
        # the COW path.
        stems = [
            [rng.randrange(1, vocab) for _ in range(page_size)],
            [rng.randrange(1, vocab) for _ in range(2 * page_size)],
        ]

    def fail(msg):
        raise InvariantViolation(f"[chaos seed={seed}] {msg}", trace)

    fired, completed, failed = [], 0, 0
    revives = restored_total = 0
    try:
        for round_i in range(rounds):
            # The reference's draws: the plan's seed, then a low fire
            # index (coalesced checkpoints cross few seams a round).
            plan = _CampaignPlan(
                rng.randrange(1 << 30), server,
                fire_window=(1, rng.randrange(3, 10)), delay_s=0.05)
            cache.plan = plan
            trace.extend(plan.trace[:1])
            if wound is not None:
                wound(round_i, server, cache, plan)
            subs = []
            for _ in range(requests_per_round):
                prompt = [rng.randrange(1, vocab)
                          for _ in range(rng.randrange(*prompt_len))]
                if prefix_mix and rng.random() < 0.75:
                    prompt = rng.choice(stems) + prompt
                subs.append(_Sub(
                    prompt=prompt, n_new=n_new,
                    streaming=rng.random() < 0.5,
                    want=oracle(prompt, n_new),
                ))
            threads = [
                threading.Thread(target=_drive, args=(server, sub),
                                 name=f"chaos-{round_i}-{i}",
                                 daemon=True)
                for i, sub in enumerate(subs)
            ]
            for i, sub in enumerate(subs):
                trace.append(
                    f"[round {round_i} submit {i}] "
                    f"len={len(sub.prompt)} "
                    f"{'stream' if sub.streaming else 'block'}"
                )
                threads[i].start()

            def heal(round_i=round_i):
                """Revive a poisoned pool; True if it healed one. A
                page-audit poison is an invariant breach, never healed:
                the books are already broken."""
                nonlocal revives, restored_total
                if server.degraded is None:
                    return False
                poison = server._poison
                if isinstance(poison, PageAccountingError):
                    fail(f"round {round_i}: page books broken — "
                         f"{poison}")
                server._thread.join(timeout=60)
                if server._thread.is_alive():
                    fail(f"round {round_i}: decode thread still "
                         "alive after poison")
                restored = server.revive()
                revives += 1
                restored_total += restored
                trace.append(f"[round {round_i}] revived, "
                             f"restored={restored}")
                return True

            # Pump the round: heal every poison until all settle.
            deadline = time.monotonic() + join_timeout_s
            while not all(s.finished.is_set() for s in subs):
                if time.monotonic() > deadline:
                    fail(f"round {round_i}: stuck ticket — a request "
                         f"never terminated within {join_timeout_s:g}s")
                if not heal():
                    time.sleep(0.01)
            for t in threads:
                t.join(timeout=10)
            # A poison that failed every request before the pump saw it
            # still needs healing: the settle checks run against a live
            # pool, and the next round submits into it.
            heal()
            fired.append(plan.fired_on)
            trace.append(f"[round {round_i}] fired_on={plan.fired_on}")
            if plan.fired_on is None:
                fail(f"round {round_i}: the armed plan never fired "
                     f"({plan.count} counted crossings, fire_at "
                     f"{plan.fire_at})")

            # Invariants 3/4 per request; 1/2 for the settled pool.
            for i, sub in enumerate(subs):
                if sub.over_emitted:
                    fail(f"round {round_i} request {i}: stream emitted "
                         f"beyond its n_new={n_new} budget")
                if sub.error is not None:
                    if not isinstance(sub.error, allowed):
                        fail(f"round {round_i} request {i} died "
                             f"UNTYPED: {type(sub.error).__name__}: "
                             f"{sub.error}")
                    failed += 1
                    trace.append(f"[round {round_i} outcome {i}] "
                                 f"{type(sub.error).__name__}")
                    continue
                if sub.tokens != sub.want:
                    fail(f"round {round_i} request {i}: tokens diverge "
                         f"from the fault-free oracle\n got "
                         f"{sub.tokens}\nwant {sub.want}")
                completed += 1
                trace.append(f"[round {round_i} outcome {i}] ok")
            _check_settled(server, cache, fail,
                           context=f"round {round_i}")
            _check_bundle(server, cache, fail,
                          context=f"round {round_i}")
        return ChaosResult(
            seed=seed, config=cfg_draw, rounds=rounds, fired=fired,
            completed=completed, failed=failed, revives=revives,
            restored_total=restored_total, trace=trace,
        )
    finally:
        cache.plan = None
        server.close()


def _drive(server, sub: _Sub) -> None:
    """One consumer. Streaming consumers keep the per-token log the
    monotone-offset invariant checks; both park across revive (no
    timeout: the campaign's pump owns the deadline)."""
    try:
        if sub.streaming:
            handle = server.submit_stream(sub.prompt, sub.n_new)
            for tok in handle:
                sub.got.append(tok)
                if len(sub.got) > sub.n_new:
                    sub.over_emitted = True
                    break
            sub.tokens = sub.prompt + sub.got
        else:
            sub.tokens = server.submit(sub.prompt, sub.n_new)
    except Exception as e:
        sub.error = e
    finally:
        sub.finished.set()


def _check_settled(server, cache, fail, *, context: str) -> None:
    """Invariants 1 + 2 once a round's requests have all terminated:
    balanced books, no journal residue, nothing still admitted. With
    the prefix cache off every page must be free; with it on the
    REFCOUNT-AWARE form applies — registry pins are the only legitimate
    holds, each counted once however many entries share it, each page's
    refcount exactly the holding-entry count, the journal's shadow store
    empty, and a full force-evict returns the pool to every-page-free
    (no leaked retains or leases)."""
    # A streamed consumer ends on its last token, before the decode loop
    # releases the row: the books are read under the lock once nothing
    # is admitted or in flight (bounded: a row that never leaves is a
    # stuck ticket).
    deadline = time.monotonic() + 10.0
    while True:
        with server._lock:
            idle = not server._active and server._inflight is None
            acct = cache.page_accounting()
        if idle or time.monotonic() > deadline:
            break
        time.sleep(0.005)
    ok = (acct["free"] + acct["live"] == acct["pages_total"]
          and not acct["free_dup"] and not acct["neg_refs"]
          and not acct["free_live"])
    if not ok:
        fail(f"{context}: page books broken after settle: {acct}")
    with server._lock:
        holds: dict = {}
        for entry in server._prefix_entry_nodes.values():
            for p in entry["pages"]:
                holds[p] = holds.get(p, 0) + 1
        leases = dict(server._lease)
        shadow_nodes = len(server._prefix_shadow)
    if leases:
        fail(f"{context}: leases leaked after settle: {leases}")
    if acct["free"] + len(holds) != acct["pages_total"]:
        fail(f"{context}: pages leaked after settle "
             f"(free={acct['free']} pinned={len(holds)} "
             f"total={acct['pages_total']})")
    for p in range(acct["pages_total"]):
        want = holds.get(p, 0)
        got = cache.page_refcount(p)
        if got != want:
            fail(f"{context}: page {p} refcount {got} != "
                 f"{want} holding entries — leaked retain")
    stats = server.stats()
    if stats.get("journal_entries"):
        fail(f"{context}: journal residue after settle: "
             f"{stats['journal_entries']} entries")
    if shadow_nodes or stats.get("journal_shadow_bytes"):
        fail(f"{context}: shadow residue after settle: "
             f"{shadow_nodes} nodes, "
             f"{stats.get('journal_shadow_bytes')} bytes")
    if stats.get("in_flight"):
        fail(f"{context}: {stats['in_flight']} requests still "
             "admitted after settle")
    # The pins themselves must release cleanly: force-evict the whole
    # registry (and the host tier) and require every page free.
    if holds:
        with server._lock:
            for node in list(server._prefix_entry_nodes):
                server._evict_prefix_node(node, "pressure")
            for node in list(server._prefix_host_nodes):
                server._drop_host_record_locked(node)
        if cache.free_pages() != acct["pages_total"]:
            fail(f"{context}: {acct['pages_total'] - cache.free_pages()}"
                 f" pages still held after force-evicting the registry")


# Every key a version-1 flight bundle carries (models/serving.py
# flight_bundle). Completeness is the invariant: a post-mortem missing
# its books or its SLO state looks authoritative and is not.
_BUNDLE_V1_KEYS = frozenset((
    "bundle_version", "reason", "degraded", "metrics", "slo",
    "occupancy_tail", "journal", "config", "config_fingerprint",
    "trace_tail", "page_accounting",
))


def _check_bundle(server, cache, fail, *, context: str) -> None:
    """Flight-bundle completeness after every round: schema-complete,
    JSON-serialisable, and its SLO state and page books agree with a
    fresh ``stats()`` and the live pool — the bundle claims to BE the
    server's final state, so any drift means its one-lock assembly
    broke."""
    bundle = server.flight_bundle()
    missing = _BUNDLE_V1_KEYS - set(bundle)
    if missing:
        fail(f"{context}: bundle incomplete — missing "
             f"{sorted(missing)}")
    if bundle["bundle_version"] != 1:
        fail(f"{context}: unknown bundle_version "
             f"{bundle['bundle_version']!r}")
    try:
        json.dumps(bundle)
    except (TypeError, ValueError) as e:
        fail(f"{context}: bundle is not JSON-serialisable: {e}")
    if not bundle["config_fingerprint"]:
        fail(f"{context}: bundle config_fingerprint is empty")
    if bundle["slo"] is None:
        fail(f"{context}: bundle has no SLO state with the engine on")
    # The server runs with an occupancy ring and settle follows at
    # least one quiescent boundary: the timeline tail is not empty.
    if not bundle["occupancy_tail"]:
        fail(f"{context}: bundle occupancy_tail is empty")
    books = bundle["page_accounting"]
    if books is None:
        fail(f"{context}: bundle page books absent (cache exposes "
             "page_accounting)")
    if books != cache.page_accounting():
        fail(f"{context}: bundle page books diverge from the live "
             f"pool: {books} vs {cache.page_accounting()}")
    # The pool is quiescent after settle, so the flat slo_* gauges
    # stats() exports must be exactly what the bundle froze.
    stats = server.stats()
    for key in stats:
        if key.startswith("slo_") and bundle["metrics"].get(key) != stats[key]:
            fail(f"{context}: bundle {key}={bundle['metrics'].get(key)!r}"
                 f" != live stats {stats[key]!r}")
