"""The runtime knobs the port reads, from the runtime TOML.

The same TOML document as the JAX package's runtime config, with the
same names and defaults, for the subset the ported payloads run:

    [runtime]  name, state_dir, checkpoint_dir, heartbeat_interval_s
    [tpu]      platform (the device check's expected platform: "gpu",
               the port's default, or "cpu"), expected_chips (0 = any);
               the section keeps the reference's name so that one TOML
               parses in both packages
    [mesh]     axes over the world: every card of every process
               (``[distributed] num_processes`` x the cards each pod
               sees); data, model, seq, stage and expert may span more
               than one device (the reference's MeshSpec rules resolve
               an axis of 0)
    [distributed]  num_processes, coordinator_address,
               coordinator_port, process_id (the reference's spec;
               parallel/distributed.py joins the world at boot)
    [model]    preset, vocab, d_model, n_heads, n_kv_heads, n_layers, d_ff,
               experts (the MoE expert count, 0 = dense), expert_top_k
               (0 = 1; 2 = GShard top-2), expert_capacity_factor (0 =
               the drop-free experts / top_k), pipeline_schedule ("" =
               "gpipe" | "1f1b"; used under a stage axis above 1)
    [payload]  kind ("devicecheck", the default, | "transformer-probe" |
               "inference-probe" | "train" | "eval" | "serve" | "none"),
               seq (the model's
               max_seq and the training sequence length), attention
               ("" = "naive" | "flash"), corpus, eval_corpus, steps,
               batch, checkpoint_every; for serving: serving ("" =
               "contiguous" | "paged"), paged_attention, serving_slots,
               serving_page_size, serving_pages, serving_hbm_budget_mb
               (the pool sized from a byte budget instead of
               serving_pages), serving_min_bucket (the device batch
               dim's smallest bucket, 0 = pinned to serving_slots),
               serving_prefill_chunk, serving_window, serving_kv_dtype,
               serving_overlap ("auto" | "on" | "off"),
               serving_speculative (a draft length 0..16 or "auto"),
               serving_spec_window (0..64), serving_spec_sampled_window
               (bool); the prefix cache: serving_prefix_cache (bool,
               default true), serving_prefix_host_mb,
               serving_prefix_persist (bool, default true: the registry
               is reloaded from <state_dir>/prefix-cache.npz at boot and
               dumped there every 30 s and at shutdown); the admission
               scheduler: serving_sched_policy ("strict" | "weighted" |
               "fifo"), serving_sched_weights ("class=weight,..."),
               serving_sched_max_queue_depth,
               serving_sched_max_queue_wait_s,
               serving_sched_swap_budget_mb, serving_page_low_watermark,
               serving_page_high_watermark; degraded mode and recovery:
               serving_retry_after_s (a poisoned pool's retry hint),
               serving_recovery_attempts (the supervisor's attempts, 0 =
               a poison is terminal), serving_checkpoint_every (journal
               in-flight requests every N boundaries, 0 = off),
               serving_debug_pages (audit the page books at every
               boundary); observability and control: serving_window
               may be "auto" (the online controller picks a power of
               two in [serving_window_min, serving_window_max] at each
               harvest), serving_trace ("off" | "on" | a sample rate in
               (0, 1]: the flight recorder behind GET /trace),
               serving_slo with serving_slo_target, serving_slo_ttft_ms,
               serving_slo_itl_ms, serving_slo_queue_ms,
               serving_slo_fast_s, serving_slo_slow_s and
               serving_slo_shed (the SLO engine behind GET /slo and its
               burn-gated shed), serving_occupancy_ring (boundary
               occupancy samples, 0 = off), serving_bundle (the flight
               bundle behind GET /debug/bundle, also written beside
               last-failure.json at a poison), serving_debug_locks
               (ownership-asserting server locks)
    [status]   port, bind, token (the bearer token POST routes require;
               "" = open)

Any other section or key is REFUSED with its name, not ignored: a knob
the port does not implement would otherwise silently change nothing
(``[model] n_experts`` among them: the key is ``experts``). Still
refused by name: the ``serve`` and ``inference-probe`` payloads over a
``seq`` axis (sequence parallelism is the training layout; serving
shards over ``data``, ``model``, ``stage`` and ``expert``).
The mesh resolves over the world's devices: at parse over
``num_processes`` x :func:`fewest_cards` (the cards a process needs at
the least; what depends on the real count waits for it), at boot over
``num_processes`` x the cards the pod sees
(:meth:`RuntimeConfig.check_world`, ``parallel/launch.py``), and in a
joined world over its size (:meth:`RuntimeConfig.device_count`).
:meth:`RuntimeConfig.model_config` derives the model from it as the
reference's ``derive_model_config`` does: a ``seq`` axis
means ring attention unless ``[payload] attention`` names Ulysses, an
``expert`` axis an MoE model with its experts split over it, and a
``stage`` axis a pipelined layer stack.
:meth:`RuntimeConfig.to_toml` writes the canonical document
and :meth:`RuntimeConfig.apply` materializes it, as
``kvedge-bootstrap apply`` does.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tomllib
from typing import Mapping

from kvedge_torch.models.config import PRESETS, TransformerConfig


class RuntimeConfigError(ValueError):
    pass


DEFAULT_CONFIG_PATH = "/etc/kvedge/config.toml"
DEFAULT_STATE_DIR = "/var/lib/kvedge/state"
_VALID_PAYLOADS = (
    "devicecheck", "transformer-probe", "inference-probe", "train", "eval",
    "serve", "none",
)
_VALID_ATTENTION = ("", "naive", "flash", "ring", "ulysses")
_RUNTIME_KEYS = {"name": "name", "state_dir": "state_dir",
                 "checkpoint_dir": "checkpoint_dir",
                 "heartbeat_interval_s": "heartbeat_interval_s"}
_TPU_KEYS = {"platform": "expected_platform",
             "expected_chips": "expected_chips"}
_MODEL_KEYS = ("preset", "vocab", "d_model", "n_heads", "n_kv_heads",
               "n_layers", "d_ff", "experts", "expert_top_k",
               "expert_capacity_factor", "pipeline_schedule")
# TOML key -> RuntimeConfig field.
_PAYLOAD_KEYS = {
    "kind": "payload",
    "serving": "payload_serving",
    "seq": "max_seq",
    "attention": "payload_attention",
    "corpus": "train_corpus",
    "eval_corpus": "eval_corpus",
    "steps": "train_steps",
    "batch": "train_batch",
    "checkpoint_every": "train_checkpoint_every",
    "paged_attention": "payload_paged_attention",
    "serving_slots": "serving_slots",
    "serving_page_size": "serving_page_size",
    "serving_pages": "serving_pages",
    "serving_hbm_budget_mb": "serving_hbm_budget_mb",
    "serving_min_bucket": "serving_min_bucket",
    "serving_prefill_chunk": "serving_prefill_chunk",
    "serving_window": "serving_window",
    "serving_kv_dtype": "serving_kv_dtype",
    "serving_overlap": "serving_overlap",
    "serving_speculative": "serving_speculative",
    "serving_spec_window": "serving_spec_window",
    "serving_spec_sampled_window": "serving_spec_sampled_window",
    "serving_prefix_cache": "serving_prefix_cache",
    "serving_prefix_host_mb": "serving_prefix_host_mb",
    "serving_prefix_persist": "serving_prefix_persist",
    "serving_sched_policy": "serving_sched_policy",
    "serving_sched_weights": "serving_sched_weights",
    "serving_sched_max_queue_depth": "serving_sched_max_queue_depth",
    "serving_sched_max_queue_wait_s": "serving_sched_max_queue_wait_s",
    "serving_sched_swap_budget_mb": "serving_sched_swap_budget_mb",
    "serving_page_low_watermark": "serving_page_low_watermark",
    "serving_page_high_watermark": "serving_page_high_watermark",
    "serving_retry_after_s": "serving_retry_after_s",
    "serving_recovery_attempts": "serving_recovery_attempts",
    "serving_checkpoint_every": "serving_checkpoint_every",
    "serving_debug_pages": "serving_debug_pages",
    "serving_window_min": "serving_window_min",
    "serving_window_max": "serving_window_max",
    "serving_trace": "serving_trace",
    "serving_debug_locks": "serving_debug_locks",
    "serving_slo": "serving_slo",
    "serving_slo_target": "serving_slo_target",
    "serving_slo_ttft_ms": "serving_slo_ttft_ms",
    "serving_slo_itl_ms": "serving_slo_itl_ms",
    "serving_slo_queue_ms": "serving_slo_queue_ms",
    "serving_slo_fast_s": "serving_slo_fast_s",
    "serving_slo_slow_s": "serving_slo_slow_s",
    "serving_slo_shed": "serving_slo_shed",
    "serving_bundle": "serving_bundle",
    "serving_occupancy_ring": "serving_occupancy_ring",
}
# Fractions and seconds: a TOML integer reads as the float, as the
# reference's float() does.
_FLOAT_FIELDS = ("heartbeat_interval_s", "expert_capacity_factor",
                 "serving_sched_max_queue_wait_s",
                 "serving_page_low_watermark", "serving_page_high_watermark",
                 "serving_retry_after_s", "serving_slo_target",
                 "serving_slo_ttft_ms", "serving_slo_itl_ms",
                 "serving_slo_queue_ms", "serving_slo_fast_s",
                 "serving_slo_slow_s")
_STATUS_KEYS = {"port": "status_port", "bind": "status_bind",
                "token": "status_token"}
_DISTRIBUTED_KEYS = ("num_processes", "coordinator_address",
                     "coordinator_port", "process_id")


def _toml_str(value: str) -> str:
    """Quote a string as a TOML basic string (JSON escaping is TOML-valid)."""
    return json.dumps(value, ensure_ascii=True)


def _toml_bool(value: bool) -> str:
    return "true" if value else "false"


# The axes the port shards over.
_MESH_AXES = ("data", "model", "seq", "stage", "expert")


class MeshConfigError(RuntimeConfigError):
    """The operator's mesh cannot run this payload (the reference's
    ``runtime/workload.py`` error of the same name)."""


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The reference's ``MeshSpec``: axis names and sizes in mesh order,
    a size of 0 inferred from the device count (at most one)."""

    axes: tuple[tuple[str, int], ...] = (("data", 0), ("model", 1))

    def validate(self) -> None:
        if not self.axes:
            raise RuntimeConfigError("[mesh] axes must be a non-empty table")
        for axis, size in self.axes:
            if not axis:
                raise RuntimeConfigError("mesh axis names must be non-empty")
            if not isinstance(size, int) or isinstance(size, bool) \
                    or size < 0:
                raise RuntimeConfigError(
                    f"mesh axis {axis!r} size must be a non-negative int")
        names = self.axis_names()
        if len(set(names)) != len(names):
            raise RuntimeConfigError(f"duplicate mesh axis names in {names}")
        if sum(1 for _, size in self.axes if size == 0) > 1:
            raise RuntimeConfigError(
                "at most one mesh axis may be 0 (inferred)")

    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    def resolved_shape(self, n_devices: int) -> tuple[int, ...]:
        """Concrete mesh shape for ``n_devices``, inferring any zero axis."""
        sizes = [size for _, size in self.axes]
        self.validate()
        zeros = [i for i, s in enumerate(sizes) if s == 0]
        fixed = 1
        for s in sizes:
            if s:
                fixed *= s
        if zeros:
            if n_devices % fixed:
                raise RuntimeConfigError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"({fixed})")
            sizes[zeros[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise RuntimeConfigError(
                f"mesh {dict(self.axes)} wants {fixed} devices, have "
                f"{n_devices}")
        return tuple(sizes)

    def axis_sizes(self, n_devices: int) -> dict[str, int]:
        return dict(zip(self.axis_names(), self.resolved_shape(n_devices)))


def fewest_cards(axes, num_processes: int) -> int:
    """The fewest cards a process over which ``axes`` resolve in a world
    of ``num_processes`` processes: the mesh's fixed product (an axis of
    0 counts as 1) over ``num_processes`` where that divides, else the
    least count that makes it divide (``fixed / gcd(fixed,
    num_processes)``). A mesh with no axis of 0 whose product the
    processes cannot share alike resolves on no count, and is refused.
    The CPU has no cards to count, so this is its count of local ranks
    (``parallel/launch.visible_cards``)."""
    fixed = math.prod(size or 1 for _, size in axes)
    if all(size for _, size in axes) and fixed % num_processes:
        raise RuntimeConfigError(
            f"mesh {dict(axes)} wants {fixed} devices, which [distributed] "
            f"num_processes = {num_processes} cannot hold as the same "
            "number of cards in every process")
    return fixed // math.gcd(fixed, num_processes)


@dataclasses.dataclass(frozen=True)
class DistributedSpec:
    """The reference's ``DistributedSpec``: the world the runtime joins at
    boot (``parallel/distributed.py``). ``num_processes == 1`` joins
    nothing; ``-1`` / ``""`` mean "infer from the pod's identity"."""

    num_processes: int = 1
    coordinator_address: str = ""  # "" = infer; "host" or "host:port"
    coordinator_port: int = 8478
    process_id: int = -1  # -1 = infer

    def validate(self) -> None:
        if self.num_processes < 1:
            raise RuntimeConfigError(
                "[distributed] num_processes must be >= 1")
        if not (0 < self.coordinator_port < 65536):
            raise RuntimeConfigError(
                "[distributed] coordinator_port out of range")
        if self.process_id < -1 or self.process_id >= self.num_processes:
            raise RuntimeConfigError(
                f"[distributed] process_id {self.process_id} not in "
                f"[-1, {self.num_processes})")


def _mesh_axes(table) -> tuple[tuple[str, int], ...]:
    """``[mesh] axes`` with the reference's checks and messages (the
    port's refusals of resolved axes are ``_validate_world``'s)."""
    if not isinstance(table, Mapping):
        raise RuntimeConfigError("[mesh] axes must be a table")
    axes = tuple((str(axis), size) for axis, size in table.items())
    MeshSpec(axes).validate()
    return axes


def _refuse_axis(axis: str, size: int) -> None:
    raise RuntimeConfigError(
        f"[mesh] axis {axis!r} = {size}: the PyTorch port shards over "
        f"{list(_MESH_AXES)} only")


def _distributed(table) -> dict:
    """``[distributed]`` with the reference's checks; returns the
    :class:`RuntimeConfig` fields it sets."""
    if not isinstance(table, Mapping):
        raise RuntimeConfigError("[distributed] must be a table")
    bad = sorted(set(table) - set(_DISTRIBUTED_KEYS))
    if bad:
        raise RuntimeConfigError(
            f"[distributed] key(s) {bad} are not supported by the "
            f"PyTorch port; it reads {sorted(_DISTRIBUTED_KEYS)}")
    spec = DistributedSpec()
    fields = {key: table.get(key, getattr(spec, key))
              for key in _DISTRIBUTED_KEYS}
    for key in ("num_processes", "coordinator_port", "process_id"):
        value = fields[key]
        if not isinstance(value, int) or isinstance(value, bool):
            raise RuntimeConfigError(
                f"[distributed] {key} must be an integer, got {value!r}")
    if not isinstance(fields["coordinator_address"], str):
        raise RuntimeConfigError(
            "[distributed] coordinator_address must be a string")
    DistributedSpec(**fields).validate()
    return fields


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Validated runtime config (the parsed form of the TOML)."""

    name: str = "kvedge-tpu"
    state_dir: str = DEFAULT_STATE_DIR
    # "" = <state_dir>/checkpoints (runtime/checkpoint.py).
    checkpoint_dir: str = ""
    # Seconds between heartbeats (runtime/heartbeat.py HeartbeatWriter).
    heartbeat_interval_s: float = 10.0
    # [tpu] platform and expected_chips: what the device check expects
    # ("gpu" on the card, "cpu" when the CPU is asked for; 0 chips =
    # whatever is visible).
    expected_platform: str = "gpu"
    expected_chips: int = 0
    # [mesh] axes as (name, size) pairs (0 = inferred from the world).
    mesh_axes: tuple = (("data", 0), ("model", 1))
    # [distributed]: the world of processes (pods), each with one rank a
    # card it sees.
    num_processes: int = 1
    coordinator_address: str = ""
    coordinator_port: int = 8478
    process_id: int = -1
    preset: str = ""  # "" = "probe"
    vocab: int = 0    # 0 = from the preset, for every shape field
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    n_layers: int = 0
    d_ff: int = 0
    # Mixture of experts: the expert count (0 = dense), experts a token
    # (0 = 1) and the training capacity factor (0.0 = drop-free,
    # experts / top_k).
    experts: int = 0
    expert_top_k: int = 0
    expert_capacity_factor: float = 0.0
    # Pipelining needs a stage axis over more than one device: "" only.
    pipeline_schedule: str = ""
    payload: str = "devicecheck"
    # "" = "contiguous": one request at a time through models/decode.py;
    # "paged" = the continuous-batching server over the page pool.
    payload_serving: str = ""
    max_seq: int = 128  # [payload] seq (the reference's train_seq default)
    payload_attention: str = ""  # "" = "naive"
    train_corpus: str = ""
    # "" = evaluate on the training corpus, with a warning.
    eval_corpus: str = ""
    train_steps: int = 100
    train_batch: int = 8
    train_checkpoint_every: int = 10
    payload_paged_attention: str = ""  # "" = "auto"
    serving_slots: int = 4
    serving_page_size: int = 16
    serving_pages: int = 0  # 0 = every slot can hold a max_seq request
    # The pool sized from a byte budget (MiB, 0 = off) instead: pages =
    # budget // the bytes one page costs. Exclusive with serving_pages.
    serving_hbm_budget_mb: int = 0
    # The device batch dim runs at a power-of-two bucket from this one
    # up, capped at serving_slots, stepping with the occupied slots at
    # quiescent boundaries (0 = pinned to serving_slots).
    serving_min_bucket: int = 0
    serving_prefill_chunk: int = 64
    # The decode window cap in steps, or "auto": the online controller
    # (runtime/autotune.py) picks the smallest power of two in
    # [serving_window_min, serving_window_max] whose device time covers
    # the host's turnaround, at every harvest. Tokens are the same.
    serving_window: int | str = 64
    serving_window_min: int = 1
    serving_window_max: int = 256
    serving_kv_dtype: str = ""
    # The paged server's double-buffered decode loop: "auto" and "on"
    # enqueue window N+1 on the device-resident carry before window N is
    # harvested; "off" keeps the serial loop. Tokens are the same.
    serving_overlap: str = "auto"
    # Server-wide speculative decoding on the paged backend: the draft
    # length K (0 = off) or "auto", which sizes the pools for K = 4 and
    # lets the boot probe (``resolve_speculation``) turn speculation off
    # when plain windows beat its best case. Greedy requests reserve K
    # slack positions; sampled ones reserve none.
    serving_speculative: int | str = 0
    # W > 0 runs W draft+verify passes as one device-resident spec
    # window (a captured CUDA graph on the card) inside the overlap
    # pipeline; 0 = one verify pass per host round trip. Needs
    # speculation.
    serving_spec_window: int = 0
    # Keep a batch with sampled co-tenants on the spec windows (sampled
    # rows advance one token a pass, drawn on the device); false sends
    # such a batch to the per-pass path, counted as a fallback.
    serving_spec_sampled_window: bool = True
    # The prefix cache: completed prompts (and finished requests'
    # generated tokens) register their page-aligned prefixes; a later
    # prompt sharing one starts on those read-only pages, copies a shared
    # partial page on write and prefills only its suffix. Evicted entries
    # go to a host tier of serving_prefix_host_mb MB (0 = dropped).
    serving_prefix_cache: bool = True
    serving_prefix_host_mb: int = 0
    # Prefix persistence across restarts (with the prefix cache on and a
    # state_dir): <state_dir>/prefix-cache.npz re-pins at boot, is
    # dumped every 30 s while entries register, and once more after
    # shutdown.
    serving_prefix_persist: bool = True
    # The admission scheduler: "strict" admits the best class first
    # (FIFO within one), "weighted" shares by serving_sched_weights,
    # "fifo" ignores classes. The queue watermarks shed at submit (0 =
    # off); a swap budget > 0 lets an interactive request preempt a batch
    # one by swapping its KV pages to host memory.
    serving_sched_policy: str = "strict"
    serving_sched_weights: str = "interactive=4,batch=1"
    serving_sched_max_queue_depth: int = 0
    serving_sched_max_queue_wait_s: float = 0.0
    serving_sched_swap_budget_mb: int = 0
    # Free-page watermarks (fractions of the pool, 0 = off): below
    # ``low`` unreserved headroom a batch arrival sheds; a swapped-out
    # request resumes only at ``high`` or better.
    serving_page_low_watermark: float = 0.0
    serving_page_high_watermark: float = 0.0
    # Seconds a client refused by a poisoned pool should wait; while the
    # recovery supervisor heals, its measured recovery time instead.
    serving_retry_after_s: float = 30.0
    # Heal attempts (warm restart, backoff between them) before a poison
    # escalates to the terminal 503; 0 = no supervisor.
    serving_recovery_attempts: int = 2
    # Journal every live request every N quiescent boundaries so a
    # poisoned pool resumes it after the heal (0 = off: a poison fails
    # the requests in flight).
    serving_checkpoint_every: int = 0
    # Audit free + live == pages_total at every quiescent boundary.
    serving_debug_pages: bool = False
    # The flight recorder (runtime/tracing.py): "off", "on" or a
    # per-request sample rate in (0, 1]; GET /trace exports it.
    serving_trace: str | float = "off"
    # Ownership-asserting server locks (runtime/debuglock.py).
    serving_debug_locks: bool = False
    # The SLO engine (runtime/slo.py, GET /slo): a compliance target,
    # p99 objectives in ms, the fast and slow burn windows, and the
    # burn-gated shed of non-top classes while the alert fires.
    serving_slo: bool = False
    serving_slo_target: float = 0.99
    serving_slo_ttft_ms: float = 1000.0
    serving_slo_itl_ms: float = 250.0
    serving_slo_queue_ms: float = 1000.0
    serving_slo_fast_s: float = 60.0
    serving_slo_slow_s: float = 600.0
    serving_slo_shed: bool = False
    # The flight bundle (GET /debug/bundle, and flight-bundle.json
    # beside last-failure.json at a poison).
    serving_bundle: bool = False
    # Occupancy samples kept at quiescent boundaries (0 = off).
    serving_occupancy_ring: int = 0
    status_port: int = 8476
    status_bind: str = "0.0.0.0"
    # Bearer token every POST route requires ("" = open).
    status_token: str = ""

    @classmethod
    def parse(cls, text: str) -> "RuntimeConfig":
        try:
            doc = tomllib.loads(text)
        except tomllib.TOMLDecodeError as e:
            raise RuntimeConfigError(f"invalid TOML: {e}") from e
        return cls.from_mapping(doc)

    @classmethod
    def from_mapping(cls, doc: Mapping) -> "RuntimeConfig":
        unknown = sorted(set(doc) - {"runtime", "tpu", "mesh", "model",
                                     "distributed", "payload", "status"})
        if unknown:
            raise RuntimeConfigError(
                f"section(s) {unknown} are not read by the PyTorch port "
                "(it reads [runtime], [tpu], [mesh], [model], "
                "[distributed], [payload] and [status] only)"
            )
        fields: dict = {}
        mesh = doc.get("mesh", {})
        if not isinstance(mesh, Mapping):
            raise RuntimeConfigError("[mesh] must be a table")
        bad = sorted(set(mesh) - {"axes"})
        if bad:
            raise RuntimeConfigError(
                f"[mesh] key(s) {bad} are not supported by the PyTorch "
                "port; it reads ['axes']")
        if "axes" in mesh:
            fields["mesh_axes"] = _mesh_axes(mesh["axes"])
        if "distributed" in doc:
            fields.update(_distributed(doc["distributed"]))
        for section, known in (("runtime", _RUNTIME_KEYS),
                               ("tpu", _TPU_KEYS),
                               ("model", {k: k for k in _MODEL_KEYS}),
                               ("payload", _PAYLOAD_KEYS),
                               ("status", _STATUS_KEYS)):
            table = doc.get(section, {})
            if not isinstance(table, Mapping):
                raise RuntimeConfigError(f"[{section}] must be a table")
            bad = sorted(set(table) - set(known))
            if bad:
                raise RuntimeConfigError(
                    f"[{section}] key(s) {bad} are not supported by the "
                    f"PyTorch port; it reads {sorted(known)}"
                )
            for key, value in table.items():
                if (known[key] in _FLOAT_FIELDS and isinstance(value, int)
                        and not isinstance(value, bool)):
                    value = float(value)
                fields[known[key]] = value
        cfg = cls(**fields)
        cfg.validate()
        return cfg

    def sched_weights_dict(self) -> dict[str, float]:
        """``serving_sched_weights`` ("class=weight,...") as a dict;
        ValueError on a malformed entry or a weight <= 0."""
        out: dict[str, float] = {}
        for part in self.serving_sched_weights.split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, val = part.partition("=")
            name = name.strip()
            if not sep or not name:
                raise ValueError(f"expected 'class=weight', got {part!r}")
            weight = float(val.strip())
            if weight <= 0:
                raise ValueError(
                    f"weight for {name!r} must be > 0, got {weight}")
            out[name] = weight
        return out

    def validate(self) -> None:
        if not isinstance(self.name, str) or not self.name:
            raise RuntimeConfigError("[runtime] name must be non-empty")
        if (not isinstance(self.heartbeat_interval_s, (int, float))
                or isinstance(self.heartbeat_interval_s, bool)
                or self.heartbeat_interval_s <= 0):
            raise RuntimeConfigError(
                "[runtime] heartbeat_interval_s must be > 0")
        if not isinstance(self.expected_platform, str):
            raise RuntimeConfigError("[tpu] platform must be a string")
        if (not isinstance(self.expected_chips, int)
                or isinstance(self.expected_chips, bool)
                or self.expected_chips < 0):
            raise RuntimeConfigError("[tpu] expected_chips must be >= 0")
        _mesh_axes(dict(self.mesh_axes))
        _distributed({k: getattr(self, k) for k in _DISTRIBUTED_KEYS})
        self._validate_world()
        if self.pipeline_schedule not in ("", "gpipe", "1f1b"):
            raise RuntimeConfigError(
                "[model] pipeline_schedule must be 'gpipe' or '1f1b' "
                "('' = gpipe)")
        for name in ("serving_prefix_host_mb",
                     "serving_sched_max_queue_depth",
                     "serving_sched_swap_budget_mb",
                     "serving_recovery_attempts",
                     "serving_checkpoint_every"):
            value = getattr(self, name)
            if not isinstance(value, int) or isinstance(value, bool):
                raise RuntimeConfigError(
                    f"[payload] {name} must be an integer, got {value!r}")
        for name in ("serving_sched_max_queue_wait_s",
                     "serving_page_low_watermark",
                     "serving_page_high_watermark",
                     "serving_retry_after_s"):
            value = getattr(self, name)
            if not isinstance(value, (int, float)) or isinstance(value,
                                                                 bool):
                raise RuntimeConfigError(
                    f"[payload] {name} must be a number, got {value!r}")
        for name in ("serving_sched_policy", "serving_sched_weights"):
            if not isinstance(getattr(self, name), str):
                raise RuntimeConfigError(
                    f"[payload] {name} must be a string, got "
                    f"{getattr(self, name)!r}")
        for name in ("serving_page_low_watermark",
                     "serving_page_high_watermark"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise RuntimeConfigError(
                    f"[payload] {name} must be a fraction in [0, 1) "
                    "(0 = off)")
        if (self.serving_page_low_watermark
                and self.serving_page_high_watermark
                and self.serving_page_low_watermark
                > self.serving_page_high_watermark):
            raise RuntimeConfigError(
                "[payload] serving_page_low_watermark must be <= "
                "serving_page_high_watermark")
        if not isinstance(self.serving_prefix_cache, bool):
            raise RuntimeConfigError(
                "[payload] serving_prefix_cache must be a boolean")
        if not isinstance(self.serving_prefix_persist, bool):
            raise RuntimeConfigError(
                "[payload] serving_prefix_persist must be a boolean")
        if self.serving_retry_after_s <= 0:
            raise RuntimeConfigError(
                "[payload] serving_retry_after_s must be > 0 "
                "(seconds a refused client should wait before retrying)")
        if self.serving_recovery_attempts < 0:
            raise RuntimeConfigError(
                "[payload] serving_recovery_attempts must be >= 0 "
                "(0 = no in-process recovery; degrade is terminal)")
        if self.serving_checkpoint_every < 0:
            raise RuntimeConfigError(
                "[payload] serving_checkpoint_every must be >= 0 "
                "(0 = off: no in-flight checkpointing)")
        if not isinstance(self.serving_debug_pages, bool):
            raise RuntimeConfigError(
                "[payload] serving_debug_pages must be a boolean")
        if self.serving_prefix_host_mb < 0:
            raise RuntimeConfigError(
                "[payload] serving_prefix_host_mb must be >= 0 "
                "(0 disables the host residency tier)")
        if self.serving_sched_policy not in ("fifo", "strict", "weighted"):
            raise RuntimeConfigError(
                "[payload] serving_sched_policy must be 'fifo', "
                "'strict' or 'weighted'")
        try:
            self.sched_weights_dict()
        except ValueError as e:
            raise RuntimeConfigError(
                f"[payload] serving_sched_weights: {e}") from None
        if self.serving_sched_max_queue_depth < 0:
            raise RuntimeConfigError(
                "[payload] serving_sched_max_queue_depth must be >= 0 "
                "(0 = no depth watermark)")
        if self.serving_sched_max_queue_wait_s < 0:
            raise RuntimeConfigError(
                "[payload] serving_sched_max_queue_wait_s must be >= 0 "
                "(0 = no wait watermark)")
        if self.serving_sched_swap_budget_mb < 0:
            raise RuntimeConfigError(
                "[payload] serving_sched_swap_budget_mb must be >= 0 "
                "(0 = preemptive swap off)")
        self._validate_observability()
        for name in ("vocab", "d_model", "n_heads", "n_kv_heads", "n_layers",
                     "d_ff", "max_seq", "serving_slots", "serving_page_size",
                     "serving_pages", "serving_prefill_chunk",
                     "status_port", "train_steps",
                     "train_batch", "train_checkpoint_every"):
            value = getattr(self, name)
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value < 0:
                raise RuntimeConfigError(
                    f"{name} must be a non-negative integer, got {value!r}")
        if self.status_port >= 65536:
            raise RuntimeConfigError("[status] port out of range")
        for name in ("serving_hbm_budget_mb", "serving_min_bucket"):
            value = getattr(self, name)
            if not isinstance(value, int) or isinstance(value, bool):
                raise RuntimeConfigError(
                    f"[payload] {name} must be an integer, got {value!r}")
        if self.serving_hbm_budget_mb < 0:
            raise RuntimeConfigError(
                "[payload] serving_hbm_budget_mb must be >= 0 "
                "(0 = off; size the pool by serving_pages instead)")
        if self.serving_hbm_budget_mb > 0 and self.serving_pages > 0:
            raise RuntimeConfigError(
                "[payload] serving_hbm_budget_mb and serving_pages are "
                "mutually exclusive — two sources of truth for one "
                "page pool; set one and leave the other 0")
        if self.serving_min_bucket < 0:
            raise RuntimeConfigError(
                "[payload] serving_min_bucket must be >= 0 (0 = off: "
                "the device batch dim is pinned to serving_slots)")
        for name in ("state_dir", "checkpoint_dir", "train_corpus",
                     "eval_corpus", "payload_attention"):
            if not isinstance(getattr(self, name), str):
                raise RuntimeConfigError(
                    f"{name} must be a string, got {getattr(self, name)!r}")
        if self.preset not in ("", *PRESETS):
            raise RuntimeConfigError(
                f"[model] preset must be one of {sorted(PRESETS)}, got "
                f"{self.preset!r}")
        self._validate_experts()
        if self.payload not in _VALID_PAYLOADS:
            raise RuntimeConfigError(
                f"[payload] kind must be one of {_VALID_PAYLOADS}, "
                f"got {self.payload!r}")
        if self.payload_attention not in _VALID_ATTENTION:
            raise RuntimeConfigError(
                f"[payload] attention must be one of {_VALID_ATTENTION}, "
                f"got {self.payload_attention!r}")
        if self.payload == "train" and not self.train_corpus:
            raise RuntimeConfigError(
                "[payload] kind = 'train' requires corpus = '<path>' "
                "(a KVFEED01 token file, typically on the state volume)")
        if self.payload == "eval" and not (self.train_corpus
                                           or self.eval_corpus):
            raise RuntimeConfigError(
                "[payload] kind = 'eval' requires corpus = '<path>' or "
                "eval_corpus = '<path>' (a KVFEED01 token file; "
                "eval_corpus is the held-out split)")
        for name in ("train_steps", "train_batch", "train_checkpoint_every"):
            if getattr(self, name) <= 0:
                raise RuntimeConfigError(
                    f"[payload] {name.removeprefix('train_')} must be "
                    "positive")
        if self.payload_serving not in ("", "contiguous", "paged"):
            raise RuntimeConfigError(
                "[payload] serving must be '', 'contiguous', or 'paged', "
                f"got {self.payload_serving!r}")
        if self.serving_overlap not in ("auto", "on", "off"):
            raise RuntimeConfigError(
                "[payload] serving_overlap must be 'auto', 'on' or 'off'")
        if self.serving_speculative != "auto" and not (
                isinstance(self.serving_speculative, int)
                and not isinstance(self.serving_speculative, bool)
                and 0 <= self.serving_speculative <= 16):
            raise RuntimeConfigError(
                "[payload] serving_speculative (draft length) must be "
                "in [0, 16] (0 = off) or 'auto'")
        if (not isinstance(self.serving_spec_window, int)
                or isinstance(self.serving_spec_window, bool)
                or not 0 <= self.serving_spec_window <= 64):
            raise RuntimeConfigError(
                "[payload] serving_spec_window must be in [0, 64] "
                "(0 = one spec pass per dispatch)")
        if self.serving_spec_window > 0 and self.serving_speculative == 0:
            raise RuntimeConfigError(
                "[payload] serving_spec_window > 0 needs speculative "
                "decoding (serving_speculative 'auto' or > 0)")
        if not isinstance(self.serving_spec_sampled_window, bool):
            raise RuntimeConfigError(
                "[payload] serving_spec_sampled_window must be a boolean")
        if self.payload_paged_attention not in ("", "auto", "kernel",
                                                "gather"):
            raise RuntimeConfigError(
                "[payload] paged_attention must be 'auto', 'kernel' or "
                f"'gather', got {self.payload_paged_attention!r}")
        if self.serving_kv_dtype not in ("", "int8"):
            raise RuntimeConfigError(
                "[payload] serving_kv_dtype must be '' or 'int8', got "
                f"{self.serving_kv_dtype!r}")
        for name in ("serving_slots", "serving_page_size"):
            if getattr(self, name) < 1:
                raise RuntimeConfigError(f"[payload] {name} must be >= 1")
        if self.max_seq < 2:
            raise RuntimeConfigError(
                f"[payload] seq = {self.max_seq} is too small to serve")

    def _validate_observability(self) -> None:
        """The window, tracing, lock, SLO, bundle and occupancy knobs,
        with the reference's ranges and messages."""
        if self.serving_window != "auto" and not (
                isinstance(self.serving_window, int)
                and not isinstance(self.serving_window, bool)
                and 1 <= self.serving_window <= 1024):
            raise RuntimeConfigError(
                "[payload] serving_window must be in [1, 1024] "
                "(1 = per-step dispatch) or 'auto' (online "
                "controller)")
        for name in ("serving_window_min", "serving_window_max",
                     "serving_occupancy_ring"):
            value = getattr(self, name)
            if not isinstance(value, int) or isinstance(value, bool):
                raise RuntimeConfigError(
                    f"[payload] {name} must be an integer, got {value!r}")
        for name in ("serving_window_min", "serving_window_max"):
            if not 1 <= getattr(self, name) <= 1024:
                raise RuntimeConfigError(
                    f"[payload] {name} must be in [1, 1024]")
        if self.serving_window_min > self.serving_window_max:
            raise RuntimeConfigError(
                "[payload] serving_window_min must be <= "
                "serving_window_max (controller bounds)")
        trace = self.serving_trace
        if isinstance(trace, bool):
            raise RuntimeConfigError(
                "[payload] serving_trace must be 'off', 'on' or a sample "
                "rate in (0, 1] — not a boolean")
        if isinstance(trace, str):
            if trace not in ("off", "on"):
                raise RuntimeConfigError(
                    "[payload] serving_trace must be 'off', 'on' or a "
                    f"sample rate in (0, 1], got {trace!r}")
        elif (not isinstance(trace, (int, float))
                or not 0.0 < trace <= 1.0):
            raise RuntimeConfigError(
                "[payload] serving_trace sample rate must be in "
                f"(0, 1], got {trace!r}")
        for name in ("serving_debug_locks", "serving_slo",
                     "serving_slo_shed", "serving_bundle"):
            if not isinstance(getattr(self, name), bool):
                raise RuntimeConfigError(
                    f"[payload] {name} must be a boolean")
        for name in ("serving_slo_target", "serving_slo_ttft_ms",
                     "serving_slo_itl_ms", "serving_slo_queue_ms",
                     "serving_slo_fast_s", "serving_slo_slow_s"):
            value = getattr(self, name)
            if not isinstance(value, (int, float)) or isinstance(value,
                                                                 bool):
                raise RuntimeConfigError(
                    f"[payload] {name} must be a number, got {value!r}")
        if not 0.0 < self.serving_slo_target < 1.0:
            raise RuntimeConfigError(
                "[payload] serving_slo_target must be in (0, 1) "
                f"(got {self.serving_slo_target!r}; the error budget "
                "is 1 - target)")
        for name in ("serving_slo_ttft_ms", "serving_slo_itl_ms",
                     "serving_slo_queue_ms"):
            if getattr(self, name) <= 0.0:
                raise RuntimeConfigError(
                    f"[payload] {name} must be > 0 (an objective in "
                    "milliseconds)")
        if not 0.0 < self.serving_slo_fast_s <= self.serving_slo_slow_s:
            raise RuntimeConfigError(
                "[payload] serving_slo windows must satisfy "
                "0 < serving_slo_fast_s <= serving_slo_slow_s "
                f"(got fast={self.serving_slo_fast_s!r}, "
                f"slow={self.serving_slo_slow_s!r})")
        if self.serving_slo_shed and not self.serving_slo:
            raise RuntimeConfigError(
                "[payload] serving_slo_shed requires serving_slo = "
                "true (the burn-rate input comes from the SLO engine)")
        if self.serving_occupancy_ring < 0:
            raise RuntimeConfigError(
                "[payload] serving_occupancy_ring must be >= 0 "
                "(0 = off; otherwise the ring depth in samples)")
        if not isinstance(self.status_token, str):
            raise RuntimeConfigError("[status] token must be a string")

    @property
    def mesh(self) -> MeshSpec:
        return MeshSpec(axes=tuple(self.mesh_axes))

    @property
    def distributed(self) -> DistributedSpec:
        return DistributedSpec(**{k: getattr(self, k)
                                  for k in _DISTRIBUTED_KEYS})

    def device_count(self) -> int:
        """The devices the mesh resolves over: the joined world's size
        (``num_processes`` x the cards of each process), or, in a
        process that joined none, ``num_processes`` x
        :func:`fewest_cards`."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return self.num_processes * fewest_cards(self.mesh_axes,
                                                 self.num_processes)

    def axis_sizes(self, n_devices: int | None = None) -> dict[str, int]:
        """The mesh resolved over ``n_devices`` (None: over
        :meth:`device_count`)."""
        return self.mesh.axis_sizes(self.device_count() if n_devices is None
                                    else n_devices)

    def check_world(self, n_devices: int) -> tuple[int, ...]:
        """Boot's check of the mesh over the ``n_devices`` it found
        (``num_processes`` x the cards each pod sees), before any local
        rank starts: the mesh resolves, with the reference's
        "mesh resolution failed: ..." (``runtime/devicecheck.py``), and
        the parser's refusals of resolved axes hold over it. Returns the
        mesh's shape. The model's derivation and the batch over ``data``
        run in the payloads, against the joined world."""
        try:
            shape = self.mesh.resolved_shape(n_devices)
        except RuntimeConfigError as e:
            raise RuntimeConfigError(f"mesh resolution failed: {e}") from None
        self._validate_world(n_devices)
        return shape

    def _validate_world(self, n_devices: int | None = None) -> None:
        """The mesh over ``n_devices`` (None, at parse: over
        ``num_processes`` x :func:`fewest_cards`, so an axis of 0 is
        refused here only where it is above 1 on every count): only the
        port's axes above 1; ``serve`` and ``inference-probe`` on no
        ``seq`` axis above 1."""
        if n_devices is None:
            n_devices = self.num_processes * fewest_cards(
                self.mesh_axes, self.num_processes)
        sizes = self.axis_sizes(n_devices)
        for axis, size in sizes.items():
            if size > 1 and axis not in _MESH_AXES:
                _refuse_axis(axis, size)
        if self.payload not in ("serve", "inference-probe"):
            return
        if sizes.get("seq", 1) > 1:
            raise RuntimeConfigError(
                f"[payload] kind = {self.payload!r} over a 'seq' axis of "
                f"{sizes['seq']}: sequence parallelism is the "
                "training layout; serving shards over 'data', 'model', "
                "'stage' and 'expert'")

    def _validate_experts(self) -> None:
        """The reference parser's checks of the MoE knobs, with its
        messages."""
        for name in ("experts", "expert_top_k"):
            value = getattr(self, name)
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value < 0:
                raise RuntimeConfigError(
                    f"[model] {name} must be a non-negative int "
                    "(0 = from the preset)")
        if (not isinstance(self.expert_capacity_factor, (int, float))
                or isinstance(self.expert_capacity_factor, bool)):
            raise RuntimeConfigError(
                "[model] expert_capacity_factor must be a number, got "
                f"{self.expert_capacity_factor!r}")
        if self.expert_capacity_factor < 0:
            raise RuntimeConfigError(
                "[model] expert_capacity_factor must be >= 0 "
                "(0 = drop-free capacity)")
        if self.expert_top_k not in (0, 1, 2):
            raise RuntimeConfigError(
                "[model] expert_top_k must be 1 or 2 (0 = default 1)")

    def model_config(self, dtype: str = "bfloat16",
                     device=None) -> TransformerConfig:
        """The model of every payload, derived from ``[model]`` and the
        mesh as the reference's ``derive_model_config`` derives it, with
        its messages (:class:`MeshConfigError`):

        * the preset with explicit fields on top, ``seq`` as max_seq;
        * a ``seq`` axis means ring attention, or the strategy
          ``[payload] attention`` names; one that would leave the axis
          holding replicas is refused, and so is a sequence-parallel
          strategy without a ``seq`` axis;
        * a preset's head count rises to the ``model`` axis, and for
          Ulysses rounds up to a multiple of seq x model; an explicit
          ``n_heads`` that Ulysses cannot split is refused;
        * the MoE fields: ``experts`` as given (a count the ``expert``
          axis does not divide is refused) or, unset, the ``expert``
          axis's size when above 1; top_k ``expert_top_k or 1``, the
          capacity factor ``expert_capacity_factor or experts / top_k``
          (provably drop-free, so training and dropless serving compute
          the same function), and MoE knobs on a dense model refused;
        * a ``stage`` axis above 1: a preset's ``n_layers`` rounds up to
          a multiple of it (an explicit one that does not divide is
          refused), ``pipeline_stages`` is its size and
          ``pipeline_schedule`` defaults to "gpipe";
        * ``dtype``, except that on the CPU (``device``) a stage axis
          above 1 with a ``model`` axis above 1 or more than one expert
          derives "float32", as the reference does on its CPU backend
          (a JAX compiler workaround: the card keeps ``dtype``);
        * the port's own rule for a ``model`` axis: it shards whole heads
          and K/V heads (``parallel/sharding.check_shardable``)."""
        axis_sizes = self.axis_sizes()
        model_axis = axis_sizes.get("model", 1)
        sp = axis_sizes.get("seq", 1)
        attention = self.payload_attention or ("ring" if sp > 1 else "naive")
        if sp > 1 and attention not in ("ring", "ulysses"):
            raise MeshConfigError(
                f"mesh declares a 'seq' axis but [payload] attention = "
                f"{attention!r} would silently ignore it (the axis devices "
                "would hold replicas); use attention = \"ring\"/\"ulysses\" "
                "or drop the seq axis")
        if "seq" not in axis_sizes and attention in ("ring", "ulysses"):
            raise MeshConfigError(
                f"[payload] attention = {attention!r} is sequence-parallel "
                "and needs a 'seq' axis in the mesh")
        base = PRESETS[self.preset or "probe"]
        n_heads = self.n_heads or max(base["n_heads"], model_axis)
        group = sp * model_axis
        if attention == "ulysses" and n_heads % group:
            if self.n_heads:
                raise MeshConfigError(
                    f"[model] n_heads = {self.n_heads} cannot run ulysses "
                    f"attention on this mesh: the head count must divide by "
                    f"seq x model = {group}")
            n_heads = group * -(-n_heads // group)  # round up, preset-derived
        n_experts_axis = axis_sizes.get("expert", 1)
        if self.experts:
            n_experts = self.experts
            if n_experts % n_experts_axis:
                raise MeshConfigError(
                    f"[model] experts = {n_experts} must divide by the "
                    f"mesh's expert axis ({n_experts_axis}) — each device "
                    "holds E/ep whole experts (parallel/sharding.py)")
        else:
            n_experts = n_experts_axis if n_experts_axis > 1 else 0
        if not n_experts and (self.expert_top_k
                              or self.expert_capacity_factor):
            raise MeshConfigError(
                "[model] expert_top_k/expert_capacity_factor are set but "
                "the model is dense (no [model] experts and no 'expert' "
                "mesh axis) — set experts = N or drop the MoE knobs")
        stages = axis_sizes.get("stage", 1)
        n_layers = self.n_layers or base["n_layers"]
        if stages > 1 and n_layers % stages:
            if self.n_layers:
                raise MeshConfigError(
                    f"[model] n_layers = {n_layers} must divide by the "
                    f"mesh's stage axis ({stages}) — each stage holds L/S "
                    "whole layers")
            n_layers = stages * -(-n_layers // stages)  # round up
        top_k = self.expert_top_k or 1
        capacity = (self.expert_capacity_factor
                    or max(n_experts, 1) / top_k)
        on_cpu = device is not None and str(device).split(":")[0] == "cpu"
        if stages > 1 and (model_axis > 1 or n_experts > 1) and on_cpu:
            dtype = "float32"
        tcfg = TransformerConfig(
            vocab=self.vocab or base["vocab"],
            d_model=self.d_model or base["d_model"],
            n_heads=n_heads,
            n_kv_heads=self.n_kv_heads or base["n_kv_heads"],
            n_layers=n_layers,
            d_ff=self.d_ff or base["d_ff"],
            max_seq=self.max_seq,
            dtype=dtype,
            paged_attention=self.payload_paged_attention or "auto",
            attention=attention,
            n_experts=n_experts,
            expert_top_k=top_k,
            expert_capacity_factor=float(capacity),
            pipeline_stages=stages if stages > 1 else 0,
            pipeline_schedule=self.pipeline_schedule or "gpipe",
        )
        try:
            tcfg.validate()
            if model_axis > 1:
                from kvedge_torch.parallel.sharding import check_shardable

                check_shardable(tcfg, model_axis)
        except ValueError as e:
            raise MeshConfigError(
                f"[model] configuration is invalid: {e}") from e
        return tcfg

    def to_toml(self) -> str:
        """Serialize back to TOML, the document ``apply`` writes: the
        reference's sections, keys and order, strings as TOML basic
        strings (JSON escaping), so the document re-parses to this
        config in either package."""
        s = _toml_str

        def scalar(value) -> str:
            return s(value) if isinstance(value, str) else str(value)

        axes = ", ".join(f"{s(name)} = {size}" for name, size in
                         self.mesh_axes)
        lines = [
            "[runtime]",
            f"name = {s(self.name)}",
            f"state_dir = {s(self.state_dir)}",
            f"checkpoint_dir = {s(self.checkpoint_dir)}",
            f"heartbeat_interval_s = {float(self.heartbeat_interval_s)}",
            "", "[tpu]",
            f"platform = {s(self.expected_platform)}",
            f"expected_chips = {self.expected_chips}",
            "", "[mesh]",
            f"axes = {{ {axes} }}",
            "", "[model]",
            f"preset = {s(self.preset)}",
        ]
        lines += [f"{k} = {getattr(self, k)}" for k in (
            "vocab", "d_model", "n_heads", "n_kv_heads", "n_layers", "d_ff",
            "experts", "expert_top_k")]
        lines += [
            "expert_capacity_factor = "
            f"{float(self.expert_capacity_factor)}",
            f"pipeline_schedule = {s(self.pipeline_schedule)}",
            "", "[distributed]",
            f"num_processes = {self.num_processes}",
            f"coordinator_address = {s(self.coordinator_address)}",
            f"coordinator_port = {self.coordinator_port}",
            f"process_id = {self.process_id}",
            "", "[status]",
            f"port = {self.status_port}",
            f"bind = {s(self.status_bind)}",
            f"token = {s(self.status_token)}",
            "", "[payload]",
        ]
        for key, field in _PAYLOAD_KEYS.items():
            value = getattr(self, field)
            if isinstance(value, bool):
                lines.append(f"{key} = {_toml_bool(value)}")
            elif field in _FLOAT_FIELDS:
                lines.append(f"{key} = {float(value)}")
            else:
                lines.append(f"{key} = {scalar(value)}")
        return "\n".join(lines) + "\n"

    def apply(self, config_path: str = DEFAULT_CONFIG_PATH) -> str:
        """Materialize the validated config, as ``kvedge-bootstrap
        apply`` does: the canonical TOML at ``config_path`` (tmp +
        ``os.replace``) and the state directory, so that a runtime boot
        finds both."""
        self.validate()
        os.makedirs(os.path.dirname(config_path) or ".", exist_ok=True)
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = config_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(self.to_toml())
        os.replace(tmp, config_path)
        return config_path


def _spec_draft_len(cfg: RuntimeConfig) -> int:
    """The draft length ``serving_speculative`` resolves to before the
    boot probe: "auto" sizes the pools for draft 4 (the probe may still
    turn speculation off at boot; sizing for it keeps the pool
    independent of the probe's outcome)."""
    if cfg.serving_speculative == "auto":
        return 4
    return cfg.serving_speculative


# The serving slice's name for the same parsed config.
ServeConfig = RuntimeConfig
