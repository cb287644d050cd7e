"""Device resolution and the device probe (the ``devicecheck`` payload).

Every entry point of the port runs on the CUDA card unless the caller
asks for the CPU (``device="cpu"``); with no card and no explicit CPU
request it raises instead of carrying on on the CPU. On the card,
float32 matmuls and convolutions run in full float32 — TF32 and
reduced-precision bf16/fp16 reductions are switched off explicitly,
because fp32 parity with the reference must not ride on defaults.
"""

from __future__ import annotations

import dataclasses
import time

import torch

PROBE_ROWS = 16
PROBE_DIM = 128


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/"cuda" -> the CUDA card (raising when there is none);
    "cpu" -> the CPU, only because the caller asked for it."""
    dev = torch.device(device or "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"the PyTorch port runs on 'cuda' or 'cpu', got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the PyTorch port runs on the card "
            "unless the CPU is asked for explicitly (device='cpu' / "
            "--device cpu)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceCheckResult:
    """What a payload reports to boot, ``/status`` and the heartbeat: the
    reference's keys (``mesh_axes`` and ``mesh_shape`` of the mesh
    resolved over the world, ``probe_ms``, ``probe_checksum``) and the
    port's ``probe_max_err``, the matmul probe's distance from the
    CPU."""

    ok: bool
    platform: str
    device_count: int
    device_kinds: tuple[str, ...]
    mesh_axes: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    probe_ms: float
    probe_checksum: float
    probe_max_err: float = 0.0
    error: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {
            "device_kinds": list(self.device_kinds),
            "mesh_axes": list(self.mesh_axes),
            "mesh_shape": list(self.mesh_shape),
        }


def _failure(platform: str, count: int, kinds, error: str
             ) -> DeviceCheckResult:
    return DeviceCheckResult(
        ok=False, platform=platform, device_count=count,
        device_kinds=tuple(kinds), mesh_axes=(), mesh_shape=(),
        probe_ms=0.0, probe_checksum=0.0, error=error,
    )


def run_device_check(cfg=None, device: str | torch.device | None = None
                     ) -> DeviceCheckResult:
    """Probe the device: platform, count, names, and one bf16 matmul
    checked against the same product on the CPU. With a runtime config,
    its ``[tpu] platform`` and ``expected_chips`` are held to what is
    visible, with the reference's messages, and its ``[mesh]`` resolved
    over the joined world (one rank a card: the device count is the
    world's size, ``num_processes`` x the cards of each pod, as the
    reference's is ``len(jax.devices())``) is reported. Raises when the
    card is missing (see :func:`resolve_device`)."""
    from kvedge_torch.parallel.distributed import local_cards, world_size

    dev = resolve_device(device)
    world = world_size()
    if world > 1:
        kinds = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu",)
        count, platform = world, "gpu" if dev.type == "cuda" else "cpu"
    elif dev.type == "cuda":
        count = torch.cuda.device_count()
        kinds = tuple(sorted({torch.cuda.get_device_name(i)
                              for i in range(count)}))
        platform = "gpu"
    else:
        count, kinds, platform = 1, ("cpu",), "cpu"
    axes, shape = (), ()
    if cfg is not None:
        if cfg.expected_platform and platform != cfg.expected_platform:
            return _failure(
                platform, count, kinds,
                f"expected platform {cfg.expected_platform!r}, "
                f"got {platform!r}")
        if cfg.expected_chips and count != cfg.expected_chips:
            return _failure(
                platform, count, kinds,
                f"expected {cfg.expected_chips} chips, {count} visible")
        axes = cfg.mesh.axis_names()
        try:
            shape = cfg.mesh.resolved_shape(world)
        except ValueError as e:
            return _failure(platform, count, kinds,
                            f"mesh resolution failed: {e}")
        cards = local_cards()
        if world != cfg.num_processes * cards:
            return _failure(
                platform, count, kinds,
                f"[distributed] num_processes = {cfg.num_processes} x "
                f"{cards} cards, but this process is in a world of {world}")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(PROBE_ROWS, PROBE_DIM, generator=gen).to(torch.bfloat16)
    w = torch.randn(PROBE_DIM, PROBE_DIM, generator=gen).to(torch.bfloat16)
    want = x.float() @ w.float()
    t0 = time.perf_counter()
    got = (x.to(dev) @ w.to(dev)).float().cpu()  # .cpu() synchronizes
    probe_ms = (time.perf_counter() - t0) * 1e3
    err = float((got - want).abs().max())
    # One bf16 rounding of O(10)-sized sums: well inside 0.5.
    ok = bool(torch.isfinite(got).all()) and err < 0.5
    return DeviceCheckResult(
        ok=ok, platform=platform, device_count=count, device_kinds=kinds,
        mesh_axes=axes, mesh_shape=shape,
        probe_ms=probe_ms, probe_checksum=float(got.sum()),
        probe_max_err=err,
        error="" if ok else f"matmul probe disagrees with the CPU by {err}",
    )
