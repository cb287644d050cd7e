"""Device resolution and the device probe.

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
    ok: bool
    platform: str
    device_count: int
    device_kinds: tuple[str, ...]
    probe_ms: float
    probe_max_err: float
    error: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {
            "device_kinds": list(self.device_kinds)}


def run_device_check(device: str | torch.device | None = None
                     ) -> DeviceCheckResult:
    """Probe the device: platform, count, names, and one bf16 matmul
    checked against the same product on the CPU. Raises when the card
    is missing (see :func:`resolve_device`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        kinds = tuple(sorted({torch.cuda.get_device_name(i)
                              for i in range(count)}))
        platform = "gpu"
    else:
        count, kinds, platform = 1, ("cpu",), "cpu"
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(16, PROBE_DIM, generator=gen).to(torch.bfloat16)
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
        probe_ms=probe_ms, probe_max_err=err,
        error="" if ok else f"matmul probe disagrees with the CPU by {err}",
    )
