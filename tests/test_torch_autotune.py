"""The online window controller in the port, against the JAX package, at
small shapes (vocab 128, d_model 32, 4 heads, 2 kv heads, 2 layers,
page 4, fp32) on the CPU.

* ``WindowController`` gives the JAX controller's picks, EWMAs and
  snapshots for one seeded sequence of observations, on the decode and
  the spec channel, and ``pick_window`` keeps the law (the smallest power
  of two in the bounds with ``W * t >= R``).
* A server with ``window="auto"`` returns the tokens of a fixed window
  bit for bit, plain (overlap on and off, greedy and sampled) and with
  spec windows; the controller learned from every harvested window and
  its pick stays on the power-of-two ladder inside its bounds.
"""

import jax
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.runtime import autotune as jautotune
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime import autotune as tautotune

torch.set_num_threads(2)

KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64, dtype="float32")


@pytest.fixture(scope="module")
def tmodel():
    jcfg = jtr.TransformerConfig(**KW, remat=False, paged_attention="gather")
    tcfg = TransformerConfig(**KW)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return tcfg, params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")


@pytest.mark.parametrize("lo,hi,alpha", [(1, 256, 0.2), (2, 64, 0.5),
                                         (4, 4, 1.0), (3, 100, 0.2)])
def test_controller_picks_equal_the_reference(lo, hi, alpha):
    ours = tautotune.WindowController(lo=lo, hi=hi, alpha=alpha)
    theirs = jautotune.WindowController(lo=lo, hi=hi, alpha=alpha)
    rng = np.random.default_rng(lo * 1000 + hi)
    for channel in ("decode", "spec"):
        assert ours.window(channel, default=8) == \
            theirs.window(channel, default=8)
    for _ in range(200):
        channel = "spec" if rng.random() < 0.3 else "decode"
        window = int(2 ** rng.integers(0, 8))
        device = float(rng.exponential(1.6) * window)
        obs = dict(rtt_ms=device + float(rng.exponential(3.0)),
                   device_ms=device, host_ms=float(rng.exponential(0.5)),
                   window=window, channel=channel)
        ours.observe(**obs)
        theirs.observe(**obs)
        for ch in ("decode", "spec"):
            assert ours.window(ch) == theirs.window(ch)
            assert ours.window(ch, default=16) == \
                theirs.window(ch, default=16)
            assert ours.snapshot(ch) == theirs.snapshot(ch)


def test_pick_window_keeps_the_law():
    for r, t in [(10.0, 1.6), (0.5, 1.6), (100.0, 0.01), (3.0, 0.0),
                 (1.6, 1.6), (3.3, 1.6)]:
        for lo, hi in [(1, 256), (2, 64), (8, 8)]:
            w = tautotune.pick_window(r, t, lo, hi)
            assert w == jautotune.pick_window(r, t, lo, hi)
            assert w & (w - 1) == 0 and lo <= w <= hi
            if t > 0 and w > lo:
                assert (w // 2) * t < r <= w * t or w == hi


def _sampling(k):
    return np.asarray(jax.random.PRNGKey(k), np.uint32), 0.8, 0.9


TRAFFIC = [([5, 9, 2, 7], 30, None), ([1, 2, 3, 4], 24, 3),
           ([8, 8, 1], 40, None), ([3, 1, 4, 1, 5], 33, 5),
           ([6, 2, 6, 2, 6, 2], 28, None)]


def _serve(tmodel, greedy_only=False, **kw):
    tcfg, params = tmodel
    server = PagedGenerationServer(params, tcfg, slots=2, pages=48,
                                   page_size=4, device="cpu", **kw)
    try:
        out = [server.submit(p, n, sampling=None if greedy_only or not s
                             else _sampling(s))
               for p, n, s in TRAFFIC]
        return out, server.stats()
    finally:
        server.close()


@pytest.mark.parametrize("shape", [
    dict(overlap="on"), dict(overlap="off"),
    dict(overlap="on", speculative=2, spec_window=4),
    dict(overlap="on", speculative=2, spec_window=4, greedy_only=True)],
    ids=["overlap", "serial", "spec-windows", "spec-windows-greedy"])
def test_auto_window_returns_the_fixed_windows_tokens(tmodel, shape):
    fixed, _ = _serve(tmodel, window=64, **shape)
    auto, st = _serve(tmodel, window="auto", window_min=1, window_max=64,
                      **shape)
    assert auto == fixed
    w = st["autotune_window"]
    assert w & (w - 1) == 0 and 1 <= w <= 64
    if shape["overlap"] == "on" and not shape.get("greedy_only"):
        # Every harvested plain window taught the controller (an
        # all-greedy spec batch feeds only the spec channel).
        assert st["autotune_updates"] >= 1
        assert st["autotune_t_ms"] > 0
    if shape.get("spec_window"):
        assert 1 <= st["autotune_spec_window"] <= 4


def _mark_captured(cache, which):
    """Wrap the cache's dispatch seams so the dispatches whose ordinal
    ``which`` accepts come back marked as having captured their graph
    (the CPU runs eagerly and never captures)."""
    seen = {"n": 0}

    def wrap(fn):
        def marked(*args, **kwargs):
            handle = fn(*args, **kwargs)
            handle.captured = which(seen["n"])
            seen["n"] += 1
            return handle
        return marked

    cache._device_window_dispatch = wrap(cache._device_window_dispatch)
    cache._device_spec_window = wrap(cache._device_spec_window)


@pytest.mark.parametrize("shape", [
    dict(overlap="on"), dict(overlap="on", speculative=2, spec_window=4)],
    ids=["overlap", "spec-windows"])
def test_a_captured_window_never_reaches_the_controller(tmodel, shape):
    """Greedy traffic whose windows' round trips span a graph capture:
    each such window is counted in ``autotune_skipped_captures`` and
    leaves the controller's R, t and update count as they were (the
    plain channel, or the spec channel with spec windows); the tokens
    are the fixed window's."""
    tcfg, params = tmodel
    channel = "spec" if shape.get("spec_window") else "decode"
    fixed, _ = _serve(tmodel, window=64, greedy_only=True, **shape)

    def run(which):
        server = PagedGenerationServer(
            params, tcfg, slots=2, pages=48, page_size=4, device="cpu",
            window="auto", window_min=1, window_max=64, **shape)
        recs = []

        def spy(dispatch):
            def recorded(first):
                rec = dispatch(first)
                if rec is not None:
                    recs.append(rec)
                return rec
            return recorded

        server._dispatch_window_locked = spy(server._dispatch_window_locked)
        server._dispatch_spec_window_locked = spy(
            server._dispatch_spec_window_locked)
        try:
            before = server._autotune.snapshot(channel)
            _mark_captured(server._cache, which)
            out = [server.submit(p, n) for p, n, _ in TRAFFIC]
            return (out, before, server._autotune.snapshot(channel),
                    server.stats(), recs)
        finally:
            server.close()

    out, before, after, st, recs = run(lambda i: True)
    assert out == fixed
    assert after == before and after["updates"] == 0
    assert st["autotune_skipped_captures"] == len(recs) >= len(TRAFFIC)
    out, _, after, st, recs = run(lambda i: i == 1)
    assert out == fixed
    # The marked window, and the one in flight while it was dispatched
    # (window 0: its round trip spans the capture), are skipped; the
    # rest teach the controller.
    assert recs[1]["depth"] == 1
    assert st["autotune_skipped_captures"] == 2
    assert after["updates"] == len(recs) - 2
