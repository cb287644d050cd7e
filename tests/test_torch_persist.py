"""Prefix persistence: the port's ``dump_prefix_cache`` /
``load_prefix_cache`` / ``start_prefix_persistence`` against the JAX
package's.

The file is the interface: an ``.npz`` holding a JSON doc (fingerprint,
page size, entries with their token paths and page ids, the page ids
dumped) and fp32 K/V, no framework in it. So a file the JAX server dumps
loads into the port's, and the reverse. Both servers run the same
traffic at the reference's small shapes (vocab 128, d_model 32, 4 heads,
2 kv heads, 2 layers, max_seq 64, page 4), at bf16 and over an int8 pool;
each file is loaded by a fresh server of either package, and the two
loaders of one file are compared with each other (entries, their pages
and every page's count) and with their package's own cold run: the first
request after the load is a hit that returns the tokens the same request
got cold. That holds when the file comes from the loader's own package,
and across the packages at fp32; at bf16 the two packages' K/V differ
in the last bit where their kernels round apart, so a bf16 load across
them is held to the bytes it loads (the file's values, bit for bit) and
its tokens are not compared. Nothing is compared with a hard-coded
count. Then the port's
own edges: a stale fingerprint or page size, a pool too full (skip, not
stop), the periodic thread (dumps only on change, stops at close), the
atomic write, and the serve payload's wiring.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.serving import PagedGenerationServer
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.config import ServeConfig
from kvedge_torch.runtime.serve import ServeRuntime

torch.set_num_threads(2)

KW = dict(vocab=128, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_seq=64)
FP = "step=None test-fingerprint"
BASE = [7, 3, 9, 1, 5, 5, 2, 8, 11, 12]   # two full pages and a partial
TRAFFIC = [(BASE + [4, 6], 6), (BASE[:8] + [40, 41, 42, 43, 44], 5)]
PROBE = (BASE + [4, 6, 99], 6)


def _models(dtype):
    jcfg = jtr.TransformerConfig(**KW, dtype=dtype, remat=False,
                                 paged_attention="gather")
    tcfg = TransformerConfig(**KW, dtype=dtype)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(
        {k: np.asarray(v, np.float32) for k, v in jparams.items()}, tcfg,
        "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def models(request):
    return _models(request.param)


def _server(models, jax_side, kv_dtype="", **kw):
    jcfg, tcfg, jparams, tparams = models
    kw = dict(dict(slots=2, pages=32, page_size=4, kv_dtype=kv_dtype), **kw)
    if jax_side:
        return JaxServer(jparams, jcfg, **kw)
    return PagedGenerationServer(tparams, tcfg, device="cpu", **kw)


def _registry(server) -> dict:
    """{token path: [(page, page count), ...]} of the pool entries, the
    pages renamed in order of first use over the sorted paths (a load
    allocates fresh ids; which entries share a page is what must hold)."""
    with server._lock:
        raw = {tuple(server._node_tokens(node)): list(entry["pages"])
               for node, entry in server._prefix_entry_nodes.items()}
        names: dict = {}
        return {
            path: [(names.setdefault(p, len(names)),
                    server._cache.page_refcount(p)) for p in raw[path]]
            for path in sorted(raw)}


def _loaded_bytes(server, path):
    """The loaded pages' K as the pool holds them (fp32 on the host) and
    the file's K of the same pages, in the registry's page order."""
    doc, pool_k, _ = _read(path)
    pos = {p: i for i, p in enumerate(doc["page_ids"])}
    by_path = {tuple(e["tokens"]): e["pages"] for e in doc["entries"]}
    with server._lock:
        mine, theirs = [], []
        for node, entry in server._prefix_entry_nodes.items():
            old = by_path[tuple(server._node_tokens(node))]
            mine += list(entry["pages"])
            theirs += [pos[p] for p in old]
        k, _ = server._cache.read_pages(mine)
    return np.asarray(k, np.float32), pool_k[:, theirs]


def _run(server, reqs):
    return [server.submit(p, n_new=n) for p, n in reqs]


def _read(path):
    with np.load(path) as data:
        return (json.loads(bytes(data["doc"]).decode()),
                data["pool_k"].copy(), data["pool_v"].copy())


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_files_cross_between_the_packages(models, kv_dtype, tmp_path):
    """JAX dump -> port load and port dump -> JAX load: the two loaders
    of each file hold the same entries, pages and counts, and the first
    request after a load is a hit with the loader's cold tokens."""
    paths = {}
    cold = {}
    for jax_side in (True, False):
        server = _server(models, jax_side, kv_dtype)
        try:
            cold[jax_side] = (_run(server, TRAFFIC),
                              _run(server, [PROBE])[0])
            server.close()
            path = str(tmp_path / f"{'jax' if jax_side else 'port'}.npz")
            assert server.dump_prefix_cache(path, FP) == \
                len(_registry(server))
            paths[jax_side] = path
        finally:
            server.close()
    # Both packages registered the same entries on the same pages.
    (jdoc, jk, jv), (tdoc, tk, tv) = _read(paths[True]), _read(paths[False])
    assert jdoc == tdoc
    assert jk.dtype == tk.dtype == np.float32 and jk.shape == tk.shape
    # Each file, into a fresh server of each package.
    bf16 = models[1].dtype == "bfloat16"
    for src in (True, False):
        loaded = {}
        for jax_side in (True, False):
            server = _server(models, jax_side, kv_dtype)
            try:
                n = server.load_prefix_cache(paths[src], FP)
                assert n == len(jdoc["entries"]) > 0
                reg = _registry(server)
                if not jax_side:
                    mine, theirs = _loaded_bytes(server, paths[src])
                    if kv_dtype:
                        # Re-quantized: within one int8 step of the row.
                        np.testing.assert_allclose(
                            mine, theirs, rtol=0,
                            atol=np.abs(theirs).max() / 127)
                    else:
                        np.testing.assert_array_equal(mine, theirs)
                warm = server.submit(*PROBE)
                st = server.stats()
                assert st["prefix_hits"] == 1 and st["prefix_tokens_saved"] > 0
                loaded[jax_side] = (reg, warm)
            finally:
                server.close()
        assert loaded[True][0] == loaded[False][0]
        for jax_side in (True, False):
            if src == jax_side or not bf16:
                assert loaded[jax_side][1] == cold[jax_side][1], \
                    (src, jax_side)


def test_port_round_trip_keeps_tokens_and_counts(models, tmp_path):
    """A port server dumps; a fresh one loads: the registry's entries,
    pages and counts are the dumping server's, and the warm tokens the
    cold ones."""
    path = str(tmp_path / "pc.npz")
    server = _server(models, False)
    try:
        _run(server, TRAFFIC)
        before = _registry(server)
        cold = server.submit(*PROBE)
    finally:
        server.close()
    # The probe registered more entries after ``before``: reload those.
    after = _registry(server)
    assert server.dump_prefix_cache(path, FP) == len(after)
    fresh = _server(models, False)
    try:
        assert fresh.load_prefix_cache(path, FP) == len(after)
        assert _registry(fresh) == after and set(before) <= set(after)
        assert fresh.submit(*PROBE) == cold
        assert fresh.stats()["prefix_hits"] == 1
        acc = fresh.stats()["page_accounting"]
        assert acc["free"] + acc["live"] == acc["pages_total"]
        # Boot time only: a second load into live entries is refused.
        assert fresh.load_prefix_cache(path, FP) == 0
    finally:
        fresh.close()


def test_stale_file_is_ignored(tmp_path, capsys):
    models = _models("float32")
    path = str(tmp_path / "pc.npz")
    server = _server(models, False)
    try:
        _run(server, TRAFFIC)
        assert server.dump_prefix_cache(path, FP) > 0
    finally:
        server.close()
    for kw, fp in ((dict(), "step=7 other"), (dict(page_size=8), FP)):
        fresh = _server(models, False, **kw)
        try:
            assert fresh.load_prefix_cache(path, fp) == 0
            assert _registry(fresh) == {}
            assert "stale prefix cache" in capsys.readouterr().out
        finally:
            fresh.close()
    fresh = _server(models, False)
    try:
        assert fresh.load_prefix_cache(str(tmp_path / "absent.npz"), FP) == 0
        with open(tmp_path / "torn.npz", "wb") as f:
            f.write(b"not an npz")
        assert fresh.load_prefix_cache(str(tmp_path / "torn.npz"), FP) == 0
        assert "unreadable prefix cache" in capsys.readouterr().out
        # Nothing registered: no file is written.
        assert fresh.dump_prefix_cache(str(tmp_path / "none.npz"), FP) == 0
        assert not os.path.exists(tmp_path / "none.npz")
    finally:
        fresh.close()


def test_pool_too_full_skips_and_does_not_stop(tmp_path):
    """Entries whose new pages the free list cannot cover are skipped and
    the rest still load, in both packages alike; nothing is evicted."""
    models = _models("float32")
    path = str(tmp_path / "pc.npz")
    long_prompt = list(range(20, 44))  # 6 pages: 6 nested entries
    server = _server(models, False)
    try:
        _run(server, [(long_prompt, 2), (BASE + [4, 6], 2)])
    finally:
        server.close()
    assert server.dump_prefix_cache(path, FP) > 0
    got = []
    for jax_side in (True, False):
        small = _server(models, jax_side, pages=5)
        try:
            n = small.load_prefix_cache(path, FP)
            reg = _registry(small)
            assert 0 < n == len(reg) < len(_registry(server))
            assert small._cache.free_pages() == 0
            got.append(reg)
        finally:
            small.close()
    assert got[0] == got[1]


def test_periodic_dump_only_on_change_and_stops_at_close(tmp_path):
    models = _models("float32")
    path = str(tmp_path / "pc.npz")
    server = _server(models, False)
    try:
        server.start_prefix_persistence(path, FP, interval=0.05)
        with pytest.raises(RuntimeError, match="already started"):
            server.start_prefix_persistence(path, FP)
        time.sleep(0.3)
        assert not os.path.exists(path)  # nothing registered yet
        server.submit(*TRAFFIC[0])
        deadline = time.monotonic() + 30
        while not os.path.exists(path):
            assert time.monotonic() < deadline, "no periodic dump"
            time.sleep(0.02)
        time.sleep(0.3)
        stamp = os.stat(path).st_mtime_ns
        time.sleep(0.3)
        assert os.stat(path).st_mtime_ns == stamp  # no change, no dump
        thread = server._persist_thread
    finally:
        server.close()
    assert not thread.is_alive()
    assert not os.path.exists(path + ".tmp")


def test_dump_is_atomic(tmp_path, monkeypatch):
    """The file lands by ``os.replace`` of a finished temporary: a dump
    that fails mid-write leaves the previous file whole."""
    models = _models("float32")
    path = str(tmp_path / "pc.npz")
    server = _server(models, False)
    try:
        _run(server, TRAFFIC)
        assert server.dump_prefix_cache(path, FP) > 0
        good = _read(path)[0]

        def broken(*args, **kw):
            raise OSError("disk full")

        monkeypatch.setattr(np, "savez", broken)
        with pytest.raises(OSError, match="disk full"):
            server.dump_prefix_cache(path, FP)
        monkeypatch.undo()
        assert _read(path)[0] == good
    finally:
        server.close()


def test_serve_payload_reloads_its_prefixes_across_restarts(tmp_path,
                                                            capsys):
    """``serving_prefix_persist`` (the default) with a state directory:
    the runtime dumps after close, the next one re-pins at boot with the
    reference's fingerprint, and its first request is a hit with the
    cold tokens; a runtime with persistence off neither loads nor
    dumps."""
    cfg = ServeConfig(preset="probe", n_layers=1, max_seq=64,
                      payload_serving="paged", serving_slots=2,
                      serving_page_size=4, serving_prefill_chunk=8,
                      state_dir=str(tmp_path))
    assert cfg.serving_prefix_persist is True
    body = {"tokens": [BASE + [4, 6]], "n_new": 6}
    rt = ServeRuntime(cfg, device="cpu", dtype="float32", seed=3)
    try:
        t = rt.tcfg
        assert rt.prefix_fingerprint == (
            f"step=None {t.vocab}v {t.d_model}d {t.n_heads}h "
            f"{t.kv_heads}kv {t.n_layers}L {t.d_ff}ff {t.max_seq}T "
            f"{t.dtype}")
        cold = rt.serve_fn(body)["tokens"]
    finally:
        rt.close()
    path = tmp_path / "prefix-cache.npz"
    assert path.exists()
    rt = ServeRuntime(cfg, device="cpu", dtype="float32", seed=3)
    try:
        assert "re-pinned" in capsys.readouterr().out
        assert rt.serve_fn(body)["tokens"] == cold
        assert rt.server.stats()["prefix_hits"] == 1
    finally:
        rt.close()
    os.remove(path)
    off = ServeRuntime(ServeConfig(**{**cfg.__dict__,
                                      "serving_prefix_persist": False}),
                       device="cpu", dtype="float32", seed=3)
    try:
        off.serve_fn(body)
        assert off.prefix_path is None
    finally:
        off.close()
    assert not path.exists()


PAYLOAD_TOML = """[runtime]
state_dir = "{state}"
[tpu]
platform = "cpu"
[model]
preset = "probe"
n_layers = 1
{moe}[payload]
kind = "serve"
serving = "paged"
seq = 64
serving_slots = 2
serving_page_size = 4
serving_prefill_chunk = 8
[status]
port = 0
bind = "127.0.0.1"
"""


def _payload_toml(state, moe=""):
    return PAYLOAD_TOML.format(state=state, moe=moe)


@pytest.fixture(scope="module")
def jax_dense_file(tmp_path_factory):
    """A ``prefix-cache.npz`` that the JAX package's serve payload dumped
    at close, with the fingerprint that payload wrote into it."""
    from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
    from kvedge_tpu.runtime.workload import run_serve_payload

    state = tmp_path_factory.mktemp("jax-serve")
    check, serve_fn = run_serve_payload(
        JaxConfig.parse(_payload_toml(state)))
    assert check.ok, check.error
    try:
        serve_fn({"tokens": [BASE], "n_new": 4})
    finally:
        serve_fn.close()
    path = state / "prefix-cache.npz"
    return path, _read(path)[0]["fingerprint"]


def _fresh_state(tmp_path, name, seed_file=None):
    state = tmp_path / name
    state.mkdir()
    if seed_file is not None:
        (state / "prefix-cache.npz").write_bytes(seed_file.read_bytes())
    return state


def test_dense_fingerprint_is_the_reference_string_and_files_cross(
        jax_dense_file, tmp_path):
    """A dense serve payload's fingerprint is byte for byte the one the
    JAX package writes, so its file re-pins in the port."""
    path, jax_fp = jax_dense_file
    state = _fresh_state(tmp_path, "dense", path)
    rt = ServeRuntime(ServeConfig.parse(_payload_toml(state)),
                      device="cpu", dtype="bfloat16")
    try:
        assert rt.prefix_fingerprint == jax_fp
        assert rt.prefix_load["entries"] >= 1
    finally:
        rt.close()


def test_moe_fingerprint_names_its_experts_and_refuses_a_dense_file(
        jax_dense_file, tmp_path, capsys):
    """An MoE model's fingerprint is the dense string plus its experts
    and top-k, so a dense file at the same step and geometry (the
    JAX package's, or the port's own) loads 0 entries into it. MoE
    files no longer cross to the JAX package, whose string names no
    experts."""
    path, jax_fp = jax_dense_file
    moe = "experts = 4\nexpert_top_k = 2\n"
    dense_state = _fresh_state(tmp_path, "port-dense")
    rt = ServeRuntime(ServeConfig.parse(_payload_toml(dense_state)),
                      device="cpu", dtype="bfloat16")
    try:
        rt.serve_fn({"tokens": [BASE], "n_new": 4})
    finally:
        rt.close()
    port_file = dense_state / "prefix-cache.npz"
    assert _read(port_file)[0]["entries"]
    for name, seed in (("from-jax", path), ("from-port", port_file)):
        state = _fresh_state(tmp_path, name, seed)
        rt = ServeRuntime(ServeConfig.parse(_payload_toml(state, moe)),
                          device="cpu", dtype="bfloat16")
        try:
            assert rt.prefix_fingerprint == jax_fp + " 4e2k"
            assert rt.prefix_load["entries"] == 0
            assert rt.server.stats()["prefix_entries"] <= 1
        finally:
            rt.close()
    assert "fingerprint/page-size changed" in capsys.readouterr().out
