"""The port's server and serve payload against the JAX reference.

* ``kvedge_torch`` ``PagedGenerationServer`` vs the reference's
  (``prefix_cache=False, overlap="off", window=4``) on the same
  concurrent greedy and seeded-sampled requests at fp32: identical
  tokens (a request's tokens do not depend on its co-tenants).
* The port's copy of ``_parse_generate_request`` vs the reference's on a
  table of good and bad bodies: the same result or the same error.
* HTTP round trips (buffered and streamed) on 127.0.0.1 with
  ``device="cpu"``; the entry
  points raise without a card unless the CPU is asked for; the package
  imports with ``jax`` and ``kvedge_tpu`` blocked.
* ``boot_serve(port=0)`` is the runtime booted through
  ``start_runtime``: its heartbeat's ``boot_count`` goes 1 -> 2 over two
  runtimes on one state directory, ``/status`` and ``/healthz`` are
  ``start_runtime``'s for the same config, and ``/profile`` captures;
  ``StatusServer`` is built in ``runtime/boot.py`` only.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvedge_tpu.models import transformer as jtr
from kvedge_tpu.models.serving import PagedGenerationServer as JaxServer
from kvedge_tpu.runtime.workload import (
    _parse_generate_request as jax_parse,
)
from kvedge_torch.models.config import TransformerConfig
from kvedge_torch.models.decode import generate, init_cache
from kvedge_torch.models.kvcache import PagedKVCache
from kvedge_torch.models.serving import (
    PagedGenerationServer,
    RequestCancelled,
    ServerBusy,
    ServerClosed,
)
from kvedge_torch.models.transformer import forward
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.config import RuntimeConfigError, ServeConfig
from kvedge_torch.cli import main
from kvedge_torch.runtime.serve import (
    ServeRuntime,
    boot_serve,
    _parse_generate_request,
    row_key_data,
)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(
        vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=128, max_seq=48, dtype="float32", remat=False,
        paged_attention="gather")
    tcfg = TransformerConfig(
        vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=128, max_seq=48, dtype="float32")
    jparams = jtr.init_params(jax.random.PRNGKey(1), jcfg)
    tree = {k: np.asarray(v) for k, v in jparams.items()}
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, "cpu")


# (prompt, n_new, sampling (seed, row, temperature, top_p) or None)
REQUESTS = [
    ([5, 9, 2, 77, 3, 1, 8, 40, 41, 6, 7], 9, None),
    ([100, 3], 6, None),
    ([1, 2, 3, 4, 5, 6], 12, (11, 0, 0.8, 0.9)),
    ([9, 9, 9, 9, 9, 9, 9, 9, 9], 7, (11, 1, 1.3, 1.0)),
    ([42] * 15, 5, (3, 0, 0.5, 0.7)),
]


def _run_concurrently(submit):
    out = [None] * len(REQUESTS)

    def one(i):
        out[i] = submit(*REQUESTS[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(REQUESTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


def test_server_tokens_match_reference_server(models):
    jcfg, tcfg, jparams, tparams = models
    jserver = JaxServer(jparams, jcfg, slots=2, pages=24, page_size=4,
                        prefill_chunk=4, prefix_cache=False, overlap="off",
                        window=4)
    tserver = PagedGenerationServer(tparams, tcfg, slots=2, pages=24,
                                    page_size=4, prefill_chunk=4, window=4,
                                    prefix_cache=False, device="cpu")
    try:
        def jsub(prompt, n_new, s):
            sampling = None
            if s is not None:
                seed, row, t, p = s
                sampling = (jax.random.fold_in(jax.random.PRNGKey(seed), row),
                            jnp.float32(t), jnp.float32(p))
            return jserver.submit(prompt, n_new, sampling=sampling)

        def tsub(prompt, n_new, s):
            sampling = None
            if s is not None:
                seed, row, t, p = s
                sampling = (row_key_data(seed, row), t, p)
            return tserver.submit(prompt, n_new, sampling=sampling)

        want = _run_concurrently(jsub)
        got = _run_concurrently(tsub)
        assert got == want
        # Each request alone returns the same tokens (no co-tenant effect).
        assert tsub(*REQUESTS[2]) == got[2]
        stats = tserver.stats()
        assert stats["requests_done"] == len(REQUESTS) + 1
        assert stats["windows"] > 0 and stats["decode_steps"] > 0
        acct = stats["page_accounting"]
        assert acct["free"] == acct["pages_total"]
    finally:
        jserver.close()
        tserver.close()


def test_greedy_server_equals_forward_argmax(models):
    _, tcfg, _, tparams = models
    server = PagedGenerationServer(tparams, tcfg, slots=2, pages=24,
                                   page_size=4, prefill_chunk=3, window=8,
                                   device="cpu")
    try:
        prompt = [7, 1, 2, 99, 4]
        out = server.submit(prompt, 10)
        logits = forward(tparams, torch.tensor([out]), tcfg)
        assert out[len(prompt):] == \
            logits[0, len(prompt) - 1:-1].argmax(-1).tolist()
    finally:
        server.close()


def test_stop_token_cancel_drain_and_busy(models):
    _, tcfg, _, tparams = models
    long_cfg = dataclasses.replace(tcfg, max_seq=1024)
    server = PagedGenerationServer(tparams, long_cfg, slots=1, pages=300,
                                   page_size=4, prefill_chunk=4, window=2,
                                   device="cpu")
    try:
        full = server.submit([3, 4, 5], 12)
        gen = full[3:]
        stop = gen[4]
        cut = server.submit([3, 4, 5], 12, stop_token=stop)
        assert cut[3:] == gen[:gen.index(stop) + 1]
        # A long stream holds the only slot: a second request times out
        # as busy; the cancelled stream then ends in RequestCancelled.
        stream = server.submit_stream([1, 2], 1000)
        assert isinstance(next(stream), int)
        with pytest.raises(ServerBusy):
            server.submit([1], 2, timeout=0.05)
        stream.cancel()
        with pytest.raises(RequestCancelled):
            list(stream)
        assert len(server.submit([1], 2)) == 3
        assert server.stats()["active"] == 0
        with pytest.raises(ValueError):
            server.submit([1] * 1020, 20)  # past max_seq
    finally:
        server.close(drain=True)
    with pytest.raises(ServerClosed):
        server.submit([1], 2)


BODIES = [
    {"tokens": [[1, 2, 3]], "n_new": 4},
    {"tokens": [[1, 2], [3, 4]], "n_new": 2, "temperature": 0.7,
     "top_p": 0.9, "seed": 5},
    {"tokens": [[1]], "n_new": 1, "priority": "batch", "deadline_ms": 50},
    {"tokens": [[1]], "stream": True},
    {},
    {"tokens": []},
    {"tokens": [[]]},
    {"tokens": [[1, 2], [3]]},
    {"tokens": [[1]] * 9},
    {"tokens": [[1]], "n_new": "x"},
    {"tokens": [[1]], "n_new": 0},
    {"tokens": [[1] * 60], "n_new": 10},
    {"tokens": [[1.5]]},
    {"tokens": [[True]]},
    {"tokens": [[1]], "temperature": True},
    {"tokens": [[1]], "seed": 1.0},
    {"tokens": [[1]], "temperature": -1},
    {"tokens": [[1]], "top_p": 0},
    {"tokens": [[1]], "top_p": 1.5},
    {"tokens": [[1]], "stream": "yes"},
    {"tokens": [[1]], "speculative": 2},
    {"tokens": [[1]], "speculative": 17},
    {"tokens": [[1]], "speculative": 2, "stream": True},
    {"tokens": [[1]], "priority": ""},
    {"tokens": [[1]], "deadline_ms": 0},
]


@pytest.mark.parametrize("paged", [True, False])
def test_request_parser_matches_reference(paged):
    tcfg = types.SimpleNamespace(max_seq=64)

    def outcome(parse, doc):
        try:
            return ("ok", parse(doc, tcfg, max_rows=8, paged=paged))
        except ValueError as e:
            return ("error", str(e))

    for doc in BODIES:
        assert outcome(_parse_generate_request, doc) == \
            outcome(jax_parse, doc), doc


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip_on_cpu(tmp_path):
    cfg = ServeConfig(preset="probe", n_layers=1, max_seq=64,
                      payload_serving="paged", serving_slots=2, serving_prefill_chunk=8,
                      serving_window=4, state_dir=str(tmp_path))
    rt = boot_serve(cfg, device="cpu", dtype="float32", seed=3,
                    host="127.0.0.1", port=0)
    try:
        base = f"http://127.0.0.1:{rt.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200
        code, doc = _post(base + "/generate",
                          {"tokens": [[1, 2, 3], [600, 5, 6]], "n_new": 5})
        assert code == 200, doc
        assert doc["n_new"] == 5 and doc["restored_step"] is None
        assert [r[:3] for r in doc["tokens"]] == [[1, 2, 3], [88, 5, 6]]
        assert all(len(r) == 8 for r in doc["tokens"])
        sampled = {"tokens": [[4, 5]], "n_new": 6, "temperature": 0.9,
                   "top_p": 0.95, "seed": 17}
        code, a = _post(base + "/generate", sampled)
        code2, b = _post(base + "/generate", sampled)
        # Each response carries its own minted request id; the rest of
        # a seeded sampled request repeats exactly.
        assert a.pop("request_id") != b.pop("request_id")
        assert code == code2 == 200 and a == b
        assert _post(base + "/generate", {"tokens": [[1]], "n_new": 0})[0] \
            == 400
        assert _post(base + "/generate", {"tokens": [[1]],
                                          "priority": "vip"})[0] == 400
        assert _post(base + "/nope", {"tokens": [[1]]})[0] == 404
        # Streaming: per-token records for both rows, then the summary,
        # which equals the buffered answer to the same request.
        body = {"tokens": [[1, 2, 3], [600, 5, 6]], "n_new": 5,
                "stream": True}
        req = urllib.request.Request(base + "/generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(ln) for ln in r.read().splitlines()]
        *tokens, summary = lines
        assert summary["done"] is True and summary["tokens"] == doc["tokens"]
        for row in (0, 1):
            assert [x["token"] for x in tokens if x["row"] == row] == \
                doc["tokens"][row][3:]
    finally:
        rt.close()


def test_entry_points_need_a_card_unless_cpu_is_asked(models, monkeypatch):
    _, tcfg, _, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeRuntime(ServeConfig(preset="probe"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--preset", "probe", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(tcfg, slots=1, pages=4, page_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedGenerationServer(tparams, tcfg, slots=1, pages=4, page_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(tparams, [[1, 2]], tcfg, n_new=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(tcfg, 1)
    # Asked for, the CPU runs all of them.
    PagedKVCache(tcfg, slots=1, pages=4, page_size=4, device="cpu")
    PagedGenerationServer(tparams, tcfg, slots=1, pages=4, page_size=4,
                          device="cpu").close()
    assert generate(tparams, [[1, 2]], tcfg, n_new=2,
                    device="cpu").shape == (1, 4)


def test_config_reads_the_reference_toml_names_and_refuses_the_rest():
    cfg = ServeConfig.parse(
        '[model]\npreset = "flagship"\n'
        '[payload]\nkind = "serve"\nserving = "paged"\nseq = 2048\n'
        'serving_slots = 4\nserving_page_size = 16\nserving_window = 64\n'
        'serving_prefill_chunk = 64\nserving_kv_dtype = "int8"\n'
        'paged_attention = "gather"\n[status]\nport = 9000\n')
    tcfg = cfg.model_config()
    assert (tcfg.vocab, tcfg.d_model, tcfg.n_layers, tcfg.max_seq) == \
        (32000, 512, 8, 2048)
    assert tcfg.paged_attention == "gather" and cfg.status_port == 9000
    assert ServeConfig().model_config().paged_attention == "auto"
    # [payload] serving reads as the reference's: "" is the contiguous
    # backend, the default; serving_overlap defaults to "auto".
    assert ServeConfig().payload_serving == "" and \
        ServeConfig().serving_overlap == "auto"
    assert cfg.payload_serving == "paged" and cfg.serving_overlap == "auto"
    for value in ("", "contiguous", "paged"):
        assert ServeConfig.parse(
            f'[payload]\nserving = "{value}"\n').payload_serving == value
    for value in ("auto", "on", "off"):
        assert ServeConfig.parse(
            f'[payload]\nserving_overlap = "{value}"\n'
        ).serving_overlap == value
    assert ServeConfig.parse('[payload]\nserving_bundle = true\n'
                             ).serving_bundle is True
    assert ServeConfig.parse('[payload]\nserving_window = "auto"\n'
                             ).serving_window == "auto"
    for text, match in [
        ('[payload]\nserving_bundle = 1\n', "serving_bundle"),
        ('[payload]\nserving_window = "fast"\n', "serving_window"),
        ('[mesh]\naxes = {data = 3}\n[distributed]\nnum_processes = 2\n',
         "mesh"),
        ('[model]\npreset = "huge"\n', "preset"),
        ('[payload]\nserving = "ragged"\n', "serving must be"),
        ('[payload]\nserving_overlap = "sometimes"\n', "serving_overlap"),
        ('[payload]\nserving_kv_dtype = "fp8"\n', "kv_dtype"),
        ('[model]\nn_heads = 3\n', "invalid"),
        ('[payload\n', "TOML"),
    ]:
        with pytest.raises(RuntimeConfigError, match=match):
            ServeConfig.parse(text).model_config()


def test_port_imports_with_jax_and_kvedge_tpu_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'kvedge_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import kvedge_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    kvedge_torch.__path__, 'kvedge_torch.')]\n"
        "assert 'kvedge_torch.models.decode' in mods, mods\n"
        "assert 'kvedge_torch.models.speculative' in mods, mods\n"
        "assert 'kvedge_torch.models.moe' in mods, mods\n"
        "for new in ('tracing', 'slo', 'autotune', 'debuglock', 'status',\n"
        "            'boot', 'probes', 'profiling', 'healthcheck',\n"
        "            'sliceserve'):\n"
        "    assert 'kvedge_torch.runtime.' + new in mods, mods\n"
        "for new in ('bootdoc', 'mount', 'commands', 'entrypoint'):\n"
        "    assert 'kvedge_torch.bootstrap.' + new in mods, mods\n"
        "for new in ('version', 'utils.gojson', 'config.values',\n"
        "            'render.names', 'render.bootconfig', 'render.emit',\n"
        "            'render.helmlite', 'render.manifests',\n"
        "            'testing.fakecluster', 'testing.faults',\n"
        "            'analysis', 'analysis.locklint', 'testing.chaos',\n"
        "            'data.feeder', 'parallel', 'parallel.distributed',\n"
        "            'parallel.mesh', 'parallel.sharding',\n"
        "            'parallel.ringattention', 'parallel.ulysses',\n"
        "            'parallel.pipeline', 'parallel.pipeline1f1b',\n"
        "            'parallel.launch',\n"
        "            'testing.world', 'testing.parallelcases',\n"
        "            'testing.slicecases', 'testing.servingfaults'):\n"
        "    assert 'kvedge_torch.' + new in mods, mods\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'kvedge_tpu') and sys.modules[k]]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def _booted_cfg(state_dir, **kw):
    return ServeConfig(preset="probe", n_layers=1, max_seq=64,
                       payload_serving="paged", serving_slots=2,
                       serving_prefill_chunk=8, serving_window=4,
                       state_dir=str(state_dir), **kw)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serve_runtime_with_a_port_boots_and_counts_boots(tmp_path):
    beats = []
    for want in (1, 2):
        rt = boot_serve(_booted_cfg(tmp_path), device="cpu",
                        dtype="float32", seed=3, host="127.0.0.1", port=0)
        try:
            assert rt.handle.boot_count == want
            assert rt.http is rt.handle.server and rt.port > 0
            beat = json.loads((tmp_path / "heartbeat.json").read_text())
            assert beat["boot_count"] == want and beat["payload"] == "serve"
            beats.append(beat["seq"])
            code, doc = _post(f"http://127.0.0.1:{rt.port}/generate",
                              {"tokens": [[1, 2, 3]], "n_new": 4})
            assert code == 200 and len(doc["tokens"][0]) == 7
            assert rt.stats()["requests_total"] == 1
            assert rt.payload_fn().runtime is rt
        finally:
            rt.close()
        # Closed: the status server is down.
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{rt.port}/version",
                                   timeout=5)
    assert beats[1] > beats[0]


def test_booted_status_and_healthz_are_start_runtimes(tmp_path):
    from kvedge_torch.runtime.boot import start_runtime

    volatile = {"uptime_s", "heartbeat_seq", "heartbeat_age_s",
                "boot_count", "init_events"}
    docs = []
    for name in ("serve_runtime", "start_runtime"):
        cfg = _booted_cfg(tmp_path / name)
        if name == "serve_runtime":
            rt = boot_serve(cfg, device="cpu", dtype="float32", seed=3,
                            host="127.0.0.1", port=0)
            port, close = rt.port, rt.close
        else:
            handle = start_runtime(dataclasses.replace(
                cfg, payload="serve", status_port=0, status_bind="127.0.0.1",
                expected_platform="cpu"), device="cpu", dtype="float32",
                seed=3)
            port, close = handle.status_port, handle.shutdown
        try:
            base = f"http://127.0.0.1:{port}"
            health = _get(base + "/healthz")
            code, status = _get(base + "/status")
            assert code == 200 and status["payload"] == "serve"
            status = {k: v for k, v in status.items() if k not in volatile}
            status["check"].pop("probe_ms")
            serving = status.pop("serving")
            docs.append((health, status, sorted(serving),
                         serving["requests_total"]))
        finally:
            close()
    assert docs[0] == docs[1]
    assert docs[0][0] == (200, {"status": "ok"})


def test_booted_runtime_serves_profile(tmp_path):
    rt = boot_serve(_booted_cfg(tmp_path), device="cpu", dtype="float32",
                    seed=3, host="127.0.0.1", port=0)
    try:
        base = f"http://127.0.0.1:{rt.port}"
        assert _get(base + "/profile/traces") == (200, {"traces": []})
        code, doc = _post(base + "/profile?seconds=0.05", {})
        assert code == 200, doc
        code, listed = _get(base + "/profile/traces")
        assert code == 200 and len(listed["traces"]) == 1
        code, doc = _post(base + "/generate",
                          {"tokens": [[4, 5]], "n_new": 3})
        assert code == 200 and len(doc["tokens"][0]) == 5
    finally:
        rt.close()


def test_status_server_is_built_in_boot_only():
    hits = sorted(
        str(p.relative_to(REPO)) for p in (REPO / "kvedge_torch").rglob("*.py")
        if "StatusServer(" in p.read_text())
    assert hits == ["kvedge_torch/runtime/boot.py"]
