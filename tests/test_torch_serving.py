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
from kvedge_torch.models.serving import (
    PagedGenerationServer,
    RequestCancelled,
    ServerBusy,
    ServerClosed,
)
from kvedge_torch.models.transformer import forward
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime.config import RuntimeConfigError, ServeConfig
from kvedge_torch.runtime.serve import (
    ServeRuntime,
    _parse_generate_request,
    main,
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
                                    page_size=4, prefill_chunk=4, window=4)
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
                                   page_size=4, prefill_chunk=3, window=8)
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
                                   page_size=4, prefill_chunk=4, window=2)
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


def test_http_round_trip_on_cpu():
    cfg = ServeConfig(preset="probe", n_layers=1, max_seq=64,
                      serving_slots=2, serving_prefill_chunk=8,
                      serving_window=4)
    rt = ServeRuntime(cfg, device="cpu", dtype="float32", seed=3,
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


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeRuntime(ServeConfig(preset="probe"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--preset", "probe", "--port", "0"])


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
    for text, match in [
        ('[payload]\nserving_speculative = 4\n', "serving_speculative"),
        ('[payload]\nserving_window = "auto"\n', "serving_window"),
        ('[mesh]\naxes = {data = 1}\n', "mesh"),
        ('[model]\npreset = "huge"\n', "preset"),
        ('[payload]\nserving = "contiguous"\n', "paged"),
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
    assert int(proc.stdout.strip()) >= 13
