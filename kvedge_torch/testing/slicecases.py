"""Cases a gloo world runs for the multi-process ``serve`` payload
(``testing/world.run_world``): every rank boots the payload from the
same TOML through ``runtime/serve.run_serve_payload``; rank 0 answers
the requests, the other ranks replay its op stream (or its contiguous
relay) and answer ``/generate`` with a 503. Each rank returns numpy
results for the caller to hold against the JAX package and against one
process."""

from __future__ import annotations

import contextlib
import warnings

import torch


def _drain(doc):
    """A streamed response's final tokens."""
    final = None
    for item in doc["_stream"]:
        if "done" in item:
            final = item
    return final["tokens"]


def _paged_state(cache) -> dict:
    """This rank's device tables, lengths and pools (its heads of its
    layers), on the host, with its coordinates on the axes that cut
    them."""
    st = cache.state
    return {"tables": cache._tables_full.numpy().copy(),
            "lengths": cache._lengths_full.numpy().copy(),
            "pool_k": st.pool_k.float().numpy().copy(),
            "pool_v": st.pool_v.float().numpy().copy(),
            "model_index": cache.mesh.index("model"),
            "stage_index": cache.mesh.index("stage"),
            "expert_index": cache.mesh.index("expert")}


@contextlib.contextmanager
def _state_at_swapout(into: dict):
    """Fill ``into`` with this rank's :func:`_paged_state` as each
    swap-out reaches it, just before it runs: after the last one, the
    state the requests left. A follower is read there because the
    swap-in it replays next writes the leader's bytes into its pool."""
    from kvedge_torch.runtime.sliceserve import SlicePagedKVCache

    plain = SlicePagedKVCache._exec_swapout

    def exec_swapout(self, ids):
        into.update(_paged_state(self))
        return plain(self, ids)

    SlicePagedKVCache._exec_swapout = exec_swapout
    try:
        yield
    finally:
        SlicePagedKVCache._exec_swapout = plain


def _moe_block(cfg, case) -> dict:
    """``moe.moe_ffn_dropless`` on this rank's experts of the case's
    full ``router``, ``w_up`` and ``w_down`` (one layer's), over the
    mesh of ``[mesh]``: its output on the case's rows ``x``."""
    import numpy as np

    from kvedge_torch.models.moe import moe_ffn_dropless
    from kvedge_torch.parallel.mesh import build_mesh

    mesh = build_mesh(cfg.mesh)
    n = case["w_up"].shape[0] // mesh.size("expert")
    mine = slice(mesh.index("expert") * n, (mesh.index("expert") + 1) * n)
    with torch.no_grad():
        out = moe_ffn_dropless(
            torch.from_numpy(case["x"]), torch.from_numpy(case["router"]),
            torch.from_numpy(np.ascontiguousarray(case["w_up"][mine])),
            torch.from_numpy(np.ascontiguousarray(case["w_down"][mine])),
            top_k=case["top_k"], mesh=mesh)
    return {"out": out.numpy(), "expert_index": mesh.index("expert")}


def serve_cases(cases: list) -> list:
    """``{"toml", "params" (a numpy tree, or None for the checkpoint),
    "requests": [POST /generate bodies]}``, ``{"toml", "kind": "train"
    | "inference-probe"}``, or ``{"toml", "kind": "moe-block", "x",
    "router", "w_up", "w_down", "top_k"}`` (:func:`_moe_block`), in
    order on every rank, at fp32 on the CPU; a serve case with
    ``"warnings_error"`` boots with a ``RuntimeWarning`` an error. A
    serve case returns ``{"backend", "tokens" (rank 0: each request's
    rows), "follower_error" (elsewhere: the 503's type),
    "restored_step"}``, and on the paged backend the rank's state after
    the requests (tables, lengths, pools; read on every rank as the
    leader's swap-out of every page reaches it), on rank 0 every head of
    every layer of every page that swap-out gathered (over ``model`` and
    ``stage``), and under ``"after"`` the rank's state read again once
    the leader swapped the gathered pages back in."""
    from kvedge_torch.runtime import probes, train
    from kvedge_torch.runtime.config import RuntimeConfig

    torch.set_num_threads(1)
    results = []
    for case in cases:
        cfg = RuntimeConfig.parse(case["toml"])
        kind = case.get("kind", "serve")
        if kind == "train":
            out = train.run_train_payload(cfg, device="cpu", dtype="float32")
            results.append({"ok": out.ok, "error": out.error,
                            "loss": out.loss})
            continue
        if kind == "moe-block":
            results.append(_moe_block(cfg, case))
            continue
        if kind == "inference-probe":
            out = probes.run_inference_probe(cfg, "cpu", "float32")
            results.append({"ok": out.ok, "error": out.error,
                            "checksum": out.probe_checksum})
            continue
        before = {}
        with _state_at_swapout(before):
            results.append(_serve_case(cfg, case, before))
    return results


def _serve_case(cfg, case: dict, before: dict) -> dict:
    """One serve case on this rank (:func:`serve_cases`); ``before`` is
    filled by :func:`_state_at_swapout`."""
    from kvedge_torch.parallel.distributed import rank
    from kvedge_torch.runtime.serve import run_serve_payload

    with warnings.catch_warnings():
        if case.get("warnings_error"):
            warnings.simplefilter("error", RuntimeWarning)
        check, serve_fn = run_serve_payload(cfg, "cpu", "float32",
                                            params=case.get("params"))
    doc = {"ok": check.ok, "error": check.error,
           "backend": serve_fn.stats()["backend"]}
    if rank() == 0:
        rt = serve_fn.runtime
        doc["restored_step"] = rt.restored_step
        doc["tokens"] = [
            _drain(out) if "_stream" in out else out["tokens"]
            for out in (serve_fn(body) for body in case["requests"])]
        if rt.server is not None:
            cache = rt.server._cache
            with rt.server.device_quiet():
                cache._flush_ops()
                gathered = cache.swapout_pages(range(cache.num_pages))
                # Written back, each rank keeps its own heads of its own
                # layers: the state read after equals the one before.
                cache.swapin_pages(range(cache.num_pages), gathered)
                cache._flush_ops()
                doc["after"] = _paged_state(cache)
            doc["gathered_k"], doc["gathered_v"] = (
                t.float().numpy() for t in gathered[:2])
            doc["slice_op_ms"] = serve_fn.stats().get("slice_op_ms")
        serve_fn.close()
    else:
        try:
            serve_fn({"tokens": [[1, 2]], "n_new": 1})
        except Exception as e:
            doc["follower_error"] = type(e).__name__
        serve_fn.join(timeout=120)
        if serve_fn.cache is not None:
            doc["after"] = _paged_state(serve_fn.cache)
    doc.update(before)
    return doc
