"""Cases a gloo world runs for the multi-process ``serve`` payload
(``testing/world.run_world``): every rank boots the payload from the
same TOML through ``runtime/serve.run_serve_payload``; rank 0 answers
the requests, the other ranks replay its op stream (or its contiguous
relay) and answer ``/generate`` with a 503. Each rank returns numpy
results for the caller to hold against the JAX package and against one
process."""

from __future__ import annotations

import torch


def _drain(doc):
    """A streamed response's final tokens."""
    final = None
    for item in doc["_stream"]:
        if "done" in item:
            final = item
    return final["tokens"]


def _paged_state(cache) -> dict:
    """This rank's device tables, lengths and pools, on the host."""
    st = cache.state
    return {"tables": cache._tables_full.numpy().copy(),
            "lengths": cache._lengths_full.numpy().copy(),
            "pool_k": st.pool_k.float().numpy().copy(),
            "pool_v": st.pool_v.float().numpy().copy(),
            "model_index": cache.mesh.index("model")}


def serve_cases(cases: list) -> list:
    """``{"toml", "params" (a numpy tree, or None for the checkpoint),
    "requests": [POST /generate bodies]}``, or ``{"toml", "kind":
    "train" | "inference-probe"}``, in order on every rank, at fp32 on
    the CPU. A serve case returns ``{"backend", "tokens" (rank 0: each
    request's rows), "follower_error" (elsewhere: the 503's type),
    "restored_step"}``, and on the paged backend the rank's state after
    the requests (tables, lengths, pools) plus, on rank 0, every head of
    every page gathered by a swap-out."""
    from kvedge_torch.parallel.distributed import rank
    from kvedge_torch.runtime import probes, train
    from kvedge_torch.runtime.config import RuntimeConfig
    from kvedge_torch.runtime.serve import run_serve_payload

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
        if kind == "inference-probe":
            out = probes.run_inference_probe(cfg, "cpu", "float32")
            results.append({"ok": out.ok, "error": out.error,
                            "checksum": out.probe_checksum})
            continue
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
                    doc.update(_paged_state(cache))
                    gathered = cache.swapout_pages(range(cache.num_pages))
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
                doc.update(_paged_state(serve_fn.cache))
        results.append(doc)
    return results
