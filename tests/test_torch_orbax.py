"""``tools/orbax_torch.py``: JAX-written orbax checkpoints into the port's
layout and back (ROADMAP Queue A item 6).

* The JAX package's train payload writes an orbax checkpoint; the tool
  converts it; the port's ``serve`` payload restores it, and its greedy
  ``POST /generate`` tokens equal the JAX ``serve`` payload's on the same
  checkpoint (both bf16, as both payloads serve).
* The reverse: the port's train payload writes its checkpoint, the tool
  converts it to orbax, and the JAX ``serve`` payload's tokens equal the
  port's on the port's checkpoint.
* A port train run resumes from the converted step, with the optimizer
  state carried across (count, mu, nu), and converting back gives the
  same tree.
* A configured model that does not match the checkpoint is refused with
  the reference's ``_verify_template`` message, in both directions.
"""

import dataclasses
import importlib.util
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from kvedge_torch.data.feeder import write_corpus
from kvedge_torch.runtime import train as torch_train
from kvedge_torch.runtime.boot import start_runtime
from kvedge_torch.runtime.checkpoint import StateCheckpointer
from kvedge_torch.runtime.config import RuntimeConfig
from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxConfig
from kvedge_tpu.runtime.workload import run_serve_payload, run_train_payload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1, 8]]
N_NEW = 8


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_torch", os.path.join(REPO, "tools", "orbax_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _toml(root, state, ckpt, steps=4, n_layers=0):
    return (
        "[runtime]\n"
        'name = "orbax"\n'
        f'state_dir = "{root / state}"\n'
        f'checkpoint_dir = "{root / ckpt}"\n'
        "[tpu]\n"
        'platform = "cpu"\n'
        "[model]\n"
        f"n_layers = {n_layers}\n"
        "[status]\n"
        "port = 0\n"
        'bind = "127.0.0.1"\n'
        "[payload]\n"
        'kind = "train"\n'
        f'corpus = "{root / "corpus.kvfeed"}"\n'
        f"steps = {steps}\n"
        "batch = 8\n"
        "seq = 32\n"
        "checkpoint_every = 2\n"
    )


def _write(root, name, text):
    path = root / name
    path.write_text(text)
    return str(path)


def _jax_tokens(text):
    check, serve_fn = run_serve_payload(
        dataclasses.replace(JaxConfig.parse(text), payload="serve"))
    assert check.ok, check.error
    return [serve_fn({"tokens": [p], "n_new": N_NEW})["tokens"][0]
            for p in PROMPTS]


def _port_tokens(text):
    cfg = dataclasses.replace(RuntimeConfig.parse(text), payload="serve")
    handle = start_runtime(cfg, device="cpu")
    try:
        assert handle.check.ok, handle.check.error
        out = []
        for p in PROMPTS:
            req = urllib.request.Request(
                f"http://127.0.0.1:{handle.status_port}/generate",
                data=json.dumps({"tokens": [p], "n_new": N_NEW}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out.append(json.loads(r.read())["tokens"][0])
        return out
    finally:
        handle.shutdown()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX-trained orbax checkpoint converted to the port's layout, and
    a port-trained checkpoint converted to orbax."""
    root = tmp_path_factory.mktemp("orbax")
    rng = np.random.default_rng(5)
    write_corpus(root / "corpus.kvfeed",
                 rng.integers(0, 512, size=8000, dtype=np.int32))
    tool = _tool()
    jax_text = _toml(root, "jax-state", "jax-ckpt")
    result = run_train_payload(JaxConfig.parse(jax_text))
    assert result.ok, result.error
    path = _write(root, "jax.toml", jax_text)
    assert tool.orbax_to_torch(jax_text, str(root / "jax-ckpt"),
                               str(root / "from-jax")) == 4
    torch_text = _toml(root, "torch-state", "torch-ckpt")
    result = torch_train.run_train_payload(RuntimeConfig.parse(torch_text),
                                           device="cpu")
    assert result.ok, result.error
    assert tool.main(["--config", path, "--from-torch",
                      str(root / "torch-ckpt"), "--to-orbax",
                      str(root / "from-torch")]) == 0
    return root, tool


def test_jax_checkpoint_serves_the_same_tokens_through_the_port(trained):
    root, _ = trained
    want = _jax_tokens(_toml(root, "jax-serve", "jax-ckpt"))
    got = _port_tokens(_toml(root, "port-serve", "from-jax"))
    assert got == want
    assert all(len(t) == len(p) + N_NEW for t, p in zip(got, PROMPTS))


def test_port_checkpoint_serves_the_same_tokens_through_jax(trained):
    root, _ = trained
    want = _port_tokens(_toml(root, "port-serve-2", "torch-ckpt"))
    got = _jax_tokens(_toml(root, "jax-serve-2", "from-torch"))
    assert got == want


def test_a_port_run_resumes_from_the_converted_step(trained):
    root, tool = trained
    text = _toml(root, "resume-state", "from-jax", steps=6)
    result = torch_train.run_train_payload(RuntimeConfig.parse(text),
                                           device="cpu")
    assert result.ok, result.error
    assert (result.resumed_from, result.step, len(result.losses)) == (4, 6, 2)
    ckpt = StateCheckpointer("", checkpoint_dir=str(root / "from-jax"))
    assert ckpt.steps()[-2:] == [4, 6]
    # The optimizer state crossed: the count continued from the JAX run.
    opt = torch.load(os.path.join(ckpt.directory, "6", "opt_state.pt"),
                     weights_only=True)
    assert int(opt["count"]) == 6


def test_round_trip_is_the_identity(trained, tmp_path):
    """orbax -> port -> orbax -> port gives the first port tree back."""
    root, tool = trained
    text = _toml(root, "x", "x")
    tool.torch_to_orbax(text, str(root / "torch-ckpt"), str(tmp_path / "o"))
    tool.orbax_to_torch(text, str(tmp_path / "o"), str(tmp_path / "t"))
    a = StateCheckpointer("", checkpoint_dir=str(root / "torch-ckpt"))
    b = StateCheckpointer("", checkpoint_dir=str(tmp_path / "t"))
    assert a.latest_step() == b.latest_step() == 4
    for name in ("params.pt", "opt_state.pt"):
        x = torch.load(os.path.join(a.directory, "4", name),
                       weights_only=True)
        y = torch.load(os.path.join(b.directory, "4", name),
                       weights_only=True)
        assert x.keys() == y.keys()
        for key in x:
            assert torch.equal(x[key], y[key]), key


@pytest.mark.parametrize("direction", ["from-orbax", "from-torch"])
def test_a_mismatched_model_is_refused(trained, tmp_path, direction):
    root, tool = trained
    text = _toml(root, "x", "x", n_layers=3)
    if direction == "from-orbax":
        convert, src = tool.orbax_to_torch, root / "jax-ckpt"
    else:
        convert, src = tool.torch_to_orbax, root / "torch-ckpt"
    with pytest.raises(ValueError, match="checkpoint shape mismatch") as e:
        convert(text, str(src), str(tmp_path / "out"))
    assert "the configured model does not match the checkpointed one" in \
        str(e.value)
    assert not (tmp_path / "out").exists()
