"""The port's ``train`` / ``eval`` payloads, their config and feeder, and
``serve`` restoring what ``train`` wrote.

The feeder is held to the reference's ``PyTokenFeeder`` byte for byte
(corpus file, batch order, ``start_batch``, sharding, wrap). The
payloads run through ``python -m kvedge_torch`` in a subprocess on the
CPU (``--device cpu``) at a tiny width; ``serve`` then restores the
checkpoint and its greedy tokens equal the naive forward pass's argmax
over the restored params at fp32.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from kvedge_tpu.config.runtime_config import RuntimeConfig as JaxRuntimeConfig
from kvedge_tpu.data import feeder as jfeed
from kvedge_torch.cli import main
from kvedge_torch.data import feeder as tfeed
from kvedge_torch.models.transformer import forward
from kvedge_torch.models.weights import params_from_numpy
from kvedge_torch.runtime import train as tpay
from kvedge_torch.runtime.config import RuntimeConfig, RuntimeConfigError
from kvedge_torch.runtime.serve import ServeRuntime

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
STEPS = 4


def test_feeder_batches_are_byte_identical_to_the_reference(tmp_path):
    tokens = np.random.default_rng(0).integers(0, 50000, 1003)
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    tfeed.write_corpus(ours, tokens)
    jfeed.write_corpus(theirs, tokens)
    assert ours.read_bytes() == theirs.read_bytes()
    assert tfeed.read_corpus_header(ours) == 1003
    # Wrap modulo the corpus, a resume point, and a shard of a wider batch.
    for kw in (dict(batch=3, seq=64), dict(batch=4, seq=40, start_batch=7),
               dict(batch=2, seq=16, start_batch=5, global_batch=6,
                    shard_offset=2)):
        t = tfeed.open_feeder(ours, **kw)
        j = jfeed.PyTokenFeeder(theirs, **kw)
        for _ in range(12):
            got, want = next(t), next(j)
            assert got.dtype == want.dtype == np.int32
            assert got.tobytes() == want.tobytes(), kw
    (tmp_path / "bad.bin").write_bytes(b"NOTAFEED" + bytes(8))
    with pytest.raises(ValueError, match="magic"):
        tfeed.read_corpus_header(tmp_path / "bad.bin")
    with pytest.raises(ValueError, match="shard"):
        tfeed.open_feeder(ours, batch=4, seq=8, global_batch=4, shard_offset=1)
    with pytest.raises(ValueError, match="smaller than one sequence"):
        tfeed.open_feeder(ours, batch=1, seq=1003)


def test_config_reads_the_reference_names_and_defaults():
    text = ('[runtime]\nstate_dir = "/s"\ncheckpoint_dir = "/c"\n'
            '[model]\npreset = "flagship"\n'
            '[payload]\nkind = "train"\ncorpus = "/s/c.bin"\n'
            'eval_corpus = "/s/e.bin"\nsteps = 30\nbatch = 64\nseq = 512\n'
            'checkpoint_every = 10\nattention = "flash"\n')
    ours, theirs = RuntimeConfig.parse(text), JaxRuntimeConfig.parse(text)
    for field, theirs_field in (
            ("state_dir", "state_dir"), ("checkpoint_dir", "checkpoint_dir"),
            ("train_corpus", "train_corpus"), ("eval_corpus", "eval_corpus"),
            ("train_steps", "train_steps"), ("train_batch", "train_batch"),
            ("max_seq", "train_seq"),
            ("train_checkpoint_every", "train_checkpoint_every"),
            ("payload_attention", "payload_attention")):
        assert getattr(ours, field) == getattr(theirs, theirs_field), field
    defaults, ref = RuntimeConfig(), JaxRuntimeConfig()
    assert (defaults.state_dir, defaults.train_steps, defaults.train_batch,
            defaults.max_seq, defaults.train_checkpoint_every) == \
        (ref.state_dir, ref.train_steps, ref.train_batch, ref.train_seq,
         ref.train_checkpoint_every)
    tcfg = ours.model_config()
    assert (tcfg.attention, tcfg.max_seq, tcfg.remat, tcfg.vocab) == \
        ("flash", 512, True, 32000)
    assert RuntimeConfig().model_config().attention == "naive"


@pytest.mark.parametrize("text,match", [
    ('[payload]\nkind = "train"\ncorpus = "c"\nlearning_rate = 1.0\n',
     "learning_rate"),
    # A zero heartbeat interval (the key is read since the port boots as
    # the reference does; 5.0 parses, see the test below).
    ('[runtime]\nheartbeat_interval_s = 0.0\n',
     "heartbeat_interval_s must be > 0"),
    ('[payload]\nkind = "train"\n', "requires corpus"),
    ('[payload]\nkind = "eval"\n', "requires corpus"),
    # The reference's kinds and message.
    ('[payload]\nkind = "probe"\n', "kind must be one of"),
    ('[payload]\nattention = "sparse"\n', "attention must be one of"),
    ('[payload]\nsteps = 0\ncorpus = "c"\n', "steps must be positive"),
    ('[payload]\nbatch = -1\n', "train_batch"),
    ('[runtime]\nstate_dir = 3\n', "state_dir"),
    # [tpu] is read (platform and expected_chips); any other key of it
    # is refused by name.
    ('[tpu]\nplatform = "tpu"\nchips = 4\n', "tpu"),
])
def test_config_refuses_unknown_keys_and_bad_values(text, match):
    with pytest.raises(RuntimeConfigError, match=match):
        RuntimeConfig.parse(text)


@pytest.mark.parametrize("text,field,want", [
    ('[runtime]\nheartbeat_interval_s = 5.0\n', "heartbeat_interval_s", 5.0),
    ('[tpu]\nplatform = "tpu"\n', "expected_platform", "tpu"),
    ('[tpu]\nexpected_chips = 2\n', "expected_chips", 2),
])
def test_config_reads_the_boot_keys_it_once_refused(text, field, want):
    """Keys the port refused before it booted as the reference does; a
    platform or chip count the card cannot give degrades the boot."""
    assert getattr(RuntimeConfig.parse(text), field) == want


def test_ring_attention_is_refused_at_the_model():
    cfg = RuntimeConfig.parse('[payload]\nattention = "ring"\n')
    with pytest.raises(RuntimeConfigError, match="sequence-parallel"):
        cfg.model_config()


def _toml(tmp, **payload) -> pathlib.Path:
    corpus = tmp / "corpus.bin"
    if not corpus.exists():
        tfeed.write_corpus(corpus, np.random.default_rng(1).integers(
            0, 1000, 5000))
    fields = dict(kind="train", corpus=str(corpus), seq=40, batch=2,
                  steps=STEPS, checkpoint_every=2, attention="flash")
    fields.update(payload)
    lines = ["[runtime]", f'state_dir = "{tmp / "state"}"', "[model]",
             "vocab = 128", "d_model = 64", "n_heads = 4", "n_layers = 2",
             "d_ff = 128", "[payload]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in fields.items()]
    # Every entry point starts the runtime and its status server: an
    # ephemeral port, so no two runs contend for the default one.
    lines += ["[status]", "port = 0", 'bind = "127.0.0.1"']
    path = tmp / "x.toml"
    path.write_text("\n".join(lines) + "\n")
    return path


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "kvedge_torch", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train`` then ``eval`` through the CLI on the CPU."""
    tmp = tmp_path_factory.mktemp("payload")
    toml = _toml(tmp)
    train = _cli("train", "--config", str(toml), "--device", "cpu",
                 "--dtype", "float32", cwd=tmp)
    evaluate = _cli("eval", "--config", str(toml), "--device", "cpu",
                    "--dtype", "float32", cwd=tmp)
    return tmp, toml, train, evaluate


def test_train_then_eval_through_the_cli(trained):
    tmp, _, train, evaluate = trained
    assert train.returncode == 0, train.stderr
    doc = json.loads(train.stdout.strip().splitlines()[-1])
    assert doc["ok"] and doc["step"] == STEPS and doc["resumed_from"] is None
    progress = tpay.read_train_progress(str(tmp / "state"))
    assert progress["step"] == STEPS and progress["target_steps"] == STEPS
    assert progress["loss"] == pytest.approx(doc["loss"], abs=1e-6)
    ckpt = tmp / "state" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["2", "4"]
    assert evaluate.returncode == 0, evaluate.stderr
    lines = evaluate.stdout.splitlines()
    assert any("WARNING: no [payload] eval_corpus" in ln for ln in lines)
    line = next(ln for ln in lines if ln.startswith(
        "[kvedge-eval] checkpoint_step="))
    assert line.startswith(f"[kvedge-eval] checkpoint_step={STEPS} "
                           f"batches={STEPS} held_out=False loss=")
    result = json.loads(lines[-1])
    assert result["ok"] and np.isfinite(result["loss"])
    assert f"ppl={np.exp(result['loss']):.2f}" in line


def test_a_rerun_past_its_target_resumes_and_returns(trained):
    tmp, toml, _, _ = trained
    again = _cli("train", "--config", str(toml), "--device", "cpu",
                 "--dtype", "float32", cwd=tmp)
    assert again.returncode == 0, again.stderr
    doc = json.loads(again.stdout.strip().splitlines()[-1])
    assert doc["ok"] and doc["resumed_from"] == STEPS and doc["step"] == STEPS


def test_serve_restores_the_trained_checkpoint(trained):
    tmp, toml, _, _ = trained
    cfg = dataclasses.replace(RuntimeConfig.parse(toml.read_text()),
                              payload="serve", payload_serving="paged")
    rt = ServeRuntime(cfg, device="cpu", dtype="float32")
    try:
        assert rt.restored_step == STEPS
        step, tree = tpay.restore_latest_params(cfg, rt.tcfg)
        assert step == STEPS
        weights = params_from_numpy(tree, rt.tcfg, "cpu")
        prompt = [5, 17, 99, 3]
        doc = rt.serve_fn({"tokens": [prompt], "n_new": 6})
        assert doc["restored_step"] == STEPS
        seq = list(prompt)
        for _ in range(6):
            logits = forward(weights, torch.tensor([seq]), rt.tcfg)
            seq.append(int(logits[0, -1].argmax()))
        assert doc["tokens"] == [seq]
    finally:
        rt.close()


def test_a_diverged_run_fails_the_payload(tmp_path, monkeypatch):
    from kvedge_torch.models import training

    real = training.loss_fn
    monkeypatch.setattr(training, "loss_fn",
                        lambda p, b, c, m=None: real(p, b, c, m) * float("nan"))
    cfg = RuntimeConfig.parse(_toml(tmp_path, steps=2).read_text())
    result = tpay.run_train_payload(cfg, device="cpu", dtype="float32")
    assert not result.ok and result.error.startswith("training diverged")
    assert tpay.read_train_progress(cfg.state_dir)["loss"] is None


def test_train_and_eval_need_a_card_unless_the_cpu_is_asked_for(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    toml = _toml(tmp_path)
    cfg = RuntimeConfig.parse(toml.read_text())
    for run in (tpay.run_train_payload, tpay.run_eval_payload):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(cfg)
    for cmd in ("train", "eval"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([cmd, "--config", str(toml)])
    assert not (tmp_path / "state").exists()
