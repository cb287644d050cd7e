"""The port's native feeder (``kvedge_torch/data/feeder.py``: the
repository's ``native/kvedge-feed.cc`` built with this machine's g++
into ``build/kvedge_torch/`` and loaded through ``ctypes``) and the
CLI's ``corpus`` command, against the port's numpy feeder and the JAX
package's feeder and CLI.

* Native batches equal ``PyTokenFeeder``'s and the reference's, past
  one epoch (wrap-around), resumed at ``start_batch``, and as shards
  whose rows reassemble the whole batch.
* Bad inputs are rejected at open, as the reference's tests require,
  and the options past ``seq`` are keyword-only.
* ``open_feeder`` returns the native feeder, and warns and falls back to
  the numpy one when the library does not build.
* ``python -m kvedge_torch corpus`` writes the reference command's
  bytes, train and held-out files, and refuses what it refuses with its
  messages.
"""

import pathlib
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest

from kvedge_tpu import cli as jcli
from kvedge_tpu.data import feeder as jfeed
from kvedge_torch import cli
from kvedge_torch.data import feeder as feed

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "corpus.kvfeed"
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 32000, size=1000, dtype=np.int32)
    feed.write_corpus(path, tokens)
    return path, tokens


def test_library_builds_from_the_repo_source_into_the_ports_build_dir():
    lib = feed._build_native()
    assert lib.parent == feed.BUILD_DIR and lib.exists()
    assert lib.name.startswith("libkvedge-feed-") and lib.suffix == ".so"
    assert feed._build_native() == lib == feed._library_path()
    assert feed._load_native() is not None


@pytest.mark.parametrize("batch,seq,depth", [(4, 16, 3), (1, 7, 1),
                                             (3, 333, 4)])
def test_native_matches_numpy_and_reference(corpus, batch, seq, depth):
    path, _ = corpus
    with feed.TokenFeeder(path, batch, seq, depth=depth) as native:
        ours = feed.PyTokenFeeder(path, batch, seq)
        theirs = jfeed.PyTokenFeeder(path, batch, seq)
        assert native.n_tokens == ours.n_tokens == theirs.n_tokens == 1000
        for step in range(64):  # far past one epoch: wrap-around
            got = next(native)
            assert got.dtype == np.int32 and got.shape == (batch, seq + 1)
            np.testing.assert_array_equal(got, next(ours),
                                          err_msg=f"batch {step}")
            np.testing.assert_array_equal(got, next(theirs),
                                          err_msg=f"batch {step}")


def test_native_resume_is_exact(corpus):
    path, _ = corpus
    with feed.TokenFeeder(path, batch=2, seq=8) as a:
        for _ in range(7):
            next(a)
        want = next(a)
    with feed.TokenFeeder(path, batch=2, seq=8, start_batch=7) as b:
        np.testing.assert_array_equal(next(b), want)
    ref = jfeed.PyTokenFeeder(path, batch=2, seq=8, start_batch=7)
    np.testing.assert_array_equal(next(ref), want)


@pytest.mark.parametrize("start", [0, 3])
def test_native_shards_reassemble_the_global_batch(corpus, start):
    path, _ = corpus
    B, P, seq = 8, 2, 16
    whole = jfeed.PyTokenFeeder(path, B, seq, start_batch=start)
    shards = [feed.TokenFeeder(path, B // P, seq, start_batch=start,
                               global_batch=B, shard_offset=p * (B // P))
              for p in range(P)]
    try:
        for _ in range(6):
            got = np.concatenate([next(s) for s in shards], axis=0)
            np.testing.assert_array_equal(got, next(whole))
    finally:
        for s in shards:
            s.close()


@pytest.mark.parametrize("cls", [feed.TokenFeeder, feed.PyTokenFeeder])
def test_bad_inputs_rejected_at_open(tmp_path, corpus, cls):
    path, _ = corpus
    bad = tmp_path / "bad.kvfeed"
    bad.write_bytes(b"NOTAFEED" + b"\x00" * 100)
    with pytest.raises(ValueError, match="magic"):
        cls(bad, batch=1, seq=8)
    tiny = tmp_path / "tiny.kvfeed"
    feed.write_corpus(tiny, np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError, match="sequence"):
        cls(tiny, batch=1, seq=8)
    short = tmp_path / "short.kvfeed"
    feed.write_corpus(short, np.arange(100, dtype=np.int32))
    short.write_bytes(short.read_bytes()[:-40])       # 10 tokens cut
    with pytest.raises(ValueError):
        cls(short, batch=1, seq=8)
    huge = tmp_path / "huge.kvfeed"
    huge.write_bytes(struct.pack("<8sQ", b"KVFEED01", 2**62)
                     + b"\x00" * 64)
    with pytest.raises(ValueError):
        cls(huge, batch=1, seq=8)
    with pytest.raises(ValueError, match="shard"):
        cls(path, 4, 16, global_batch=4, shard_offset=1)
    with pytest.raises(ValueError, match="shard"):
        cls(path, 4, 16, global_batch=2, shard_offset=0)


def test_close_is_idempotent_and_ends_iteration(corpus):
    path, _ = corpus
    f = feed.TokenFeeder(path, batch=2, seq=8)
    next(f)
    f.close()
    f.close()
    with pytest.raises(StopIteration):
        next(f)
    del f  # __del__ after close is a no-op


def test_open_feeder_is_native_and_falls_back_loudly(corpus, monkeypatch):
    path, _ = corpus
    with feed.open_feeder(path, batch=4, seq=16) as f:
        assert isinstance(f, feed.TokenFeeder)
        np.testing.assert_array_equal(
            next(f), next(jfeed.PyTokenFeeder(path, 4, 16)))

    def broken():
        raise subprocess.CalledProcessError(2, ["make"], stderr=b"no g++")

    monkeypatch.setattr(feed, "_lib", None)
    monkeypatch.setattr(feed, "_build_native", broken)
    with pytest.warns(RuntimeWarning, match="native feeder unavailable.*"
                                            "no g\\+\\+"):
        f = feed.open_feeder(path, batch=4, seq=16, start_batch=2)
    assert isinstance(f, feed.PyTokenFeeder)
    np.testing.assert_array_equal(
        next(f), next(jfeed.PyTokenFeeder(path, 4, 16, start_batch=2)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the negative is cached: no repeat
        assert isinstance(feed.open_feeder(path, 4, 16), feed.PyTokenFeeder)
    with pytest.raises(RuntimeError, match="native feeder library"):
        feed.TokenFeeder(path, 4, 16)


@pytest.mark.parametrize("make", [feed.TokenFeeder, feed.PyTokenFeeder,
                                  feed.open_feeder],
                         ids=["native", "numpy", "open_feeder"])
def test_options_past_seq_are_keyword_only(corpus, make):
    # The reference's fourth positional is ``depth``; here it would have
    # been ``start_batch``, so a positional call is refused outright.
    path, _ = corpus
    with pytest.raises(TypeError):
        make(path, 2, 8, 4)


CORPUS_ARGS = [
    ["--random", "5000", "--seed", "7"],
    ["--random", "5000", "--seed", "7", "--holdout", "0.1"],
    ["--random", "3000", "--seed", "0", "--vocab", "32000"],
]


@pytest.mark.parametrize("args", CORPUS_ARGS,
                         ids=["random", "holdout", "vocab"])
def test_corpus_command_writes_the_references_bytes(tmp_path, capsys, args):
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    assert cli.main(["corpus", "--out", str(ours), *args]) == 0
    our_err = capsys.readouterr().err
    assert jcli.main(["corpus", "--out", str(theirs), *args]) == 0
    their_err = capsys.readouterr().err
    assert ours.read_bytes() == theirs.read_bytes()
    assert our_err.replace("ours", "theirs") == their_err
    if "--holdout" in args:
        assert (tmp_path / "ours.bin.eval").read_bytes() == \
            (tmp_path / "theirs.bin.eval").read_bytes()
    # The file is a corpus the native feeder reads.
    with feed.open_feeder(ours, batch=2, seq=64) as f:
        assert next(f).shape == (2, 65)


def test_corpus_from_tokens_and_refusals_match_the_reference(tmp_path,
                                                             capsys):
    words = tmp_path / "ids.txt"
    words.write_text("5 6 7\n8\n9 10 " + " ".join(map(str, range(300))))
    cases = [
        ["--from-tokens", str(words)],
        ["--from-tokens", str(words), "--holdout", "0.5"],
        [],
        ["--random", "10", "--from-tokens", str(words)],
        ["--random", "0"],
        ["--random", "100", "--holdout", "0.5"],
        ["--random", "1000", "--holdout", "1.5"],
    ]
    empty = tmp_path / "empty.txt"
    empty.write_text(" \n")
    junk = tmp_path / "junk.txt"
    junk.write_text("1 2 x")
    neg = tmp_path / "neg.txt"
    neg.write_text("1 -2")
    cases += [["--from-tokens", str(p)] for p in (empty, junk, neg)]
    for i, args in enumerate(cases):
        ours, theirs = tmp_path / f"o{i}.bin", tmp_path / f"t{i}.bin"
        rc = cli.main(["corpus", "--out", str(ours), *args])
        our_err = capsys.readouterr().err
        jrc = jcli.main(["corpus", "--out", str(theirs), *args])
        their_err = capsys.readouterr().err
        assert rc == jrc, (args, our_err, their_err)
        assert our_err.replace(f"o{i}.bin", f"t{i}.bin") == their_err, args
        if rc == 0:
            assert ours.read_bytes() == theirs.read_bytes()


def test_corpus_command_through_the_module_entry_point(tmp_path):
    out = tmp_path / "c.bin"
    proc = subprocess.run(
        [sys.executable, "-m", "kvedge_torch", "corpus", "--out", str(out),
         "--random", "500", "--seed", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip() == f"wrote 500 tokens to {out}"
    assert feed.read_corpus_header(out) == 500
