"""The port's native C++ packer (nsa_vibe_tpu_torch/native) against its
Python packer and the JAX package's packer (after tests/test_native_packer.py).

The JAX side builds its own packer.cpp with its own build function into
a temporary directory (its cached library is not in git), so nothing is
written into the JAX package.
"""

import itertools

import numpy as np
import pytest

from nsa_vibe_tpu import native as jnative
from nsa_vibe_tpu.train import data as jdata
from nsa_vibe_tpu_torch import native
from nsa_vibe_tpu_torch.train import data as tdata


@pytest.fixture(scope="module")
def jax_packer(tmp_path_factory):
    """The JAX package's native packer, built into a temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_HERE", str(tmp_path_factory.mktemp("jax_native")))
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", False)
        assert jnative.native_available()
        yield


def _take(it, n):
    return list(itertools.islice(it, n))


def _equal(*runs):
    assert all(len(r) == len(runs[0]) > 0 for r in runs)
    for batches in zip(*runs):
        for b in batches:
            assert b.dtype == np.int32 and b.shape == batches[0].shape
            np.testing.assert_array_equal(b, batches[0])


def test_port_library_builds_in_the_port_build_directory():
    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-3:] == ("nsa_vibe_tpu_torch", "_build", "native")


def test_native_matches_python_packing(jax_packer):
    def docs():
        return itertools.islice(tdata.synthetic_docs(0), 32)

    _equal(_take(tdata.pack_token_stream(docs(), seq_len=64, batch_size=4), 8),
           _take(tdata.pack_token_stream_native(docs(), seq_len=64, batch_size=4), 8),
           _take(jdata.pack_token_stream_native(docs(), seq_len=64, batch_size=4), 8))


def test_native_text_feed_roundtrip():
    p = native.ByteStreamPacker(seq_len=7, batch_size=1)
    p.feed("hello world, hello world!")   # 25 bytes -> 3 full rows of 8
    assert p.ready == 3
    np.testing.assert_array_equal(p.next_batch()[0], tdata.tokenize_bytes("hello wo"))
    p.close()


def test_native_empty_and_partial():
    p = native.ByteStreamPacker(seq_len=16, batch_size=2)
    assert p.next_batch() is None
    p.feed(b"x" * 10)
    assert p.ready == 0 and p.buffered_tokens == 10
    p.close()


@pytest.mark.parametrize("source", ["synthetic", "local"])
def test_make_batches_native_matches_python_and_jax(jax_packer, tmp_path, source):
    if source == "local":
        path = tmp_path / "c.jsonl"
        path.write_text("\n".join('{"text": "%s"}' % ("doc %d é " % i * 13) for i in range(9)))
        source, n, kw = str(path), 100, dict(epochs=1)
    else:
        n, kw = 5, dict(seed=3)
    runs = [_take(tdata.make_batches(source, 16, 2, native=nat, **kw), n)
            for nat in (False, True, None)]
    runs.append(_take(jdata.make_batches(source, 16, 2, native=True, **kw), n))
    _equal(*runs)


def test_without_a_compiler_native_raises_and_auto_packs_in_python(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="native packer unavailable"):
        next(tdata.make_batches("synthetic", 32, 4, seed=3, native=True))
    _equal(_take(tdata.make_batches("synthetic", 32, 4, seed=3, native=None), 3),
           _take(tdata.make_batches("synthetic", 32, 4, seed=3, native=False), 3))
    assert list(tmp_path.iterdir()) == []
