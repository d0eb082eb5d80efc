"""The port's native shard reader (``data/native.py``) and the loader's
``backend`` argument, against ``np.load`` and the JAX package's loader.

``fill_batch`` equals ``np.load`` slices for uint16, uint32 and int32
shards; the port loader's batches under ``"native"``, ``"numpy"`` and
``"auto"`` equal each other and the JAX ``ShardedTokenLoader``'s across
shard boundaries, with rank striding and after ``restore()``;
``"auto"`` moves to numpy on a shard the C++ parser cannot read, where
``"native"`` raises; and a failed build makes ``"native"`` raise with
the compiler's message while ``"auto"`` settles on numpy.
"""

import numpy as np
import pytest

from mamba_distributed_tpu.data.loader import ShardedTokenLoader as JaxLoader
from mamba_distributed_tpu_torch.data import native
from mamba_distributed_tpu_torch.data.loader import ShardedTokenLoader

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("nshards")
    rng = np.random.default_rng(0)
    np.save(d / "tok_train_000.npy", rng.integers(0, 60000, 8192).astype(np.uint16))
    np.save(d / "tok_train_001.npy", rng.integers(0, 100000, 4096).astype(np.uint32))
    np.save(d / "tok_val_000.npy", rng.integers(0, 1000, 4096).astype(np.int32))
    return str(d)


@pytest.fixture
def built():
    if not native.available():
        pytest.fail(f"the native shard reader did not build: {native.unavailable_reason()}")


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.int32])
def test_fill_batch_equals_np_load(tmp_path, built, dtype):
    data = np.random.default_rng(1).integers(0, 50000, 4097).astype(dtype)
    path = tmp_path / "t.npy"
    np.save(path, data)
    s = native.NativeShard(str(path))
    assert len(s) == 4097
    ref = np.load(path).astype(np.int32)
    for pos, B, T in ((0, 4, 1024), (17, 3, 100), (4096 - 64, 1, 64)):
        x, y = s.fill_batch(pos, B, T)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, ref[pos:pos + B * T].reshape(B, T))
        np.testing.assert_array_equal(y, ref[pos + 1:pos + B * T + 1].reshape(B, T))
    with pytest.raises(IndexError):
        s.fill_batch(0, 4097, 1)  # needs 4098 tokens
    s.close()


def _run(loader, n):
    return [loader.next_batch() for _ in range(n)]


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3)])
def test_backends_equal_each_other_and_jax(shard_dir, built, rank, world):
    kw = dict(B=2, T=64, data_dir=shard_dir, split="train", process_rank=rank,
              num_processes=world, master_process=False)
    loaders = {b: ShardedTokenLoader(backend=b, **kw) for b in ("native", "numpy", "auto")}
    assert {b: ld.backend for b, ld in loaders.items()} == {
        "native": "native", "numpy": "numpy", "auto": "native"}
    ref = _run(JaxLoader(backend="numpy", **kw), 120)  # crosses both shards, twice
    for b, ld in loaders.items():
        got = _run(ld, 120)
        for (gx, gy), (rx, ry) in zip(got, ref):
            np.testing.assert_array_equal(gx, rx, err_msg=b)
            np.testing.assert_array_equal(gy, ry, err_msg=b)
        ld.close()


def test_restore_resumes_bit_identical(shard_dir, built):
    kw = dict(B=2, T=32, data_dir=shard_dir, split="train", master_process=False)
    a = ShardedTokenLoader(backend="native", **kw)
    _run(a, 97)  # past the first shard boundary
    st = a.state()
    expect = _run(a, 40)
    for backend in ("native", "numpy", "auto"):
        b = ShardedTokenLoader(backend=backend, **kw)
        b.restore(st)
        for (ex, ey), (gx, gy) in zip(expect, _run(b, 40)):
            np.testing.assert_array_equal(ex, gx)
            np.testing.assert_array_equal(ey, gy)
        b.close()
    a.close()


def test_auto_moves_to_numpy_on_an_unparsable_shard(tmp_path, built):
    """int64 shards are outside the C++ parser's set: "auto" takes numpy
    for the loader, "native" raises."""
    np.save(tmp_path / "tok_train_000.npy", np.arange(4096, dtype=np.int64))
    kw = dict(B=2, T=16, data_dir=str(tmp_path), split="train", master_process=False)
    auto = ShardedTokenLoader(backend="auto", **kw)
    assert auto.backend == "numpy"
    x, _ = auto.next_batch()
    np.testing.assert_array_equal(x.reshape(-1), np.arange(32))
    with pytest.raises(OSError):
        ShardedTokenLoader(backend="native", **kw)
    with pytest.raises(ValueError, match="backend"):
        ShardedTokenLoader(backend="mmap", **kw)


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """The reader's source replaced by one that does not compile, built
    into an empty directory."""
    bad = tmp_path / "shard_reader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    yield
    native._load.cache_clear()


def test_native_raises_when_the_build_fails(shard_dir, broken_build):
    kw = dict(B=2, T=16, data_dir=shard_dir, split="train", master_process=False)
    with pytest.warns(UserWarning, match="unavailable"):
        assert not native.available()
    assert "g++ failed for shard_reader.cc" in native.unavailable_reason()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ShardedTokenLoader(backend="native", **kw)
    auto = ShardedTokenLoader(backend="auto", **kw)
    assert auto.backend == "numpy"
    auto.close()
