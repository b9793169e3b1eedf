"""tpudist_torch's data layer against the JAX package's: the sampler index
for index, each rank's loader rows and validity mask against tpudist's
global batch over a W-device data mesh, the stacked stream, the native
gather pool and IDX reader, the datasets bit for bit, and the device
prefetch contract.  Exact equality throughout (integer indices and the
same float32 arrays); no tolerance."""

import gzip
import struct
import threading
import types

import numpy as np
import pytest
import torch

from tpudist_torch import _native
from tpudist_torch.data import (
    DevicePrefetch,
    ShardedLoader,
    ShardedSampler,
    device_prefetch,
    ragged_embedding_batches,
)
from tpudist_torch.data import mnist, native


@pytest.fixture(scope="module")
def ref():
    """The JAX package's data layer (imported here, so the card's run of
    this file's ``cuda`` test needs no JAX)."""
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    from tpudist.data import mnist as jmnist
    from tpudist.data.loader import ShardedLoader
    from tpudist.data.sampler import ShardedSampler
    from tpudist.data.synthetic import ragged_embedding_batches
    from tpudist.runtime.mesh import data_mesh

    return types.SimpleNamespace(
        mnist=jmnist, Loader=ShardedLoader, Sampler=ShardedSampler,
        ragged=ragged_embedding_batches, data_mesh=data_mesh)


@pytest.mark.parametrize("n,world", [(10, 4), (16, 4), (7, 3), (5, 1)])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_sampler_equals_tpudist(ref, n, world, shuffle, drop_last):
    for shard in range(world):
        for epoch in (0, 3):
            kw = dict(shuffle=shuffle, seed=11, drop_last=drop_last)
            want = ref.Sampler(n, world, shard, **kw).indices(epoch)
            got = ShardedSampler(n, world, shard, **kw).indices(epoch)
            np.testing.assert_array_equal(got, want)


def test_sampler_rejects_bad_shard():
    with pytest.raises(ValueError, match="out of range"):
        ShardedSampler(10, 2, 2)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_rank_rows_and_mask_are_tpudists_shard(ref, world, shuffle,
                                               drop_last):
    """Rank r of W gets rows r·local : (r+1)·local of the global batch
    tpudist assembles over a W-device data mesh, and that slice of its
    validity mask (N = 250 pads 6 rows over 4 shards at drop_last=False)."""
    n, gb = 250, 32
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    y = np.arange(n, dtype=np.int32)
    jl = ref.Loader([x, y], gb, ref.data_mesh(world), shuffle=shuffle,
                    seed=5, drop_last=drop_last)
    ranks = [ShardedLoader([x, y], gb, shuffle=shuffle, seed=5,
                           drop_last=drop_last, num_shards=world, shard=r,
                           device="cpu") for r in range(world)]
    local = gb // world
    assert all(ld.steps_per_epoch == jl.steps_per_epoch for ld in ranks)
    for epoch in (0, 2):
        streams = [list(ld.epoch(epoch)) for ld in ranks]
        for step, (gx, gy) in enumerate(jl.epoch(epoch)):
            gx, gy = np.asarray(gx), np.asarray(gy)
            mask = jl.valid_mask(step)
            rows = len(gy) // world
            for r, ld in enumerate(ranks):
                bx, by = streams[r][step]
                assert isinstance(bx, torch.Tensor) and bx.device.type == "cpu"
                sl = slice(r * rows, (r + 1) * rows)
                np.testing.assert_array_equal(bx.numpy(), gx[sl])
                np.testing.assert_array_equal(by.numpy(), gy[sl])
                np.testing.assert_array_equal(ld.valid_mask(step), mask[sl])
                assert rows <= local
    if not drop_last:
        assert sum(int(ld.valid_mask(s).sum()) for ld in ranks
                   for s in range(ld.steps_per_epoch)) == n


def test_epoch_stacked_equals_single_steps():
    ds = mnist.synthetic_mnist("train", n=448)  # 7 steps of 64
    ld = ShardedLoader([ds.images, ds.labels], 64, shuffle=True,
                       device="cpu")
    singles = list(ld.epoch(3))
    stacked = list(ld.epoch_stacked(3, n_steps=3))
    assert ld.stacked_groups(3) == len(stacked) == 2
    for g, group in enumerate(stacked):
        for i, arr in enumerate(group):
            assert arr.shape[:2] == (3, 64)
            for s in range(3):
                assert torch.equal(arr[s], singles[g * 3 + s][i])
    tail = list(ld.epoch(3, start_step=6))
    assert len(tail) == 1 and torch.equal(tail[0][1], singles[6][1])


@pytest.fixture(scope="module")
def pool():
    if not native.available():
        pytest.skip("g++ could not build native/dataload.cpp here")
    p = native.GatherPool(threads=4)
    yield p
    p.close()


def test_native_library_builds_into_the_ports_build_dir():
    if not native.available():
        pytest.skip("g++ could not build native/dataload.cpp here")
    path = _native.lib_path()
    assert path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == \
        "tpudist_torch"


def test_gather_matches_numpy_fancy_indexing(pool):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((1000, 7, 3)).astype(np.float32)
    b = rng.integers(0, 9, 1000).astype(np.int32)
    idx = rng.integers(0, 1000, 600)
    ga, gb = pool.gather([a, b], idx)
    np.testing.assert_array_equal(ga, a[idx])
    np.testing.assert_array_equal(gb, b[idx])
    with pytest.raises(ValueError, match="C-contiguous"):
        pool.gather([a[:, 0]], idx)
    with pytest.raises(IndexError):
        pool.gather([b], np.array([1000]))


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_through_the_pool_equals_numpy(shuffle):
    if not native.available():
        pytest.skip("g++ could not build native/dataload.cpp here")
    ds = mnist.synthetic_mnist("train", n=300)
    args = ([ds.images, ds.labels], 32)
    kw = dict(shuffle=shuffle, drop_last=False, device="cpu")
    plain = ShardedLoader(*args, **kw)
    pooled = ShardedLoader(*args, prefetch=3, **kw)
    assert pooled.pool is not None and not pooled.thread_prefetch
    for a, b in zip(plain.epoch(1), pooled.epoch(1), strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(plain.epoch_stacked(1, 4), pooled.epoch_stacked(1, 4),
                    strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert pooled.pool.jobs > 0
    # an abandoned epoch reaps its in-flight jobs
    it = pooled.epoch(0)
    next(it)
    it.close()
    assert not pooled.pool._pending


def _write_idx(path, arr, gz=False):
    code = {np.uint8: 0x08, np.int32: 0x0C}[arr.dtype.type]
    head = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    data = head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    (gzip.open if gz else open)(path, "wb").write(data)


@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_equals_tpudists(ref, tmp_path, gz):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (20, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 20).astype(np.uint8)
    sfx = ".gz" if gz else ""
    _write_idx(tmp_path / f"t10k-images-idx3-ubyte{sfx}", imgs, gz)
    _write_idx(tmp_path / f"t10k-labels-idx1-ubyte{sfx}", labels, gz)
    got = mnist.load_mnist_idx(tmp_path, "test")
    want = ref.mnist.load_mnist_idx(tmp_path, "test")
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.shape == (20, 28, 28, 1)
    if not gz and native.available():
        np.testing.assert_array_equal(
            native.read_idx_native(tmp_path / "t10k-images-idx3-ubyte"), imgs)


@pytest.mark.parametrize("split", ["train", "test"])
def test_datasets_bit_equal_tpudists(ref, split):
    for got, want in ((mnist.synthetic_mnist(split, n=300, seed=4),
                       ref.mnist.synthetic_mnist(split, n=300, seed=4)),
                      (mnist.load_real_digits(split),
                       ref.mnist.load_real_digits(split))):
        assert got.images.dtype == want.images.dtype == np.float32
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.name == want.name and len(got) == len(want)
    assert mnist.MNIST_MEAN == ref.mnist.MNIST_MEAN
    assert mnist.MNIST_STD == ref.mnist.MNIST_STD


def test_load_mnist_falls_back_to_synthetic(tmp_path, monkeypatch):
    monkeypatch.delenv("TPUDIST_MNIST_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    ds = mnist.load_mnist("test", data_dir=str(tmp_path), n=50)
    assert ds.name == "synthetic-mnist-test" and len(ds) == 50


def test_ragged_embedding_batches_equal_tpudists(ref):
    for got, want in zip(ragged_embedding_batches(3, 7, seed=9),
                         ref.ragged(3, 7, seed=9), strict=True):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---- device prefetch: tpudist's contract ----------------------------------

@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_identity_and_order(device):
    items = [(np.full((4,), i, np.float32),) for i in range(10)]
    out = list(device_prefetch(iter(items), depth=3, device=device))
    assert len(out) == 10
    for i, (a,) in enumerate(out):
        if device == "cpu":
            assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(np.asarray(a), items[i][0])


def test_prefetch_depth_zero_is_synchronous():
    main = threading.get_ident()
    tids = []

    def put(x):
        tids.append(threading.get_ident())
        return x

    pf = DevicePrefetch(iter([1, 2, 3]), depth=0, put=put)
    assert pf._thread is None and list(pf) == [1, 2, 3]
    assert tids == [main] * 3
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetch(iter([]), depth=-1)


def test_prefetch_put_runs_on_the_worker_thread():
    main = threading.get_ident()
    tids = []

    def put(x):
        tids.append(threading.get_ident())
        return x * 2

    assert list(device_prefetch(iter([1, 2, 3]), depth=2, put=put)) == \
        [2, 4, 6]
    assert tids and all(t != main for t in tids)


def test_prefetch_source_exception_in_order():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    it = device_prefetch(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_early_break_closes_the_source():
    closed = threading.Event()

    def gen():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.set()

    for i in device_prefetch(gen(), depth=2):
        if i == 3:
            break
    assert closed.wait(5.0)


def test_loader_thread_prefetch_without_native(monkeypatch):
    """Without the native pool, ``prefetch > 0`` runs the stream ahead on
    a Python thread, with the batches of the synchronous loader."""
    monkeypatch.setattr(native, "available", lambda: False)
    ds = mnist.synthetic_mnist("train", n=200)
    plain = ShardedLoader([ds.images, ds.labels], 32, shuffle=True,
                          device="cpu")
    ahead = ShardedLoader([ds.images, ds.labels], 32, shuffle=True,
                          prefetch=2, device="cpu")
    assert ahead.pool is None and ahead.thread_prefetch
    for a, b in zip(plain.epoch(0), ahead.epoch(0), strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_loader_needs_a_device_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedLoader([np.zeros((4, 1))], 2)


@pytest.mark.cuda
def test_cuda_prefetch_batches_survive_buffer_reuse():
    """On the card: the producer overwrites its one host buffer after each
    yield and the consumer keeps the card busy before reading, so a batch
    read before its side-stream copy landed, or whose memory the
    allocator handed to a later copy, would show another batch's value."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (side-stream copies)")
    buf = np.zeros((256, 1024), np.float32)

    def producer():
        for i in range(32):
            buf[:] = i
            yield (buf,)

    kept = []
    for i, (x,) in enumerate(device_prefetch(producer(), depth=3,
                                             device="cuda")):
        torch.cuda._sleep(2_000_000)        # the step still runs ...
        assert x.device.type == "cuda"
        assert bool((x == i).all()), i      # ... when its batch is read
        kept.append(x if i % 2 else None)
        del x
    torch.cuda.synchronize()
    for i, x in enumerate(kept):
        if x is not None:
            assert bool((x == i).all()), i
