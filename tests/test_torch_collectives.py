"""The port's host collectives (``tpudist_torch.runtime.collectives``)
against tpudist's.

The first part holds the port to tpudist bit for bit: on the same seeded
trees at world 3 (a thread per rank, each with its own store connection)
the port's results equal tpudist's BITWISE for flat/ring/hier ×
none/bf16/topk, with several buckets, async submissions and a broadcast;
a mixed gang (ranks 0 and 2 the port, rank 1 tpudist) computes the same
bytes as an all-tpudist gang; the bf16 codec rounds as ``ml_dtypes``
does; tensors come back as tensors of their dtype.  The rest are the
twins of ``tests/test_collectives.py`` on the port (tpudist's obs
counters read as the instance's plain counters).
"""

import threading
import time

import numpy as np
import pytest

import torch

from tpudist_torch.runtime import collectives as C
from tpudist_torch.runtime.collectives import (
    CollectiveConfig,
    HostCollectives,
    PeerLost,
)
from tpudist_torch.runtime.coord import CoordClient, CoordServer, Rendezvous


@pytest.fixture(scope="module")
def server():
    try:
        srv = CoordServer(0)
    except Exception:
        pytest.skip("native coordination library unavailable")
    yield srv
    srv.stop()


def _run_world(server, world, fn):
    """Run fn(rank, client) in `world` threads; re-raise any failure."""
    errors = []
    results = [None] * world

    def work(rank):
        try:
            with CoordClient(port=server.port) as client:
                results[rank] = fn(rank, client)
        except Exception as e:  # noqa: BLE001
            errors.append((rank, e))

    threads = [threading.Thread(target=work, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return results


def test_allreduce_sum_and_mean(server):
    world = 3

    def fn(rank, client):
        coll = HostCollectives(client, rank, world, round_id=10)
        tree = {"a": np.full((4,), float(rank + 1)),
                "b": np.arange(6, dtype=np.int64).reshape(2, 3) * (rank + 1)}
        s = coll.allreduce_sum(tree)
        m = coll.allreduce_mean({"x": np.asarray([float(rank)])})
        return s, m

    for s, m in _run_world(server, world, fn):
        np.testing.assert_array_equal(s["a"], np.full((4,), 6.0))
        np.testing.assert_array_equal(
            s["b"], np.arange(6).reshape(2, 3) * 6)
        np.testing.assert_allclose(m["x"], [1.0])


def test_broadcast_from_root(server):
    world = 3

    def fn(rank, client):
        coll = HostCollectives(client, rank, world, round_id=11)
        tree = {"w": np.full((3,), float(rank) + 7.0)}
        return coll.broadcast(tree, root=0)

    for out in _run_world(server, world, fn):
        np.testing.assert_array_equal(out["w"], np.full((3,), 7.0))


def test_back_to_back_broadcasts_with_slow_consumer(server):
    """Broadcast is synchronizing: three broadcasts in a row must all land
    even when a peer is slow to start fetching — without the trailing
    barrier, the root's op-2 key GC would delete payload 0 before the slow
    peer reads it (review finding r2)."""
    import time as _time

    def fn(rank, client):
        coll = HostCollectives(client, rank, 2, round_id=15, timeout_s=20.0)
        outs = []
        for i in range(3):
            if rank == 1 and i == 0:
                _time.sleep(0.5)  # slow joiner
            outs.append(coll.broadcast(
                {"x": np.full((2,), float(i + 10 * rank))}, root=0))
        return outs

    for outs in _run_world(server, 2, fn):
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o["x"], np.full((2,), float(i)))


def test_key_cleanup_stays_bounded(server):
    """Posting op N deletes op N-2: after K allreduces at most 2 keys per
    rank remain, and close_round removes the rest."""
    world = 2

    def fn(rank, client):
        coll = HostCollectives(client, rank, world, round_id=12)
        for _ in range(5):
            coll.allreduce_sum({"x": np.ones(2)})
        return coll

    colls = _run_world(server, world, fn)
    with CoordClient(port=server.port) as probe:
        leftover = probe.keys("coll/12/")
        assert len(leftover) <= 2 * world, leftover
        colls[0].client = probe  # reuse a live connection for cleanup
        colls[0].close_round()
        assert probe.keys("coll/12/") == []


def test_missing_peer_raises_peer_lost(server):
    def fn(rank, client):
        coll = HostCollectives(client, rank, 2, round_id=13, timeout_s=1.0)
        if rank == 1:
            return None  # never posts
        with pytest.raises(PeerLost):
            coll.allreduce_sum({"x": np.ones(1)})
        return True

    assert _run_world(server, 2, fn)[0] is True


def test_on_wait_hook_can_abort(server):
    """The elastic hook: a wait callback raising (as ElasticMonitor.check
    does on membership change) aborts the collective immediately."""

    class Boom(RuntimeError):
        pass

    def raiser():
        raise Boom()

    def fn(rank, client):
        coll = HostCollectives(client, rank, 2, round_id=14, timeout_s=30.0,
                               on_wait=raiser)
        with pytest.raises(Boom):
            coll.allreduce_sum({"x": np.ones(1)})
        return True

    assert _run_world(server, 1, fn)[0] is True


def _tree_bytes(tree: dict) -> bytes:
    return b"".join(np.ascontiguousarray(v).tobytes()
                    for _, v in sorted(tree.items()))


def _ring_cfg(**kw) -> CollectiveConfig:
    base = dict(algorithm="ring", bucket_bytes=2048, compress="none")
    base.update(kw)
    return CollectiveConfig(**base)


class TestRingAllreduce:
    """The bandwidth-optimal path: chunked ring reduce-scatter + star
    all-gather over the store, with and without bf16 wire compression."""

    @pytest.mark.parametrize("compress", ["none", "bf16"])
    def test_replicas_bitwise_identical(self, server, compress):
        """The elastic-grow checksum invariant: every rank's result is
        BITWISE the same tree, across multiple fused buckets and a
        non-divisible chunk split, compression on or off."""
        world = 4
        rid = 20 if compress == "none" else 21
        rng = np.random.default_rng(7)
        trees = [{"w": rng.standard_normal(2000 + 13).astype(np.float32) * (r + 1),
                  "b": rng.standard_normal(5).astype(np.float32) + r}
                 for r in range(world)]

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=rid,
                                   config=_ring_cfg(compress=compress))
            out = coll.allreduce_sum(trees[rank])
            coll.close()
            return out

        results = _run_world(server, world, fn)
        blobs = {_tree_bytes(out) for out in results}
        assert len(blobs) == 1, "replicas diverged"
        assert results[0]["w"].dtype == np.float32

    def test_flat_vs_ring_numerics(self, server):
        """Same data through both algorithms: results agree to float32
        tolerance (addition order differs, values must not)."""
        world = 3
        rng = np.random.default_rng(11)
        trees = [{"g": rng.standard_normal(999).astype(np.float32)}
                 for _ in range(world)]

        def run(rid, algo):
            def fn(rank, client):
                coll = HostCollectives(
                    client, rank, world, round_id=rid,
                    config=CollectiveConfig(algorithm=algo,
                                            bucket_bytes=1024,
                                            compress="none"))
                out = coll.allreduce_sum(trees[rank])
                coll.close()
                return out

            return _run_world(server, world, fn)

        flat = run(22, "flat")
        ring = run(23, "ring")
        # addition order differs between the algorithms; values must agree
        # to f32 reorder tolerance (ULPs on near-zero sums)
        np.testing.assert_allclose(flat[0]["g"], ring[0]["g"],
                                   rtol=1e-5, atol=1e-6)

    def test_bf16_compression_accuracy_and_ratio(self, server):
        """bf16 wire + fp32 accumulation: result within a few percent of
        the f64 reference, and the wire carries about half the bytes."""
        world = 4
        rng = np.random.default_rng(3)
        trees = [{"g": rng.standard_normal(4096).astype(np.float32)}
                 for _ in range(world)]
        ref = sum(t["g"].astype(np.float64) for t in trees)

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=24,
                                   config=_ring_cfg(compress="bf16"))
            out = coll.allreduce_sum(trees[rank])
            posted = coll.bytes_posted
            coll.close()
            return out, posted, coll.compress_ratio

        results = _run_world(server, world, fn)
        out, posted, _ = results[0]
        # normalized L2: bf16 carries ~8 mantissa bits (rel ~4e-3/step);
        # a few wire hops stay well under 5%
        err = (np.linalg.norm(out["g"] - ref)
               / np.linalg.norm(ref))
        assert err < 0.05, f"bf16 error too large: {err}"
        native = trees[0]["g"].nbytes
        # ring posts ~1x the WIRE size per rank; bf16 halves it
        assert posted < 0.6 * native, (posted, native)
        assert results[0][2] == pytest.approx(2.0)

    def test_mixed_dtypes_stay_exact_under_compression(self, server):
        """Compression applies to float32 only: int64 / f64 / bool groups
        ride the wire raw and reduce exactly (the root-election score and
        the legacy allreduce contracts depend on this)."""
        world = 3

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=25,
                                   config=_ring_cfg(compress="bf16",
                                                    bucket_bytes=256))
            out = coll.allreduce_sum({
                "i": np.arange(100, dtype=np.int64) * (rank + 1),
                "d": np.linspace(0.0, 1.0, 77) * (rank + 1),
            })
            coll.close()
            return out

        results = _run_world(server, world, fn)
        np.testing.assert_array_equal(
            results[0]["i"], np.arange(100, dtype=np.int64) * 6)
        assert results[0]["i"].dtype == np.int64
        assert results[0]["d"].dtype == np.float64
        blobs = {_tree_bytes(out) for out in results}
        assert len(blobs) == 1

    def test_grow_and_shrink_rounds_on_ring(self, server):
        """The elastic resize pattern on the ring path: round N at world
        4, shrink to 3, grow back to 4 — fresh HostCollectives per round
        (as the elastic worker builds them), replicas bitwise identical
        in every round."""
        rng = np.random.default_rng(5)
        data = rng.standard_normal(1500).astype(np.float32)

        def run_round(rid, world):
            def fn(rank, client):
                coll = HostCollectives(client, rank, world, round_id=rid,
                                       config=_ring_cfg())
                out = coll.allreduce_sum({"g": data * (rank + 1)})
                coll.close()  # close_round would race peers' AG fetches
                return out

            results = _run_world(server, world, fn)
            assert len({_tree_bytes(o) for o in results}) == 1
            scale = sum(range(1, world + 1))
            np.testing.assert_allclose(results[0]["g"], data * scale,
                                       rtol=1e-4)

        run_round(26, 4)
        run_round(27, 3)  # shrink
        run_round(28, 4)  # grow

    def test_ring_keys_bounded_and_cleaned(self, server):
        """The op-2 GC holds for the ring's multi-key ops: repeated
        allreduces leave a bounded key set, close_round clears it."""
        world = 3

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=29,
                                   config=_ring_cfg(bucket_bytes=512))
            for _ in range(3):
                coll.allreduce_sum({"x": np.ones(600, np.float32) * rank})
            return coll

        colls = _run_world(server, world, fn)
        with CoordClient(port=server.port) as probe:
            after3 = len(probe.keys("coll/29/"))
            # 3 more ops: steady state, the key count must not grow
            def fn2(rank, client):
                coll = colls[rank]
                coll.client = client
                for _ in range(3):
                    coll.allreduce_sum({"x": np.ones(600, np.float32)})
                return True

            _run_world(server, world, fn2)
            assert len(probe.keys("coll/29/")) <= after3
            colls[0].client = probe
            colls[0].close_round()
            assert probe.keys("coll/29/") == []


class TestSharedDeadline:
    def test_peer_dying_mid_ring_fails_within_one_timeout(self, server):
        """Regression (per-chunk deadlines): a peer that posts its first
        reduce-scatter chunk then stops must surface PeerLost after ~one
        timeout_s, not once per remaining chunk/bucket."""
        world, rid, timeout = 3, 30, 1.2
        cfg = CollectiveConfig(algorithm="ring", bucket_bytes=256,
                               compress="none")
        n = 2000  # 8000B f32 -> ~32 buckets of 256B: many pending fetches

        def fn(rank, client):
            tree = {"x": np.full(n, float(rank), np.float32)}
            if rank == 2:
                # the half-dead peer: post step-0 chunks in the real wire
                # format, then stop (a kill -9 between chunk posts)
                buckets, _ = C._fuse([tree["x"]], cfg)
                for bi, b in enumerate(buckets):
                    lo, hi = C._chunk_bounds(len(b.data), world)[rank]
                    client.set(f"coll/{rid}/0/rs/{bi}/0/{rank}",
                               C._encode(b.data[lo:hi], b.wire))
                return None
            coll = HostCollectives(client, rank, world, round_id=rid,
                                   timeout_s=timeout, config=cfg)
            t0 = time.monotonic()
            with pytest.raises(PeerLost):
                coll.allreduce_sum(tree)
            elapsed = time.monotonic() - t0
            coll.close()
            return elapsed

        results = _run_world(server, world, fn)
        for rank in (0, 1):
            assert results[rank] < 2.5 * timeout, (
                f"rank {rank} took {results[rank]:.1f}s — deadline not "
                f"shared across chunks")


class TestFetchOrder:
    def test_flat_fetch_starts_at_right_neighbor(self, server):
        """Anti-hot-spot stagger: each rank's FIRST peer fetch targets
        (rank+1) % world, not rank 0 (reduction order stays rank-ordered
        for bitwise agreement — only the fetch sequence rotates)."""
        world, rid = 3, 31

        class RecordingClient(CoordClient):
            def __init__(self, port):
                super().__init__(port=port)
                self.fetched: list[str] = []

            def get(self, key):
                val = super().get(key)
                if val is not None and key.startswith(f"coll/{rid}/"):
                    self.fetched.append(key)
                return val

        def fn(rank, client):
            rec = RecordingClient(server.port)
            try:
                coll = HostCollectives(
                    rec, rank, world, round_id=rid,
                    config=CollectiveConfig(algorithm="flat"))
                coll.allreduce_sum({"x": np.ones(4, np.float32) * rank})
                first_peer = int(rec.fetched[0].rsplit("/", 1)[1])
                return rank, first_peer
            finally:
                rec.close()

        for rank, first_peer in _run_world(server, world, fn):
            assert first_peer == (rank + 1) % world, (rank, first_peer)


class TestAsyncHandles:
    def test_async_matches_sync_bitwise(self, server):
        """wait() returns exactly the tree the sync call would have, for
        a queue of overlapping submissions, and a sync op after async
        ones drains them (op ids stay agreed)."""
        world, rid = 3, 32
        rng = np.random.default_rng(9)
        payloads = [rng.standard_normal(700).astype(np.float32)
                    for _ in range(4)]

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=rid,
                                   config=_ring_cfg(bucket_bytes=1024))
            handles = [coll.allreduce_sum_async({"g": p * (rank + 1)})
                       for p in payloads]
            outs = [h.wait(30) for h in handles]
            tail = coll.allreduce_sum({"t": np.ones(3, np.float32) * rank})
            coll.close()
            return outs, tail

        results = _run_world(server, world, fn)
        scale = sum(range(1, world + 1))
        for i, p in enumerate(payloads):
            blobs = {results[r][0][i]["g"].tobytes() for r in range(world)}
            assert len(blobs) == 1
            np.testing.assert_allclose(results[0][0][i]["g"], p * scale,
                                       rtol=1e-4)
        np.testing.assert_array_equal(
            results[0][1]["t"], np.full(3, sum(range(world)), np.float32))

    def test_worker_thread_error_reraises_from_wait(self, server):
        """A PeerLost hit on the background worker must surface from
        wait() on the caller's thread, not vanish."""

        def fn(rank, client):
            coll = HostCollectives(client, rank, 2, round_id=33,
                                   timeout_s=1.0, config=_ring_cfg())
            if rank == 1:
                return True  # never participates
            h = coll.allreduce_sum_async(
                {"x": np.ones(50_000, np.float32)})
            with pytest.raises(PeerLost):
                h.wait(15)
            coll.close()
            return True

        assert all(_run_world(server, 2, fn))

    def test_on_wait_hook_raises_through_async_wait(self, server):
        """The elastic WorldChanged path: on_wait raising on the worker
        thread re-raises from Handle.wait()."""

        class Boom(RuntimeError):
            pass

        def raiser():
            raise Boom()

        def fn(rank, client):
            coll = HostCollectives(client, rank, 2, round_id=34,
                                   timeout_s=20.0, on_wait=raiser,
                                   config=_ring_cfg())
            h = coll.allreduce_sum_async({"x": np.ones(9000, np.float32)})
            with pytest.raises(Boom):
                h.wait(15)
            coll.close()
            return True

        assert _run_world(server, 1, fn)[0] is True


class TestCollectiveConfig:
    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("TPUDIST_COLL_ALGO", "ring")
        monkeypatch.setenv("TPUDIST_COLL_BUCKET_BYTES", "8192")
        monkeypatch.setenv("TPUDIST_COLL_COMPRESS", "fp16")
        monkeypatch.setenv("TPUDIST_COLL_FLAT_MAX_BYTES", "128")
        cfg = CollectiveConfig.from_env()
        assert cfg == CollectiveConfig(algorithm="ring", bucket_bytes=8192,
                                       compress="fp16", flat_max_bytes=128)

    def test_defaults(self):
        cfg = CollectiveConfig()
        assert cfg.algorithm == "auto"
        assert cfg.compress == "bf16"

    def test_rejects_unknown_values(self):
        with pytest.raises(ValueError):
            CollectiveConfig(algorithm="tree")
        with pytest.raises(ValueError):
            CollectiveConfig(compress="zstd")

    def test_auto_picks_flat_for_small_and_ring_for_large(self):
        cfg = CollectiveConfig()
        # mirrors _run_allreduce's switch: world<=2 or small payload -> flat
        assert 100 <= cfg.flat_max_bytes
        assert cfg.flat_max_bytes < 4 << 20


_ALGOS = ("flat", "ring", "hier")
_COMPRESS = ("none", "bf16", "topk")


def _hier_cfg(**kw) -> CollectiveConfig:
    base = dict(algorithm="hier", hosts=2, bucket_bytes=1024,
                compress="none")
    base.update(kw)
    return CollectiveConfig(**base)


class TestHierAllreduce:
    """algorithm="hier": intra-host reduce-scatter, cross-host ring over
    one representative rank per host, intra-host all-gather."""

    def test_hier_matches_dense_sum_exactly(self, server):
        """Integer-valued f32 payloads: the three-phase reduction is
        exact, so hier must equal the dense sum bitwise."""
        world = 4

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=40,
                                   config=_hier_cfg())
            out = coll.allreduce_sum(
                {"g": np.arange(700, dtype=np.float32) + rank})
            coll.close()
            return out

        results = _run_world(server, world, fn)
        want = sum(np.arange(700, dtype=np.float32) + r
                   for r in range(world))
        for out in results:
            np.testing.assert_array_equal(out["g"], want)

    def test_cross_host_bytes_meet_host_bound(self, server):
        """THE perf claim: each rank's cross-host wire traffic is
        2(H-1)/H x tree size — a function of HOSTS, not chips (the flat
        ring moves 2(w-1)/w x size per rank)."""
        world, hosts, n = 4, 2, 2048

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=41,
                                   config=_hier_cfg(hosts=hosts))
            coll.allreduce_sum({"g": np.ones(n, np.float32) * rank})
            moved = coll.bytes_posted_cross + coll.bytes_fetched_cross
            coll.close()
            return moved

        results = _run_world(server, world, fn)
        bound = 2 * (hosts - 1) / hosts * (n * 4)
        for moved in results:
            assert moved <= bound * 1.05, (moved, bound)
        # and it actually rode the cross wire (not degenerate zero)
        assert max(results) > 0

    def test_hier_falls_back_to_ring_when_hosts_dont_divide(self, server):
        """An elastic shrink to a non-divisible world must not wedge:
        every rank computes the same fallback from (world, config)."""
        world = 3

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=42,
                                   config=_hier_cfg(hosts=2))
            out = coll.allreduce_sum({"g": np.ones(500, np.float32)})
            assert coll.bytes_posted_cross == 0  # plain ring, no cross leg
            assert coll.calls["hier_fallback"] == 1
            assert coll.calls["allreduce~algo=ring~compress=none"] == 1
            coll.close()
            return out

        results = _run_world(server, world, fn)
        np.testing.assert_array_equal(
            results[0]["g"], np.full(500, world, np.float32))

    def test_rejects_mismatched_intra_plane(self, server):
        """An injected ICI plane whose span disagrees with the host
        grouping is a wiring bug — fail loudly, don't mis-shard."""

        class BadPlane:
            local_world = 3  # hier expects groups of 2 at world 4
            local_index = 0

        def fn(rank, client):
            coll = HostCollectives(client, rank, 4, round_id=43,
                                   config=_hier_cfg(),
                                   intra=BadPlane() if rank == 0 else None)
            if rank == 0:
                with pytest.raises(ValueError, match="intra plane"):
                    coll.allreduce_sum({"g": np.ones(8, np.float32)})
                return True
            # peers would block on rank 0's posts: don't join the op
            return True

        assert all(_run_world(server, 1, lambda r, c: fn(0, c)))

    @pytest.mark.parametrize("algo", _ALGOS)
    @pytest.mark.parametrize("compress", _COMPRESS)
    def test_matrix_bitwise_identical_through_resize(
            self, server, algo, compress):
        """The full determinism matrix: {flat, ring, hier}
        x {none, bf16, topk} x {steady, shrink, grow} — every round's
        replicas agree bitwise (fresh HostCollectives per round, as the
        elastic worker builds them; hier at world 3 exercises the
        fallback leg)."""
        base = (44 + _ALGOS.index(algo) * 9
                + _COMPRESS.index(compress) * 3)
        rng = np.random.default_rng(13)
        data = rng.standard_normal(1800).astype(np.float32)

        def run_round(rid, world):
            def fn(rank, client):
                coll = HostCollectives(
                    client, rank, world, round_id=rid,
                    config=CollectiveConfig(
                        algorithm=algo, compress=compress, hosts=2,
                        bucket_bytes=1024, topk_frac=0.25))
                out = coll.allreduce_sum({"g": data * (rank + 1),
                                          "i": np.arange(40, dtype=np.int32)})
                coll.close()
                return out

            results = _run_world(server, world, fn)
            assert len({_tree_bytes(o) for o in results}) == 1, (
                f"replicas diverged: {algo}/{compress} world={world}")
            # int group must stay exact under every combo
            np.testing.assert_array_equal(
                results[0]["i"], np.arange(40, dtype=np.int32) * world)

        run_round(base, 4)       # steady
        run_round(base + 1, 3)   # shrink
        run_round(base + 2, 4)   # grow


class TestTopkErrorFeedback:
    """compress="topk": top-k magnitude sparsification with per-bucket
    error-feedback residuals owned by the HostCollectives instance."""

    def test_codec_roundtrip(self):
        arr = np.asarray([0.1, -5.0, 0.2, 3.0, -0.05, 0.0], np.float32)
        raw = C._encode_topk(arr, frac=0.34)  # k = ceil(6*0.34) = 3
        dec = C._decode_topk(raw, len(arr))
        np.testing.assert_array_equal(
            dec, np.asarray([0, -5.0, 0.2, 3.0, 0, 0], np.float32))
        assert len(raw) == 3 * 8  # int32 index + f32 value per survivor

    def test_codec_empty_and_full(self):
        assert C._decode_topk(C._encode_topk(
            np.zeros(0, np.float32), 0.5), 0).size == 0
        arr = np.asarray([1.0, -2.0], np.float32)
        np.testing.assert_array_equal(
            C._decode_topk(C._encode_topk(arr, 1.0), 2), arr)

    def test_wire_bytes_sparsified(self, server):
        """topk at frac=0.25 carries ~2*frac of the dense f32 bytes
        (index + value per survivor)."""
        world, n = 2, 4096

        def fn(rank, client):
            coll = HostCollectives(
                client, rank, world, round_id=80,
                config=_ring_cfg(compress="topk"))
            coll.allreduce_sum(
                {"g": np.linspace(-1, 1, n).astype(np.float32)})
            posted = coll.bytes_posted
            coll.close()
            return posted

        for posted in _run_world(server, world, fn):
            assert posted < 0.6 * n * 4, (posted, n * 4)

    def test_residual_feedback_changes_second_op(self, server):
        """What op 1 drops is folded into op 2's contribution: the same
        instance produces a DIFFERENT (residual-corrected) second result
        than a fresh instance would — and both stay bitwise-identical
        across replicas."""
        world = 2
        rng = np.random.default_rng(17)
        data = rng.standard_normal(512).astype(np.float32)
        cfg = dict(compress="topk", bucket_bytes=512)

        def with_residual(rank, client):
            coll = HostCollectives(client, rank, world, round_id=81,
                                   config=_ring_cfg(**cfg))
            first = coll.allreduce_sum({"g": data})
            second = coll.allreduce_sum({"g": data})
            coll.close()
            return first, second

        def fresh_each_op(rank, client):
            a = HostCollectives(client, rank, world, round_id=82,
                                config=_ring_cfg(**cfg))
            first = a.allreduce_sum({"g": data})
            a.close()
            b = HostCollectives(client, rank, world, round_id=83,
                                config=_ring_cfg(**cfg))
            second = b.allreduce_sum({"g": data})
            b.close()
            return first, second

        kept = _run_world(server, world, with_residual)
        fresh = _run_world(server, world, fresh_each_op)
        # replicas agree in both worlds
        assert len({_tree_bytes(r[1]) for r in kept}) == 1
        assert len({_tree_bytes(r[1]) for r in fresh}) == 1
        # op 1 identical (no residual yet) ...
        np.testing.assert_array_equal(kept[0][0]["g"], fresh[0][0]["g"])
        # ... op 2 differs: the error feedback was applied, not dropped
        assert not np.array_equal(kept[0][1]["g"], fresh[0][1]["g"])
        # EF's guarantee is on the CUMULATIVE sum: what op 1 dropped
        # rides op 2, so the two-op total tracks the dense total better
        # than two independent (fresh-residual) ops do
        dense2 = 2 * data * world
        err_kept = np.linalg.norm(
            kept[0][0]["g"] + kept[0][1]["g"] - dense2)
        err_fresh = np.linalg.norm(
            fresh[0][0]["g"] + fresh[0][1]["g"] - dense2)
        assert err_kept < err_fresh, (err_kept, err_fresh)

    def test_residuals_reset_on_new_instance(self, server):
        """The membership-change rule: a fresh HostCollectives (what the
        elastic worker builds per round) starts residuals from zero —
        stale error feedback is never replayed into a new world."""
        world = 2
        data = np.linspace(-2, 2, 256).astype(np.float32)

        def fn(rank, client):
            a = HostCollectives(client, rank, world, round_id=84,
                                config=_ring_cfg(compress="topk"))
            a.allreduce_sum({"g": data})         # arms a's residuals
            assert a._residuals                  # state exists ...
            a.close()
            b = HostCollectives(client, rank, world, round_id=85,
                                config=_ring_cfg(compress="topk"))
            assert not b._residuals              # ... and is NOT carried
            out = b.allreduce_sum({"g": data})
            b.close()
            return out

        results = _run_world(server, world, fn)
        assert len({_tree_bytes(o) for o in results}) == 1

    def test_ints_exempt_from_topk(self, server):
        world = 2

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=86,
                                   config=_ring_cfg(compress="topk"))
            out = coll.allreduce_sum(
                {"i": np.arange(300, dtype=np.int64) * (rank + 1)})
            coll.close()
            return out

        results = _run_world(server, world, fn)
        np.testing.assert_array_equal(
            results[0]["i"], np.arange(300, dtype=np.int64) * 3)


class TestHierFaultSeam:
    def test_rank_dying_between_phases_surfaces_peer_lost(self, server):
        """The seam between hier's phases: a rank dying BETWEEN the
        intra-host phase and the cross-host ring must surface as
        PeerLost on every survivor within ~one shared timeout_s (the
        three phases share one deadline)."""
        from tpudist_torch.runtime import faults
        from tpudist_torch.runtime.faults import FaultInjected, FaultPlan

        world, rid, timeout = 4, 90, 1.5
        faults.install(FaultPlan(coll_kill_phase="hier_cross",
                                 coll_kill_rank=3, coll_kill_raise=True))
        try:
            def fn(rank, client):
                coll = HostCollectives(
                    client, rank, world, round_id=rid, timeout_s=timeout,
                    config=_hier_cfg(bucket_bytes=512))
                tree = {"g": np.ones(1500, np.float32) * rank}
                t0 = time.monotonic()
                if rank == 3:
                    with pytest.raises(FaultInjected):
                        coll.allreduce_sum(tree)
                    return 0.0
                with pytest.raises(PeerLost):
                    coll.allreduce_sum(tree)
                elapsed = time.monotonic() - t0
                coll.close()
                return elapsed

            results = _run_world(server, world, fn)
        finally:
            faults.reset()
        for rank in (0, 1, 2):
            assert results[rank] < 2.5 * timeout, (
                f"rank {rank} took {results[rank]:.1f}s — deadline not "
                f"shared across hier phases")


class TestNewConfigKnobs:
    def test_from_env_parses_topk_and_hosts(self, monkeypatch):
        monkeypatch.setenv("TPUDIST_COLL_ALGO", "hier")
        monkeypatch.setenv("TPUDIST_COLL_COMPRESS", "topk")
        monkeypatch.setenv("TPUDIST_COLL_TOPK_FRAC", "0.125")
        monkeypatch.setenv("TPUDIST_COLL_HOSTS", "4")
        cfg = CollectiveConfig.from_env()
        assert cfg.algorithm == "hier" and cfg.compress == "topk"
        assert cfg.topk_frac == 0.125 and cfg.hosts == 4

    def test_unknown_algo_names_allowed_values_and_knob(self):
        with pytest.raises(ValueError) as ei:
            CollectiveConfig(algorithm="tree")
        msg = str(ei.value)
        assert "TPUDIST_COLL_ALGO" in msg
        for allowed in ("auto", "flat", "ring", "hier"):
            assert allowed in msg

    def test_unknown_compress_names_allowed_values_and_knob(self):
        with pytest.raises(ValueError) as ei:
            CollectiveConfig(compress="zstd")
        msg = str(ei.value)
        assert "TPUDIST_COLL_COMPRESS" in msg
        for allowed in ("none", "bf16", "fp16", "topk"):
            assert allowed in msg

    def test_env_typo_fails_at_construction(self, monkeypatch):
        monkeypatch.setenv("TPUDIST_COLL_ALGO", "rnig")
        with pytest.raises(ValueError, match="rnig"):
            CollectiveConfig.from_env()

    def test_out_of_range_topk_frac_and_hosts(self):
        with pytest.raises(ValueError, match="TPUDIST_COLL_TOPK_FRAC"):
            CollectiveConfig(topk_frac=0.0)
        with pytest.raises(ValueError, match="TPUDIST_COLL_TOPK_FRAC"):
            CollectiveConfig(topk_frac=1.5)
        with pytest.raises(ValueError, match="TPUDIST_COLL_HOSTS"):
            CollectiveConfig(hosts=0)


class _FakeColl:
    """Deterministic stand-in: allreduce = x * world, records call order."""

    world = 2

    def __init__(self):
        self.calls: list[list[str]] = []

    def allreduce_sum(self, tree):
        self.calls.append(sorted(tree))
        return {k: np.asarray(v) * self.world for k, v in tree.items()}


class TestOverlappedGradSyncBucketed:
    """Bucketed backward-order mode of OverlappedGradSync: named
    gradients stream in, buckets fire when their last member lands."""

    def _grads(self):
        return {f"l{i}": np.full(4, float(i) + 1, np.float32)
                for i in range(5)}

    def _sync(self, coll, bucket_bytes=40):
        from tpudist_torch.elastic.worker import OverlappedGradSync

        return OverlappedGradSync(coll, bucket_bytes=bucket_bytes)

    def test_step1_records_plan_and_mean_matches(self):
        coll = _FakeColl()
        s = self._sync(coll)
        g = self._grads()
        for n in ["l4", "l3", "l2", "l1", "l0"]:   # backward order
            s.grad_ready(n, g[n])
        out = s.reduce(mean=True)
        for n in g:
            np.testing.assert_array_equal(out[n], g[n])  # x*2/2
        # greedy >= 40B packing over 16B leaves: [l4,l3,l2], [l1,l0]
        assert coll.calls == [["l2", "l3", "l4"], ["l0", "l1"]]

    def test_step2_fires_in_plan_order_under_jitter(self):
        coll = _FakeColl()
        s = self._sync(coll)
        g = self._grads()
        for n in ["l4", "l3", "l2", "l1", "l0"]:
            s.grad_ready(n, g[n])
        s.reduce()
        coll.calls = []
        # arrival jitter: plan-order submission must hold (op-id agreement)
        for n in ["l1", "l3", "l0", "l4", "l2"]:
            s.grad_ready(n, g[n])
        out = s.reduce(mean=True)
        assert coll.calls == [["l2", "l3", "l4"], ["l0", "l1"]]
        for n in g:
            np.testing.assert_array_equal(out[n], g[n])

    def test_repeat_name_accumulates_locally(self):
        coll = _FakeColl()
        s = self._sync(coll, bucket_bytes=1 << 20)  # one big bucket
        g = np.ones(4, np.float32)
        s.grad_ready("a", g)
        s.grad_ready("a", g)   # second microbatch, bucket still open
        out = s.reduce(mean=True)
        np.testing.assert_array_equal(out["a"], g)  # 2g*2/(2*2)

    def test_unknown_name_after_freeze_rejected(self):
        s = self._sync(_FakeColl(), bucket_bytes=16)
        s.grad_ready("a", np.ones(4, np.float32))
        s.reduce()
        with pytest.raises(ValueError, match="unknown gradient"):
            s.grad_ready("b", np.ones(4, np.float32))

    def test_reduce_with_missing_gradient_rejected(self):
        s = self._sync(_FakeColl(), bucket_bytes=16)
        for n in ("a", "b"):
            s.grad_ready(n, np.ones(4, np.float32))
        s.reduce()
        s.grad_ready("a", np.ones(4, np.float32))
        with pytest.raises(ValueError, match="missing"):
            s.reduce()

    def test_mixing_push_and_grad_ready_rejected(self):
        s = self._sync(_FakeColl())
        s.push({"x": np.zeros(2, np.float32)})
        with pytest.raises(ValueError, match="mixed"):
            s.grad_ready("a", np.ones(4, np.float32))

    def test_push_after_bucketed_reduce_still_rejected(self):
        """The mode is per-instance, not per-step: once a plan exists,
        push() must not silently enqueue a whole-tree op between steps."""
        s = self._sync(_FakeColl(), bucket_bytes=16)
        s.grad_ready("a", np.ones(4, np.float32))
        s.reduce()
        with pytest.raises(ValueError, match="mixed"):
            s.push({"x": np.zeros(2, np.float32)})

    def test_bucketed_needs_bucket_bytes(self):
        from tpudist_torch.elastic.worker import OverlappedGradSync

        s = OverlappedGradSync(_FakeColl())
        with pytest.raises(ValueError, match="bucket_bytes"):
            s.grad_ready("a", np.ones(4, np.float32))

    def test_bucketed_over_host_collectives_bitwise(self, server):
        """End to end over the real plane: every rank streams the same
        named layout, results are bitwise-identical across ranks and
        exact for integer-valued grads."""
        from tpudist_torch.elastic.worker import OverlappedGradSync

        world, rid = 2, 95
        names = [f"p{i}" for i in range(6)]

        def fn(rank, client):
            coll = HostCollectives(client, rank, world, round_id=rid,
                                   config=_ring_cfg(bucket_bytes=256))
            s = OverlappedGradSync(coll, bucket_bytes=600)
            outs = []
            for _step in range(2):
                for i, n in enumerate(reversed(names)):
                    s.grad_ready(n, np.full(50, float(i + rank),
                                            np.float32))
                outs.append(s.reduce())
            coll.close()
            return outs

        results = _run_world(server, world, fn)
        for step in range(2):
            blobs = {
                b"".join(r[step][n].tobytes() for n in names)
                for r in results}
            assert len(blobs) == 1
            # sum over ranks of (i + rank) = world*i + 0+1
            for i, n in enumerate(reversed(names)):
                np.testing.assert_array_equal(
                    results[0][step][n],
                    np.full(50, world * i + 1, np.float32))


@pytest.mark.slow
class TestTopkConvergence:
    def test_topk_ef_trains_within_tolerance_of_dense(self, server):
        """MNIST-scale end-to-end: the same 2-worker data-parallel MLP
        run trained with dense allreduce vs topk+EF at frac=0.25 — the
        error-feedback loop must keep the sparsified run converging to
        within tolerance of the dense loss (the SGD-with-memory result
        the compression literature promises), not just stay bitwise
        replica-consistent."""
        from tpudist_torch.models import MLP
        from tpudist_torch.ops.losses import cross_entropy
        from tpudist_torch.train.state import TrainState, sgd

        world, steps, batch = 2, 120, 32

        def make_batches():
            rng = np.random.default_rng(23)
            xs = rng.standard_normal(
                (steps, batch, 28 * 28)).astype(np.float32)
            ys = rng.integers(0, 10, (steps, batch))
            # separable-ish signal so the loss actually falls: shift
            # each class's pixels by its label
            for s in range(steps):
                xs[s] += ys[s][:, None] * 0.5
            return xs, ys

        def train(rid, compress):
            xs, ys = make_batches()
            shard = batch // world

            def fn(rank, client):
                coll = HostCollectives(
                    client, rank, world, round_id=rid,
                    config=CollectiveConfig(
                        algorithm="ring", compress=compress,
                        topk_frac=0.25, bucket_bytes=2048))
                model = MLP(hidden_layers=1, features=32, device="cpu")
                model.init_weights(torch.Generator().manual_seed(0))
                state = TrainState.create(model, sgd(0.05))
                params = dict(model.named_parameters())
                losses = []
                for s in range(steps):
                    lo = rank * shard
                    model.zero_grad(set_to_none=True)
                    loss = cross_entropy(
                        model(torch.from_numpy(xs[s, lo:lo + shard])),
                        torch.from_numpy(ys[s, lo:lo + shard]))
                    loss.backward()
                    # one fused allreduce syncs grads AND the scalar
                    # loss, so the recorded curve is global and rank-
                    # agreed (the per-shard local loss is not)
                    grads, gloss = coll.allreduce_mean(
                        ({n: p.grad for n, p in params.items()},
                         loss.detach()))
                    for n, p in params.items():
                        p.grad = grads[n]
                    state.apply_gradients()
                    losses.append(float(gloss))
                coll.close()
                return losses

            results = _run_world(server, world, fn)
            assert results[0] == results[1]  # replicas agree
            return results[0]

        dense = train(96, "none")
        sparse = train(97, "topk")
        # both runs actually learn ...
        assert dense[-1] < dense[0] * 0.8
        assert sparse[-1] < sparse[0] * 0.8
        # ... and topk+EF lands within tolerance of the dense loss
        # (averaged over the tail to smooth per-step noise)
        d_tail = float(np.mean(dense[-5:]))
        s_tail = float(np.mean(sparse[-5:]))
        assert s_tail < d_tail * 1.25 + 0.05, (d_tail, s_tail)


class TestJoinLive:
    def test_assigns_dense_sorted_ranks(self, server):
        world = 4

        def fn(rank, client):
            wid = f"alpha{rank}"
            client.heartbeat(wid, 5.0)  # liveness is membership
            rdzv = Rendezvous(client, namespace="jl1")
            got = rdzv.join_live(0, wid, timeout_s=20, min_world=world)
            client.heartbeat(wid, 0)  # leave
            return wid, got

        results = _run_world(server, world, fn)
        worlds = {got[1] for _, got in results}
        assert worlds == {world}
        ranks = sorted((got[0], wid) for wid, got in results)
        assert [r for r, _ in ranks] == list(range(world))
        # rank order == sorted worker-id order, identical member lists
        members = {tuple(got[2]) for _, got in results}
        assert len(members) == 1
        assert [wid for _, wid in ranks] == sorted(w for w, _ in results)

    def test_forms_smaller_world_after_grace(self, server):
        """A registered-but-dead peer must not hang the round: after the
        min_world grace the live members form the round without it."""

        def fn(rank, client):
            wid = f"beta{rank}"
            client.heartbeat(wid, 5.0)
            rdzv = Rendezvous(client, namespace="jl2")
            got = rdzv.join_live(0, wid, timeout_s=30, min_world=3,
                                 min_world_grace_s=1.5)
            client.heartbeat(wid, 0)
            return got

        results = _run_world(server, 2, fn)
        assert all(world == 2 for _, world, _ in results)


# ---------------------------------------------------------------------------
# parity with tpudist: the same bytes on the same trees

_ROUNDS = iter(range(1000, 100000))


def _ref_modules():
    """tpudist's collectives and client (imported in the tests: this
    module imports no JAX at its top)."""
    from tpudist.runtime import collectives as RC
    from tpudist.runtime.coord import CoordClient as RCl

    return RC, RCl


def _parity_tree(rank: int, port: bool) -> dict:
    """Rank ``rank``'s seeded tree: f32 leaves over several buckets, an
    f16, f64 and int64 leaf.  The port's f32 leaf is a CPU tensor, so the
    tensor path is held to the same bytes.  No bf16 leaf: tpudist's
    ``_fuse`` cannot cast one (ROADMAP Queue C 7); the port's bf16 leaves
    are held in ``test_cpu_tensors_come_back_as_their_kind``."""
    rng = np.random.default_rng(100 + rank)
    w = rng.standard_normal(3001).astype(np.float32)
    return {"w": torch.from_numpy(w) if port else w,
            "b": rng.standard_normal((5, 3)).astype(np.float32),
            "h": rng.standard_normal(11).astype(np.float16),
            "d": rng.standard_normal(13),
            "i": np.arange(7, dtype=np.int64) * (rank + 1)}


def _leaf_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _bytes(tree) -> bytes:
    return b"".join(_leaf_bytes(tree[k]) for k in sorted(tree))


def _parity_ops(coll, tree):
    """Two sums (the second carries topk's residuals), an async mean and
    a broadcast from rank 1.  The barrier before the broadcast keeps
    tpudist's ranks clear of its key-collection race (ROADMAP Queue C 9,
    ``test_broadcast_after_allreduce_waits_for_a_slow_peer``)."""
    first = coll.allreduce_sum(tree)
    second = coll.allreduce_sum(tree)
    mean = coll.allreduce_mean_async(tree).wait(60)
    coll.barrier()
    bcast = coll.broadcast(tree, root=1)
    coll.close()
    return [first, second, mean, bcast]


def _parity_gang(server, world, cfg, port_ranks):
    """One gang at ``world``: ranks in ``port_ranks`` run the port, the
    others tpudist; returns each rank's results as bytes."""
    RC, RCl = _ref_modules()
    rid = next(_ROUNDS)

    def work(rank):
        port = rank in port_ranks
        mod, cl = (C, CoordClient) if port else (RC, RCl)
        with cl(port=server.port) as client:
            coll = mod.HostCollectives(client, rank, world, round_id=rid,
                                       config=mod.CollectiveConfig(**cfg))
            return [_bytes(o) for o in _parity_ops(
                coll, _parity_tree(rank, port))]

    results = [None] * world
    errors = []

    def run(rank):
        try:
            results[rank] = work(rank)
        except Exception as e:  # noqa: BLE001
            errors.append((rank, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return results


@pytest.mark.parametrize("compress", _COMPRESS)
@pytest.mark.parametrize("algo", _ALGOS)
def test_port_equals_tpudist_bitwise(server, algo, compress):
    """Every rank's every result (two sums, an async mean, a broadcast)
    is byte for byte tpudist's.  flat and ring at world 3; hier at world 4
    over 2 hosts (at world 3 it would fall back to the ring)."""
    world = 4 if algo == "hier" else 3
    cfg = dict(algorithm=algo, compress=compress, bucket_bytes=1024,
               topk_frac=0.25, hosts=2)
    ref = _parity_gang(server, world, cfg, port_ranks=())
    got = _parity_gang(server, world, cfg, port_ranks=range(world))
    for rank in range(world):
        for op in range(4):
            assert got[rank][op] == ref[rank][op], (rank, op)


@pytest.mark.parametrize("compress", ["none", "bf16"])
@pytest.mark.parametrize("algo", ["flat", "ring"])
def test_mixed_gang_computes_tpudist_bytes(server, algo, compress):
    """Ranks 0 and 2 run the port, rank 1 tpudist, on one store: every
    rank returns what an all-tpudist gang returns."""
    cfg = dict(algorithm=algo, compress=compress, bucket_bytes=1024)
    ref = _parity_gang(server, 3, cfg, port_ranks=())
    mixed = _parity_gang(server, 3, cfg, port_ranks=(0, 2))
    assert mixed == ref


def test_bf16_codec_rounds_as_ml_dtypes():
    """f32 -> bf16 bits round to nearest-even as ``ml_dtypes`` does (ties,
    subnormals, overflow to inf included; NaN payloads are not held), and
    bits -> f32 is exact."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(10_000).astype(np.float32) * 1e3,
        # exact ties: a bf16 value plus half its last place, both parities
        ((np.arange(0x3F00, 0x3F80, dtype=np.uint32) << 16) | 0x8000)
        .view(np.float32),
        np.asarray([0.0, -0.0, 1e-40, -1e-42, 3.4e38, -3.4e38, np.inf,
                    -np.inf], np.float32)])
    want = x.astype(ml_dtypes.bfloat16)
    got = C._bf16_bits(x)
    assert got.dtype == np.dtype("V2")
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    np.testing.assert_array_equal(C._bf16_float(got),
                                  want.astype(np.float32))
    assert C._token(got.dtype) == np.dtype(ml_dtypes.bfloat16).str


def test_cpu_tensors_come_back_as_their_kind(server):
    """CPU tensors return as CPU tensors of their own dtype (bf16, f16,
    int64 included), numpy leaves as numpy, nested lists and tuples as
    themselves; the values are the numpy path's."""
    world = 3

    def tree(rank, as_tensor):
        rng = np.random.default_rng(rank)
        a = rng.standard_normal(300).astype(np.float32)
        h = rng.standard_normal(9).astype(np.float16)
        i = np.arange(4, dtype=np.int64) * rank
        if not as_tensor:
            return {"a": a, "h": h, "i": i, "n": [a[:3], (i,)],
                    "s": a[0], "u": a[1]}
        return {"a": torch.from_numpy(a), "h": torch.from_numpy(h),
                "i": torch.from_numpy(i), "n": [a[:3], (torch.from_numpy(i),)],
                "z": torch.from_numpy(a).bfloat16(),
                "s": torch.tensor(a[0]), "u": torch.tensor(a[1]).bfloat16()}

    def fn(rank, client, as_tensor, rid):
        coll = HostCollectives(client, rank, world, round_id=rid,
                               config=_ring_cfg(bucket_bytes=512,
                                                compress="bf16"))
        out = (coll.allreduce_sum(tree(rank, as_tensor)),
               coll.allreduce_mean(tree(rank, as_tensor)))
        coll.close()
        return out

    rid_t, rid_n = next(_ROUNDS), next(_ROUNDS)
    tens = _run_world(server, world, lambda r, c: fn(r, c, True, rid_t))
    nump = _run_world(server, world, lambda r, c: fn(r, c, False, rid_n))
    for (ts, tm), (ns, nm) in zip(tens, nump):
        for got, want in ((ts, ns), (tm, nm)):
            for k, dt in (("a", torch.float32), ("h", torch.float16),
                          ("z", torch.bfloat16)):
                assert isinstance(got[k], torch.Tensor)
                assert got[k].dtype == dt and got[k].device.type == "cpu"
            assert isinstance(got["n"], list)
            assert isinstance(got["n"][0], np.ndarray)
            assert isinstance(got["n"][1], tuple)
            assert isinstance(got["n"][1][0], torch.Tensor)
            for k in ("a", "h"):
                assert _leaf_bytes(got[k]) == _leaf_bytes(want[k])
        assert ts["i"].dtype == torch.int64
        np.testing.assert_array_equal(ts["i"].numpy(), ns["i"])
        # an integer mean is float64, as numpy divides
        assert tm["i"].dtype == torch.float64
        np.testing.assert_array_equal(tm["i"].numpy(), nm["i"])
        assert ts["z"].shape == (300,)
        # 0-d leaves stay 0-d, bf16 ones too
        assert ts["s"].shape == () and np.shape(ns["s"]) == ()
        assert tm["u"].shape == () and tm["u"].dtype == torch.bfloat16
        assert _leaf_bytes(ts["s"]) == _leaf_bytes(ns["s"])


def test_tensor_broadcast_lands_in_the_receivers_kind(server):
    """Broadcast: the root returns its own tree; a receiver gets the
    root's values as its own leaves' kinds (a bf16 tensor stays bf16)."""

    def fn(rank, client, rid):
        coll = HostCollectives(client, rank, 2, round_id=rid)
        out = coll.broadcast({"t": torch.full((3,), 1.5 + rank).bfloat16(),
                              "s": 7 + rank}, root=0)
        coll.close()
        return out

    rid = next(_ROUNDS)
    root, other = _run_world(server, 2, lambda r, c: fn(r, c, rid))
    assert root["s"] == 7
    assert other["t"].dtype == torch.bfloat16
    np.testing.assert_array_equal(other["t"].float().numpy(),
                                  np.full(3, 1.5, np.float32))
    assert int(other["s"]) == 7


@pytest.mark.parametrize("package", ["port", "tpudist"])
def test_broadcast_after_allreduce_waits_for_a_slow_peer(server, package):
    """An allreduce, then a broadcast, with rank 2 slow to fetch the
    allreduce's posts.  Ranks 0 and 1 finish the allreduce, the broadcast
    and reach its closing barrier first.  tpudist deletes their allreduce
    posts at that barrier, so rank 2 never finds them and every rank
    fails with PeerLost at the deadline (ROADMAP Queue C 9); the port
    collects them only after the barrier, and all three finish."""
    if package == "port":
        mod, client_cls = C, CoordClient
    else:
        mod, client_cls = _ref_modules()
    rid, timeout = next(_ROUNDS), 3.0

    class SlowFetch(client_cls):
        def get(self, key):
            if key.startswith(f"coll/{rid}/0/"):
                time.sleep(0.6)   # a starved fetch of op 0's posts
            return super().get(key)

    def fn(rank, client):
        slow = SlowFetch(port=server.port) if rank == 2 else client
        try:
            coll = mod.HostCollectives(
                slow, rank, 3, round_id=rid, timeout_s=timeout,
                config=mod.CollectiveConfig(algorithm="flat"))
            try:
                coll.allreduce_sum({"x": np.ones(4, np.float32) * rank})
                out = coll.broadcast({"y": np.full(2, float(rank))}, root=0)
                return ("ok", float(out["y"][0]))
            except mod.PeerLost:
                return ("lost", None)
            finally:
                coll.close()
        finally:
            if slow is not client:
                slow.close()

    results = _run_world(server, 3, fn)
    if package == "port":
        assert results == [("ok", 0.0)] * 3
    else:
        assert ("lost", None) in results
