"""The process-group data plane (``tpudist_torch.runtime.ici``) against
tpudist's ``tests/test_ici_unit.py`` cases.

* The failure classifier's table: tpudist's cases, plus the marks the
  port gives gloo's, NCCL's and the round store's failures.
* On a world-1 gloo group in this process: ``allreduce_mean``/``_sum``
  and their async handles against tpudist's single-process
  ``IciCollectives`` (within 1e-6 relative: tpudist sums its 8 local
  device rows, a few f32 roundings; the port's one member returns its
  contribution bitwise), equal ``rs_bounds``, the empty vector, a rejected shard
  size; ``IciDataPlane`` forming, tearing down and re-forming rounds over
  a coordination server, with no group left behind.
* In 3 gloo ranks: ``reduce_scatter``, ``all_gather`` and ``IciIntraHost``
  under ``HostCollectives(algorithm="hier")``, against the port's
  store-backed ``HostCollectives`` (integer-valued f32 data: every sum is
  exact, so the tolerance is 0).  tpudist's own reduce-scatter, all-gather
  and intra-host adapter fail their tests (ROADMAP Queue C 3) and are not
  used as anchors.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpudist_torch.runtime.collectives import CollectiveConfig, PeerLost
from tpudist_torch.runtime.coord import CoordClient, CoordServer
from tpudist_torch.runtime.ici import (
    FormationTimeout,
    IciCollectives,
    IciDataPlane,
    IciIntraHost,
    is_collective_failure,
    live_groups,
)


# ---- the failure classifier ---------------------------------------------

@pytest.mark.parametrize("exc,want", [
    # tpudist's table (tests/test_ici_unit.py:18-47)
    (ValueError("UNKNOWN: Buffer Definition Event: Gloo all-reduce failed: "
                "[external/gloo/gloo/transport/tcp/pair.cc:538] Read error "
                "[127.0.0.1]:12684: Connection reset by peer"), True),
    (TypeError("unsupported operand type(s) for +: 'int' and 'str'"), False),
    (ValueError("shapes do not match"), False),
    (KeyError("socket closed"), False),
    (OSError("connection refused"), False),
    (ConnectionError("Connection refused"), False),
    # the port's own: gloo, NCCL, the watchdog, the round store
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:553] "
                  "Connection closed by peer [127.0.0.1]:5822"), True),
    (RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1970, remote "
                  "process exited or there was a network error"), True),
    (RuntimeError("[Rank 1] Watchdog caught collective operation timeout: "
                  "WorkNCCL(SeqNum=7, OpType=ALLREDUCE) ran for 60000 ms"),
     True),
    (RuntimeError("Socket Timeout"), True),
    (RuntimeError("wait timeout after 30000ms, keys: /ici/3/card/1"), True),
    (dist.DistBackendError("anything at all"), True),
    (dist.DistStoreError("anything at all"), True),
    (RuntimeError("CUDA out of memory"), False),
    (ConnectionError("coordination store unreachable: timed out"), False),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException) else None)
def test_is_collective_failure(exc, want):
    assert is_collective_failure(exc) is want


def test_classifier_agrees_with_tpudist_on_its_table():
    from tpudist.runtime.ici import is_collective_failure as jax_classify

    table = [
        ValueError("Gloo all-reduce failed: Connection reset by peer"),
        RuntimeError("UNAVAILABLE: Failed to send RPC to coordination "
                     "service"),
        TypeError("unsupported operand"), ValueError("shapes do not match"),
        KeyError("socket closed"), OSError("connection refused"),
        ConnectionError("Connection refused"),
    ]
    # every case but the coordination-service RPC (a jax.distributed
    # runtime the port does not have) is classified alike
    for e in table[:1] + table[2:]:
        assert is_collective_failure(e) == jax_classify(e), e


# ---- one process: a world-1 gloo group -------------------------------------

@pytest.fixture
def group1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_coll():
    import jax

    from tpudist.runtime.ici import IciCollectives as JaxIci

    return JaxIci(jax.sharding.Mesh(np.asarray(jax.devices()), ("data",)))


def _grads():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((4, 8)).astype(np.float32),
            "b": np.asarray(2.0, np.float32)}


def test_allreduce_matches_tpudist_single_process(group1, jax_coll):
    """A mean and a sum over one member: tpudist's over its 8 local
    devices (1e-6 relative), the port's over a world-1 group (bitwise the
    contribution); the port's returns each leaf as its kind (tensor in,
    tensor out)."""
    coll = IciCollectives(group1)
    g = _grads()
    want_mean, want_sum = jax_coll.allreduce_mean(g), jax_coll.allreduce_sum(g)
    got = coll.allreduce_mean({"w": torch.from_numpy(g["w"]), "b": g["b"]})
    assert isinstance(got["w"], torch.Tensor)
    assert isinstance(got["b"], np.ndarray)
    np.testing.assert_allclose(got["w"].numpy(), want_mean["w"], rtol=1e-6)
    np.testing.assert_allclose(got["b"], want_mean["b"], rtol=1e-6)
    np.testing.assert_array_equal(got["w"].numpy(), g["w"])
    got = coll.allreduce_sum(g)
    for k in g:
        np.testing.assert_allclose(got[k], want_sum[k], rtol=1e-6)
        np.testing.assert_array_equal(got[k], g[k])
    assert coll.calls == {"allreduce": 2}
    assert coll.bytes == 2 * 33 * 4


def test_async_handle_matches_sync(group1):
    coll = IciCollectives(group1)
    g = {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}
    sync = coll.allreduce_mean(g)
    h = coll.allreduce_mean_async(g)
    out = h.wait()
    assert h.done()
    np.testing.assert_array_equal(out["w"], sync["w"])
    np.testing.assert_array_equal(coll.allreduce_sum_async(g).wait()["w"],
                                  sync["w"])
    handles = [coll.allreduce_mean_async({"x": np.full(8, float(i),
                                                       np.float32)})
               for i in range(3)]
    for i, h in reversed(list(enumerate(handles))):
        np.testing.assert_array_equal(h.wait()["x"], np.full(8, float(i)))


def test_on_check_runs_before_dispatch(group1):
    calls = []
    coll = IciCollectives(group1, on_check=lambda: calls.append(1))
    coll.allreduce_mean({"x": np.ones(2, np.float32)})
    assert calls


def test_rs_bounds_equal_tpudist(group1, jax_coll):
    coll = IciCollectives(group1)
    for n in (0, 1, 5, 23, 64, 97):
        assert coll.rs_bounds(n) == jax_coll.rs_bounds(n), n


def test_reduce_scatter_and_all_gather_one_member(group1):
    coll = IciCollectives(group1)
    vec = np.arange(23, dtype=np.float32) * 0.5 - 3.0
    shard = coll.reduce_scatter(vec)
    np.testing.assert_array_equal(shard, vec)
    np.testing.assert_array_equal(coll.all_gather(shard, 23), vec)


def test_empty_vector(group1):
    coll = IciCollectives(group1)
    shard = coll.reduce_scatter(np.zeros(0, np.float32))
    assert shard.size == 0
    assert coll.all_gather(shard, 0).size == 0


def test_all_gather_rejects_wrong_shard_size(group1):
    coll = IciCollectives(group1)
    with pytest.raises(ValueError, match="shard"):
        coll.all_gather(np.zeros(999, np.float32), 23)


def test_poll_deadline_is_peer_lost(group1):
    """A collective that never completes surfaces as PeerLost at the
    deadline (the TTL probe normally fires first)."""
    class Stuck:
        def is_completed(self):
            return False

    coll = IciCollectives(group1, timeout_s=0.05)
    with pytest.raises(PeerLost, match="not done"):
        coll._wait_ready([Stuck()])


@pytest.fixture
def coord():
    srv = CoordServer(0)
    client = CoordClient("127.0.0.1", srv.port)
    try:
        yield client
    finally:
        client.close()
        srv.stop()


def test_data_plane_rounds_form_and_tear_down(coord):
    """Three rounds of a world-1 plane over a coordination server: each
    forms a fresh gloo group through its own store process (the spare,
    adopted), reduces, and leaves no group behind; the finalize sweep
    deletes every round's keys and ends the store processes and the
    spare."""
    plane = IciDataPlane(coord, device="cpu")
    assert plane.backend == "gloo"
    for round_id in range(3):
        group = plane.form(round_id, 0, 1)
        assert live_groups() == 1
        coll = IciCollectives(group)
        out = coll.allreduce_sum({"x": np.full(3, float(round_id),
                                               np.float32)})
        np.testing.assert_array_equal(out["x"], np.full(3, float(round_id)))
        plane.teardown()
        assert live_groups() == 0 and not dist.is_initialized()
    assert plane.formed == 3
    pids = [int(coord.get(f"ici/{r}/svc").decode().split(":")[0])
            for r in (1, 2)]
    assert coord.get("ici/0/svc") is None   # swept two rounds on
    spare = plane._spare
    plane.finalize(0, lambda: None)
    assert coord.keys("ici/") == []
    assert spare.poll() is not None and plane._spare is None
    for pid in pids:
        for _ in range(100):
            try:
                os.kill(pid, 0)
            except OSError:
                break
            import time
            time.sleep(0.05)
        else:
            pytest.fail(f"store process {pid} outlived the sweep")


def test_data_plane_backend_choice(coord, monkeypatch):
    """The backend follows the device; TPUDIST_ICI_BACKEND or backend=
    override it; NCCL on the CPU is refused, never replaced."""
    for env in (None, "gloo"):
        if env:
            monkeypatch.setenv("TPUDIST_ICI_BACKEND", env)
        plane = IciDataPlane(coord, device="cpu")
        assert plane.backend == "gloo"
        plane.close()
    with pytest.raises(ValueError, match="CUDA device"):
        IciDataPlane(coord, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        IciDataPlane(coord, device="cpu", backend="mpi")


def test_unpublished_address_is_formation_timeout(coord):
    """Rank 1 of a round whose rank 0 never publishes: FormationTimeout
    within init_timeout_s, with the TTL probe polled meanwhile."""
    probes = []
    plane = IciDataPlane(coord, device="cpu", init_timeout_s=0.5)
    with pytest.raises(FormationTimeout, match="never published"):
        plane.form(7, 1, 2, on_wait=lambda: probes.append(1))
    assert probes and not dist.is_initialized()
    spare = plane._spare
    plane.close()
    assert spare.poll() is not None


# ---- gloo ranks against the store-backed HostCollectives ------------------

def _rank_data(rank, n):
    # integer-valued f32: every sum of a few is exact in any order
    return (np.arange(n, dtype=np.float32) % 7 + rank * 10).astype(np.float32)


def _ranks(rank, world, port, n):
    from tpudist_torch.runtime.collectives import HostCollectives
    from tpudist_torch.runtime.ici import host_group

    client = CoordClient("127.0.0.1", port)
    coll = IciCollectives(dist.group.WORLD)
    vec = _rank_data(rank, n)
    shard = coll.reduce_scatter(vec)
    full = coll.all_gather(shard, n)
    torch_shard = coll.reduce_scatter(torch.from_numpy(vec))
    store = HostCollectives(client, rank, world, round_id=0,
                            config=CollectiveConfig(algorithm="flat",
                                                    compress="none"))
    want = store.allreduce_sum({"v": vec})["v"]
    mean = coll.allreduce_mean({"v": torch.from_numpy(vec)})["v"].numpy()
    store_mean = store.allreduce_mean({"v": vec})["v"]
    hier = intra_calls = None
    if world == 4:
        # two hosts of two ranks: hier's intra legs on each host's group
        intra = IciCollectives(host_group(2))
        hc = HostCollectives(client, rank, world, round_id=1,
                             config=CollectiveConfig(
                                 algorithm="hier", hosts=2, compress="none",
                                 flat_max_bytes=0),
                             intra=IciIntraHost(intra))
        hier = hc.allreduce_sum({"v": vec})["v"]
        intra_calls = dict(intra.calls)
        hc.close()
    store.close(), client.close()
    return (coll.rs_bounds(n), shard, full, torch_shard.numpy(), want,
            mean, store_mean, dict(coll.calls), hier, intra_calls)


@pytest.mark.parametrize("world,n", [(3, 23), (3, 64), (4, 23)])
def test_ranks_against_host_collectives(tmp_path, world, n):
    """reduce_scatter (numpy and tensor), all_gather and the mean in
    ``world`` gloo ranks equal the store's flat allreduce; in 4 ranks,
    ``IciIntraHost`` over two host groups carries hier's intra legs and
    hier's result equals it too."""
    from tests.test_torch_data_parallel import run_ranks

    srv = CoordServer(0)
    try:
        out = run_ranks(_ranks, world, tmp_path, srv.port, n)
    finally:
        srv.stop()
    for rank, (bounds, shard, full, tshard, want, mean, smean, calls, hier,
               intra_calls) in enumerate(out):
        lo, hi = bounds[rank]
        np.testing.assert_array_equal(shard, want[lo:hi])
        np.testing.assert_array_equal(tshard, want[lo:hi])
        np.testing.assert_array_equal(full, want)
        np.testing.assert_allclose(mean, smean, rtol=1e-6)
        # gloo: reduce-scatter is an all-reduce plus a slice
        assert calls == {"allreduce": 3, "all_gather": 1}
        if world == 4:
            np.testing.assert_array_equal(hier, want)
            assert intra_calls == {"allreduce": 1, "all_gather": 1}


@pytest.mark.cuda
def test_nccl_rounds_in_one_process(coord):
    """Three world-1 NCCL rounds on the card: each forms, reduces right,
    and is aborted and destroyed, leaving no group behind."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL)")
    plane = IciDataPlane(coord, device="cuda:0")
    assert plane.backend == "nccl"
    for round_id in range(3):
        group = plane.form(round_id, 0, 1)
        coll = IciCollectives(group, device="cuda:0")
        x = torch.full((1024,), float(round_id + 1), device="cuda:0")
        out = coll.allreduce_sum({"x": x})["x"]
        assert out.device.type == "cuda" and torch.equal(out, x)
        plane.teardown()
        assert live_groups() == 0
    plane.finalize(0, lambda: None)
    assert coord.keys("ici/") == []


def test_spare_store_ends_with_its_worker(tmp_path):
    """An unadopted spare store process ends when the process that
    started it dies (a kill -9'd worker leaves no store behind)."""
    import subprocess
    import sys
    import time

    code = ("import sys, time; from tpudist_torch.runtime.ici import "
            "IciDataPlane; from tpudist_torch.runtime.coord import "
            "CoordClient; p = IciDataPlane(CoordClient('127.0.0.1', "
            "int(sys.argv[1])), device='cpu'); "
            "print(p._spare.pid, flush=True); time.sleep(600)")
    srv = CoordServer(0)
    try:
        worker = subprocess.Popen([sys.executable, "-c", code,
                                   str(srv.port)], stdout=subprocess.PIPE)
        spare = int(worker.stdout.readline())
        worker.kill()
        worker.wait()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                os.kill(spare, 0)
            except OSError:
                break
            time.sleep(0.1)
        else:
            pytest.fail("the spare store outlived its worker")
    finally:
        srv.stop()
