"""tpudist_torch.obs.xla (its telemetry read from CUDA) against the JAX
package's ``tpudist.obs.xla``.

* ``note_compile``, ``compile_watch`` (per-site names, no double count)
  and ``note_step`` leave the same registry snapshots as tpudist's on the
  same inputs (exact, times aside).
* ``peak_tflops`` knows the H100's name (989 TFLOP/s dense bf16) and
  gives None on the CPU, as tpudist's does off-TPU;
  ``update_memory_gauges`` returns ``{}`` without a card.
* ``cost_flops`` of one MLP training step equals the analytic matmul
  FLOPs exactly.
* The builds report themselves: a ``g++`` build of a native library and
  an ``nvcc`` build of each kernel source (a stand-in compiler here)
  tick ``xla/compiles`` once each; a library already built counts
  nothing.
* On the card (marker ``cuda``) the memory gauges read the allocator."""

import importlib
import os
import stat
import sys

import numpy as np
import pytest
import torch

txla = importlib.import_module("tpudist_torch.obs.xla")
treg = importlib.import_module("tpudist_torch.obs.registry")

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def ref():
    return {"xla": importlib.import_module("tpudist.obs.xla"),
            "registry": importlib.import_module("tpudist.obs.registry")}


def _snap(reg):
    """A registry snapshot without its wall-clock stamp."""
    snap = reg.snapshot()
    snap.pop("time", None)
    return snap


def _strip_times(snap):
    """Counters and gauges as they are; histograms by count (their
    values are wall times)."""
    return {"counters": snap["counters"], "gauges": snap["gauges"],
            "histograms": {k: h["count"]
                           for k, h in snap["histograms"].items()}}


def test_note_compile_and_step_equal(ref):
    ra, rb = ref["registry"].MetricRegistry(), treg.MetricRegistry()
    rng = np.random.default_rng(0)
    for s in rng.exponential(3.0, size=5):
        ref["xla"].note_compile(float(s), registry=ra, source="nvcc")
        txla.note_compile(float(s), registry=rb, source="nvcc")
    assert _snap(ra) == _snap(rb)
    for seconds, flops in ((0.5, 2e12), (0.01, 3.3e11), (0.0, 1e12),
                           (0.2, None), (0.2, 0.0)):
        assert ref["xla"].note_step(seconds, flops, registry=ra) \
            == txla.note_step(seconds, flops, registry=rb)
    assert _snap(ra) == _snap(rb)
    assert rb.snapshot()["gauges"]["xla/step_tflops"]["value"] \
        == pytest.approx(3.3e11 / 0.01 / 1e12, rel=1e-15)
    assert "xla/mfu" not in rb.snapshot()["gauges"]   # no known card


def test_compile_watch_counts_per_site(ref):
    ra, rb = ref["registry"].MetricRegistry(), treg.MetricRegistry()
    for mod, reg in ((ref["xla"], ra), (txla, rb)):
        for _ in range(3):
            with mod.compile_watch("ici", registry=reg) as w:
                pass
            assert w.seconds >= 0.0
        with pytest.raises(KeyError):
            with mod.compile_watch("ici", registry=reg):
                raise KeyError("a failed build counts nothing")
    sa, sb = _strip_times(_snap(ra)), _strip_times(_snap(rb))
    assert sa == sb
    assert sb["counters"]["xla/compiles_ici"]["value"] == 3
    assert "xla/compiles" not in sb["counters"]       # no double count
    assert txla.install_compile_telemetry() is True


def test_peak_and_memory_off_the_card():
    assert txla.peak_tflops(H100) == 989.0
    assert txla.mfu(989.0 / 4, H100) == 0.25
    assert txla.peak_tflops("NVIDIA Unknown Card") is None
    if not torch.cuda.is_available():
        assert txla.peak_tflops() is None
        assert txla.mfu(10.0) is None
        assert txla.update_memory_gauges() == {}
    assert txla.peak_tflops(torch.device("cpu")) is None
    assert txla.peak_tflops("cpu") is None


def _mlp_step(hidden, features, batch):
    from tpudist_torch.models import MLP
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.parallel.data_parallel import make_dp_train_step
    from tpudist_torch.train.state import TrainState, adam

    model = MLP(hidden, features, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    state = TrainState.create(model, adam(1e-3))

    def loss(m, b, generator):
        x, y = b
        return cross_entropy(m(x), y), {}

    step = make_dp_train_step(loss)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(batch, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, batch).astype(np.int64))
    return step, state, x, y


@pytest.mark.parametrize("hidden,features,batch", [(2, 64, 16),
                                                   (1, 32, 8)])
def test_cost_flops_mlp_step_analytic(hidden, features, batch):
    step, state, x, y = _mlp_step(hidden, features, batch)
    out = []
    flops = txla.cost_flops(lambda: out.append(step(state, x, y)))
    assert out and out[0][0].step == 1           # the step ran, once
    layers = [(784, features)] + [(features, features)] * hidden \
        + [(features, 10)]
    # forward 2·B·in·out a layer; backward the weight gradient, and the
    # input gradient of every layer but the first (its input needs none)
    want = sum(2 * batch * a * b * (2 if i == 0 else 3)
               for i, (a, b) in enumerate(layers))
    assert flops == float(want)
    assert txla.cost_flops(lambda: None) is None


def _fake_nvcc(tmp_path):
    """A stand-in compiler: writes its ``-o`` target and exits 0."""
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'wb').write(b'lib')\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_builds_report_compiles(tmp_path, monkeypatch):
    from tpudist_torch import _native, obs
    from tpudist_torch.ops import _cuda

    def compiles():
        return obs.snapshot()["counters"].get("xla/compiles",
                                              {}).get("value", 0)

    def sources():
        return [r["source"] for r in obs.recorder.events()
                if r["kind"] == "xla_compile"]

    # nvcc: one compile a kernel source, then none once they are built
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "cuda")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: _fake_nvcc(tmp_path))
    c0, s0 = compiles(), len(sources())
    libs = _cuda.build()
    n = len(_cuda._sources())
    assert n >= 5 and len(libs) == n
    assert compiles() - c0 == n
    assert sources()[s0:] == ["nvcc"] * n
    _cuda.build()
    assert compiles() - c0 == n
    # g++: a native library built fresh counts once; found built, nothing
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.delitem(_native._libs, "dataload", raising=False)
    c1 = compiles()
    assert _native._load("dataload") is not None
    assert compiles() - c1 == 1 and sources()[-1] == "g++"
    monkeypatch.delitem(_native._libs, "dataload")
    assert _native._load("dataload") is not None
    assert compiles() - c1 == 1
    assert os.path.exists(_native.lib_path("dataload"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_memory_gauges_on_the_card(card):
    x = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    reg = treg.MetricRegistry()
    vals = txla.update_memory_gauges(registry=reg)
    got = vals["xla/mem/bytes_in_use/d0"]
    assert got == float(torch.cuda.memory_allocated(0)) >= x.numel()
    assert vals["xla/mem/peak_bytes_in_use/d0"] >= got
    assert vals["xla/mem/bytes_limit/d0"] \
        == float(torch.cuda.mem_get_info(0)[1])
    assert reg.snapshot()["gauges"]["xla/mem/bytes_in_use/d0"]["value"] \
        == got
    assert txla.peak_tflops(card) == txla.PEAK_TFLOPS.get(
        torch.cuda.get_device_name(0))
