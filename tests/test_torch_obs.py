"""tpudist_torch.obs's registry, aggregation, exporters, spans and flight
recorder against the JAX package's ``tpudist.obs``.

The same recordings (seeded with numpy; the port is handed CPU tensors
where tpudist is handed numpy arrays) must give equal snapshots key for
key, equal quantiles, equal merged cluster views and byte-equal JSONL and
Prometheus text.  The registry's one batched transfer of pending CUDA
values is checked on the card (marker ``cuda``)."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from tpudist_torch import obs as tobs

# obs.registry / obs.recorder name the process-global instances, so the
# modules come by path
tagg = importlib.import_module("tpudist_torch.obs.aggregate")
texp = importlib.import_module("tpudist_torch.obs.export")
trec = importlib.import_module("tpudist_torch.obs.recorder")
treg = importlib.import_module("tpudist_torch.obs.registry")


@pytest.fixture(scope="module")
def ref():
    """tpudist.obs's modules (imported here so a card run of the cuda
    tests, which has no JAX package to spare, collects)."""
    return {m: importlib.import_module(f"tpudist.obs.{m}")
            for m in ("registry", "aggregate", "export", "spans",
                      "recorder")}


def _script(seed: int, n: int = 60) -> list[tuple]:
    """A seeded op list: (kind, name, value) with scalars, arrays,
    zeros and negatives (the histogram's zero bucket)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["counter", "gauge", "hist", "hist_arr",
                           "counter_arr"])
        name = f"t/{kind}_{int(rng.integers(0, 3))}"
        if kind == "counter":
            ops.append((kind, name, int(rng.integers(0, 9))))
        elif kind == "counter_arr":
            ops.append(("counter", name,
                        rng.integers(0, 5, size=3).astype(np.float32)))
        elif kind == "gauge":
            ops.append((kind, name, float(rng.normal())))
        elif kind == "hist":
            ops.append((kind, name, float(rng.choice(
                [0.0, -1.0, 2.0 ** int(rng.integers(-4, 4)),
                 float(rng.exponential())]))))
        else:
            ops.append(("hist", name,
                        rng.exponential(size=5).astype(np.float32)))
    ops.append(("hist", "t/labeled~replica=r0~class=a", 0.5))
    ops.append(("counter", "t/labeled~replica=r0", 3))
    return ops


def _apply(reg, ops, as_tensor: bool) -> None:
    for kind, name, v in ops:
        if as_tensor and isinstance(v, np.ndarray):
            v = torch.from_numpy(v.copy())
        if kind == "counter":
            reg.counter(name, unit="u").inc(v)
        elif kind == "gauge":
            reg.gauge(name, unit="g").set(v)
        else:
            reg.histogram(name, unit="s").record(v)


def _snaps(ref, seed):
    ops = _script(seed)
    want_reg, got_reg = ref["registry"].MetricRegistry(), tobs.MetricRegistry()
    _apply(want_reg, ops, as_tensor=False)
    _apply(got_reg, ops, as_tensor=True)
    want, got = want_reg.snapshot(), got_reg.snapshot()
    got["time"] = want["time"]
    return want, got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshots_equal_key_for_key(ref, seed):
    want, got = _snaps(ref, seed)
    assert got == want


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_hist_quantile_and_summary_equal(ref, q):
    want, got = _snaps(ref, 3)
    for name, h in want["histograms"].items():
        w = ref["registry"].hist_quantile(h, q)
        g = treg.hist_quantile(got["histograms"][name], q)
        assert (np.isnan(w) and np.isnan(g)) or w == g, name
        assert treg.summarize(got["histograms"][name]) == \
            ref["registry"].summarize(h)


def test_values_to_hist_and_labels_equal(ref):
    vals = np.random.default_rng(4).exponential(size=50).tolist() + [0.0]
    assert treg.values_to_hist(vals, growth=1.5, unit="s") == \
        ref["registry"].values_to_hist(vals, growth=1.5, unit="s")
    for name in ("a", "a~k=v~x=y", "a~bare~k=v"):
        assert treg.split_labels(name) == ref["registry"].split_labels(name)
    for bad in ("", "~k=v", "a~k", "a~k=v=w", "a~k-1=v"):
        with pytest.raises(ValueError):
            ref["registry"].validate_metric_name(bad)
        with pytest.raises(ValueError):
            treg.validate_metric_name(bad)


def test_windowed_histogram_expires_like_tpudist(ref):
    """Two rotating half-window generations on an injected clock."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    hs = [ref["registry"].Histogram("w", window_s=10.0, clock=clock),
          treg.Histogram("w", window_s=10.0, clock=clock)]
    snaps = [[], []]
    for step, v in enumerate([1.0, 2.0, 4.0, 8.0, 0.5, 16.0, 32.0]):
        t[0] = step * 3.0
        for h, out in zip(hs, snaps):
            h.record(v)
            out.append(h.summary())
    assert snaps[1] == snaps[0]


def test_merge_snapshots_and_collect_equal(ref):
    """Three ranks' snapshots merged into one cluster view."""
    per_rank_w, per_rank_g = {}, {}
    for rank in range(3):
        w, g = _snaps(ref, 10 + rank)
        per_rank_w[rank], per_rank_g[rank] = w, g
    assert tagg.merge_snapshots(per_rank_g) == \
        ref["aggregate"].merge_snapshots(per_rank_w)


def test_publisher_round_trip_through_a_store(ref):
    class Store:
        def __init__(self):
            self.kv = {}

        def set(self, k, v):
            self.kv[k] = v

        def get(self, k):
            return self.kv.get(k)

        def keys(self, prefix=""):
            return [k for k in self.kv if k.startswith(prefix)]

    want_reg = ref["registry"].MetricRegistry()
    got_reg = tobs.MetricRegistry()
    ops = _script(20)
    _apply(want_reg, ops, as_tensor=False)
    _apply(got_reg, ops, as_tensor=True)
    s1, s2 = Store(), Store()
    ref["aggregate"].MetricsPublisher(s1, 0, want_reg, namespace="m").publish()
    tagg.MetricsPublisher(s2, 0, got_reg, namespace="m").publish()
    w = ref["aggregate"].collect(s1, "m")
    g = tagg.collect(s2, "m")
    assert set(g) == set(w) == {0}
    for doc in (w[0], g[0]):
        for key in ("time", "published_at", "age_s"):
            doc.pop(key)
    assert g == w


def test_prometheus_and_jsonl_text_equal(ref):
    want, got = _snaps(ref, 5)
    assert texp.to_prometheus(got) == ref["export"].to_prometheus(want)
    assert texp.snapshot_to_jsonl(got, run="x") == \
        ref["export"].snapshot_to_jsonl(want, run="x")
    assert texp.jsonl_line("m", 1.5, "s", vs_baseline=2.0, a=1) == \
        ref["export"].jsonl_line("m", 1.5, "s", vs_baseline=2.0, a=1)


def test_metrics_server_serves_the_port_registry():
    import urllib.request

    reg = tobs.MetricRegistry()
    reg.counter("serve/tokens", unit="tokens").inc(torch.tensor(7))
    srv = tobs.MetricsServer(reg, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=5).read()
        assert b"serve_tokens" in text and b" 7" in text
        body = urllib.request.urlopen(base + "/healthz", timeout=5).read()
        assert json.loads(body)["status"] == "ok"
    finally:
        srv.close()


def test_plain_numbers_never_touch_torch(monkeypatch):
    """A snapshot of plain Python recordings never calls into torch."""
    reg = tobs.MetricRegistry()
    reg.counter("c").inc(3)
    reg.gauge("g").set(1.5)
    reg.histogram("h").record(0.25)

    def boom(*a, **k):
        raise AssertionError("torch touched for plain numbers")

    monkeypatch.setattr(torch, "cat", boom)
    monkeypatch.setattr(torch.Tensor, "cpu", boom)
    snap = reg.snapshot()
    assert snap["counters"]["c"]["value"] == 3.0
    assert snap["histograms"]["h"]["count"] == 1


def test_cpu_tensors_fold_without_a_device_copy(monkeypatch):
    """CPU tensors (bf16 among them) fold to the same values as numpy;
    no ``.cpu()`` copy is issued for them."""
    reg = tobs.MetricRegistry()
    reg.counter("c").inc(torch.tensor([1.0, 2.0], dtype=torch.bfloat16))
    reg.gauge("g").set(torch.tensor([3.0, 4.0]))
    reg.histogram("h").record(torch.tensor([0.5, 2.0, 0.0]))
    monkeypatch.setattr(torch, "cat", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("stacked copy for CPU tensors")))
    snap = reg.snapshot()
    assert snap["counters"]["c"]["value"] == 3.0
    assert snap["gauges"]["g"]["value"] == 4.0
    assert snap["histograms"]["h"]["count"] == 3
    assert snap["histograms"]["h"]["zero"] == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_values_fold_in_one_stacked_copy(card, monkeypatch):
    """Every pending CUDA value of every metric crosses in ONE ``.cpu()``
    of one concatenated tensor, and recording never syncs."""
    reg = tobs.MetricRegistry()
    for i in range(5):
        reg.counter("c").inc(torch.tensor(float(i), device=card))
        reg.gauge("g").set(torch.tensor([1.0, float(i)], device=card))
        reg.histogram("h").record(torch.full((3,), 2.0 ** i, device=card))
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    snap = reg.snapshot()
    assert len(calls) == 1
    assert snap["counters"]["c"]["value"] == 10.0
    assert snap["gauges"]["g"]["value"] == 4.0
    assert snap["histograms"]["h"]["count"] == 15


def test_spans_chrome_trace_and_fence(tmp_path, monkeypatch):
    """Spans nest with depth, carry args, ring-evict the oldest, write
    an atomic Chrome trace; a fence without CUDA initialised is a no-op."""
    tr = tobs.SpanTracer(max_events=3, fence=True)
    with tr.span("outer", a=1):
        with tr.span("inner"):
            pass
    for i in range(3):
        with tr.span("x", i=i):
            pass
    ev = tr.events()
    assert [e["name"] for e in ev] == ["x", "x", "x"] and tr.dropped == 2
    path = tr.write(str(tmp_path / "trace.json"))
    doc = json.load(open(path))
    assert doc["displayTimeUnit"] == "ms" and len(doc["traceEvents"]) == 3
    tr2 = tobs.SpanTracer()
    with tr2.span("outer"):
        with tr2.span("inner", k="v"):
            pass
    inner, outer = tr2.events()
    assert inner["args"] == {"depth": 1, "k": "v"}
    assert outer["args"] == {"depth": 0}
    monkeypatch.setenv("TPUDIST_OBS_FENCE", "1")
    assert tobs.SpanTracer().fence is True


def test_spans_are_profiler_regions():
    tr = tobs.SpanTracer()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("serve/segment", steps=4):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "serve/segment" in names


def test_recorder_bundle_schema_and_topology(ref, tmp_path, monkeypatch):
    """The post-mortem keeps tpudist's schema and keys; its env surface
    is TPUDIST_/CUDA_/NCCL_/TORCH_; its topology is {} while neither
    CUDA nor a process group is initialised."""
    monkeypatch.setenv("TPUDIST_X", "1")
    monkeypatch.setenv("NCCL_DEBUG", "WARN")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    reg = tobs.MetricRegistry()
    reg.counter("c").inc(2)
    tr = tobs.SpanTracer()
    with tr.span("s"):
        pass
    ev = tobs.RequestEventLog()
    ev.record("admit", trace="t1", slot=0)
    rec = tobs.FlightRecorder(capacity=2, registry=reg, tracer=tr,
                              request_events=ev)
    for i in range(3):
        rec.record("tick", i=i)
    assert rec.dropped == 1
    try:
        raise ValueError("boom")
    except ValueError as e:
        path = rec.dump(exc=e, path=str(tmp_path / "pm.json"))
    doc = json.load(open(path))
    want = ref["recorder"].FlightRecorder(
        registry=ref["registry"].MetricRegistry()).bundle()
    assert tobs.POSTMORTEM_SCHEMA == ref["recorder"].POSTMORTEM_SCHEMA
    assert set(doc) == set(want)
    assert doc["schema"] == "tpudist.postmortem/1"
    assert doc["exception"]["type"] == "ValueError"
    assert [e["i"] for e in doc["events"]] == [1, 2]
    assert doc["snapshot"]["counters"]["c"]["value"] == 2.0
    assert doc["request_events"][0]["kind"] == "admit"
    assert set(doc["env"]) >= {"TPUDIST_X", "NCCL_DEBUG"}
    assert "JAX_PLATFORMS" not in doc["env"]
    if not torch.cuda.is_initialized():
        assert trec._topology() == {}


def test_recorder_guard_dumps_and_reraises(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDIST_POSTMORTEM_DIR", str(tmp_path))
    rec = tobs.FlightRecorder()
    with pytest.raises(KeyError):
        with rec.guard("serve_loop", num_slots=2):
            raise KeyError("x")
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("postmortem-")
    doc = json.load(open(tmp_path / files[0]))
    assert doc["context"] == {"component": "serve_loop", "num_slots": 2}


def test_package_exports_the_process_globals():
    for name in ("registry", "tracer", "events", "slo", "recorder",
                 "counter", "gauge", "histogram", "snapshot", "span"):
        assert hasattr(tobs, name)
    assert tobs.counter.__self__ is tobs.registry
    # the whole plane is ported: tpudist.obs's exports are all here
    ref = importlib.import_module("tpudist.obs")
    assert set(ref.__all__) <= set(tobs.__all__)
    for name in ("TSDB", "AlertManager", "mfu"):
        assert hasattr(tobs, name)
