"""tpudist_torch's Trainer against the JAX package's, its snapshots and
exact evaluation, the utilities it stands on (config, metrics, logging:
the twins of ``tests/test_utils.py``), and the two MNIST examples run on
the CPU.

Trajectory parity: an MLP(hidden 1, features 64) on
``synthetic_mnist(n=512)``, Adam 1e-3, batch 64, the same shuffled order,
three epochs of tpudist's ``Trainer`` on ``data_mesh(1)`` and of the
port's on the CPU from the same weights (drawn with numpy in the shapes
``jax.eval_shape`` gives, then converted).  Tolerances (f32): each
epoch's mean loss within atol = rtol = 1e-5 (XLA's CPU dot and ATen's sum
in other orders: about 40 ulps of the first epoch's loss, measured 5e-6);
the parameters after the 24 Adam steps every element within 1e-4 and all
but one in 10,000 within 3e-6 (``tests/test_torch_training.py``'s bound
for Adam steps, which moves an element whose gradient is near zero by up
to lr on a difference in that gradient's last bits; measured 4.5e-7);
the test accuracy exactly equal.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from tpudist.data.loader import ShardedLoader as JaxLoader
from tpudist.data.mnist import synthetic_mnist
from tpudist.models import MLP as JaxMLP
from tpudist.runtime.mesh import data_mesh
from tpudist.train.trainer import Trainer as JaxTrainer
from tpudist.train.trainer import TrainerConfig as JaxTrainerConfig
from tpudist_torch.data import ShardedLoader
from tpudist_torch.models import MLP, from_flax_mlp_params
from tpudist_torch.train import Trainer, TrainerConfig, adam
from tpudist_torch.utils.config import cli_override, config_field
from tpudist_torch.utils.logging import coordinator_only, get_logger
from tpudist_torch.utils.metrics import (
    MetricLogger,
    Stopwatch,
    ThroughputMeter,
    maybe_profile,
)

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
BATCH = 64


def assert_params_close(got: dict, want: dict) -> None:
    """Parameters after Adam steps, by name (the module docstring's
    tolerance)."""
    assert set(got) == set(want)
    diff = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel()
                           for k in want])
    assert diff.max() <= 1e-4, diff.max()
    assert int((diff > 3e-6).sum()) <= diff.size * 1e-4


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist("train", n=512), synthetic_mnist("test", n=256)


@pytest.fixture(scope="module")
def flax_params(data):
    jm = JaxMLP(hidden_layers=1, features=64)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            data[0].images[:1])["params"]
    rng = np.random.default_rng(0)

    def draw(s):
        fan_in = s.shape[0] if len(s.shape) == 2 else 10
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree.map(draw, shapes)


def port_trainer(tmp_path, data, flax_params=None, *, snap="p.npz",
                 epochs=3, test_loader=None, **config):
    train, test = data
    model = MLP(1, 64, device="cpu")
    if flax_params is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(from_flax_mlp_params(flax_params))
    cfg = TrainerConfig(total_epochs=epochs, batch_size=BATCH,
                        snapshot_path=str(tmp_path / snap), log_every=1000,
                        **config)
    train_loader = ShardedLoader([train.images, train.labels], BATCH,
                                 shuffle=True, device="cpu")
    if test_loader is None:
        test_loader = ShardedLoader([test.images, test.labels], BATCH,
                                    drop_last=False, device="cpu")
    return Trainer(cfg, model, adam(1e-3), None, train_loader, test_loader)


@pytest.mark.parametrize("steps_per_dispatch", [1, 3])
def test_trajectory_matches_tpudist(tmp_path, data, flax_params,
                                    steps_per_dispatch):
    """Three epochs, epoch by epoch; at steps_per_dispatch=3 each epoch's
    8 steps are 2 stacked groups of 3 and 2 single tail steps on both
    sides."""
    train, test = data
    mesh = data_mesh(1)
    ref = JaxTrainer(
        JaxTrainerConfig(total_epochs=3, batch_size=BATCH,
                         snapshot_path=str(tmp_path / "j.npz"),
                         log_every=1000,
                         steps_per_dispatch=steps_per_dispatch),
        JaxMLP(hidden_layers=1, features=64).apply, flax_params,
        optax.adam(1e-3), mesh,
        JaxLoader([train.images, train.labels], BATCH, mesh, shuffle=True),
        JaxLoader([test.images, test.labels], BATCH, mesh, drop_last=False))
    port = port_trainer(tmp_path, data, flax_params,
                        steps_per_dispatch=steps_per_dispatch)
    assert (port.train_loop is not None) == (steps_per_dispatch > 1)
    for epoch in (1, 2, 3):
        want, got = ref.train(max_epochs=epoch), port.train(max_epochs=epoch)
        assert got["epoch"] == want["epoch"] == epoch - 1
        np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
        assert got["test_accuracy"] == want["test_accuracy"]
    assert port.state.step == int(ref.state.step) == 24
    assert_params_close(
        port.state.model.state_dict(),
        from_flax_mlp_params(jax.tree.map(np.asarray, ref.state.params)))


def _params(trainer) -> dict:
    return {k: v.clone() for k, v in trainer.state.model.state_dict().items()}


def test_resume_equals_uninterrupted_run(tmp_path, data):
    """Two epochs, then a new Trainer on the same snapshot for the third:
    the parameters, the optimizer state, the step and the epoch mean loss
    equal those of one uninterrupted three-epoch run bit for bit."""
    first = port_trainer(tmp_path, data, snap="r.npz", epochs=2)
    first.train()
    resumed = port_trainer(tmp_path, data, snap="r.npz", epochs=3)
    assert resumed.epochs_run == 2 and resumed.state.step == 16
    assert all(torch.equal(resumed.state.model.state_dict()[k], v)
               for k, v in _params(first).items())
    got = resumed.train()
    whole = port_trainer(tmp_path, data, snap="w.npz", epochs=3)
    want = whole.train()
    assert got["epoch"] == want["epoch"] == 2
    assert got["loss"] == want["loss"]
    assert resumed.state.step == whole.state.step == 24
    for k, v in _params(whole).items():
        assert torch.equal(resumed.state.model.state_dict()[k], v), k
    for a, b in zip(resumed.state.optimizer.state.values(),
                    whole.state.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_snapshot_is_durable_with_its_meta(tmp_path, data):
    trainer = port_trainer(tmp_path, data, epochs=2, async_snapshot=True)
    trainer.train()
    meta = json.loads((tmp_path / "p.meta.json").read_text())
    assert meta == {"epochs_run": 2, "step": 16, "seed": 0}
    with np.load(tmp_path / "p.npz") as z:
        assert "params/dense.0.weight" in z.files
        assert "opt_state/0/exp_avg" in z.files


@pytest.mark.parametrize("config", [dict(device_prefetch=0),
                                    dict(async_snapshot=False)])
def test_prefetch_and_sync_snapshot_change_no_number(tmp_path, data,
                                                     config):
    a = port_trainer(tmp_path, data, snap="a.npz", epochs=1).train()
    b = port_trainer(tmp_path, data, snap="b.npz", epochs=1,
                     **config).train()
    assert a["loss"] == b["loss"] and a["test_accuracy"] == \
        b["test_accuracy"]


def test_padded_test_loader_accuracy_is_exact(tmp_path, data):
    """N = 250 over 4 shards at drop_last=False pads 6 wrap-around rows:
    the shards' masked counts add up to the 250 true samples and to the
    correct count of one pass over them, and ``test()`` on one shard
    equals that single pass."""
    test = synthetic_mnist("test", n=250)
    trainer = port_trainer(tmp_path, data, epochs=1)
    trainer.train()
    model = trainer.state.model
    with torch.no_grad():
        want = int((model(torch.from_numpy(test.images)).argmax(-1)
                    == torch.from_numpy(test.labels)).sum())
    correct = total = 0
    for shard in range(4):
        ld = ShardedLoader([test.images, test.labels], BATCH,
                           drop_last=False, num_shards=4, shard=shard,
                           device="cpu")
        for step, batch in enumerate(ld.epoch(0)):
            c, t = trainer.eval_step(model, *batch, ld.valid_mask(step))
            correct, total = correct + int(c), total + int(t)
    assert (correct, total) == (want, 250)
    trainer.test_loader = ShardedLoader([test.images, test.labels], BATCH,
                                        drop_last=False, device="cpu")
    assert trainer.test() == want / 250


def test_profile_dir_writes_a_trace(tmp_path, data):
    trainer = port_trainer(tmp_path, data, epochs=1,
                           profile_dir=str(tmp_path / "trace"),
                           eval_every_epoch=False)
    trainer.train()
    traces = list((tmp_path / "trace").glob("trace_p0.json"))
    assert traces and json.loads(traces[0].read_text())["traceEvents"]


def test_trainer_takes_meshspec(tmp_path, data, flax_params):
    """A MeshSpec selects how the Trainer trains (tpudist's test of the
    same name, at fsdp 2 × tp 2 in 4 gloo ranks): two epochs, the second
    from a resumed snapshot, against tpudist's Trainer on the same spec
    over 4 virtual CPU devices.  The resumed state is the saved one bit
    for bit; losses, test accuracy and parameters hold to the trajectory
    test's tolerances."""
    from tests.test_torch_data_parallel import run_ranks
    from tests.test_torch_mesh_compose import trainer_rank
    from tpudist.parallel.mesh import MeshSpec as JaxMeshSpec

    train, test = data
    arrays = (train.images, train.labels, test.images, test.labels)
    sd = {k: v.numpy() for k, v in from_flax_mlp_params(flax_params).items()}
    results = run_ranks(trainer_rank, 4, tmp_path, sd, arrays, BATCH,
                        str(tmp_path / "mesh_snap.npz"))
    spec = JaxMeshSpec.parse("fsdp=2,tp=2")
    mesh = spec.build(jax.devices()[:4])
    ref = JaxTrainer(
        JaxTrainerConfig(total_epochs=2, batch_size=BATCH,
                         snapshot_path=str(tmp_path / "j.npz"),
                         log_every=1000, mesh_axes="fsdp=2,tp=2"),
        JaxMLP(hidden_layers=1, features=64).apply, flax_params,
        optax.adam(1e-3), mesh,
        JaxLoader([train.images, train.labels], BATCH, mesh,
                  data_axis=("dp", "fsdp")),
        JaxLoader([test.images, test.labels], BATCH, mesh,
                  data_axis=("dp", "fsdp"), drop_last=False))
    want = [ref.train(max_epochs=1), ref.train(max_epochs=2)]
    want_params = {k: torch.from_numpy(v.numpy()) for k, v in
                   from_flax_mlp_params(jax.tree.map(
                       np.asarray, ref.state.params)).items()}
    for res in results:
        assert res["mesh_spec"].fsdp == res["mesh_spec"].tp == 2
        assert res["epochs_run"] == 2
        assert res["shapes"]["dense.0.weight"] == (64, 784 // 2)
        for k, v in res["after_1"].items():
            assert np.array_equal(res["resumed"][k], v), k
        for got, w in zip(res["summaries"], want):
            np.testing.assert_allclose(got["loss"], w["loss"], **LOSS_TOL)
            assert got["test_accuracy"] == w["test_accuracy"]
        assert_params_close({k: torch.from_numpy(v) for k, v in
                             res["final"].items()}, want_params)


def test_trainer_rejects_pp_spec(tmp_path, data):
    from tpudist_torch.parallel import MeshSpec

    train, _ = data
    loader = ShardedLoader([train.images, train.labels], 16, device="cpu")
    with pytest.raises(ValueError, match="make_composed_train_step"):
        Trainer(TrainerConfig(total_epochs=1, batch_size=16,
                              snapshot_path=str(tmp_path / "x.npz")),
                MLP(1, 8, device="cpu"), adam(1e-3),
                MeshSpec(dp=2, pp=2, num_microbatches=4), loader)


def test_config_errors_raise(tmp_path, data):
    train, _ = data
    loader = ShardedLoader([train.images, train.labels], 32, device="cpu")
    model = MLP(1, 64, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        Trainer(TrainerConfig(batch_size=64,
                              snapshot_path=str(tmp_path / "x.npz")),
                model, adam(1e-3), None, loader)
    cfg = TrainerConfig(batch_size=32, mesh_axes="dp=2,fsdp=2",
                        snapshot_path=str(tmp_path / "x.npz"))
    with pytest.raises(ValueError, match="MeshSpec.parse"):
        Trainer(cfg, model, adam(1e-3), None, loader)
    cfg = dataclasses.replace(cfg, mesh_axes="")
    with pytest.raises(TypeError, match="MeshSpec"):
        Trainer(cfg, model, adam(1e-3), object(), loader)


# ---- config, metrics, logging (the twins of tests/test_utils.py) ----------

@dataclasses.dataclass
class _Cfg:
    epochs: int = config_field(3, "total epochs")
    lr: float = config_field(0.1, "learning rate")
    name: str = config_field("run", "run name")
    bf16: bool = config_field(False, "bfloat16 compute")


def test_config_defaults_and_overrides():
    assert cli_override(_Cfg, []) == _Cfg()
    cfg = cli_override(_Cfg, ["--epochs", "7", "--lr", "3e-4", "--name",
                              "x", "--bf16", "true"])
    assert cfg.epochs == 7 and isinstance(cfg.epochs, int)
    assert cfg.lr == pytest.approx(3e-4) and cfg.name == "x"
    assert cfg.bf16 is True
    for spelling in ("0", "false", "no"):
        assert cli_override(_Cfg, ["--bf16", spelling]).bf16 is False


def test_trainer_config_cli_covers_every_field():
    cfg = cli_override(TrainerConfig, ["--steps-per-dispatch", "4",
                                       "--async-snapshot", "false"])
    assert cfg.steps_per_dispatch == 4 and cfg.async_snapshot is False
    jfields = {f.name: f.default for f in dataclasses.fields(
        JaxTrainerConfig)}
    pfields = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    assert pfields == jfields


def test_throughput_meter_excludes_warmup():
    m = ThroughputMeter(warmup_steps=1)
    m.start()
    time.sleep(0.05)   # warm-up step: excluded from the rate
    m.step(1000)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.01:
        pass
    m.step(100, block=True)
    assert 0 < m.items_per_sec < 100 / 0.0099
    assert m.mean_step_time > 0
    sw = Stopwatch()
    assert sw.elapsed(block=True) > 0


def test_metric_logger_means_scalars_and_stacked():
    ml = MetricLogger()
    ml.update(loss=2.0, acc=torch.tensor(0.5))
    ml.update(loss=torch.tensor([4.0, 6.0]), acc=1.0)
    means = ml.means()
    assert means["loss"] == pytest.approx(4.0)
    assert means["acc"] == pytest.approx(0.75)
    assert ml.reset() == means and ml.means() == {}


def test_maybe_profile_noop_and_trace(tmp_path):
    with maybe_profile(None):
        pass
    with maybe_profile(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert any((tmp_path / "trace").rglob("*.json")), "no trace written"


def test_logger_stamps_rank_and_coordinator_only():
    log = get_logger("tpudist_torch.test")
    handler = logging.getLogger("tpudist_torch").handlers[0]
    record = log.makeRecord(log.name, logging.INFO, __file__, 1, "hello",
                            None, None)
    assert "[p0]" in handler.format(record)
    assert coordinator_only(log) is log and log.level != logging.WARNING


# ---- the examples, on the CPU ---------------------------------------------

EXAMPLES = ("mnist_ddp_elastic_gpu.py", "mnist_horovod_gpu.py")


def _run(script, *args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(cwd))


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_help(script, tmp_path):
    res = _run(script, "--help", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout and "--limit" in res.stdout


def test_ddp_example_trains_and_resumes_on_cpu(tmp_path):
    args = ["--device", "cpu", "--limit", "256", "--batch_size", "32",
            "--features", "64", "--hidden-layers", "1", "--snapshot-path",
            str(tmp_path / "snap.npz")]
    res = _run("mnist_ddp_elastic_gpu.py", "1", "1", *args, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "Training completed in" in res.stdout
    res = _run("mnist_ddp_elastic_gpu.py", "2", "1", *args, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "Resuming from snapshot at epoch 1" in res.stderr
    assert "'epoch': 1" in res.stdout


def test_horovod_example_trains_on_cpu(tmp_path):
    res = _run("mnist_horovod_gpu.py", "--device", "cpu", "--epochs", "2",
               "--batch-size", "64", "--limit", "256", "--log-every", "2",
               cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    losses = [float(line.rsplit(":", 1)[1]) for line in
              res.stdout.splitlines() if line.startswith("Train Epoch")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
