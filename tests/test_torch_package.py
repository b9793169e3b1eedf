"""tpudist_torch stands alone: it imports neither JAX nor the JAX package,
runs on the card unless told otherwise, and sends CPU tensors to the plain
versions of its kernels without ever loading the kernel libraries."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpudist_torch
from tpudist_torch.models.moe import MoEConfig, MoETransformerLM
from tpudist_torch.models.transformer import TransformerConfig, TransformerLM
from tpudist_torch.ops import _cuda
from tpudist_torch.ops import flash_attention as tfa
from tpudist_torch.ops import flash_decode as tfd
from tpudist_torch.ops import group_norm as tgn
from tpudist_torch.ops import moe_dispatch as tmd
from tpudist_torch.parallel import ring_flash_attention_fn
from tpudist_torch.utils.config import env_flag

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpudist")
CFG = TransformerConfig(vocab_size=32, num_layers=1, num_heads=2,
                        embed_dim=32, max_seq_len=16)


def _port_files():
    files = sorted((ROOT / "tpudist_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    *sorted((ROOT / "examples").glob("*_gpu.py"))]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    """AST scan: no import of jax, flax, optax or the tpudist package
    (``tpudist_torch`` itself is fine)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}: imports {name}"


def test_imports_and_runs_with_jax_blocked():
    """With jax, flax and tpudist made unimportable, the whole package
    imports and a CPU greedy rollout runs."""
    code = "\n".join([
        "import sys",
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'tpudist'):",
        "    sys.modules[m] = None",
        "import torch, tpudist_torch",
        "import tpudist_torch.models.serving, tpudist_torch.ops.flash_decode",
        "import tpudist_torch.models.kv_pages",
        "import tpudist_torch.ops.flash_attention, tpudist_torch.ops.losses",
        "import tpudist_torch.train, tpudist_torch.parallel",
        "import tpudist_torch.runtime, tpudist_torch.parallel.ring_attention",
        "import tpudist_torch.models.moe, tpudist_torch.ops.moe_dispatch",
        "import tpudist_torch.ops.group_norm, tpudist_torch.ops.batch_norm",
        "import tpudist_torch.models.resnet, tpudist_torch.models.convert",
        "import tpudist_torch.runtime.coord, tpudist_torch.runtime.faults",
        "import tpudist_torch.runtime.collectives",
        "import tpudist_torch.runtime.launch, tpudist_torch.elastic.worker",
        "from tpudist_torch.elastic import ElasticState, elastic_run",
        "from tpudist_torch.train import adamw, init_optimizer_state",
        "from tpudist_torch.data import synthetic_images",
        "from tpudist_torch.models import ResNet50, resnet50_stages",
        "from tpudist_torch.ops import GroupNorm, BatchNorm",
        "from tpudist_torch.train import sgd, fold_in",
        "from tpudist_torch.models import MoEConfig, MoETransformerLM",
        "from tpudist_torch import TransformerConfig, TransformerLM",
        "from tpudist_torch import greedy_generate",
        "cfg = TransformerConfig(vocab_size=32, num_layers=1, num_heads=2,",
        "                        embed_dim=32, max_seq_len=16)",
        "g = torch.Generator().manual_seed(0)",
        "sd = TransformerLM(cfg, device='cpu').init_weights(g).state_dict()",
        "out = greedy_generate(cfg, sd, [[1, 2, 3]], 4, device='cpu')",
        "assert out.shape == (1, 7), out.shape",
        "moe = MoETransformerLM(cfg, MoEConfig(num_experts=4,",
        "                       dispatch='fused', fused_block_rows=8),",
        "                       device='cpu').init_weights(g)",
        "logits, aux = moe(torch.tensor([[1, 2, 3]]))",
        "assert logits.shape == (1, 3, 32), logits.shape",
        "from tpudist_torch.parallel import ring_flash_attention_fn",
        "q = torch.randn(1, 8, 2, 16, requires_grad=True)",
        "ring_flash_attention_fn()(q, q, q).sum().backward()",
        "x = torch.randn(2, 4, 4, 64, requires_grad=True)",
        "GroupNorm(64, fused='add_relu', device='cpu')(x, x).sum().backward()",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_scan_covers_the_elastic_slice():
    """The import scan reaches every module of the elastic slice, its
    example and chip_smoke.py."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"chip_smoke.py", "examples/horovod_mnist_elastic_gpu.py",
            "tpudist_torch/runtime/coord.py",
            "tpudist_torch/runtime/collectives.py",
            "tpudist_torch/runtime/faults.py",
            "tpudist_torch/runtime/launch.py",
            "tpudist_torch/elastic/state.py",
            "tpudist_torch/elastic/loop.py",
            "tpudist_torch/elastic/worker.py"} <= scanned


def test_scan_covers_the_fleet_slice():
    """The import scan reaches every module of the observability core and
    the serve fleet, and the fleet example."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"examples/serve_fleet_gpu.py",
            *(f"tpudist_torch/obs/{m}.py" for m in (
                "__init__", "registry", "spans", "events", "aggregate",
                "recorder", "health", "export")),
            *(f"tpudist_torch/runtime/{m}.py" for m in (
                "wire", "prefix_directory", "quarantine", "disagg",
                "router"))} <= scanned


def test_fleet_modules_import_with_jax_blocked():
    """With jax, flax, tpudist and ml_dtypes made unimportable, the obs
    core and the fleet import, a registry folds a tensor, a bf16 KV
    payload round-trips the wire, and a router picks a replica."""
    code = "\n".join([
        "import sys",
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'tpudist',",
        "          'ml_dtypes'):",
        "    sys.modules[m] = None",
        "import torch",
        "from tpudist_torch import obs",
        "from tpudist_torch.runtime import (wire, prefix_directory,",
        "                                   quarantine, disagg, router)",
        "obs.counter('c').inc(torch.tensor([1.0, 2.0]))",
        "assert obs.snapshot()['counters']['c']['value'] == 3.0",
        "layer = {'k': torch.ones(1, 8, 4, dtype=torch.bfloat16),",
        "         'v': torch.zeros(1, 8, 4, dtype=torch.bfloat16)}",
        "doc = disagg.encode_payload({'prompt': [1], 'chain': [2],",
        "                             'layers': [layer]})",
        "assert doc['layers'][0]['k']['dtype'] == 'bfloat16'",
        "back = disagg.decode_payload(wire.decode_record(",
        "    wire.encode_record('kv_migration', doc)))",
        "assert torch.equal(back['layers'][0]['k'], layer['k'])",
        "r = router.Router(None, use_health=False, quarantine=False)",
        "assert r._pick(['a', 'b'], {}, {'a': 1}) == 'b'",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_store_collectives_run_with_jax_blocked():
    """With jax, flax and tpudist made unimportable, the coordination
    store, a two-rank host allreduce (bf16 on the wire) and an elastic
    state's commit and rollback run."""
    code = "\n".join([
        "import sys, threading",
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'tpudist',",
        "          'ml_dtypes'):",
        "    sys.modules[m] = None",
        "import numpy as np, torch",
        "from tpudist_torch.runtime.coord import CoordServer, CoordClient",
        "from tpudist_torch.runtime.collectives import HostCollectives",
        "from tpudist_torch.elastic import ElasticState",
        "from tpudist_torch.models import MLP",
        "from tpudist_torch.train import TrainState, adamw",
        "srv = CoordServer(0)",
        "out = [None, None]",
        "def rank(r):",
        "    with CoordClient(port=srv.port) as c:",
        "        coll = HostCollectives(c, r, 2)",
        "        out[r] = coll.allreduce_mean({'g': torch.ones(5) * r})",
        "        coll.close()",
        "ts = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]",
        "[t.start() for t in ts]; [t.join(60) for t in ts]",
        "assert torch.equal(out[0]['g'], torch.full((5,), 0.5)), out",
        "srv.stop()",
        "m = MLP(1, 8, device='cpu')",
        "es = ElasticState(TrainState.create(m, adamw(1e-3)))",
        "w = m.dense[0].weight.detach().clone()",
        "m(torch.ones(2, 784)).sum().backward()",
        "es.state.apply_gradients()",
        "es.rollback()",
        "assert torch.equal(m.dense[0].weight, w)",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_trainer_stack_runs_with_jax_blocked(tmp_path):
    """With jax, flax and tpudist made unimportable, the MNIST training
    stack imports and a one-epoch CPU Trainer run snapshots, resumes and
    evaluates."""
    code = "\n".join([
        "import sys",
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'tpudist'):",
        "    sys.modules[m] = None",
        "import torch",
        "from tpudist_torch import Trainer, TrainerConfig",
        "from tpudist_torch.data import ShardedLoader, load_mnist",
        "from tpudist_torch.data.mnist import load_real_digits",
        "from tpudist_torch.models import ConvNet, EmbeddingBagClassifier",
        "from tpudist_torch.models import MLP",
        "from tpudist_torch.elastic import Checkpointer",
        "from tpudist_torch.parallel import make_dp_masked_eval_step",
        "from tpudist_torch.train import adam",
        "import tpudist_torch.data.native, tpudist_torch.utils.metrics",
        "ds = load_real_digits('test')",
        f"snap = {str(tmp_path / 's.npz')!r}",
        "for epochs in (1, 2):",
        "    m = MLP(1, 32, device='cpu')",
        "    m.init_weights(torch.Generator().manual_seed(0))",
        "    ld = ShardedLoader([ds.images, ds.labels], 32, device='cpu')",
        "    cfg = TrainerConfig(total_epochs=epochs, batch_size=32,",
        "                        snapshot_path=snap)",
        "    t = Trainer(cfg, m, adam(1e-3), None, ld, ld)",
        "    assert t.epochs_run == epochs - 1",
        "    out = t.train()",
        "assert 0 <= out['test_accuracy'] <= 1, out",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is usable")
    sd = TransformerLM(CFG, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpudist_torch.greedy_generate(CFG, sd, [[1, 2]], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpudist_torch.ServeLoop(CFG, sd, num_slots=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoETransformerLM(CFG, MoEConfig(dispatch="fused"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpudist_torch.runtime.initialize("file:///nonexistent", 2, 0)


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors never touch the kernels: launch counts stay put and no
    kernel library is built or loaded."""
    kernels = (tfa.FLASH_FORWARD, tfa.FLASH_BWD_DQ, tfa.FLASH_BWD_DKV,
               tfa.FLASH_BWD_DQ_DELTA, tfd.FLASH_DECODE,
               tfd.PAGED_FLASH_DECODE, tfd.FLASH_DECODE_Q8, tmd.MOE_GMM,
               tgn.GN_FWD, tgn.GN_BWD)
    counts = [k.launches for k in kernels]
    libs = dict(_cuda._libs)
    q = torch.randn(1, 5, 2, 16)
    k = torch.randn(1, 9, 2, 16)
    tfa._flash_forward(q, k, k, True, q_offset=4)
    tfd.flash_decode(q[:, :1], k, k, 7)
    pool = torch.randn(3, 8, 32)
    table = torch.tensor([[2, 0]], dtype=torch.int32)
    tfd.paged_flash_decode(q[:, :1], pool, pool, table,
                           torch.tensor([11]), packed_kv_heads=2)
    tfd.flash_decode_q8(q[:, :1], *tfd.quantize_kv(k, k), 7)
    sd = TransformerLM(CFG, device="cpu").state_dict()
    for layout in ("dense", "paged"):
        loop = tpudist_torch.ServeLoop(CFG, sd, num_slots=1,
                                       steps_per_sync=2, prefill_chunk=4,
                                       cache_layout=layout, kv_block_size=8,
                                       device="cpu")
        loop.run([tpudist_torch.Request(np.arange(5), 3)])
    moe = MoETransformerLM(CFG, MoEConfig(num_experts=4, dispatch="fused",
                                          fused_block_rows=8),
                           attention_fn=tfa.flash_attention_fn(),
                           device="cpu")
    logits, aux = moe(torch.tensor([[1, 2, 3, 4]]))
    (logits.sum() + aux).backward()
    # the ring flash route (K1, then K8 and K4 with an explicit Delta)
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    ring_flash_attention_fn()(x, x, x).sum().backward()
    # the fused GroupNorm modes (K9, K10), through the module
    x = torch.randn(2, 4, 4, 64, requires_grad=True)
    tgn.GroupNorm(64, fused="relu", device="cpu")(x).sum().backward()
    tgn.GroupNorm(64, fused="add_relu", device="cpu")(x, x).sum().backward()
    tgn.group_norm_act(x, torch.ones(64), torch.zeros(64), 32, 1e-6,
                       "plain").sum().backward()
    assert [k.launches for k in kernels] == counts
    assert _cuda._libs == libs


def test_kernel_wrappers_reject_other_devices():
    q = torch.randn(1, 5, 2, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa._flash_forward(q, q, q, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfd.flash_decode(q[:, :1], q, q, 3)
    lse = torch.zeros(1, 2, 5, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_block_grads(q, q, q, q, lse, lse, causal=True)
    pool = torch.randn(3, 8, 32, device="meta")
    table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfd.paged_flash_decode(q[:, :1], pool, pool, table,
                               torch.tensor([3], device="meta"),
                               packed_kv_heads=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfd.flash_decode_q8(q[:, :1], q.to(torch.int8), q[..., :1],
                            q.to(torch.int8), q[..., :1], 3)
    x = torch.randn(2, 4, 4, 64, device="meta")
    w = torch.ones(64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgn._fused_call_fwd(x, w, w, None, 32, 1e-6, "relu")
    mean = torch.zeros(2, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgn._fused_call_bwd(x, x, w, w, mean, mean, x, 32, "add_relu")


def test_build_is_keyed_by_source_content(tmp_path, monkeypatch):
    """A kernel library's file name hashes its source and headers, so an
    edited kernel rebuilds and an unchanged one is reused."""
    src = tmp_path / "k.cu"
    src.write_text("int x;")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "_build")
    a = _cuda._lib_path(src)
    assert a == _cuda._lib_path(src)
    (tmp_path / "common.cuh").write_text("// header")
    b = _cuda._lib_path(src)
    src.write_text("int y;")
    assert len({a, b, _cuda._lib_path(src)}) == 3


@pytest.mark.parametrize("raw,want", [
    (None, False), ("", False), ("0", False), ("false", False),
    ("Off", False), ("1", True), ("yes", True), ("on", True)])
def test_env_flag(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("TPUDIST_TORCH_TEST_FLAG", raising=False)
    else:
        monkeypatch.setenv("TPUDIST_TORCH_TEST_FLAG", raw)
    assert env_flag("TPUDIST_TORCH_TEST_FLAG") is want


# ---- on the card ----------------------------------------------------------

@pytest.mark.cuda
def test_cuda_tensor_launches_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    q = torch.randn(1, 5, 2, 16, device="cuda")
    before = tfa.FLASH_FORWARD.launches
    tfa._flash_forward(q, q, q, True)
    torch.cuda.synchronize()
    assert tfa.FLASH_FORWARD.launches == before + 1
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.randn(1, 5, 2, 24, device="cuda")
        tfa._flash_forward(x, x, x, True)


@pytest.mark.cuda
def test_group_norm_kernels_need_channels_last_layout():
    """K9 and K10 read ``[B, H·W, C]``: an NHWC view of a channels-first
    tensor raises (no quiet copy), as does a residual or gradient in that
    layout; the contiguous tensors launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K9 and K10 have no CPU "
                    "mode)")
    nchw = torch.randn(2, 64, 4, 4, device="cuda").to(torch.bfloat16)
    x = nchw.permute(0, 2, 3, 1)                   # NHWC view, NCHW memory
    good = x.contiguous()
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(ValueError, match="contiguous NHWC"):
        tgn._fused_call_fwd(x, w, b, None, 32, 1e-6, "relu")
    with pytest.raises(ValueError, match="contiguous NHWC"):
        tgn._fused_call_fwd(good, w, b, x, 32, 1e-6, "add_relu")
    before = tgn.GN_FWD.launches
    _, mean, rstd = tgn._fused_call_fwd(good, w, b, None, 32, 1e-6, "relu")
    torch.cuda.synchronize()
    assert tgn.GN_FWD.launches == before + 1
    with pytest.raises(ValueError, match="contiguous NHWC"):
        tgn._fused_call_bwd(good, x, w, b, mean, rstd, None, 32, "relu")
