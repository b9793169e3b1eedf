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
from tpudist_torch.models.transformer import TransformerConfig, TransformerLM
from tpudist_torch.ops import _cuda
from tpudist_torch.ops import flash_attention as tfa
from tpudist_torch.ops import flash_decode as tfd
from tpudist_torch.utils.config import env_flag

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpudist")
CFG = TransformerConfig(vocab_size=32, num_layers=1, num_heads=2,
                        embed_dim=32, max_seq_len=16)


def _port_files():
    files = sorted((ROOT / "tpudist_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "examples" / "long_context_lm_gpu.py"]


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
        "import tpudist_torch.ops.flash_attention, tpudist_torch.ops.losses",
        "import tpudist_torch.train, tpudist_torch.parallel",
        "from tpudist_torch import TransformerConfig, TransformerLM",
        "from tpudist_torch import greedy_generate",
        "cfg = TransformerConfig(vocab_size=32, num_layers=1, num_heads=2,",
        "                        embed_dim=32, max_seq_len=16)",
        "g = torch.Generator().manual_seed(0)",
        "sd = TransformerLM(cfg, device='cpu').init_weights(g).state_dict()",
        "out = greedy_generate(cfg, sd, [[1, 2, 3]], 4, device='cpu')",
        "assert out.shape == (1, 7), out.shape",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
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


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors never touch the kernels: launch counts stay put and no
    kernel library is built or loaded."""
    f0, d0 = tfa.FLASH_FORWARD.launches, tfd.FLASH_DECODE.launches
    libs = dict(_cuda._libs)
    q = torch.randn(1, 5, 2, 16)
    k = torch.randn(1, 9, 2, 16)
    tfa._flash_forward(q, k, k, True, q_offset=4)
    tfd.flash_decode(q[:, :1], k, k, 7)
    sd = TransformerLM(CFG, device="cpu").state_dict()
    loop = tpudist_torch.ServeLoop(CFG, sd, num_slots=1, steps_per_sync=2,
                                   prefill_chunk=4, device="cpu")
    loop.run([tpudist_torch.Request(np.arange(5), 3)])
    assert tfa.FLASH_FORWARD.launches == f0
    assert tfd.FLASH_DECODE.launches == d0
    assert _cuda._libs == libs


def test_kernel_wrappers_reject_other_devices():
    q = torch.randn(1, 5, 2, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa._flash_forward(q, q, q, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfd.flash_decode(q[:, :1], q, q, 3)


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
