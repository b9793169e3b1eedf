"""tpudist on PyTorch and CUDA: the port of :mod:`tpudist` to an NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout so a
reader finds each module's counterpart (``tpudist/models/serving.py`` ->
``tpudist_torch/models/serving.py``).  It imports ``torch`` and ``numpy``
only — never JAX, flax or anything under ``tpudist``.

Every TPU (Pallas) kernel on a ported path is a CUDA C++ kernel written for
Hopper (``tpudist_torch/csrc``), built with ``nvcc`` at first use and bound
with ``ctypes``.  A CUDA tensor goes to the kernel or the call raises; a
CPU tensor takes the kernel's plain PyTorch version (tests only).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import importlib

# the exports load on first use (PEP 562), so a stdlib-only module such as
# tpudist_torch.sim.scenario imports without torch
_EXPORTS = {
    "from_flax_params": "tpudist_torch.models.convert",
    "greedy_generate": "tpudist_torch.models.generate",
    "Completion": "tpudist_torch.models.serving",
    "Request": "tpudist_torch.models.serving",
    "ServeLoop": "tpudist_torch.models.serving",
    "TransformerConfig": "tpudist_torch.models.transformer",
    "TransformerLM": "tpudist_torch.models.transformer",
    "data_mesh": "tpudist_torch.runtime",
    "make_mesh": "tpudist_torch.runtime",
    "Trainer": "tpudist_torch.train.trainer",
    "TrainerConfig": "tpudist_torch.train.trainer",
}
_SUBPACKAGES = ("data", "elastic", "models", "obs", "ops", "parallel",
                "runtime", "sim", "train", "utils")

__version__ = "0.1.0"

__all__ = [
    "Completion",
    "Request",
    "ServeLoop",
    "Trainer",
    "TrainerConfig",
    "TransformerConfig",
    "TransformerLM",
    "data_mesh",
    "from_flax_params",
    "greedy_generate",
    "make_mesh",
]


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    if name in _SUBPACKAGES:
        return importlib.import_module(f"tpudist_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
