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

from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.generate import greedy_generate
from tpudist_torch.models.serving import Completion, Request, ServeLoop
from tpudist_torch.models.transformer import TransformerConfig, TransformerLM
from tpudist_torch.runtime import data_mesh, make_mesh
from tpudist_torch.train.trainer import Trainer, TrainerConfig

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
