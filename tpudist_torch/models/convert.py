"""Weights carried across from the JAX package.

:func:`from_flax_params` takes a flax ``TransformerLM`` parameter tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's ``state_dict``.  It imports nothing of the JAX package:
the tree is plain numpy.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tpudist_torch.models.transformer import TransformerConfig


def unstack_layer_params(params: Mapping[str, Any],
                         num_layers: int) -> dict[str, Any]:
    """A scanned checkpoint (``blocks/block/...`` with a leading layer
    axis) as the unrolled ``block{i}/...`` tree, as the JAX package's
    ``unstack_layer_params`` does.  Other entries pass through."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    stacked = params["blocks"]["block"]

    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    for i in range(num_layers):
        out[f"block{i}"] = take(stacked, i)
    return out


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def from_flax_params(params: Mapping[str, Any],
                     cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` (f32 CPU tensors) from a flax parameter
    tree: Dense kernels ``[in, out]`` become ``nn.Linear`` weights
    ``[out, in]``; embeddings and LayerNorm ``scale``/``bias`` map as they
    are; a scanned checkpoint is unstacked first.  ``load_state_dict``
    casts to the model's dtype and device."""
    if "params" in params and "tok_embed" not in params:
        params = params["params"]
    if "blocks" in params:
        params = unstack_layer_params(params, cfg.num_layers)
    sd = {
        "tok_embed.weight": _t(params["tok_embed"]["embedding"]),
        "pos_embed.weight": _t(params["pos_embed"]["embedding"]),
        "ln_f.scale": _t(params["ln_f"]["scale"]),
        "ln_f.bias": _t(params["ln_f"]["bias"]),
        "lm_head.weight": _t(params["lm_head"]["kernel"]).T.contiguous(),
    }
    for i in range(cfg.num_layers):
        blk, pre = params[f"block{i}"], f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[pre + ln + ".scale"] = _t(blk[ln]["scale"])
            sd[pre + ln + ".bias"] = _t(blk[ln]["bias"])
        names = ["proj"] + (["qkv"] if "qkv" in blk["attn"] else ["q", "kv"])
        for name in names:
            sd[pre + f"attn.{name}.weight"] = _t(
                blk["attn"][name]["kernel"]).T.contiguous()
        for name in ("up", "down"):
            sd[pre + f"mlp.{name}.weight"] = _t(
                blk["mlp"][name]["kernel"]).T.contiguous()
    return sd
