"""Weights carried across from the JAX package.

:func:`from_flax_params` takes a flax ``TransformerLM`` parameter tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's ``state_dict``; :func:`from_flax_moe_params` does the
same for a ``MoETransformerLM`` and :func:`from_flax_resnet_params` for a
ResNet50 or one of its pipeline segments.  It imports nothing of the JAX
package: the tree is plain numpy.
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


def _unwrap(params: Mapping[str, Any],
            cfg: TransformerConfig) -> Mapping[str, Any]:
    """The bare parameter tree: a ``{"params": ...}`` wrapper removed and
    a scanned layer stack unstacked."""
    if "params" in params and "tok_embed" not in params:
        params = params["params"]
    if "blocks" in params:
        params = unstack_layer_params(params, cfg.num_layers)
    return params


def _shared_params(params: Mapping[str, Any],
                   cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """What the dense and the MoE LM share: embeddings, the final
    LayerNorm, the head, and each block's LayerNorms and attention."""
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
    return sd


def from_flax_params(params: Mapping[str, Any],
                     cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` (f32 CPU tensors) from a flax parameter
    tree: Dense kernels ``[in, out]`` become ``nn.Linear`` weights
    ``[out, in]``; embeddings and LayerNorm ``scale``/``bias`` map as they
    are; a scanned checkpoint is unstacked first.  ``load_state_dict``
    casts to the model's dtype and device."""
    params = _unwrap(params, cfg)
    sd = _shared_params(params, cfg)
    for i in range(cfg.num_layers):
        for name in ("up", "down"):
            sd[f"blocks.{i}.mlp.{name}.weight"] = _t(
                params[f"block{i}"]["mlp"][name]["kernel"]).T.contiguous()
    return sd


def from_flax_moe_params(params: Mapping[str, Any],
                         cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of :class:`~tpudist_torch.models.moe.MoETransformerLM`
    from a flax ``MoETransformerLM`` tree: the shared layers map as in
    :func:`from_flax_params`; ``block{i}/moe/router/kernel [d, E]``
    becomes the ``nn.Linear`` weight ``[E, d]``; the expert stacks
    ``w_up [E, d, f]`` and ``w_down [E, f, d]`` keep their layout."""
    params = _unwrap(params, cfg)
    sd = _shared_params(params, cfg)
    for i in range(cfg.num_layers):
        moe, pre = params[f"block{i}"]["moe"], f"blocks.{i}.moe."
        sd[pre + "router.weight"] = _t(moe["router"]["kernel"]).T.contiguous()
        sd[pre + "w_up"] = _t(moe["w_up"])
        sd[pre + "w_down"] = _t(moe["w_down"])
    return sd


# flax module name prefixes -> the port's, inside a ResNet segment
_RESNET_PARTS = {"ResNetStem": "stem", "Bottleneck": "blocks", "ResNetHead":
                 "head"}
_RESNET_LAYERS = {"Conv": "conv", "GroupNorm": "norm", "BatchNorm": "norm"}


def _flatten(tree: Mapping[str, Any], prefix=()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _resnet_name(path: tuple) -> str:
    """A flax ResNet leaf path (``("Bottleneck_3", "Conv_1", "kernel")``)
    as the port's parameter or buffer name (``blocks.3.conv1.weight``)."""
    if len(path) != 3:
        raise ValueError(f"unexpected ResNet leaf {'/'.join(path)}")
    (part, idx), (layer, j), leaf = (path[0].rsplit("_", 1),
                                     path[1].rsplit("_", 1), path[2])
    if part not in _RESNET_PARTS or (part == "ResNetHead") != (
            layer == "Dense"):
        raise ValueError(f"unexpected ResNet leaf {'/'.join(path)}")
    if part == "Bottleneck":
        module = f"blocks.{int(idx)}."
    else:
        module = _RESNET_PARTS[part] + "."
    if layer == "Dense":
        module += "fc."
    elif layer in _RESNET_LAYERS:
        module += f"{_RESNET_LAYERS[layer]}{int(j)}."
    else:
        raise ValueError(f"unexpected ResNet leaf {'/'.join(path)}")
    return module + ("weight" if leaf == "kernel" else leaf)


def from_flax_resnet_params(
        params: Mapping[str, Any],
        batch_stats: Mapping[str, Any] | None = None,
) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a :class:`~tpudist_torch.models.resnet.
    ResNetSegment` (or ``ResNet50``) from a flax ResNet tree of numpy
    arrays (a ``{"params": ...}`` wrapper and ``ResNet50``'s
    ``ResNetSegment_0`` level are removed).

    Conv kernels go from HWIO to OIHW and Dense kernels from ``[in, out]``
    to ``[out, in]``; norm ``scale``/``bias`` map as they are and
    ``batch_stats`` ``mean``/``var`` become the norms' buffers.  Every
    leaf maps to exactly one name: an unknown leaf, or two leaves on one
    name, raises."""
    sd: dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for key in ("params", "batch_stats", "ResNetSegment_0"):
            if set(tree) == {key}:
                tree = tree[key]
        for path, leaf in _flatten(tree).items():
            name = _resnet_name(path)
            if name in sd:
                raise ValueError(f"two flax leaves map to {name}")
            w = _t(leaf)
            if path[-1] == "kernel":
                w = (w.permute(3, 2, 0, 1) if w.dim() == 4 else w.T)
                w = w.contiguous()
            sd[name] = w
    return sd
