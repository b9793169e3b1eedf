"""Weights carried across from the JAX package.

:func:`from_flax_params` takes a flax ``TransformerLM`` parameter tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's ``state_dict``; :func:`from_flax_moe_params` does the
same for a ``MoETransformerLM`` and :func:`from_flax_resnet_params` for a
ResNet50 or one of its pipeline segments, and
:func:`from_flax_mlp_params`, :func:`from_flax_convnet_params` and
:func:`from_flax_embedding_params` for the MNIST models and the embedding
classifier.  For the pipelines, :func:`from_flax_resnet_stages` maps the
per-stage trees of ``resnet50_stages(n)`` and
:func:`from_flax_stacked_blocks` (:func:`stack_block_params` on the
port's own ``state_dict``) stacks a ``TransformerLM``'s blocks into the
chunk layout of the 1F1B real-model mode.
:func:`from_flax_tp_params` cuts a ``TransformerLM`` tree into one
process's shard of the tensor-parallel layout and
:func:`gather_tp_params` joins the shards back.  It imports nothing of the
JAX package: the tree is plain numpy.
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


def tp_param_specs(cfg: TransformerConfig, axis: str = "model"
                   ) -> dict[str, tuple]:
    """The Megatron specs (:func:`~tpudist_torch.parallel.tensor_parallel.
    transformer_tp_rules`) of a ``TransformerLM`` ``state_dict``'s
    names."""
    from tpudist_torch.parallel.tensor_parallel import (
        spec_tree_from_rules,
        transformer_tp_rules,
    )

    names = {k: None for k in from_flax_params(_shapes_tree(cfg), cfg)}
    return spec_tree_from_rules(names, transformer_tp_rules(axis))


def _shapes_tree(cfg: TransformerConfig) -> dict:
    """A flax ``TransformerLM`` tree of empty arrays with the real leaf
    names and shapes (for the names and specs alone)."""
    e, kv = cfg.embed_dim, cfg.kv_heads * cfg.head_dim
    hidden = cfg.mlp_ratio * e
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    attn = ({"qkv": {"kernel": z(e, 3 * e)}} if cfg.kv_heads == cfg.num_heads
            else {"q": {"kernel": z(e, e)}, "kv": {"kernel": z(e, 2 * kv)}})
    attn["proj"] = {"kernel": z(e, e)}
    ln = {"scale": z(e), "bias": z(e)}
    tree = {"tok_embed": {"embedding": z(cfg.vocab_size, e)},
            "pos_embed": {"embedding": z(cfg.max_seq_len, e)},
            "ln_f": ln, "lm_head": {"kernel": z(e, cfg.vocab_size)}}
    for i in range(cfg.num_layers):
        tree[f"block{i}"] = {"ln1": ln, "ln2": ln, "attn": attn,
                             "mlp": {"up": {"kernel": z(e, hidden)},
                                     "down": {"kernel": z(hidden, e)}}}
    return tree


def from_flax_tp_params(params: Mapping[str, Any], cfg: TransformerConfig,
                        rank: int, tp: int) -> dict[str, torch.Tensor]:
    """Process ``rank``'s shard, of ``tp``, of a flax ``TransformerLM``
    tree: the ``state_dict`` of a ``TransformerLM(cfg, tp_axis=...)`` on
    that process.  ``qkv``/``q``/``kv``/``up`` keep their rows of the
    process's heads (whole heads of each of q, k and v) or MLP columns,
    ``proj``/``down`` the matching input columns, the token table and the
    head their vocabulary block; the rest is whole."""
    from tpudist_torch.parallel.tensor_parallel import cut_leaf

    specs = tp_param_specs(cfg)
    coords = {"model": (rank, tp)}
    return {k: cut_leaf(v, specs[k], coords).contiguous()
            for k, v in from_flax_params(params, cfg).items()}


def gather_tp_params(shards, cfg: TransformerConfig
                     ) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every process's shard (a list in
    rank order, as :func:`from_flax_tp_params` cuts them)."""
    from tpudist_torch.parallel.tensor_parallel import join_blocks

    specs = tp_param_specs(cfg)
    out = {}
    for name, spec in specs.items():
        blocks = [torch.as_tensor(s[name]) for s in shards]
        dim = next((d for d, a in enumerate(spec) if a is not None), None)
        out[name] = (blocks[0] if dim is None else
                     join_blocks(blocks, dim, getattr(spec[dim], "parts",
                                                      1)))
    return out


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


def from_flax_resnet_stages(stage_params) -> tuple:
    """One ``state_dict`` per stage of ``resnet50_stages(n)`` from the
    flax trees of its stages (each stage numbers its blocks from 0, in
    both packages), as :func:`from_flax_resnet_params` maps each."""
    return tuple(from_flax_resnet_params(p) for p in stage_params)


def _device_order(n_stages: int, virtual_stages: int) -> list[int]:
    """Chunk ``v·P + p`` at position ``p·V + v`` (tpudist's
    ``interleave_params``)."""
    return [v * n_stages + p for p in range(n_stages)
            for v in range(virtual_stages)]


def stack_block_params(state_dict: Mapping[str, torch.Tensor],
                       num_layers: int, n_stages: int,
                       virtual_stages: int = 1) -> dict:
    """A ``TransformerLM`` ``state_dict`` as the real-model 1F1B layout:
    ``{"stages": {name: [L, k, ...]}, "extra": {name: tensor}}``.  The
    ``num_layers`` blocks are cut into ``L = n_stages · virtual_stages``
    chunks of ``k = num_layers / L`` consecutive blocks; each block's
    parameters, named as a ``DecoderBlock``'s (``ln1.scale``,
    ``attn.q.weight``, ...), are stacked ``[L, k, ...]`` with the chunks in
    device order (chunk ``v·P + p`` at ``p·V + v``).  The embeddings, final
    norm and head are ``extra``, named as the model's."""
    n = n_stages * virtual_stages
    if num_layers % n:
        raise ValueError(f"{num_layers} layers do not cut into {n_stages} "
                         f"stages × {virtual_stages} chunks")
    k = num_layers // n
    names = [key[len("blocks.0."):] for key in state_dict
             if key.startswith("blocks.0.")]
    stages = {name: torch.stack([
        torch.stack([state_dict[f"blocks.{c * k + j}.{name}"]
                     for j in range(k)])
        for c in _device_order(n_stages, virtual_stages)]) for name in names}
    extra = {key: v for key, v in state_dict.items()
             if not key.startswith("blocks.")}
    return {"stages": stages, "extra": extra}


def unstack_block_params(tree: Mapping[str, Any], n_stages: int,
                         virtual_stages: int = 1) -> dict:
    """Invert :func:`stack_block_params`: the model's ``state_dict`` names
    from the stacked layout (tensors as they are, e.g. the gradients)."""
    order = _device_order(n_stages, virtual_stages)
    out = dict(tree["extra"])
    for name, leaf in tree["stages"].items():
        k = leaf.shape[1]
        for pos, c in enumerate(order):
            for j in range(k):
                out[f"blocks.{c * k + j}.{name}"] = leaf[pos, j]
    return out


def from_flax_stacked_blocks(params: Mapping[str, Any],
                             cfg: TransformerConfig, n_stages: int,
                             virtual_stages: int = 1) -> dict:
    """A flax ``TransformerLM`` tree in the real-model 1F1B layout of
    :func:`stack_block_params`."""
    return stack_block_params(from_flax_params(params, cfg), cfg.num_layers,
                              n_stages, virtual_stages)


def _mnist_name(path: tuple, layers: Mapping[str, str]) -> str:
    """A flax leaf path of the MNIST models (``("Dense_2", "kernel")``) as
    the port's name (``dense.2.weight`` for the MLP)."""
    if len(path) != 2 or path[1] not in ("kernel", "bias"):
        raise ValueError(f"unexpected leaf {'/'.join(path)}")
    layer, j = path[0].rsplit("_", 1)
    if layer not in layers:
        raise ValueError(f"unexpected leaf {'/'.join(path)}")
    return (layers[layer].format(int(j))
            + (".weight" if path[1] == "kernel" else ".bias"))


def _from_flax(params: Mapping[str, Any], name) -> dict[str, torch.Tensor]:
    """Every leaf of a flax tree under its port name: Dense kernels
    ``[in, out]`` to ``[out, in]``, Conv kernels HWIO to OIHW; an unknown
    leaf, or two leaves on one name, raises."""
    if set(params) == {"params"}:
        params = params["params"]
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params).items():
        key = name(path)
        if key in sd:
            raise ValueError(f"two flax leaves map to {key}")
        w = _t(leaf)
        if path[-1] == "kernel":
            w = (w.permute(3, 2, 0, 1) if w.dim() == 4 else w.T).contiguous()
        sd[key] = w
    return sd


def from_flax_mlp_params(params: Mapping[str, Any]
                         ) -> dict[str, torch.Tensor]:
    """The :class:`~tpudist_torch.models.mlp.MLP` ``state_dict`` from a
    flax ``MLP`` tree (``Dense_i`` → ``dense.i``)."""
    return _from_flax(params, lambda p: _mnist_name(p, {"Dense": "dense.{}"}))


def from_flax_convnet_params(params: Mapping[str, Any]
                             ) -> dict[str, torch.Tensor]:
    """The :class:`~tpudist_torch.models.convnet.ConvNet` ``state_dict``
    from a flax ``ConvNet`` tree (``Conv_j`` → ``conv{j}``, ``Dense_j`` →
    ``dense{j}``)."""
    return _from_flax(params, lambda p: _mnist_name(
        p, {"Conv": "conv{}", "Dense": "dense{}"}))


def from_flax_embedding_params(params: Mapping[str, Any]
                               ) -> dict[str, torch.Tensor]:
    """The :class:`~tpudist_torch.models.embedding.EmbeddingBagClassifier`
    ``state_dict`` from a flax ``EmbeddingBagClassifier`` tree (the
    ``embedding`` table as it is, ``fc`` transposed)."""
    def name(path: tuple) -> str:
        if path == ("embedding",):
            return "embedding"
        if len(path) == 2 and path[0] == "fc" and path[1] in ("kernel",
                                                              "bias"):
            return "fc." + ("weight" if path[1] == "kernel" else "bias")
        raise ValueError(f"unexpected leaf {'/'.join(path)}")

    return _from_flax(params, name)
