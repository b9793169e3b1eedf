"""GShard routing over a sharded batch: the port's grouped routing against
tpudist's one global ``_top_k_routing``.

tpudist's GSPMD program routes the logical global batch: one
``_top_k_routing`` call over every token, the capacity from the global
``T``, the slots in global token order.  The port's process holds a shard
of that batch and routes through a :class:`~tpudist_torch.models.moe.
RoutingGroup`.  Here one token batch (``T`` = 64, ``E`` = 4, top-2, the
first shard leaning to expert 0) is split into 2 and 4 virtual shards,
each routed in a thread of its own through a fake group with the
``RoutingGroup`` interface (``size``, ``index``, ``sum``, ``gather``),
which exchanges the shards' counts and gate sums through a barrier.

* Grouped: the shards' ``dispatch`` joined along ``T`` equals tpudist's
  global one exactly, ``combine`` and every shard's aux within 1e-6 (the
  routing head's tolerance in ``tests/test_torch_moe.py``), at capacity
  factors 2.0 (nothing dropped), 1.0 and 0.5;
* per shard (no group): each shard's routing equals tpudist's call on
  that shard alone, and at the dropping capacities it keeps another set
  of token-expert pairs than the global routing (so the grouped case
  discriminates).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models.moe import _top_k_routing as jax_top_k_routing
from tpudist_torch.models import moe as tm

T, E, K = 64, 4, 2
TOL = dict(atol=1e-6, rtol=1e-6)


class _Exchange:
    """The shards' meeting point: each writes its tensor, waits for the
    others, reads all of them, and waits again before the next exchange."""

    def __init__(self, size: int) -> None:
        self.size = size
        self.slots: list = [None] * size
        self.barrier = threading.Barrier(size)

    def __call__(self, index: int, x: torch.Tensor) -> list:
        self.slots[index] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _FakeGroup:
    """``RoutingGroup``'s interface over threads of this process."""

    def __init__(self, exchange: _Exchange, index: int) -> None:
        self.exchange, self.index, self.size = exchange, index, exchange.size

    def sum(self, x):
        parts = self.exchange(self.index, x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def gather(self, x):
        return torch.stack(self.exchange(self.index, x))


def _gates(seed: int = 0) -> np.ndarray:
    """Router probabilities ``[T, E]``; the first half of the tokens lean
    to expert 0."""
    logits = np.random.default_rng(seed).standard_normal((T, E))
    logits[: T // 2, 0] += 1.5
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


def _capacity(cf: float, t: int) -> int:
    return max(1, int(cf * t * K / E))


def _grouped(gates: np.ndarray, shards: int, capacity: int) -> list:
    """Each shard's ``(dispatch, combine, aux)`` through a fake group."""
    exchange = _Exchange(shards)
    blocks = np.split(gates, shards)

    def run(i):
        return tm._top_k_routing(torch.from_numpy(blocks[i]), K, capacity,
                                 _FakeGroup(exchange, i))

    with ThreadPoolExecutor(shards) as pool:
        return list(pool.map(run, range(shards)))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("cf", [2.0, 1.0, 0.5])
def test_grouped_routing_is_tpudists_global_routing(cf, shards):
    gates = _gates()
    capacity = _capacity(cf, T)
    jd, jc, ja = jax_top_k_routing(jnp.asarray(gates), K, capacity)
    out = _grouped(gates, shards, capacity)
    np.testing.assert_array_equal(
        torch.cat([d for d, _, _ in out]).numpy(), np.asarray(jd))
    np.testing.assert_allclose(torch.cat([c for _, c, _ in out]).numpy(),
                               np.asarray(jc), **TOL)
    for _, _, aux in out:
        np.testing.assert_allclose(aux.item(), float(ja), **TOL)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("cf", [2.0, 1.0, 0.5])
def test_ungrouped_routing_is_tpudists_per_call(cf, shards):
    gates = _gates()
    kept_global = np.asarray(jax_top_k_routing(
        jnp.asarray(gates), K, _capacity(cf, T))[0]).sum(-1)
    local = _capacity(cf, T // shards)
    kept = []
    for block in np.split(gates, shards):
        jd, jc, ja = jax_top_k_routing(jnp.asarray(block), K, local)
        d, c, a = tm._top_k_routing(torch.from_numpy(block), K, local)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(a.item(), float(ja), **TOL)
        kept.append(d.sum(-1).numpy())
    # per-shard routing drops other pairs than the global one wherever the
    # capacity drops any
    same = np.array_equal(np.concatenate(kept), kept_global)
    assert same == (cf == 2.0), (cf, shards)


def test_routing_group_needs_its_axes():
    moe = tm.MoEConfig(num_experts=4)
    with pytest.raises(ValueError, match="routing axes"):
        tm.MoEMLP(16, 32, moe, routing_axes=("data",), device="cpu")
