"""tpudist_torch's paged-KV host half against the JAX package's.

The port's :mod:`tpudist_torch.models.kv_pages` is plain Python and numpy,
so the same operations must leave both allocators in the same state: the
same page tables, free lists (order included), refcounts, pins and
reservation arithmetic after every step, with ``check()`` passing on
both.  Exact equality throughout — there is no arithmetic to round.
"""

import numpy as np
import pytest

from tpudist.models import kv_pages as jkp
from tpudist_torch.models import kv_pages as tkp

BS = 16


def _state(pool):
    """Everything that defines an allocator's state, comparable by ==."""
    return (pool.table.tolist(), list(pool._free),
            [list(b) for b in pool._slot_blocks], list(pool._refcount),
            sorted(pool._pinned), list(pool._watermark), list(pool._cap),
            list(pool._shared_upto), list(pool._prompt_len),
            pool._reserved_total, dict(pool._migrating),
            pool.free_blocks, pool.used_blocks)


class _Twin:
    """One operation applied to the JAX pool and the port's, with every
    return value and the resulting states compared."""

    def __init__(self, *args, prefix=False):
        self.j = jkp.BlockPool(*args)
        self.t = tkp.BlockPool(*args)
        self.jc = jkp.PrefixCache(self.j) if prefix else None
        self.tc = tkp.PrefixCache(self.t) if prefix else None

    def __call__(self, method, *args, cache=False, **kw):
        jo, to = (self.jc, self.tc) if cache else (self.j, self.t)
        outs = []
        for obj in (jo, to):
            try:
                outs.append(("ok", getattr(obj, method)(*args, **kw)))
            except (RuntimeError, ValueError) as e:
                outs.append((type(e).__name__, str(e)))
        assert outs[0] == outs[1], (method, args, outs)
        self.j.check()
        self.t.check()
        assert _state(self.j) == _state(self.t), (method, args)
        if cache:
            assert list(self.jc._entries.items()) == \
                list(self.tc._entries.items())
            assert self.jc._parent == self.tc._parent
        return outs[1][1]


@pytest.mark.parametrize("seed", [42, 7, 1234])
def test_ragged_churn_replays_alike(seed):
    """tests/test_kv_pages.py's churn (admit, grow, finalize, export,
    complete/abort, adopt) with ragged lengths across 4 slots, replayed on
    both pools."""
    rng = np.random.default_rng(seed)
    S = 512
    tw = _Twin(48, BS, 4, S)
    live: dict[int, int] = {}
    migrating: set[int] = set()
    for _ in range(300):
        op = rng.integers(0, 6)
        free_slots = [s for s in range(4) if s not in live]
        if op in (0, 5) and free_slots:
            L = int(rng.integers(1, 200))
            mn = int(rng.integers(1, min(120, S - L)))
            if tw("can_admit", L, mn):
                slot = free_slots[0]
                if op == 0:
                    tw("admit", slot, L, mn)
                else:
                    tw("adopt_blocks", slot, L, mn)
                live[slot] = int(rng.integers(1, 6))
        elif op == 1:
            for slot in list(live):
                if slot not in migrating:
                    tw("grow", slot, 32)
                    live[slot] -= 1
        elif op == 2:
            for slot in [s for s, left in live.items()
                         if left <= 0 and s not in migrating]:
                tw("free_slot", slot)
                del live[slot]
        elif op == 3:
            cands = [s for s in live if s not in migrating
                     and tw.t._slot_blocks[s]]
            if cands:
                slot = cands[int(rng.integers(0, len(cands)))]
                tw("export_slot", slot)
                tw("export_slot", slot)          # refused alike
                tw("grow", slot, 8)              # frozen alike
                migrating.add(slot)
        elif op == 4 and migrating:
            slot = sorted(migrating)[0]
            migrating.discard(slot)
            if rng.integers(0, 2):
                tw("complete_export", slot)
                del live[slot]
            else:
                tw("abort_export", slot)
    for slot in sorted(migrating):
        tw("abort_export", slot)
    for slot in list(live):
        tw("free_slot", slot)
    assert tw.t.free_blocks == tw.t.num_blocks and tw.t.used_blocks == 0


@pytest.mark.parametrize("seed", [0xC057, 3, 99])
def test_prefix_churn_replays_alike(seed):
    """tests/test_prefix_sharing.py's churn (admit with shared prefixes,
    the copy-on-write split of a full-prompt hit, register, grow, free,
    evict) over a small universe of recurring prompts, replayed on both
    pools and both prefix caches: the same matches, peeks, evictions (LRU
    order), tables and free lists at every step."""
    rng = np.random.default_rng(seed)
    tw = _Twin(24, BS, 4, 12 * BS, prefix=True)
    bases = [rng.integers(1, 60, size=n * BS).astype(np.int32)
             for n in (1, 2, 3)]
    live: dict[int, int] = {}
    for _ in range(300):
        op = rng.random()
        free_slots = [s for s in range(4) if s not in live]
        if op < 0.45 and free_slots:
            slot = int(rng.choice(free_slots))
            base = bases[int(rng.integers(len(bases)))]
            tail = rng.integers(1, 60, size=int(
                rng.integers(0, BS + 5))).astype(np.int32)
            prompt = np.concatenate([base, tail])
            L = int(prompt.size)
            max_new = int(rng.integers(1, 2 * BS))
            n_sh = tw("peek", prompt, cache=True)
            cow = int(n_sh * BS >= L)
            if not tw("can_admit", L, max_new, shared=n_sh, cow=cow):
                continue
            blocks = tw("match", prompt, cache=True)
            tw("admit", slot, L, max_new, shared=blocks)
            if len(blocks) * BS >= L:                # full-prompt hit
                tw("cow_write", slot, len(blocks) - 1)
            tw("register", prompt, list(tw.t._slot_blocks[slot]), cache=True)
            live[slot] = L
        elif op < 0.7 and live:
            tw("grow", int(rng.choice(list(live))), int(rng.integers(1, BS)))
        elif op < 0.9 and live:
            slot = int(rng.choice(list(live)))
            tw("free_slot", slot)
            del live[slot]
        else:
            tw("evict_one", cache=True)
    for slot in list(live):
        tw("free_slot", slot)
    tw("flush", cache=True)
    assert tw.t.free_blocks == tw.t.num_blocks
    assert not any(tw.t._refcount) and not tw.t._pinned
    assert tw.t.cow_splits > 0 and tw.tc.hits > 0


def test_cache_pins_and_installs_replay_alike():
    """alloc_cached_block / install / cache_unpin (the landing pages of
    an install) and the refusals of each, on both."""
    tw = _Twin(6, BS, 2, 4 * BS, prefix=True)
    toks = np.arange(2 * BS, dtype=np.int32)
    h = tkp.chain_hashes(toks, BS)
    a = tw("alloc_cached_block")
    tw("install", h[0], a, None, cache=True)
    tw("install", h[0], a, None, cache=True)      # already resident
    b = tw("alloc_cached_block")
    tw("install", h[1], b, h[0], cache=True)
    assert tw("match", toks, cache=True) == [a, b]
    tw("admit", 0, 2 * BS + 3, 4, shared=[a, b])
    tw("install", 123, a, None, cache=True)       # not cached-idle
    tw("cow_write", 0, 0)                         # only the last shared
    tw("free_slot", 0)
    c = tw("alloc_cached_block")
    tw("cache_unpin", c)                          # straight back to free
    tw("flush", cache=True)
    assert tw.t.free_blocks == 6


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 64, 100])
def test_hashes_are_the_same_integers(n):
    toks = np.random.default_rng(n).integers(0, 32000, n)
    assert tkp.chain_hashes(toks, BS) == jkp.chain_hashes(toks, BS)
    assert tkp.chain_hashes(list(toks), 8) == jkp.chain_hashes(toks, 8)
    assert (tkp.request_prefix_hash(toks)
            == jkp.request_prefix_hash(toks))
    assert tkp.blocks_for(n, BS) == jkp.blocks_for(n, BS)


def test_lru_eviction_order_matches():
    """Registration, a recency touch by match, and evictions: both caches
    evict the same entries in the same order, and stop at entries a live
    slot references."""
    tw = _Twin(12, BS, 3, 6 * BS, prefix=True)
    prompts = [np.full(2 * BS, i, np.int32) for i in range(3)]
    for slot, p in enumerate(prompts):
        tw("admit", slot, p.size, 1)
        tw("register", p, list(tw.t._slot_blocks[slot]), cache=True)
    tw("free_slot", 0)
    tw("free_slot", 2)
    tw("match", prompts[0], cache=True)           # prompt 0 now recent
    order = []
    while tw("evict_one", cache=True):
        order.append(len(tw.tc))
    assert tw.tc.evictions == 4 and len(tw.tc) == 2   # slot 1's stay
    tw("free_slot", 1)
    tw("flush", cache=True)
    assert tw.t.free_blocks == 12


def test_construction_errors_alike():
    for args in ((4, 12, 2, 64), (4, 0, 2, 64), (0, 16, 2, 64)):
        with pytest.raises(ValueError) as want:
            jkp.BlockPool(*args)
        with pytest.raises(ValueError) as got:
            tkp.BlockPool(*args)
        assert str(got.value) == str(want.value)
