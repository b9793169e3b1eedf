"""The pipelined ServeLoop on the card (marked ``cuda``; skips without
one).  This file imports no JAX, so it runs on a card host without flax:
``python -m pytest --noconftest -m cuda tests/test_torch_card_pipelined.py``.

At depth 2 the emits come home through the pinned ring on the side
stream.  The card's completions at depth 2 must equal the CPU's plain
path at depth 2 (f32, tokens exact, the same order), and each request's
tokens and reason must equal depth 1's; with no request waiting for a
lane, the finish order too.  (With requests waiting, depth 2 learns of a
finish one segment later, so the next admission lands a segment later
and near-simultaneous finishes may swap places, in tpudist's loop alike;
tests/test_torch_serving.py holds the order on tpudist's workload.)  The
segment must read nothing on the host per tick; the ring's two pinned
buffers must be distinct and never reused before their copy's event
fired.
"""

import numpy as np
import pytest
import torch

from tpudist_torch.models.serving import Request, ServeLoop
from tpudist_torch.models.transformer import TransformerConfig, TransformerLM

CFG = TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
                        num_kv_heads=2, embed_dim=64, max_seq_len=96,
                        compute_dtype=torch.float32)
LOOP = dict(num_slots=2, steps_per_sync=4, prefill_chunk=8,
            stop_tokens=(59,))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1/K2/K5 have no CPU "
                    "mode)")
    return torch.device("cuda")


def _state_dict():
    g = torch.Generator().manual_seed(0)
    return TransformerLM(CFG, device="cpu").init_weights(g).state_dict()


def _workload(n=6):
    rng = np.random.default_rng(0)
    return [Request(rng.integers(0, 64, 3 + 5 * i), 25, rid=i)
            for i in range(n)]


def _sig(comps):
    return [(c.rid, tuple(int(t) for t in c.tokens), c.reason)
            for c in comps]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_pipelined_on_card_matches_depth_one(cuda_device, layout):
    kw = dict(LOOP)
    if layout == "paged":
        kw.update(cache_layout="paged", kv_block_size=16)
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = _state_dict()

    def cpu(depth, n=6):
        return _sig(ServeLoop(CFG, sd, device="cpu", pipeline_depth=depth,
                              **kw).run(_workload(n)))

    loop = ServeLoop(CFG, sd, device=cuda_device, pipeline_depth=1, **kw)
    one = _sig(loop.run(_workload()))
    assert one == cpu(1)
    loop.pipeline_depth = 2
    reads = loop.segment_host_reads
    two = _sig(loop.run(_workload()))
    assert two == cpu(2)
    assert sorted(two) == sorted(one)
    # two requests, two lanes: nobody waits, so the order is depth 1's
    assert _sig(loop.run(_workload(2))) == cpu(1, 2)
    assert loop.segment_host_reads == reads
    assert len({b["emits"].data_ptr() for b in loop._ring}) == 2
    assert all(b["emits"].is_pinned() for b in loop._ring)
    assert loop.pinned_reuse_waits == 0
    if loop.pool is not None:
        loop.pool.check()
        assert loop.pool.used_blocks == 0
