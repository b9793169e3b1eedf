"""tpudist_torch.parallel.mesh_bench against tpudist's: the composition
matrix and the real LM through interleaved 1F1B.

One run of the port's ``run_all()`` in 8 gloo ranks spawned once for the
module (``run_ranks``), on tpudist's weights converted (its flax inits
from key 0 of the one-layer LM, the MoE LM and the 16-layer LM; the
pipeline rows draw the same numpy weights in both packages).  tpudist's
rows are computed once for the module on the 8 CPU devices
``tests/conftest.py`` forces.

* the six combos: each composed step bitwise equal to its
  single-strategy step (``exact_match``, ``max_abs_diff`` 0), its FLOPs
  counted (``mfu_reported``);
* the real LM: tpudist's schedule (bubble 0.0448 over 134 ticks), trained;
* losses: the real LM's first and last, and the ``dp2_pp2``,
  ``dp2_pp2_tp2`` and ``dp2_ep2`` rows', within 1e-4 relative of
  tpudist's (f32, with reductions in other orders).  ``dp2_ep2`` is
  compared with the load-balance term off in both packages (one more
  ``_ep_row`` in the ranks and tpudist's, each under a MoEConfig whose
  ``aux_loss_weight`` is 0): the port's EP step takes that term over each
  data shard's tokens and tpudist's GSPMD program over the global batch
  (``tests/test_torch_expert_parallel.py`` compares them the same way),
  which at the bench's weight of 1e-2 moves the loss by 1.05e-4 relative.
"""

import contextlib

import numpy as np
import pytest

from tests.test_torch_data_parallel import run_ranks

COMBOS = ["dp2_tp2", "fsdp2_tp2", "dp2_fsdp2_tp2", "dp2_pp2", "dp2_pp2_tp2",
          "dp2_ep2", "dp2_ep2_aux0"]
LOSS_RTOL = 1e-4


@contextlib.contextmanager
def _aux_off(moe_module):
    """``moe_module.MoEConfig`` with the load-balance term off, for the
    duration of the context."""
    moe_config = moe_module.MoEConfig
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_module, "MoEConfig",
                   lambda **kw: moe_config(aux_loss_weight=0.0, **kw))
        yield


def _bench_rank(rank, world, weights):
    import tpudist_torch.models.moe
    from tpudist_torch.parallel import mesh_bench

    rows = mesh_bench.run_all(weights)
    with _aux_off(tpudist_torch.models.moe):
        rows.append({**mesh_bench._ep_row(weights["moe"]),
                     "combo": "dp2_ep2_aux0"})
    return rows


def _weights():
    """tpudist's flax weights of the bench's three models, as the port's
    state dicts."""
    import jax
    import jax.numpy as jnp

    from tpudist.models import (
        MoEConfig,
        MoETransformerLM,
        TransformerConfig,
        TransformerLM,
    )
    from tpudist.parallel import mesh_bench
    from tpudist_torch.models.convert import (
        from_flax_moe_params,
        from_flax_params,
    )
    from tpudist_torch.models.transformer import TransformerConfig as TCfg
    from tpudist_torch.parallel.mesh_bench import LM

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    _, _, params, _, (tokens, _) = mesh_bench._lm_setup()
    lm = from_flax_params(np_tree(params), TCfg(num_layers=1, **LM))
    cfg = TransformerConfig(num_layers=1, **LM)
    moe = MoETransformerLM(cfg, MoEConfig(num_experts=2, top_k=1,
                                          capacity_factor=4.0))
    moe_params = moe.init(jax.random.key(0), tokens)["params"]
    moe_sd = from_flax_moe_params(np_tree(moe_params),
                                  TCfg(num_layers=1, **LM))
    big = TransformerConfig(num_layers=16, **LM)
    big_params = TransformerLM(big).init(
        jax.random.key(0), jnp.zeros((2, 8), jnp.int32))["params"]
    real = from_flax_params(np_tree(big_params), TCfg(num_layers=16, **LM))
    return {"lm": lm, "moe": moe_sd, "real_lm": real}


@pytest.fixture(scope="module")
def port_rows(tmp_path_factory):
    # 8 ranks beside the other test workers: more than run_ranks' default
    # 120 s of headroom (the ranks' work takes ~10 s on an idle host)
    results = run_ranks(_bench_rank, 8, tmp_path_factory.mktemp("bench"),
                        _weights(), timeout=300)
    # every rank reports the same rows, timings aside
    untimed = [[{k: v for k, v in r.items() if k != "step_time_ms"}
                for r in rows] for rows in results]
    assert all(u == untimed[0] for u in untimed)
    return {r["combo"]: r for r in results[0]}


@pytest.fixture(scope="module")
def jax_rows():
    import tpudist.models
    from tpudist.parallel import mesh_bench

    rows = {r["combo"]: r for r in mesh_bench._pipeline_rows()}
    with _aux_off(tpudist.models):
        rows["dp2_ep2_aux0"] = mesh_bench._ep_row()
    lm = mesh_bench.run_real_lm()
    rows[lm["combo"]] = lm
    return rows


@pytest.mark.parametrize("combo", COMBOS)
def test_combo_bitwise(combo, port_rows):
    row = port_rows[combo]
    assert row["exact_match"] is True, row
    assert row["max_abs_diff"] == 0.0
    assert row["loss"] == row["ref_loss"]
    assert row["mfu_reported"] is True
    assert row["bubble_fraction"] == (0.2 if "pp2" in combo else 0.0)
    assert row["devices"] == (8 if combo.count("2") == 3 else 4)


def test_real_lm_schedule_is_tpudists(port_rows, jax_rows):
    row = port_rows["real_lm_pp4_dp2_1f1b"]
    ref = jax_rows["real_lm_pp4_dp2_1f1b"]
    assert (row["bubble_fraction"], row["schedule_ticks"]) == (0.0448, 134)
    assert (row["bubble_fraction"], row["schedule_ticks"]) \
        == (ref["bubble_fraction"], ref["schedule_ticks"])
    assert row["trained"] and row["mfu_reported"]
    assert {k: row[k] for k in ("devices", "P", "M", "V", "layers", "steps",
                                "global_batch")} \
        == {k: ref[k] for k in ("devices", "P", "M", "V", "layers", "steps",
                                "global_batch")}


@pytest.mark.parametrize("combo,key", [
    ("real_lm_pp4_dp2_1f1b", "loss_first"),
    ("real_lm_pp4_dp2_1f1b", "loss_last"),
    ("dp2_pp2", "loss"), ("dp2_pp2_tp2", "loss"),
    ("dp2_ep2_aux0", "loss")])
def test_losses_match_tpudist(combo, key, port_rows, jax_rows):
    got, want = port_rows[combo][key], jax_rows[combo][key]
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("cards", [0, 4])
def test_cli_needs_eight_cards_unless_forced_to_cpu(cards, monkeypatch):
    """Without ``--force-cpu`` the bench runs one NCCL rank a card, and a
    host with fewer than 8 cards stops it before any rank starts."""
    import torch

    from tpudist_torch.parallel import mesh_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match=rf"needs 8 cards; this host has "
                                           rf"{cards} \(--force-cpu"):
        mesh_bench.main([])
