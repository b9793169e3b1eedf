#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpudist_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line and each fatal on failure:

1. device  — the card (nvidia-smi name and power limit) and the CUDA build;
2. build   — nvcc builds every kernel in tpudist_torch/csrc;
3. kernels — each kernel against its plain PyTorch version on the card, in
   bf16, at the serve path's shapes (each O element within 2e-3 + 2e-2
   times the plain value, the LSE within 1e-3), with its time, the plain
   version's, one PyTorch library call's (a yardstick only; the port never calls it)
   and the least time the card could take (bytes or operations bound);
   K1 with the planner's split (splits, chunk), also against the split
   walk and merge in plain PyTorch, a second call bitwise equal, and K1's
   chunk invariance: a 1,024-token prompt over the 8k
   cache prefilled as one chunk and as 512 + 300 + 212 gives bit-identical
   out and LSE rows;
4. kernels_paged — K5 (paged decode, at block 128 and 16, over a pool
   whose page table is a random permutation; bit-identical to K2 over the
   gathered view) and K6 (int8 decode, per-row and scalar length) against
   their plain versions at the same decode shapes, timed the same way;
   for K2 (in kernels), K5 and K6 the split pass's and the merge's device
   ms apart, from torch.profiler; K2, K5 and K6 also against the split
   walk and merge in plain PyTorch at the wrappers' split (plan), and a
   second call bitwise equal;
5. parity  — a full-width 2-layer f32 model: ServeLoop completions (per-row
   and side-buffer decode) equal each request's own greedy_generate rollout
   (scalar decode), both through flash-prefill; cached-prefill logits on
   the card agree with the CPU plain path;
6. paged_parity — the same model and requests: the paged ServeLoop (block
   16, K5) token-identical to the dense one (K2), its pool drained;
7. serve   — the full-width 8-layer bf16 serve model (random weights from
   --seed): 8 mixed-length requests through a 4-slot ServeLoop, with
   kernel launch counts reset just before and read just after;
8. profile — one 32-tick decode segment of the serve model on the host
   clock and under torch.profiler (device busy share, device time by
   kernel family, the kernels that take the device's time), on the
   dense cache and (profile_paged) on a
   full-capacity pool of 128-token blocks;
9. serve_paged — bench.py's kv_paging cell: the serve model, dense and
   paged (block 128, a 72-block pool), 6 requests of 512-2048 prompt
   tokens and 256 new each: token identity, KV bytes, tokens/s, peak
   memory, the pool drained, launches (K5, not K2, in the paged run);
10. serve_prefix — bench.py's serve_prefix_batching cell: 13 requests
   sharing a 1024-token prefix (one a full-prompt hit) with prefix
   sharing off and on: token identity, hit rate, copy-on-write splits;
11. decode_q8 — flash_decode_q8 (K6) through 8 layers x 32 decode steps
   of int8 caches at 8k, launches counted, the last step against the
   plain version and the split walk at the wrappers' split;
12. kernels_bwd — the backward kernels K3 (dQ and Delta) and K4 (dK, dV)
   against their plain versions in bf16 at the training shape (causal,
   and with a 512 window) and at bench.py's flash shape, each gradient
   element within 1e-2 * max|plain| + 2e-2 * |plain|, Delta within 1e-3,
   a second call bitwise equal to the first, with the planner's splits
   per kernel and times beside the bound and SDPA's backward; K1 at the
   training shape beside its bound;
13. train_parity — a full-width 2-layer f32 model trained 3 Adam steps
   through flash attention (K1, K3, K4) and through the plain sdpa from
   the same weights and batches: losses and every gradient agree;
14. train — the full-width 8-layer serve model trained in bf16 with f32
   master weights (seq 2048, batch 8, the markov stream from --seed):
   20 steps through make_dp_train_step with launch counts reset just
   before and read just after (K1 = K3 = K4 = steps x layers), the loss
   falling; ms per step, tokens/s, model FLOPs and their share of the
   bf16 peak, peak memory; then one step under torch.profiler;
15. kernels_moe — the MoE grouped GEMM K7 against its plain version in
   bf16 at bench.py's bench_moe layer (T=4096, d=512, f=2048, E=8, top-2,
   block 128), the training shape (T=16,384), skewed routing (every
   token on experts 0 and 1) and block 16, each element within
   1e-2 * max|plain| + 2e-2 * |plain|, a second call bitwise equal, the
   trailing pad blocks' rows exactly zero, the path each case took
   (wgmma or mma.sync), with its time beside the function's bound, the
   design's own (the wgmma path computes h once per half of d),
   torch._grouped_mm's and bench_moe's equal-FLOP dense twin;
16. train_moe_parity — a full-width 2-layer f32 MoE model trained 3 Adam
   steps with dispatch="fused" (K7, the ragged remat backward) and
   dispatch="ragged" (plain) from the same weights and batches: losses,
   aux and every gradient agree;
17. train_moe — the train phase's model with every MLP an MoE MLP (E=8,
   top-2, fused, block 128): 20 steps, launch counts K7 = K1 = K3 = K4 =
   steps x layers, the loss falling, ms per step, tokens/s, active-weight
   model FLOPs, peak memory, the mean aux loss, one profiled step;
18. kernels_ring — K8 (dQ from a given Delta, the ring backward's) against
   its plain version in bf16 at train_sp's shape (B=1, S=8192), at the
   training shape, at the ring's three block kinds at S_loc = 2048
   (diagonal, fully live, fully masked: exact zeros from K8 and K4, and
   O = 0, LSE = -1e30 from K1), a 1024 window at offsets, and in f32,
   with K1 and K4 on the same blocks against theirs; fed K3's Delta,
   bit-identical to K3's dQ; K8 and K4 bitwise equal on a second call;
   the planner's splits per kernel; times beside K3's, the bound and
   SDPA's backward; K1 at train_sp's shape timed beside its bound and
   SDPA's forward, with its plan;
19. ring_sp4 — ring flash attention for 4 virtual ranks in one process
   (B=1, S=4 x 2048, H=8, Hkv=2, D=64), through the module's step
   functions with the blocks rotating as _ring_rotate would, causal and
   with a 1024 window, in bf16 and f32: forward and backward against one
   flash_attention call over the whole sequence and against the same ring
   on the plain versions; K1 = K8 = K4 = 16 launches a run, K3 = 0;
20. train_sp — the train phase's model at seq 8192, batch 1, trained
   through make_sp_train_step with ring flash attention on a one-rank
   NCCL group and a data 1 x seq 1 mesh: step 0's loss and gradients
   against the dense flash step's, then 10 measured steps (K1 = K8 = K4
   = 8 a step, K3 = 0), the loss falling and tracking a dense run's from
   the same weights step by step, the loss and gradients against the
   dense step's again after training, ms a step beside the dense step's,
   tokens/s, model FLOPs share, peak memory, one profiled step;
21. kernels_gn — K9 (fused GroupNorm forward) and K10 (its backward)
   against their plain versions at every distinct GroupNorm site shape of
   ResNet50 at batch 128, 128 px, in each mode the shape takes (relu,
   add_relu, plain), bf16, plus one f32 case and the 224 px stem's
   12544 x 64 slab: each on the path the planner gives it (the cluster
   path at the site shapes, the two-pass path at the stem and the f32
   tail), checked to have run it, a second call bitwise equal, and the
   other path forced, held and timed beside it where it fits; times
   beside the bound, the plain versions and F.group_norm (+ add, ReLU)
   with its autograd backward;
22. resnet_parity — full-width ResNet50 (norm="group", 1000 classes) in
   f32 with TF32 off, batch 4 at 64 px: 3 SGD steps on the card and on
   the CPU from one converted flax-layout tree, the CPU's ReLU masks and
   max-pool choices replayed on the card: losses, each gradient tensor
   and the weights after each step agree;
23. gn_sites — the activations of one ResNet50 train step (batch 128, 128
   px, bf16) at its 53 GroupNorm sites through the fused op (K9 = K10 =
   53 launches, all on the cluster path) against the closed form, every gradient element held
   but where K9's statistics flip a ReLU mask, and both paths' summed
   device time beside the bound;
24. train_resnet — ResNet50 (norm="group", bf16, f32 parameters,
   sgd(0.05)) at batch 128, 128 px through make_dp_train_step: 20 steps,
   the loss falling, ms per step, images/s, model FLOPs share, peak
   memory, one profiled step by kernel family with no layout copies;
25. mnist_parity — MLP(hidden 2, features 1024) and the ConvNet (dropout
   off), f32, from one converted flax-layout tree each: 20 Adam steps on
   the same loader batches (the card's bit for bit the CPU's) on the card
   (TF32 off), on the CPU and in f64, the card and f64 replaying the
   CPU's ReLU masks and max-pool argmax: each step's loss, the final
   parameters, the share of the card's own choices that differ;
26. train_mnist — the DDP recipe at full width through Trainer.train():
   MLP(5, 1024), Adam 1e-3, batch 128, synthetic_mnist 60,000/10,000,
   2 epochs snapshotted every epoch, a second Trainer resuming from the
   snapshot for epoch 3, bit for bit equal to an uninterrupted 3-epoch
   run (losses, parameters, Adam's state); test accuracy >= 0.9; the
   native gather pool used; no port kernel launched; the first Trainer's
   train/steps equal to its steps, xla/step_tflops (its first step's
   counted FLOPs over the mean step time) and the allocator's
   xla/mem/peak_bytes_in_use/d0 above 0; ms per step, images/s, the
   snapshot saves' blocking seconds, peak memory, 20 profiled steps'
   device busy share;
27. train_convnet — the ConvNet with dropout through Trainer.train() on
   data/real_digits.npz (batch 128, Adam 1e-3, 15 epochs): held-out
   accuracy >= 0.90; then the mnist_horovod shape (batch 1024, SGD
   0.01): ms per step, images/s, 20 profiled steps' device busy share;
28. elastic_kill9 — the TTL elastic gang of tests/test_torch_elastic_ttl.py
   (tests/workers/torch_ttl_elastic_worker.py: MLP(1, 32), SGD 0.1, 30
   steps, a commit every 5) started by the port's launcher, 3 workers on
   one card, spawn 2 SIGKILLing itself after step 13, on an f32 wire:
   survivors re-form at world 2, resume at batch 10, rescale the lr once
   to 0.1·2/3 and end bitwise equal; the same gang on the CPU ends within
   1e-4 of the card (parameters, loss); detection and recovery seconds
   from the workers' event times, ms per step at world 3 and 2, every
   worker's K1-K10 launches (0);
29. elastic_horovod — ``python -m tpudist_torch.runtime.launch -n 3
   --min-nprocs 2 --elastic-inprocess -- examples/horovod_mnist_elastic_gpu.py
   --elastic ttl --epochs 2`` (the reference recipe cut to 2 of its 15
   epochs), one worker SIGKILLed from outside after its round's second
   commit: rc 0, both survivors print ``reset: world 3 -> 2, lr ->
   0.00707`` and reach accuracy >= 0.9; images/s before and after the
   kill, the wall seconds; the cost of a commit and a rollback (host
   copies) of the ConvNet with AdamW and of the DDP MLP with Adam;
30. host_collectives — HostCollectives over the store on CUDA gradients
   (the ConvNet's 87 KB, the DDP MLP's 24.25 MB), one process a rank on
   one card: flat and ring at world 3, hier at world 4 (2 hosts), each
   with none and bf16 on the wire: ms per op, bytes posted and fetched
   per rank, the device-to-host and host-to-device staging ms apart; the
   ranks' results bitwise equal and near the f64 sum;
31. pipeline_resnet — the reference's model_parallel_ResNet50 recipe:
   resnet50_stages(2) on 2 stages run in this process (one card holds one
   NCCL rank), batch 32 at 128 px, SGD 0.05, MSE on one-hot labels; one
   GPipe step (splits 4 and 8) and one packed step held in f32 against
   the unpipelined ResNet50 step (each gradient within a multiple of its
   own f32-to-f64 distance), then GPipe and packed at splits 4 and 8 in
   bf16: ms per batch beside the unpipelined step's, peak memory, K1-K10
   = 0, one profiled batch; a pipeline step handed CUDA tensors on a gloo
   group raises;
32. train_pp — the train cell's model through the 1F1B real-model mode on
   2 local stages, M = 4, at V = 1 and 2 (K1 = 2·8·M, K3 = K4 = 8·M
   launches a step), beside the unpipelined step: ms per step, tokens/s,
   peak memory, bubble_fraction; a 2-layer f32 parity run against the
   unpipelined step's loss and gradients;
33. ps_hybrid — the reference's server_model_data_parallel recipe through
   make_ps_hybrid_train_step on a one-rank NCCL group against the CPU's
   steps, ms per step; the lookup over 2 virtual model shards against the
   whole table;
34. tp_kernels — K1, K3 and K4 at a tp = 2 shard of the train cell (B=8,
   S=2048, 4 local query heads over 1 KV head, D=64, causal) against
   their plain versions (kernels_bwd's limits, K1 by O_ATOL/O_RTOL and
   LSE_ATOL), a second call bitwise equal, the planners' splits, times
   beside the bound and SDPA's forward and backward;
35. train_spmd — the train cell through make_composed_train_step's
   sharded path on one card: the model in the Megatron layout over a
   one-rank tp axis, every leaf claimed by tp or fsdp (one-rank axes), so
   each step issues the ZeRO-3 gathers and reduce-scatters, the Megatron
   all-reduces and the logits' all-gather on one-rank NCCL groups; step 0
   against the unsharded flash step (loss and gradients), then ms a step
   beside it, peak memory, K1 = K3 = K4 = 8 launches a step and the
   collectives a step;
36. ep_moe — the train cell's widths with E = 8, top-2 einsum MoE MLPs
   (2 layers, batch 2: EP_MOE), through the composed EP step (tokens
   replicated over a one-rank ep axis, partial outputs all-reduced, routed
   over the one-rank dp × fsdp batch axes) and
   make_ep_shard_train_step (the all-to-all pair on a one-rank expert
   axis), each against the one-process MoE step at step 0 and timed
   beside it, launches and collectives a step;
37. serve_pipelined (after serve_prefix) — the serve cell's loop at
   pipeline_depth 1 and 2, dense and paged: the serve phase's request mix
   token-identical across all four (launches counted), a decode-bound mix
   timed (ms a tick) and profiled (device busy share), no per-tick host
   read at depth 2; a deadline kill that refunds the pool and a weight
   swap through run(source=, sink=), both at depth 2;
38. elastic_ici (after elastic_kill9) — the kill-9 gang on the ici data
   plane (a process group a round; gloo, asked for explicitly, since the
   3 ranks share one card) against elastic_kill9's host-plane card gang
   (within 1e-4), survivors bitwise equal, calls counted on each round's
   group and one allreduce a round on the store; detection and recovery
   seconds; then one process through 3 world-1 NCCL rounds (form,
   allreduce, abort), each right, no group left;
39. spec_parity (after serve_pipelined) — speculative serving exact in f32:
   the parity model with bench.py's draft (random, a 1,024 window) and
   with itself as draft, num_draft 4 and adaptive (2, 4), dense (K2) and
   paged (K5), depths 1 and 2, equal to the plain loop; K2/K5 launches
   exactly the verify queries x layers plus the draft's steps; pools
   drained; speculative_generate equal to greedy_generate (K1, K2);
40. spec_serve — serve_pipelined's decode-bound mix on the bf16 model,
   plain and num_draft 4 with each draft: ms a round, decode tokens/s,
   acceptance, rounds, K1/K2, agreement with plain;
41. serve_roles — serve_paged's mix on the bf16 model: prefill-role
   handoffs adopted by a decode-role loop (equal to the unified loop, no
   fallback), a corrupted chain falling back exactly, priority preemption
   with every lane busy (exact, preempted == resumed >= 1), an
   evacuation adopted by a peer; handoff bytes and ms;
42. sp_decode (after kernels_paged) — K2 and K6 at a global pos_offset
   over 4 virtual sequence shards of the serve rows' 8k cache, f32 and
   bf16 (per-row lengths, a window starting mid-shard, three shards all
   masked): each shard against its plain version, a dead shard exactly
   0 with LSE -1e30, the in-process LSE merge against the unsharded K2;
   each shard's time beside its bound, the merged step beside the
   unsharded K2, its plain version and SDPA;
43. sharded_generate (after serve_roles) — the serve width, 8 layers,
   f32, over one-rank NCCL groups: tp_generate, sp_generate,
   tp_sp_generate (flash), sample_generate at top_k=1 and
   tp_speculative_generate with bench.py's draft equal to
   greedy_generate; beam search (width 4) through K1/K2 equal to its
   plain versions; K1/K2 launches exact, ms a token;
44. kv_tier — serve_prefix's model and prefix under a 40-block pool, the
   host tier off and on: completions identical, spilled and re-admitted
   blocks and bytes, re-admit ms, prefill tokens saved; serve_roles'
   preemption with the tier off and on, the parked lane's pages through
   the tier, exact;
45. fleet (after kv_tier) — the serve fleet: the port's CoordServer and
   Router over three replica processes on this card (the router's own
   replica entry point, the serve width, f32), 12 prompts of 512-4,096
   tokens: a unified dense fleet with one replica SIGKILLed mid-decode
   and a disaggregated one (1 prefill + 2 decode, paged, KV over the
   store), each request once and token-identical to one ServeLoop on the
   card; each replica's K1/K2/K5 launches from the replica itself; wall,
   requests/s, detection s, p50/p99 latency, handoff bytes;
46. fleet_autoscale (after fleet) — the fleet phase's model and prompts,
   paged at block 128, from one replica: an Autoscaler (1-2 replicas, a
   5 ms queue-wait target) buys a joiner during batch 1, batch 2 (12
   fresh prompts from seed + 1) spreads over both, the idle tail (a 25 s
   queue-wait window) drains one replica back out; batch 1 once and
   token-identical to the fleet phase's paged ServeLoop, batch 2 to its
   own paged ServeLoop reference, >= 1 scale-up, >= 1 clean drain (exit
   0, pool_drained), no death and no ReplicaLost alert over a FleetScraper,
   K1 and K5 (no K2) in every replica that served, the joiner among
   them, a live console frame listing both; scale-up s, drain s, wall s
   and requests/s a batch, p50/p99.
47. check_build (after ep_moe) — ``python -m tpudist_torch.check_build``
   on the card: rc 0, the torch backend (capability 9.0), the
   collectives (one NCCL rank a card) and the kernels (the five
   libraries, K1 once at (1, 256, 2, 128) bf16 causal within 0.05 of the
   plain reference) OK; each probe's line, K1's error and launch;
48. sim_replay — bench.py's sim_replay cell: a live one-replica fleet on
   the card (chip_smoke's replica mode, tpudist's AutoscaleConfig, its
   16-request spike, a 15 s queue-wait window) buys a joiner; its merged
   events document replays through FleetSim.from_trace with
   decision_match (equal scale-ups, the first within one poll of the
   breach); every replica that served launched K1 and K5 and no K2
   (counted in the replica from its start: launches_sim_replay); live
   and sim wall s, speedup, live and sim p50/p99 queue wait (printed,
   not gated);
49. sim — tpudist's 13 builtin scenarios at full length through the
   port's FleetSim (``python -m tpudist_torch.sim --all --check``, a
   process of its own, steady_state once more from a spec file): every
   envelope held, no lost request, steady_state's two rows equal but for
   sim_wall_s and speedup; each scenario's sim_wall_s and speedup;
50. mesh_bench (beside sim: both are host work) — ``python -m
   tpudist_torch.parallel.mesh_bench --force-cpu`` in 8 gloo ranks on
   the CPU (one NCCL rank a card needs 8 cards; the machine has one): the six composition rows bitwise equal to
   their single-strategy steps, the real LM through interleaved 1F1B
   (P=4, M=16, V=4) trained with its bubble at most 0.08; the rows and
   the wall s.

Kernel times are device times: CUDA-graph replays with the L2 cache
flushed before each call (see ``timed_ms``).

Then each phase's wall seconds as one JSON line (``phase_seconds``: the
build, every phase by name, summed over its calls, sim and mesh_bench
overlapping, and the whole script), the card's name and power limit as
nvidia-smi prints them, the kernel summary as one JSON line, and last
the result line.  Exits non-zero
without a result when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# serve_pipelined's decode-bound mix: 4 lanes of 300-token prompts, 256 new
# tokens each, segments of 32 ticks (the serve cell's slots and segment)
SERVE_PIPE = {"slots": 4, "steps": 32, "prompt": 300, "new": 256}
# the serve model's widths (vocab, heads, KV heads, embed, context) and the
# draft of bench.py's speculative cell (1 layer, 1 head, embed 128, a
# 1,024-token window); the spec and role phases read them
SERVE_WIDTH = {"vocab_size": 32000, "num_heads": 8, "num_kv_heads": 2,
               "embed_dim": 512, "max_seq_len": 8192}
SPEC_DRAFT = {"num_layers": 1, "num_heads": 1, "num_kv_heads": 1,
              "embed_dim": 128, "attention_window": 1024}
# spec_parity: the parity phase's requests, plus a speculative_generate
# batch of 2 x 300 prompt tokens, 24 new each
SPEC_PARITY = {"lens": [1100, 37, 600, 513], "new": 24, "gen_prompt": 300,
               "gen_new": 24, "block": 16}
# serve_roles: serve_paged's mix (block 128, a 72-block pool), segments of
# 32; a priority-1 arrival of 512 + 64 tokens at the preemption's 3rd poll,
# an evacuation at the 6th
SERVE_ROLES = {"lens": [1024, 2048, 512, 1024, 512, 2048], "new": 256,
               "block": 128, "slots": 4, "steps": 32, "vip": (512, 64),
               "vip_at": 3, "evacuate_at": 6}
# sp_decode: K2/K6 over this many virtual sequence shards of the 8k cache
SP_DECODE = {"shards": 4}
# sharded_generate: the serve width at this depth, f32, 2 rows of 1,000
# prompt tokens (prefilled in chunks of 512), 32 new; beams of 4.  Beam
# scores through K1/K2 within BEAM_SCORE_ATOL of the plain versions' (sums
# of 32 f32 log-softmax terms over 32,000 logits, in other orders)
SHARDED_GEN = {"layers": 8, "batch": 2, "prompt": 1000, "new": 32,
               "chunk": 512, "beam": 4}
BEAM_SCORE_ATOL = 1e-3
# kv_tier: a 40-block pool (block 32) under the 1,024-token prefix (32
# blocks cached), 3 rounds of a prefix request then 2 fillers of 16 prompt
# tokens and 192 new (7 blocks each: their reservations evict 6 cached
# prefix blocks)
KV_TIER = {"blocks": 40, "rounds": 3, "filler_new": 192}
# fleet: three replica processes on one card at the serve width (8 layers,
# f32) through the router's model flags, 4 slots, prefill chunk 512,
# segments of 16; 12 prompts of 512-4,096 tokens, 64 new each; r1 of the
# unified fleet SIGKILLs itself after its 3rd segment; paged at block 128
FLEET = {"vocab": 32000, "layers": 8, "heads": 8, "kv_heads": 2,
         "embed": 512, "seq_len": 4224, "slots": 4, "chunk": 512,
         "steps": 16, "ttl": 2.0, "block": 128, "requests": 12,
         "min_prompt": 512, "max_prompt": 4096, "new": 64, "kill_after": 3,
         "timeout_s": 300.0}
# host seconds idled at each end of a decode kernel's profile window, so
# that a device clock running apart from the host's cuts no call off it
PROFILE_PAD_S = 0.05
# Kernel against its plain version, bf16 inputs: each O element within
# O_ATOL + O_RTOL * |plain O| (O's scale falls as the softmax spreads:
# about sqrt(e / n) over n keys, 0.02 at 8k), the f32 LSE within LSE_ATOL
O_ATOL, O_RTOL, LSE_ATOL = 2e-3, 2e-2, 1e-3
# Backward kernels against their plain versions, bf16: each dQ/dK/dV
# element within GRAD_ATOL_REL * max|plain| + GRAD_RTOL * |plain|.  Both
# round dS and P to bf16 at the same points, but sum in other orders, so
# an element of dS may land one bf16 ulp (2^-8 relative) away and its
# error spreads over a whole row of the next product: an error of order
# 2^-8 times the gradient's typical size.  A flat limit relative to the
# gradient's largest element covers that; the relative term covers the
# largest elements.  Delta is f32 in both, within DELTA_ATOL.
GRAD_ATOL_REL, GRAD_RTOL, DELTA_ATOL = 1e-2, 2e-2, 1e-3
# train_parity: flash (K1/K3/K4, exact f32 FMAs) against the plain sdpa
# (f32 einsum and softmax, TF32 off): the loss within LOSS_RTOL relative,
# each parameter's gradient within PGRAD_TOL * max|sdpa gradient| (sums in
# other orders, through 2 layers and a 32000-way softmax)
LOSS_RTOL, PGRAD_TOL = 1e-5, 1e-3
# K7 against its plain version, bf16: each y element within MOE_ATOL_REL *
# max|plain| + MOE_RTOL * |plain|.  Both round h to bf16 between the two
# products, but the first product sums in another order, so an element of
# h may land one bf16 ulp (2^-8 relative) away and its error spreads over
# the 2048-long second product; the flat term relative to y's largest
# element covers that, the relative term the largest elements.
MOE_ATOL_REL, MOE_RTOL = 1e-2, 2e-2
# f32 kernels against f32 references (exact FMAs on both sides, sums in
# other orders, the ring's 4 partial sums merged in f32): each element
# within F32_ATOL + F32_RTOL * |reference|
F32_ATOL, F32_RTOL = 1e-4, 1e-4
# train_sp step 0 against the dense flash step (bf16 compute): the loss
# within SP_LOSS_RTOL (the forward is the same kernels on the same
# inputs), each parameter's gradient within SP_GRAD_TOL * max|dense
# gradient| (Delta summed in another order, so an element of dS may round
# one bf16 ulp away)
SP_LOSS_RTOL, SP_GRAD_TOL = 1e-6, 1e-2
# train_sp's 12 SP steps against 12 dense flash steps from the same weights
# on the same batch: each step's loss within SP_TRAJ_RTOL of the dense
# one's.  Each step's gradients differ by up to SP_GRAD_TOL of their max,
# and Adam normalises per element, so an element whose gradient is near
# zero moves by up to lr on a difference in its last bits: the two runs
# drift apart by a few lr in such elements over the steps.  A fault of the
# ring backward gives gradients wrong by their own size, which Adam turns
# into updates of lr in every element it touches.
SP_TRAJ_RTOL = 5e-2
# K9/K10 against their plain versions: bf16 y by O_ATOL/O_RTOL (both round
# one f32 value, from statistics that differ in their last bits), the
# gradients by grad_ratio (dx sums rounded terms in other orders), the f32
# mean and rstd within GN_STAT_RTOL of their max (the bf16 cases' inputs
# carry a mean of up to ~3 std per channel, so E[x²] − mean² cancels about
# a decimal digit of the sums' rounding); the f32 case (zero-mean input)
# every output within GN_F32_REL of its tensor's max
GN_STAT_RTOL, GN_F32_REL = 1e-4, 1e-5
# gn_sites: the fused op (bf16) against the closed form (f32) at each
# site.  An element whose f32 pre-activation lies within rounding of 0 may
# fall on the other side of the ReLU in the two (their statistics are
# summed in other orders), and then takes or drops a whole dy in dx and
# dres.  Only such elements (gn_site_flips) may exceed grad_ratio's
# limit, and at most GN_SITE_FLIP of a gradient's elements; none at a
# plain site, none of dscale or dbias.
GN_SITE_FLIP = 1e-5
# resnet_parity: card (cuDNN, TF32 off) against CPU, f32, at equal
# weights and with the CPU's discrete choices (each ReLU's mask, the stem
# max-pool's argmax) replayed on the card and in f64.  At batch 4 and 64
# px a layer3 channel sums 64 terms, so one ReLU whose input lies within
# rounding of 0 moves that channel's gradients by whole terms: on the
# CPU, f32 against f64, two such flips among 3.2M choices set tensors'
# gradients 0.25% apart (relative L2), and a CPU f32 run on images moved
# by half an ulp flips another, putting one bias 13 times farther off.
# With the choices replayed, f32 sits at most 7e-6 from f64 in every
# tensor.  The loss within RESNET_LOSS_RTOL relative; each parameter's
# gradient, tensor by tensor (relative L2), within RESNET_NOISE_FACTOR
# times that tensor's own CPU f32-against-f64 distance at the same
# weights and choices, and never tighter than RESNET_GRAD_FLOOR (about 80
# f32 ulps: the best-conditioned tensor, the head's bias, sits 1.6e-7
# from f64).  A wrong conv or norm on the card is off by its own size.
# The card's own choices may differ from the CPU's in at most
# RESNET_FLIP_SHARE of them (a wrong conv flips about half).
RESNET_FLIP_SHARE = 1e-4
RESNET_LOSS_RTOL, RESNET_NOISE_FACTOR, RESNET_GRAD_FLOOR = 1e-5, 10.0, 1e-5
# ... at lr 1e-3, where the loss on 4 images falls every step (at the train
# cell's 0.05 it falls to a fifth, then jumps sixfold at the third step)
RESNET_PARITY_LR = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# wall seconds by phase, summed over a phase's calls (_time_phases)
PHASE_SECONDS: dict = {}


def _time_phases() -> None:
    """Wrap every ``phase_*`` function of this module so that its calls'
    wall seconds add up in PHASE_SECONDS under the phase's name (its
    ``phase=`` or ``name=`` argument where it takes one)."""
    import functools

    def timed(fn, default):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            key = kwargs.get("phase") or kwargs.get("name") or default
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                PHASE_SECONDS[key] = (PHASE_SECONDS.get(key, 0.0)
                                      + time.perf_counter() - t0)

        return run

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = timed(fn, name[len("phase_"):])


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int, flush) -> float:
    """Device time of one ``fn`` call with a cold L2 cache (the serve path
    finds a layer's K/V cold: 8 layers of cache exceed the 50 MB L2).

    ``iters`` rounds of (flush, ``fn``) are captured in one CUDA graph and
    a second graph holds the flushes alone; the difference of their
    replay times, per round, is ``fn``'s device time.  Replaying a graph
    leaves no host gap between launches, so the wrapper's Python and
    ctypes overhead is not counted as device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up: builds, allocator, handles
        flush()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for with_fn in (True, False):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                flush()
                if with_fn:
                    fn()
        graphs.append(graph)

    def replay_ms(graph) -> float:
        graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    ms = (replay_ms(graphs[0]) - replay_ms(graphs[1])) / iters
    del graphs
    torch.cuda.synchronize()
    return ms


def decode_split_ms(fn, iters: int, flush, attempts: int = 3) -> dict:
    """Device ms of a decode call's two kernels apart — the split pass
    (``decode_partial_kernel``) and the merge (``decode_merge_kernel``) —
    as torch.profiler's mean over ``iters`` calls, each after an L2
    flush.

    The profiler keeps only the device events whose timestamps, carried
    over to the host's clock, fall inside its window, so a device clock
    that runs apart from the host's cuts calls off the window's ends:
    the window is padded by ``PROFILE_PAD_S`` of host time at both ends.
    A profile that still shows another count than one of each kernel a
    call is taken again, up to ``attempts`` profiles in all; the times
    come from the first whose counts are exact."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (("partial_ms", "decode_partial_kernel"),
             ("merge_ms", "decode_merge_kernel"))
    flush()
    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(iters):
                flush()
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = prof.key_averages()
        out, counts = {"profile_attempts": attempt}, {}
        for key, name in names:
            rows = [e for e in events if name in e.key]
            counts[name] = [(e.key[:60], e.count) for e in rows]
            out[key] = (sum(e.self_device_time_total for e in rows)
                        / iters / 1e3)
        if all(sum(c for _, c in rows) == iters for rows in counts.values()):
            return out
        seen.append(counts)
    check(False, f"no profile of {iters} calls shows one of each decode "
          f"kernel a call, in {attempts} profiles: {seen}")


def compare(o, lse, po, plse) -> tuple[float, float, float]:
    """(max |O| error, max |LSE| error, worst ratio of an O element's error
    to its limit O_ATOL + O_RTOL * |plain|); the kernel agrees when the
    ratio is at most 1 and the LSE error at most LSE_ATOL."""
    diff = (o.float() - po.float()).abs()
    ratio = (diff / (O_ATOL + O_RTOL * po.float().abs())).max().item()
    return diff.max().item(), (lse - plse).abs().max().item(), ratio


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev, seed):
    import torch.nn.functional as F

    from tpudist_torch.ops import flash_attention as fa
    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    # K1 at the prefill shapes: a 512-token chunk of one request against
    # the packed 8k cache of the serve model (H=8, Hkv=2, D=64)
    H, HKV, D, S, C = 8, 2, 64, 8192, 512
    k1 = []
    kc, vc = rnd(1, S, HKV * D), rnd(1, S, HKV * D)
    k4, v4 = kc.view(1, S, HKV, D), vc.view(1, S, HKV, D)
    for q_off in (0, 4096, 7168):
        q = rnd(1, C, H, D)
        off = torch.tensor(q_off, dtype=torch.int32, device=dev)
        o, lse = fa._flash_forward(q, k4, v4, True, q_offset=off)
        po, plse = fa._flash_forward_plain(q, k4, v4, True, q_offset=off)
        err_o, err_l, ratio = compare(o, lse, po, plse)
        check(ratio <= 1.0 and err_l <= LSE_ATOL,
              f"K1 disagrees with its plain version at q_offset={q_off}: "
              f"O {err_o} (ratio to limit {ratio}) LSE {err_l}")
        again = fa._flash_forward(q, k4, v4, True, q_offset=off)
        repeat = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        check(repeat, f"K1 at q_offset={q_off}: a second call on the same "
              f"inputs gave other bits")
        plan = fa._fwd_plan_for(q, k4, causal=True)
        # ... and against the split walk and merge in plain PyTorch
        so, slse = fa._flash_forward_split_plain(q, k4, v4, True,
                                                 q_offset=off, plan=plan)
        _, split_err_l, split_ratio = compare(o, lse, so, slse)
        check(split_ratio <= 1.0 and split_err_l <= LSE_ATOL,
              f"K1 disagrees with its split plain version at q_offset="
              f"{q_off} ({plan}): ratio {split_ratio} LSE {split_err_l}")
        del so, slse
        live = min(S, q_off + C)
        pairs = sum(min(S, q_off + r + 1) for r in range(C))
        nbytes = (2 * q.numel() * 2 + H * C * 4 + 2 * live * HKV * D * 2)
        b_ms, b_by = bound(nbytes, 4.0 * pairs * D * H)
        qt, kt, vt = q.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)
        mask = (torch.arange(S, device=dev)[None, :]
                <= torch.arange(q_off, q_off + C, device=dev)[:, None])
        k1.append({
            "q_offset": q_off, "max_abs_err": err_o, "lse_err": err_l,
            "tol_ratio": ratio, "bitwise_repeat": repeat,
            "split_plain": {"tol_ratio": split_ratio,
                            "lse_err": split_err_l},
            "plan": {"splits": plan.splits, "chunk": plan.chunk},
            "ms": timed_ms(lambda: fa._flash_forward(q, k4, v4, True,
                                                     q_offset=off), 20, flush),
            "plain_ms": timed_ms(lambda: fa._flash_forward_plain(
                q, k4, v4, True, q_offset=off), 5, flush),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 20, flush),
            "bound_ms": b_ms, "bound_by": b_by})
    chunk_inv = k1_chunk_invariance(torch, fa, rnd, k4, v4, dev)

    # K2 at the decode shapes: 4 slots at per-row lengths, the side buffer
    # (capacity steps_per_sync = 32) holding 17 tokens; and a scalar length
    B, CAP = 4, 32
    lens = torch.tensor([7680, 5120, 2560, 300], dtype=torch.int32,
                        device=dev)
    kc, vc = rnd(B, S, HKV * D), rnd(B, S, HKV * D)
    sk, sv = rnd(B, CAP, HKV * D), rnd(B, CAP, HKV * D)
    side_len = torch.tensor(17, dtype=torch.int32, device=dev)
    # greedy_generate's scalar decode passes the cache index as a 0-D
    # device tensor
    scalar_len = torch.tensor(7000, dtype=torch.int32, device=dev)
    q = rnd(B, 1, H, D)
    k2 = []
    for name, kw, n_live in (
            ("per_row_side", dict(cache_len=lens, side_k=sk, side_v=sv,
                                  side_len=side_len),
             int(lens.sum()) + B * 17),
            ("scalar", dict(cache_len=scalar_len), B * 7000)):
        o, lse = fd.flash_decode(q, kc, vc, packed_kv_heads=HKV,
                                 return_lse=True, **kw)
        po, plse = fd.flash_decode_plain(q, kc, vc, packed_kv_heads=HKV,
                                         return_lse=True, **kw)
        err_o, err_l, ratio = compare(o, lse, po, plse)
        check(ratio <= 1.0 and err_l <= LSE_ATOL,
              f"K2 disagrees with its plain version ({name}): O {err_o} "
              f"(ratio to limit {ratio}) LSE {err_l}")
        # ... and against the split walk and merge in plain PyTorch at the
        # wrappers' split, and a second call bitwise equal
        split = fd._SPLIT_KEYS
        so, slse = fd._flash_decode_split_plain(
            q, kc, vc, packed_kv_heads=HKV, return_lse=True,
            split_keys=split, **kw)
        _, split_err_l, split_ratio = compare(o, lse, so, slse)
        check(split_ratio <= 1.0 and split_err_l <= LSE_ATOL,
              f"K2 disagrees with its split plain version ({name}, "
              f"{split} keys a split): ratio {split_ratio} LSE "
              f"{split_err_l}")
        again = fd.flash_decode(q, kc, vc, packed_kv_heads=HKV,
                                return_lse=True, **kw)
        repeat = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        check(repeat, f"K2 ({name}): a second call on the same inputs gave "
              f"other bits")
        del so, slse, again
        nbytes = 2 * n_live * HKV * D * 2 + 2 * q.numel() * 2
        b_ms, b_by = bound(nbytes, 4.0 * n_live * H * D)
        # the library yardstick: SDPA over main cache + side buffer with
        # a boolean mask (the concatenation is made outside the timing)
        if "side_k" in kw:
            keys = torch.cat([kc, sk], 1).view(B, S + CAP, HKV, D)
            vals = torch.cat([vc, sv], 1).view(B, S + CAP, HKV, D)
            pos = torch.arange(S + CAP, device=dev)
            m = torch.where(pos < S, pos < lens[:, None],
                            pos - S < 17)[:, None, None, :]
        else:
            keys, vals = kc.view(B, S, HKV, D), vc.view(B, S, HKV, D)
            m = (torch.arange(S, device=dev) < 7000)[None, None, None, :]
        qt, kt, vt = q.transpose(1, 2), keys.transpose(1, 2), \
            vals.transpose(1, 2)
        k2.append({
            "case": name, "max_abs_err": err_o, "lse_err": err_l,
            "tol_ratio": ratio, "bitwise_repeat": repeat,
            "split_plain": {"tol_ratio": split_ratio,
                            "lse_err": split_err_l},
            "plan": {"split_keys": split},
            "ms": timed_ms(lambda: fd.flash_decode(
                q, kc, vc, packed_kv_heads=HKV, **kw), 50, flush),
            "plain_ms": timed_ms(lambda: fd.flash_decode_plain(
                q, kc, vc, packed_kv_heads=HKV, **kw), 10, flush),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m, enable_gqa=True), 50, flush),
            **decode_split_ms(lambda: fd.flash_decode(
                q, kc, vc, packed_kv_heads=HKV, **kw), 20, flush),
            "bound_ms": b_ms, "bound_by": b_by})
    del flush_buf
    emit({"phase": "kernels", "K1": k1, "K1_chunk_invariance": chunk_inv,
          "K2": k2,
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "lse_atol": LSE_ATOL}})
    return k1, k2


def k1_chunk_invariance(torch, fa, rnd, k4, v4, dev) -> dict:
    """K1's chunk invariance at the serve shape: a 1,024-token prompt's
    queries over the packed 8k cache (the planner splits this walk),
    prefilled as one chunk and as chunks of 512 + 300 + 212 at their
    offsets (the cache index as a device scalar, as the serve path passes
    it): every out and LSE row bit-identical."""
    q = rnd(1, 1024, k4.shape[2] * 4, k4.shape[3])
    whole_o, whole_l = fa._flash_forward(q, k4, v4, True)
    chunks, lo, equal = [512, 300, 212], 0, True
    for n in chunks:
        off = torch.tensor(lo, dtype=torch.int32, device=dev)
        o, lse = fa._flash_forward(q[:, lo:lo + n], k4, v4, True,
                                   q_offset=off)
        equal = (equal and torch.equal(o, whole_o[:, lo:lo + n])
                 and torch.equal(lse, whole_l[:, :, lo:lo + n]))
        lo += n
    plan = fa._fwd_plan_for(q, k4, causal=True)
    check(equal, f"K1: the prompt's rows differ between one chunk and "
          f"chunks {chunks} (plan {plan})")
    return {"prompt": 1024, "chunks": chunks, "bit_identical": equal,
            "plan": {"splits": plan.splits, "chunk": plan.chunk}}


def phase_paged_kernels(torch, dev, seed):
    """K5 and K6 against their plain versions (bf16) at the decode shapes
    of the serve model (H=8, Hkv=2, D=64): 4 rows at lengths
    7680/5120/2560/300 with 17 of 32 side tokens.  K5 reads a pool whose
    page table is a seeded random permutation, at block 128 and block 16,
    and must equal K2 over the gathered view bit for bit; K6 reads an 8k
    int8 cache from ``quantize_kv``, at per-row and scalar length.
    Returns ``{"K5": rows, "K6": rows}``."""
    import torch.nn.functional as F

    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed + 6)
    bf = torch.bfloat16
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    H, HKV, D, S, B, CAP, SIDE = 8, 2, 64, 8192, 4, 32, 17
    F_ = HKV * D
    lens = torch.tensor([7680, 5120, 2560, 300], dtype=torch.int32,
                        device=dev)
    side_len = torch.tensor(SIDE, dtype=torch.int32, device=dev)
    q = rnd(B, 1, H, D)
    sk, sv = rnd(B, CAP, F_), rnd(B, CAP, F_)
    n_live = int(lens.sum()) + B * SIDE
    k5 = []
    for bs in (128, 16):
        m = S // bs
        kp, vp = rnd(B * m, bs, F_), rnd(B * m, bs, F_)
        table = torch.randperm(B * m, generator=g, device=dev).to(
            torch.int32).view(B, m)
        kw = dict(packed_kv_heads=HKV, side_k=sk, side_v=sv,
                  side_len=side_len)
        o = fd.paged_flash_decode(q, kp, vp, table, lens, **kw)
        po = fd.paged_flash_decode_plain(q, kp, vp, table, lens, **kw)
        kg, vg = fd.paged_gather_kv(kp, table), fd.paged_gather_kv(vp, table)
        o_k2 = fd.flash_decode(q, kg, vg, lens, **kw)
        split = fd._SPLIT_KEYS
        so = fd._paged_flash_decode_split_plain(q, kp, vp, table, lens,
                                                split_keys=split, **kw)
        repeat = bool(torch.equal(
            o, fd.paged_flash_decode(q, kp, vp, table, lens, **kw)))
        torch.cuda.synchronize()
        diff = (o.float() - po.float()).abs()
        ratio = (diff / (O_ATOL + O_RTOL * po.float().abs())).max().item()
        split_ratio = ((o.float() - so.float()).abs()
                       / (O_ATOL + O_RTOL * so.float().abs())).max().item()
        identical = bool(torch.equal(o, o_k2))
        check(ratio <= 1.0, f"K5 disagrees with its plain version (block "
              f"{bs}): O {diff.max().item()} (ratio to limit {ratio})")
        check(split_ratio <= 1.0, f"K5 disagrees with its split plain "
              f"version (block {bs}, {split} keys a split): ratio "
              f"{split_ratio}")
        check(identical, f"K5 (block {bs}) differs from K2 over the gathered "
              f"view by {(o.float() - o_k2.float()).abs().max().item()}")
        check(repeat, f"K5 (block {bs}): a second call on the same inputs "
              f"gave other bits")
        del so
        # the bound: live K/V, the live table entries, q and O
        live_blocks = int(((lens.long() + bs - 1) // bs).sum())
        nbytes = 2 * n_live * F_ * 2 + live_blocks * 4 + 2 * q.numel() * 2
        b_ms, b_by = bound(nbytes, 4.0 * n_live * H * D)
        # the library yardstick: SDPA over the gathered view plus the side
        # buffer with a boolean mask; the gather is made outside the timing
        keys = torch.cat([kg, sk], 1).view(B, S + CAP, HKV, D)
        vals = torch.cat([vg, sv], 1).view(B, S + CAP, HKV, D)
        pos = torch.arange(S + CAP, device=dev)
        mask = torch.where(pos < S, pos < lens[:, None],
                           pos - S < SIDE)[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), keys.transpose(1, 2), \
            vals.transpose(1, 2)
        k5.append({
            "case": f"block{bs}", "max_abs_err": diff.max().item(),
            "tol_ratio": ratio, "bit_identical_to_k2": identical,
            "bitwise_repeat": repeat,
            "split_plain": {"tol_ratio": split_ratio},
            "plan": {"split_keys": split},
            "ms": timed_ms(lambda: fd.paged_flash_decode(
                q, kp, vp, table, lens, **kw), 50, flush),
            "plain_ms": timed_ms(lambda: fd.paged_flash_decode_plain(
                q, kp, vp, table, lens, **kw), 10, flush),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 50, flush),
            "library": "SDPA over the gathered view with a mask (gather "
                       "not timed)",
            **decode_split_ms(lambda: fd.paged_flash_decode(
                q, kp, vp, table, lens, **kw), 20, flush),
            "bound_ms": b_ms, "bound_by": b_by})
        del kp, vp, kg, vg, keys, vals
    k6 = []
    kq, ks, vq, vs = fd.quantize_kv(rnd(B, S, HKV, D), rnd(B, S, HKV, D))
    scalar_len = torch.tensor(7000, dtype=torch.int32, device=dev)
    for name, cache_len, n in (("per_row", lens, int(lens.sum())),
                               ("scalar", scalar_len, B * 7000)):
        o, lse = fd.flash_decode_q8(q, kq, ks, vq, vs, cache_len,
                                    return_lse=True)
        po, plse = fd.flash_decode_q8_plain(q, kq, ks, vq, vs, cache_len,
                                            return_lse=True)
        err_o, err_l, ratio = compare(o, lse, po, plse)
        check(ratio <= 1.0 and err_l <= LSE_ATOL,
              f"K6 disagrees with its plain version ({name}): O {err_o} "
              f"(ratio to limit {ratio}) LSE {err_l}")
        split = fd._SPLIT_KEYS
        so, slse = fd._flash_decode_q8_split_plain(
            q, kq, ks, vq, vs, cache_len, return_lse=True, split_keys=split)
        _, split_err_l, split_ratio = compare(o, lse, so, slse)
        check(split_ratio <= 1.0 and split_err_l <= LSE_ATOL,
              f"K6 disagrees with its split plain version ({name}, "
              f"{split} keys a split): ratio {split_ratio} LSE "
              f"{split_err_l}")
        again = fd.flash_decode_q8(q, kq, ks, vq, vs, cache_len,
                                   return_lse=True)
        repeat = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        check(repeat, f"K6 ({name}): a second call on the same inputs gave "
              f"other bits")
        del so, slse, again
        # int8 K and V, one f32 scale each per (token, head), q and O
        nbytes = 2 * n * F_ + 2 * n * HKV * 4 + 2 * q.numel() * 2
        b_ms, b_by = bound(nbytes, 4.0 * n * H * D)
        k6.append({
            "case": name, "max_abs_err": err_o, "lse_err": err_l,
            "tol_ratio": ratio, "bitwise_repeat": repeat,
            "split_plain": {"tol_ratio": split_ratio,
                            "lse_err": split_err_l},
            "plan": {"split_keys": split},
            "ms": timed_ms(lambda: fd.flash_decode_q8(
                q, kq, ks, vq, vs, cache_len), 50, flush),
            "plain_ms": timed_ms(lambda: fd.flash_decode_q8_plain(
                q, kq, ks, vq, vs, cache_len), 10, flush),
            "library_ms": None,
            "library": "none: PyTorch has no single call for attention "
                       "over an int8 cache with per-token scales",
            **decode_split_ms(lambda: fd.flash_decode_q8(
                q, kq, ks, vq, vs, cache_len), 20, flush),
            "bound_ms": b_ms, "bound_by": b_by})
    del flush_buf, kq, vq
    torch.cuda.empty_cache()
    emit({"phase": "kernels_paged", "K5": k5, "K6": k6,
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "lse_atol": LSE_ATOL}})
    return {"K5": k5, "K6": k6}


def _counters() -> dict:
    from tpudist_torch.ops import flash_attention as fa
    from tpudist_torch.ops import flash_decode as fd

    from tpudist_torch.ops import group_norm as gn
    from tpudist_torch.ops import moe_dispatch as md

    return {"K1": fa.FLASH_FORWARD, "K2": fd.FLASH_DECODE,
            "K3": fa.FLASH_BWD_DQ, "K4": fa.FLASH_BWD_DKV,
            "K5": fd.PAGED_FLASH_DECODE, "K6": fd.FLASH_DECODE_Q8,
            "K7": md.MOE_GMM, "K8": fa.FLASH_BWD_DQ_DELTA,
            "K9": gn.GN_FWD, "K10": gn.GN_BWD}


def reset_launches():
    from tpudist_torch.ops import group_norm as gn

    for kernel in _counters().values():
        kernel.launches = 0
    gn.reset_path_launches()


def read_launches() -> dict:
    return {name: k.launches for name, k in _counters().items()}


def random_model(torch, cfg, dev, seed):
    from tpudist_torch.models.transformer import TransformerLM

    g = torch.Generator(device=dev).manual_seed(seed)
    return TransformerLM(cfg, device=dev).init_weights(g)


def phase_parity(torch, dev, seed):
    import numpy as np

    from tpudist_torch.models.generate import (
        _prefill,
        build_model,
        greedy_generate,
    )
    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        blank_cache,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=32000, num_layers=2, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.float32)
    sd = random_model(torch, cfg, dev, seed).state_dict()
    rng = np.random.default_rng(seed)
    lens, new = [1100, 37, 600, 513], 24
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    new, rid=i) for i, n in enumerate(lens)]
    reset_launches()
    loop = ServeLoop(cfg, sd, num_slots=2, steps_per_sync=8,
                     prefill_chunk=512, pipeline_depth=1, device=dev)
    comps = loop.run(reqs)
    serve_launches = read_launches()
    check(len(comps) == len(reqs), "parity: missing completions")
    check(serve_launches["K1"] > 0 and serve_launches["K2"] > 0,
          f"parity: ServeLoop did not run both kernels {serve_launches}")
    reset_launches()
    mismatched = []
    for c in comps:
        want = greedy_generate(cfg, sd, c.prompt[None], new,
                               prefill_chunk=512,
                               device=dev).cpu().numpy()[0, len(c.prompt):]
        if not np.array_equal(c.tokens, want):
            mismatched.append(c.rid)
    greedy_launches = read_launches()
    check(not mismatched, f"parity: ServeLoop != greedy_generate for "
          f"requests {mismatched}")
    check(greedy_launches["K1"] > 0 and greedy_launches["K2"] > 0,
          f"parity: greedy_generate did not run both kernels "
          f"{greedy_launches}")
    # cached-prefill logits on the card (K1) against the CPU plain path
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 96)))
    with torch.no_grad():
        m_gpu = build_model(cfg, sd, device=dev)
        _, lg = _prefill(m_gpu, blank_cache(cfg, 1, device=dev),
                         toks.to(dev), 32)
        cpu_sd = {k: v.cpu() for k, v in sd.items()}
        m_cpu = build_model(cfg, cpu_sd, device="cpu")
        _, lc = _prefill(m_cpu, blank_cache(cfg, 1, device="cpu"), toks, 32)
    logit_err = (lg.cpu() - lc).abs().max().item()
    check(bool(torch.isfinite(lg).all()) and lg.shape == (1, 32, 32000),
          "parity: non-finite or misshapen logits")
    check(logit_err <= 1e-3, f"parity: card logits differ from the CPU "
          f"plain path by {logit_err}")
    emit({"phase": "parity", "requests": len(comps), "tokens_each": new,
          "exact": True, "launches_serve": serve_launches,
          "launches_greedy": greedy_launches,
          "logit_max_abs_err_vs_cpu": logit_err})


def phase_serve(torch, dev, seed):
    import numpy as np

    from tpudist_torch.models.serving import Request, ServeLoop, ServeStats
    from tpudist_torch.models.transformer import TransformerConfig

    # bench.py's serve_loop model at its TPU widths
    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    sd = random_model(torch, cfg, dev, seed + 1).state_dict()
    loop = ServeLoop(cfg, sd, num_slots=4, steps_per_sync=32,
                     prefill_chunk=512, pipeline_depth=1, device=dev)
    rng = np.random.default_rng(seed + 1)
    # warm-up (cuBLAS handles, allocator) outside the measured run
    loop.run([Request(rng.integers(0, 32000, 600).astype(np.int32), 4)])
    lens = [7680, 5120, 2560, 7680, 2560, 5120, 7680, 2560]
    new = 64
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    new, rid=i) for i, n in enumerate(lens)]
    loop.stats = ServeStats()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    comps = loop.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = loop.stats
    check(len(comps) == len(reqs), "serve: missing completions")
    for c in comps:
        check(c.reason == "length" and c.tokens.shape == (new,)
              and int(c.tokens.min()) >= 0
              and int(c.tokens.max()) < cfg.vocab_size,
              f"serve: bad completion {c.rid}: {c.reason} "
              f"{c.tokens.shape}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"serve: a kernel of the path was never launched {launches}")
    emit({"phase": "serve",
          "completions": [{"rid": c.rid, "reason": c.reason,
                           "tokens": len(c.tokens),
                           "head": [int(t) for t in c.tokens[:6]]}
                          for c in comps],
          "launches": launches, "wall_s": wall,
          "prefill_s": st.prefill_seconds,
          "prefill_tokens_per_s": st.prompt_tokens / st.prefill_seconds,
          "decode_s": st.decode_seconds,
          "decode_tokens": st.decode_tokens,
          "decode_tokens_per_s": st.decode_tokens / st.decode_seconds,
          "segments": st.segments, "ticks": st.ticks,
          "decode_ms_per_tick": st.decode_seconds / st.ticks * 1e3,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)})
    return launches, loop


def kv_bytes(loop) -> int:
    """Bytes of the slot cache's K/V storage (dense rows or block pools;
    side buffers and indices excluded), as bench.py's kv_paging counts."""
    def live(name, t):  # a paged pool's sink block holds no KV
        return (t[:loop.pool.num_blocks]
                if name.startswith("paged_") else t)

    return sum(live(name, t).numel() * t.element_size()
               for layer in loop.cache for name, t in layer.items()
               if name in ("cached_key", "cached_value", "paged_key",
                           "paged_value"))


def _sig(comps):
    return [(c.rid, tuple(int(t) for t in c.tokens), c.reason)
            for c in comps]


def _profiled_run(torch, loop, reqs):
    """``loop.run(reqs)`` under torch.profiler (CUDA activity): the
    completions, the host wall ms and the device's kernel ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        comps = loop.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(e.self_device_time_total
                    for e in prof.key_averages()) / 1e3
    check(device_ms > 0, "serve_pipelined: the profiler saw no device time")
    return comps, wall_ms, device_ms


def phase_serve_pipelined(torch, dev, seed):
    """The serve cell's loop at pipeline_depth 1 and 2, dense and paged
    (block 128, a full-capacity pool): (a) the serve phase's request mix
    (8 prompts of 2,560-7,680 tokens, 64 new each) with launches counted:
    tokens, finish reasons and finish order identical in all four runs;
    (b) a decode-bound mix (SERVE_PIPE: 4 prompts of 300 tokens, 256 new
    each) timed on the host clock (ms a tick) and once more under the
    profiler (the device's busy share); at depth 2 no per-tick host read
    and no pinned buffer reused before its copy landed.  Then one
    deadline kill mid-decode at depth 2 on the paged layout (a strict
    prefix of the uninterrupted tokens, every block back in the pool) and
    one weight swap through ``run(source=, sink=)`` at depth 2 (requests
    decoding at the swap finish on the old weights, later ones on the
    new; every old completion before ``on_swapped``)."""
    import numpy as np

    from tpudist_torch.models.serving import Request, ServeLoop, ServeStats
    from tpudist_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    sd = random_model(torch, cfg, dev, seed + 1).state_dict()
    rng = np.random.default_rng(seed + 11)
    v = cfg.vocab_size
    lens = [7680, 5120, 2560, 7680, 2560, 5120, 7680, 2560]
    reqs = [Request(rng.integers(0, v, n).astype(np.int32), 64, rid=i)
            for i, n in enumerate(lens)]
    sp = SERVE_PIPE
    decode_reqs = [Request(rng.integers(0, v, sp["prompt"]).astype(np.int32),
                           sp["new"], rid=f"d{i}")
                   for i in range(sp["slots"])]
    warm = [Request(rng.integers(0, v, 600).astype(np.int32), 4)]
    arms, sigs, decode_sigs = {}, {}, {}
    for layout in ("dense", "paged"):
        kw = ({"cache_layout": "paged", "kv_block_size": 128}
              if layout == "paged" else {})
        for depth in (1, 2):
            loop = ServeLoop(cfg, sd, num_slots=sp["slots"],
                             steps_per_sync=sp["steps"], prefill_chunk=512,
                             pipeline_depth=depth, device=dev, **kw)
            loop.run(warm)
            loop.stats = ServeStats()
            reads = loop.segment_host_reads
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            comps = loop.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            st = loop.stats
            sigs[(layout, depth)] = _sig(comps)
            loop.stats = ServeStats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dcomps = loop.run(decode_reqs)
            torch.cuda.synchronize()
            dwall = time.perf_counter() - t0
            dticks = loop.stats.ticks
            host_wait = loop.stats.host_wait_seconds
            decode_sigs[(layout, depth)] = _sig(dcomps)
            pcomps, pwall, pdev = _profiled_run(torch, loop, decode_reqs)
            check(_sig(pcomps) == decode_sigs[(layout, depth)],
                  f"serve_pipelined: {layout} depth {depth} profiled run "
                  "differs")
            arm = {"launches": launches, "serve_wall_s": wall,
                   "serve_ticks": st.ticks, "serve_segments": st.segments,
                   "decode_wall_s": dwall, "decode_ticks": dticks,
                   "ms_per_tick": dwall / dticks * 1e3,
                   "host_wait_s": host_wait,
                   "profiled_wall_ms": pwall, "device_ms": pdev,
                   "device_busy_share": pdev / pwall,
                   "per_tick_host_reads": loop.segment_host_reads - reads,
                   "pinned_reuse_waits": loop.pinned_reuse_waits}
            if depth > 1:
                check(arm["per_tick_host_reads"] == 0
                      and loop.pinned_reuse_waits == 0
                      and len({b["emits"].data_ptr()
                               for b in loop._ring}) == depth,
                      f"serve_pipelined: {layout} depth {depth}: "
                      f"{arm['per_tick_host_reads']} tick reads, "
                      f"{loop.pinned_reuse_waits} early reuses")
            if loop.pool is not None:
                loop.pool.check()
                loop.flush_prefix_cache()
                check(loop.pool.free_blocks == loop.pool.num_blocks,
                      f"serve_pipelined: paged depth {depth}: pool not "
                      "drained")
            k = "K5" if layout == "paged" else "K2"
            other = "K2" if layout == "paged" else "K5"
            check(launches["K1"] > 0 and launches[k] > 0
                  and launches[other] == 0,
                  f"serve_pipelined: {layout} depth {depth} launches "
                  f"{launches}")
            arms[f"{layout}_depth{depth}"] = arm
            del loop
            torch.cuda.empty_cache()
    first = sigs[("dense", 1)]
    check(all(sig == first for sig in sigs.values()),
          "serve_pipelined: tokens, reasons or order differ across depths "
          "and layouts")
    check(all(sig == decode_sigs[("dense", 1)]
              for sig in decode_sigs.values()),
          "serve_pipelined: the decode mix differs across depths and "
          "layouts")
    check(all(c[2] == "length" for c in first),
          "serve_pipelined: a serve request did not run its budget")
    # a deadline kill mid-decode, paged, depth 2: the zombie path
    loop = ServeLoop(cfg, sd, num_slots=sp["slots"],
                     steps_per_sync=sp["steps"], prefill_chunk=512,
                     pipeline_depth=2, cache_layout="paged",
                     kv_block_size=128, device=dev)
    t0 = time.time()
    reads = [0]

    def clock():
        reads[0] += 1
        return t0 + (1e6 if reads[0] > 8 else 0.0)

    loop._clock = clock
    doomed = decode_reqs[0]
    [kc] = loop.run([Request(doomed.prompt, doomed.max_new_tokens,
                             rid="doomed", deadline_s=t0 + 1e5)])
    whole = next(c for c in decode_sigs[("dense", 1)] if c[0] == doomed.rid)
    n_kill = kc.tokens.shape[0]
    loop.pool.check()
    check(kc.reason == "timeout" and 0 < n_kill < doomed.max_new_tokens
          and tuple(int(t) for t in kc.tokens) == whole[1][:n_kill]
          and loop.pool.free_blocks == loop.pool.num_blocks
          and loop.stats.timeouts == 1,
          f"serve_pipelined: deadline kill {kc.reason} after {n_kill} "
          f"tokens, pool {loop.pool.free_blocks}/{loop.pool.num_blocks}")
    del loop
    # a midstream swap through source/sink, depth 2
    sd2 = random_model(torch, cfg, dev, seed + 12).state_dict()
    old = [Request(r.prompt, 24, rid=f"old{i}")
           for i, r in enumerate(decode_reqs[:2])]
    new = [Request(r.prompt, 24, rid=f"new{i}")
           for i, r in enumerate(decode_reqs[2:])]
    ref = ServeLoop(cfg, sd, num_slots=sp["slots"],
                    steps_per_sync=sp["steps"], prefill_chunk=512,
                    pipeline_depth=1, device=dev)
    want = {c.rid: tuple(int(t) for t in c.tokens) for c in ref.run(old)}
    ref.request_swap(lambda: sd2)
    want.update({c.rid: tuple(int(t) for t in c.tokens)
                 for c in ref.run(new)})
    del ref
    loop = ServeLoop(cfg, sd, num_slots=sp["slots"],
                     steps_per_sync=sp["steps"], prefill_chunk=512,
                     pipeline_depth=2, device=dev)
    events, polls = [], [0]

    def source():
        polls[0] += 1
        if polls[0] == 1:
            return old
        if polls[0] == 2:
            loop.request_swap(lambda: sd2, version=2,
                              on_swapped=lambda: events.append("swapped"))
            return new
        return None if len(events) == 5 else []

    comps = loop.run(source=source, sink=lambda c: events.append(c.rid),
                     idle_wait_s=0.0)
    got = {c.rid: tuple(int(t) for t in c.tokens) for c in comps}
    swap_at = events.index("swapped") if "swapped" in events else -1
    check(got == want and set(events[:swap_at]) == {"old0", "old1"}
          and loop.weights_version == 2,
          f"serve_pipelined: swap events {events}, tokens equal "
          f"{ {k: got.get(k) == w for k, w in want.items()} }")
    del loop
    torch.cuda.empty_cache()
    emit({"phase": "serve_pipelined", "exact_across_depths": True,
          "serve_requests": len(reqs), "decode_mix": sp,
          **arms,
          "deadline_kill": {"layout": "paged", "depth": 2,
                            "tokens_before_kill": n_kill,
                            "pool_refunded": True},
          "swap": {"depth": 2, "events": events, "exact": True}})
    return {f"{layout}_depth{depth}": arms[f"{layout}_depth{depth}"][
        "launches"] for layout in ("dense", "paged") for depth in (1, 2)}


def serve_config(torch, layers: int, dtype, **extra):
    from tpudist_torch.models.transformer import TransformerConfig

    return TransformerConfig(**{**SERVE_WIDTH, **extra}, num_layers=layers,
                             compute_dtype=dtype)


def spec_draft_config(torch, dtype):
    return serve_config(torch, SPEC_DRAFT["num_layers"], dtype,
                        **{k: v for k, v in SPEC_DRAFT.items()
                           if k != "num_layers"})


def spec_expected(st, layout, cfg, dcfg) -> dict:
    """The decode kernels' launches a speculative ServeLoop run must make:
    the target's verify chunks (K+1 one-query calls a round and layer) on
    K2 (dense) or K5 (paged), and the draft's steps on K2 unless its
    window sends them to the banded mask."""
    steps = st.spec_draft_steps
    draft = steps * dcfg.num_layers if dcfg.attention_window is None else 0
    target = steps * cfg.num_layers
    if layout == "paged":
        return {"K2": draft, "K5": target}
    return {"K2": target + draft, "K5": 0}


def spec_kernel_checks(torch, dev, seed) -> dict:
    """K1, K2 and K5 against their plain versions at the shapes the
    speculative paths give them, in bf16 and f32, at the serve model's
    widths (H=8, Hkv=2, D=64, the packed 8k cache).  K1: a K+1 = 5-query
    verify chunk of 2 rows at q_offset 300 (speculative_generate's first
    round).  K2: the unwindowed draft's one-query step at per-row lengths
    with no side buffer.  K2 and K5 (block 16 and 128): a 5-query verify
    chunk of 4 rows at per-row lengths over a side buffer of
    steps + K_max slots (12 as in spec_parity, 36 as in spec_serve) at the
    side lengths of a segment's first, a middle and its last round; query
    j sees the side's first side_len - (4 - j) positions.  Every query's
    O must agree within O_ATOL/O_RTOL and, where the wrapper returns it,
    its LSE within LSE_ATOL; the multi-query wrapper's output must equal
    its one-query calls (and K5 equal K2 over the gathered view) bit for
    bit.  Returns the worst errors by kernel."""
    from tpudist_torch.ops import flash_attention as fa
    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed + 23)
    H, HKV, D, S, K = 8, 2, 64, 8192, 4
    F_ = HKV * D
    lens = torch.tensor([1100, 37, 556, 300], dtype=torch.int32, device=dev)
    B = lens.numel()
    worst = {k: {"max_abs_err": 0.0, "tol_ratio": 0.0, "lse_err": 0.0}
             for k in ("K1", "K2", "K5")}
    cases = []

    def note(kernel, case, o, po, lse=None, plse=None):
        if lse is None:
            diff = (o.float() - po.float()).abs()
            err_o, err_l = diff.max().item(), 0.0
            ratio = (diff / (O_ATOL + O_RTOL * po.float().abs())).max().item()
        else:
            err_o, err_l, ratio = compare(o, lse, po, plse)
        check(ratio <= 1.0 and err_l <= LSE_ATOL,
              f"spec_parity: {kernel} disagrees with its plain version at "
              f"{case}: O {err_o} (ratio to limit {ratio}) LSE {err_l}")
        w = worst[kernel]
        w.update(max_abs_err=max(w["max_abs_err"], err_o),
                 tol_ratio=max(w["tol_ratio"], ratio),
                 lse_err=max(w["lse_err"], err_l))
        cases.append(kernel + " " + case)

    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt).split(".")[-1]

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        kc, vc = rnd(B, S, F_), rnd(B, S, F_)
        k4, v4 = kc[:2].view(2, S, HKV, D), vc[:2].view(2, S, HKV, D)
        q = rnd(2, K + 1, H, D)
        off = torch.tensor(300, dtype=torch.int32, device=dev)
        o, lse = fa._flash_forward(q, k4, v4, True, q_offset=off)
        po, plse = fa._flash_forward_plain(q, k4, v4, True, q_offset=off)
        note("K1", f"{tag} [2,5,8,64] q_offset 300", o, po, lse, plse)
        q1 = rnd(B, 1, H, D)
        o, lse = fd.flash_decode(q1, kc, vc, lens, packed_kv_heads=HKV,
                                 return_lse=True)
        po, plse = fd.flash_decode_plain(q1, kc, vc, lens,
                                         packed_kv_heads=HKV, return_lse=True)
        note("K2", f"{tag} draft step, per-row lengths, no side", o, po,
             lse, plse)
        pools = {}
        for bs in (16, 128):
            m = S // bs
            table = torch.randperm(B * m, generator=g, device=dev).to(
                torch.int32).view(B, m)
            kp = torch.empty(B * m, bs, F_, dtype=dt, device=dev)
            vp = torch.empty_like(kp)
            # the pool holds the dense cache's rows at the table's blocks,
            # so K5 must give K2's bits
            kp[table.view(-1).long()] = kc.view(B * m, bs, F_)
            vp[table.view(-1).long()] = vc.view(B * m, bs, F_)
            pools[bs] = (kp, vp, table)
        q = rnd(B, K + 1, H, D)
        for cap, side_lens in ((12, (5, 12)), (36, (5, 20, 36))):
            sk, sv = rnd(B, cap, F_), rnd(B, cap, F_)
            for n in side_lens:
                sl = torch.tensor(n, dtype=torch.int32, device=dev)
                kw = dict(side_k=sk, side_v=sv, packed_kv_heads=HKV)
                case = f"{tag} verify chunk, side {n} of {cap}"
                multi = fd.flash_decode(q, kc, vc, lens, side_len=sl, **kw)
                ones = []
                for j in range(K + 1):
                    at = sl - (K - j)
                    o, lse = fd.flash_decode(q[:, j:j + 1], kc, vc, lens,
                                             side_len=at, return_lse=True,
                                             **kw)
                    po, plse = fd.flash_decode_plain(
                        q[:, j:j + 1], kc, vc, lens, side_len=at,
                        return_lse=True, **kw)
                    note("K2", f"{case}, query {j}", o, po, lse, plse)
                    ones.append(o)
                check(torch.equal(multi, torch.cat(ones, 1)),
                      f"spec_parity: K2's multi-query call differs from its "
                      f"one-query calls ({case})")
                for bs, (kp, vp, table) in pools.items():
                    paged = fd.paged_flash_decode(q, kp, vp, table, lens,
                                                  side_len=sl, **kw)
                    for j in range(K + 1):
                        po = fd.paged_flash_decode_plain(
                            q[:, j:j + 1], kp, vp, table, lens,
                            side_len=sl - (K - j), **kw)
                        note("K5", f"{case}, block {bs}, query {j}",
                             paged[:, j:j + 1], po)
                    check(torch.equal(paged, multi),
                          f"spec_parity: K5 (block {bs}) differs from K2 "
                          f"over the same cache ({case})")
        del kc, vc, pools
    torch.cuda.empty_cache()
    return {"cases": len(cases), "worst": worst}


def phase_spec_parity(torch, dev, seed):
    """Speculative decoding exact in f32 on the card: the parity phase's
    full-width 2-layer model (TF32 off) with two drafts, bench.py's
    speculative draft (random weights, a 1,024 window: its steps take the
    banded mask) and the target itself (its steps take K2).  Greedy
    speculative ServeLoops with num_draft 4 and "adaptive" (ladder 2, 4),
    dense and paged (block 16, K5), at depths 1 and 2: every completion
    equal to the plain loop's, each run's K2/K5 launches exactly the
    target's verify queries x layers plus the draft's steps, every pool
    drained; speculative_generate (K1 verify chunks, K2 draft steps, the
    window passed to the kernel) equal to greedy_generate.  First, the
    kernels at these paths' shapes against their plain versions
    (spec_kernel_checks).  Returns (the runs' launches, those checks)."""
    import numpy as np

    from tpudist_torch.models.generate import greedy_generate
    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.models.speculative import speculative_generate

    t_start = time.perf_counter()
    kernel_checks = spec_kernel_checks(torch, dev, seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = SPEC_PARITY
    cfg = serve_config(torch, 2, torch.float32)
    sd = random_model(torch, cfg, dev, seed).state_dict()
    dcfg = spec_draft_config(torch, torch.float32)
    drafts = {"bench_draft": (dcfg, random_model(torch, dcfg, dev,
                                                 seed + 21).state_dict()),
              "self": (cfg, sd)}
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    reqs = [Request(rng.integers(0, v, n).astype(np.int32), P["new"], rid=i)
            for i, n in enumerate(P["lens"])]
    layouts = {"dense": {}, "paged": {"cache_layout": "paged",
                                      "kv_block_size": P["block"]}}
    base = dict(num_slots=2, steps_per_sync=8, prefill_chunk=512,
                device=dev)
    want = {layout: sorted(_sig(ServeLoop(cfg, sd, pipeline_depth=1,
                                          **base, **kw).run(reqs)))
            for layout, kw in layouts.items()}
    check(want["dense"] == want["paged"],
          "spec_parity: plain dense and paged completions differ")
    runs, totals = {}, {"K1": 0, "K2": 0, "K5": 0}
    for dname, (dc, dp) in drafts.items():
        for layout, kw in layouts.items():
            for kname, ks in (("k4", {"num_draft": 4}),
                              ("adaptive", {"num_draft": "adaptive",
                                            "spec_ladder": (2, 4)})):
                for depth in (1, 2):
                    name = f"{dname}_{layout}_{kname}_depth{depth}"
                    loop = ServeLoop(cfg, sd, pipeline_depth=depth,
                                     decode_mode="speculative", draft_cfg=dc,
                                     draft_params=dp, **base, **kw, **ks)
                    reset_launches()
                    comps = loop.run(reqs)
                    torch.cuda.synchronize()
                    launches = read_launches()
                    st = loop.stats
                    check(sorted(_sig(comps)) == want[layout],
                          f"spec_parity: {name} differs from plain serving")
                    expect = spec_expected(st, layout, cfg, dc)
                    check(launches["K1"] > 0
                          and all(launches[k] == n
                                  for k, n in expect.items()),
                          f"spec_parity: {name} launches {launches}, "
                          f"expected {expect} ({st.spec_draft_steps} "
                          "draft steps)")
                    if loop.pool is not None:
                        loop.pool.check()
                        check(loop.pool.free_blocks == loop.pool.num_blocks,
                              f"spec_parity: {name}: pool not drained")
                    for k in totals:
                        totals[k] += launches[k]
                    runs[name] = {
                        "rounds": st.spec_rounds,
                        "draft_steps": st.spec_draft_steps,
                        "acceptance": st.spec_accepted / max(
                            st.spec_row_rounds * st.spec_k, 1),
                        "last_k": st.spec_k, "launches": launches}
                    del loop
    prompt = rng.integers(0, v, (2, P["gen_prompt"])).astype(np.int32)
    greedy = greedy_generate(cfg, sd, prompt, P["gen_new"],
                             prefill_chunk=512, device=dev).cpu()
    gen = {}
    for dname, (dc, dp) in drafts.items():
        reset_launches()
        toks, st = speculative_generate(cfg, sd, dc, dp, prompt,
                                        P["gen_new"], num_draft=4,
                                        prefill_chunk=512, return_stats=True,
                                        device=dev)
        torch.cuda.synchronize()
        launches = read_launches()
        check(torch.equal(toks.cpu(), greedy),
              f"spec_parity: speculative_generate ({dname}) differs from "
              "greedy_generate")
        steps = st["rounds"] * 5
        chunks = -(-P["gen_prompt"] // 512)
        want_k1 = (chunks + st["rounds"]) * cfg.num_layers \
            + chunks * dc.num_layers
        check(launches["K2"] == steps * dc.num_layers
              and launches["K1"] == want_k1,
              f"spec_parity: speculative_generate ({dname}) launches "
              f"{launches}, expected K1 {want_k1}, K2 "
              f"{steps * dc.num_layers}")
        for k in totals:
            totals[k] += launches[k]
        gen[dname] = {**st, "launches": launches}
    torch.cuda.empty_cache()
    emit({"phase": "spec_parity", "exact": True, "requests": len(reqs),
          "tokens_each": P["new"], "kernel_checks": kernel_checks,
          "runs": runs, "speculative_generate": gen, "launches": totals,
          "seconds": time.perf_counter() - t_start})
    return totals, kernel_checks["worst"]


def phase_spec_serve(torch, dev, seed):
    """Speculative serving of the bf16 serve model on serve_pipelined's
    decode-bound mix (SERVE_PIPE: 4 x 300 prompt tokens, 256 new, 4 slots,
    segments of 32, depth 1): plain, then num_draft 4 with bench.py's
    draft (random weights) and with the target as its own draft, in one
    run.  For each: ms a round (a tick for plain), decode tokens/s,
    acceptance, rounds, the host reads (one a round plus one a segment),
    the K1/K2 launches (K2 exactly the verify queries
    x layers plus the unwindowed draft's steps) and the share of tokens
    equal to the plain loop's at the same position (bf16 near-ties may
    flip between the verify chunk and the decode step: reported, not
    held; spec_parity holds exactness)."""
    import numpy as np

    from tpudist_torch.models.serving import Request, ServeLoop, ServeStats

    t_start = time.perf_counter()
    sp = SERVE_PIPE
    cfg = serve_config(torch, 8, torch.bfloat16)
    sd = random_model(torch, cfg, dev, seed + 1).state_dict()
    dcfg = spec_draft_config(torch, torch.bfloat16)
    drafts = {"bench_draft": (dcfg, random_model(torch, dcfg, dev,
                                                 seed + 22).state_dict()),
              "self": (cfg, sd)}
    rng = np.random.default_rng(seed + 31)
    v = cfg.vocab_size
    reqs = [Request(rng.integers(0, v, sp["prompt"]).astype(np.int32),
                    sp["new"], rid=f"d{i}") for i in range(sp["slots"])]
    warm = [Request(rng.integers(0, v, sp["prompt"]).astype(np.int32), 8)]
    arms, plain = {}, None
    for name in ("plain", *drafts):
        kw = {}
        if name != "plain":
            dc, dp = drafts[name]
            kw = dict(decode_mode="speculative", draft_cfg=dc,
                      draft_params=dp, num_draft=4)
        loop = ServeLoop(cfg, sd, num_slots=sp["slots"],
                         steps_per_sync=sp["steps"], prefill_chunk=512,
                         pipeline_depth=1, device=dev, **kw)
        loop.run(warm)
        loop.stats = ServeStats()
        torch.cuda.synchronize()
        reads = loop.spec_host_reads
        reset_launches()
        t0 = time.perf_counter()
        comps = loop.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        st = loop.stats
        reads = loop.spec_host_reads - reads
        toks = {c.rid: c.tokens for c in comps}
        check(all(c.reason == "length" and c.tokens.shape == (sp["new"],)
                  for c in comps), f"spec_serve: {name}: bad completions")
        arm = {"wall_s": wall, "decode_s": st.decode_seconds,
               "decode_tokens": st.decode_tokens,
               "decode_tokens_per_s": st.decode_tokens / st.decode_seconds,
               "segments": st.segments,
               "launches": {k: launches[k] for k in ("K1", "K2", "K5")}}
        if name == "plain":
            plain = toks
            arm.update({"ticks": st.ticks,
                        "ms_per_tick": st.decode_seconds / st.ticks * 1e3})
        else:
            expect = spec_expected(st, "dense", cfg, drafts[name][0])
            check(launches["K2"] == expect["K2"] and launches["K1"] > 0
                  and launches["K5"] == 0,
                  f"spec_serve: {name} launches {launches}, expected "
                  f"{expect}")
            # one host read a round, and the one that ends each segment
            check(reads == st.spec_rounds + st.segments,
                  f"spec_serve: {name}: {reads} host reads for "
                  f"{st.spec_rounds} rounds in {st.segments} segments")
            same = sum(int((toks[r] == plain[r]).sum()) for r in plain)
            arm.update({
                "rounds": st.spec_rounds, "host_reads": reads,
                "ms_per_round": st.decode_seconds / st.spec_rounds * 1e3,
                "tokens_per_round": st.decode_tokens / st.spec_rounds,
                "acceptance": st.spec_accepted / max(
                    st.spec_row_rounds * 4, 1),
                "draft_steps": st.spec_draft_steps,
                "agreement_with_plain": same / (len(plain) * sp["new"])})
        arms[name] = arm
        del loop
        torch.cuda.empty_cache()
    emit({"phase": "spec_serve", "mix": sp, "num_draft": 4, **arms,
          "seconds": time.perf_counter() - t_start})
    return {k: sum(a["launches"][k] for a in arms.values())
            for k in ("K1", "K2", "K5")}


def _timed_method(torch, loop, name: str, samples: list) -> None:
    """Wrap ``loop.<name>`` to record its device-synchronized seconds."""
    orig = getattr(loop, name)

    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        return out

    setattr(loop, name, wrapped)


def _payload_bytes(payload) -> int:
    return sum(int(t.numel() * t.element_size()) if hasattr(t, "numel")
               else int(t.nbytes)
               for layer in payload["layers"] for t in layer.values())


def phase_serve_roles(torch, dev, seed):
    """The prefill/decode roles and live migration on the bf16 serve model
    with serve_paged's mix (SERVE_ROLES: block 128, a 72-block pool, 4
    slots, segments of 32, 256 new tokens, the port's default depth 2):
    (a) a prefill-role loop's handoffs adopted by a decode-role loop give
    the unified loop's tokens, every handoff adopted (no fallback), both
    pools drained; (b) one payload with a corrupted hash chain falls back
    to a prefill, exactly; (c) preempt="migrate" with every lane busy and
    a priority-1 arrival: every completion equal to the uninterrupted
    run's, preempted >= 1, resumed == preempted, the pool drained; (d) an
    evacuation in service mode adopted by a second loop, exactly.  The
    handoff's bytes, its export and adoption ms (device-synchronized) and
    the launches."""
    import numpy as np

    from tpudist_torch.models.kv_pages import blocks_for
    from tpudist_torch.models.serving import Request, ServeLoop

    t_start = time.perf_counter()
    R = SERVE_ROLES
    cfg = serve_config(torch, 8, torch.bfloat16)
    sd = random_model(torch, cfg, dev, seed + 7).state_dict()
    rng = np.random.default_rng(seed + 7)
    v = cfg.vocab_size
    reqs = [Request(rng.integers(0, v, n).astype(np.int32), R["new"], rid=i)
            for i, n in enumerate(R["lens"])]
    kw = dict(num_slots=R["slots"], steps_per_sync=R["steps"],
              prefill_chunk=512, cache_layout="paged",
              kv_block_size=R["block"],
              kv_num_blocks=R["slots"] * blocks_for(
                  max(R["lens"]) + R["new"], R["block"]), device=dev)

    def drained(loop, what):
        loop.pool.check()
        loop.flush_prefix_cache()
        check(loop.pool.free_blocks == loop.pool.num_blocks,
              f"serve_roles: {what}: pool not drained")

    def tokens(comps):
        return {c.rid: tuple(int(t) for t in c.tokens) for c in comps}

    launches = {}
    reset_launches()
    uni = ServeLoop(cfg, sd, **kw)
    want = tokens(uni.run(reqs))
    launches["unified"] = read_launches()
    drained(uni, "unified")
    del uni
    # (a) the split
    reset_launches()
    pre = ServeLoop(cfg, sd, role="prefill", **kw)
    export_s = []
    _timed_method(torch, pre, "_build_handoff", export_s)
    handoffs = pre.run(reqs)
    launches["prefill_role"] = read_launches()
    check(len(handoffs) == len(reqs)
          and all(c.reason == "handoff" and c.handoff is not None
                  for c in handoffs), "serve_roles: missing handoffs")
    drained(pre, "prefill role")
    del pre
    payloads = {c.rid: c.handoff for c in handoffs}
    nbytes = [_payload_bytes(p) for p in payloads.values()]
    reset_launches()
    dec = ServeLoop(cfg, sd, role="decode", **kw)
    adopt_s = []
    _timed_method(torch, dec, "_admit_adopt", adopt_s)
    got = tokens(dec.run([Request(r.prompt, r.max_new_tokens, rid=r.rid,
                                  kv_handoff=payloads[r.rid])
                          for r in reqs]))
    launches["decode_role"] = read_launches()
    st = dec.stats
    check(got == want, "serve_roles: the role split differs from the "
          "unified loop")
    check(st.adoptions == len(reqs) and st.handoff_fallbacks == 0,
          f"serve_roles: {st.adoptions} adoptions, {st.handoff_fallbacks} "
          "fallbacks")
    check(launches["decode_role"]["K5"] > 0
          and launches["prefill_role"]["K5"] == 0
          and launches["prefill_role"]["K1"] > 0,
          f"serve_roles: role launches {launches}")
    drained(dec, "decode role")
    del dec
    # (b) one corrupted chain falls back to a prefill
    bad = dict(payloads[0])
    bad["chain"] = [1, 2, 3]
    dec = ServeLoop(cfg, sd, role="decode", **kw)
    [c] = dec.run([Request(reqs[0].prompt, R["new"], rid=0,
                           kv_handoff=bad)])
    check(tuple(int(t) for t in c.tokens) == want[0]
          and dec.stats.handoff_fallbacks == 1
          and dec.stats.adoptions == 0,
          "serve_roles: the corrupted chain did not fall back exactly")
    drained(dec, "fallback")
    del dec
    # (c) priority preemption with every lane busy
    vip_len, vip_new = R["vip"]
    vip = Request(rng.integers(0, v, vip_len).astype(np.int32), vip_new,
                  rid="vip", priority=1)
    solo = ServeLoop(cfg, sd, **kw)
    want_vip = tokens(solo.run([vip]))["vip"]
    del solo
    loop = ServeLoop(cfg, sd, preempt="migrate", **kw)
    polls, done = [0], []

    def source():
        polls[0] += 1
        if polls[0] == 1:
            return reqs
        if polls[0] == R["vip_at"]:
            return [vip]
        return None if len(done) == len(reqs) + 1 else []

    reset_launches()
    t0 = time.perf_counter()
    got = tokens(loop.run(source=source, sink=done.append, idle_wait_s=0.0))
    torch.cuda.synchronize()
    preempt_wall = time.perf_counter() - t0
    launches["preempt"] = read_launches()
    st = loop.stats
    check(got == {**want, "vip": want_vip},
          "serve_roles: a preempted run's completion differs")
    check(st.preempted >= 1 and st.resumed == st.preempted
          and st.handoff_fallbacks == 0,
          f"serve_roles: preempted {st.preempted}, resumed {st.resumed}, "
          f"fallbacks {st.handoff_fallbacks}")
    drained(loop, "preempt")
    preempt = {"preempted": st.preempted, "resumed": st.resumed,
               "adoptions": st.adoptions, "wall_s": preempt_wall,
               "finish_order": [c.rid for c in done]}
    del loop
    # (d) an evacuation, adopted by a peer
    loop = ServeLoop(cfg, sd, preempt="migrate", **kw)
    polls[0] = 0

    def evac_source():
        polls[0] += 1
        if polls[0] == 1:
            return reqs[:3]
        if polls[0] == R["evacuate_at"]:
            loop.request_evacuate()
        return None if polls[0] > R["evacuate_at"] else []

    out = loop.run(source=evac_source, sink=lambda c: None, idle_wait_s=0.0)
    mig = {c.rid: c for c in out if c.reason == "migrate"}
    moved = [rid for rid, c in mig.items() if c.handoff is not None]
    check(sorted(mig) == [0, 1, 2] and moved,
          f"serve_roles: evacuation gave {[(c.rid, c.reason) for c in out]}")
    drained(loop, "evacuation source")
    del loop
    peer = ServeLoop(cfg, sd, preempt="migrate", **kw)
    got = tokens(peer.run([Request(reqs[rid].prompt, R["new"], rid=rid,
                                   kv_handoff=c.handoff)
                           for rid, c in mig.items()]))
    check(got == {rid: want[rid] for rid in mig}
          and peer.stats.adoptions == len(moved)
          and peer.stats.handoff_fallbacks == 0,
          "serve_roles: the evacuated requests differ after adoption")
    drained(peer, "evacuation peer")
    generated = {rid: len(mig[rid].handoff["generated"]) for rid in moved}
    del peer
    torch.cuda.empty_cache()
    emit({"phase": "serve_roles", "exact": True, "requests": len(reqs),
          "handoff_bytes": nbytes,
          "handoff_export_ms": [s * 1e3 for s in export_s],
          "adopt_ms": [s * 1e3 for s in adopt_s],
          "preempt": preempt,
          "evacuation": {"migrated": len(mig), "with_pages": len(moved),
                         "generated_at_export": generated},
          "launches": launches, "seconds": time.perf_counter() - t_start})
    return {k: sum(run[k] for run in launches.values())
            for k in ("K1", "K2", "K5")}


def phase_paged_parity(torch, dev, seed):
    """The paged ServeLoop (block 16, K5) against the dense one (K2): a
    full-width 2-layer f32 model, TF32 off, on the parity phase's
    requests; token-identical, the pool checked and drained, and the
    paged run launches K1 and K5 but not K2."""
    import numpy as np

    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.models.transformer import TransformerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=32000, num_layers=2, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.float32)
    sd = random_model(torch, cfg, dev, seed).state_dict()
    rng = np.random.default_rng(seed)
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    24, rid=i) for i, n in enumerate([1100, 37, 600, 513])]
    kw = dict(num_slots=2, steps_per_sync=8, prefill_chunk=512,
              pipeline_depth=1, device=dev)
    reset_launches()
    dense = _sig(ServeLoop(cfg, sd, **kw).run(reqs))
    dense_launches = read_launches()
    reset_launches()
    loop = ServeLoop(cfg, sd, cache_layout="paged", kv_block_size=16, **kw)
    paged = _sig(loop.run(reqs))
    launches = read_launches()
    loop.pool.check()
    loop.flush_prefix_cache()
    drained = loop.pool.free_blocks == loop.pool.num_blocks
    check(paged == dense, "paged_parity: paged and dense completions differ")
    check(drained, "paged_parity: the pool did not drain")
    check(launches["K1"] > 0 and launches["K5"] > 0 and launches["K2"] == 0,
          f"paged_parity: paged run launches {launches}")
    check(dense_launches["K2"] > 0 and dense_launches["K5"] == 0,
          f"paged_parity: dense run launches {dense_launches}")
    emit({"phase": "paged_parity", "requests": len(reqs), "exact": True,
          "pool_drained": drained, "launches_paged": launches,
          "launches_dense": dense_launches})


def phase_serve_paged(torch, dev, seed):
    """bench.py's kv_paging cell at its TPU configuration: the full-width
    8-layer bf16 model (max_seq_len 8192), 4 slots, prefill chunk 512,
    steps_per_sync 256, block 128 and a pool of 4 * blocks_for(2048 + 256,
    128) = 72 blocks; prompts [1024, 2048, 512, 1024, 512, 2048] with 256
    new tokens each, served dense and paged.  Counts are reset just
    before each measured run and read just after."""
    import numpy as np

    from tpudist_torch.models.kv_pages import blocks_for
    from tpudist_torch.models.serving import Request, ServeLoop, ServeStats
    from tpudist_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    sd = random_model(torch, cfg, dev, seed + 7).state_dict()
    rng = np.random.default_rng(seed + 7)
    lens, gen, slots, block = [1024, 2048, 512, 1024, 512, 2048], 256, 4, 128
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    gen, rid=i) for i, n in enumerate(lens)]
    blocks = slots * blocks_for(max(lens) + gen, block)
    arms = {}
    for layout in ("dense", "paged"):
        kw = ({"cache_layout": "paged", "kv_block_size": block,
               "kv_num_blocks": blocks} if layout == "paged" else {})
        loop = ServeLoop(cfg, sd, num_slots=slots, steps_per_sync=gen,
                         prefill_chunk=512, pipeline_depth=1, device=dev,
                         **kw)
        # warm-up outside the measured run (cuBLAS handles, allocator)
        loop.run([Request(rng.integers(0, cfg.vocab_size, 600).astype(
            np.int32), 2)])
        loop.stats = ServeStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        comps = loop.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        st = loop.stats
        for c in comps:
            check(c.tokens.shape == (gen,) and c.reason == "length",
                  f"serve_paged: bad {layout} completion {c.rid}")
        arm = {"sig": _sig(comps), "launches": launches, "wall_s": wall,
               "kv_bytes": kv_bytes(loop),
               "prefill_tokens_per_s": st.prompt_tokens / st.prefill_seconds,
               "decode_tokens_per_s": st.decode_tokens / st.decode_seconds,
               "decode_ms_per_tick": st.decode_seconds / st.ticks * 1e3,
               "ticks": st.ticks, "segments": st.segments,
               "max_memory_allocated_bytes":
                   torch.cuda.max_memory_allocated(dev)}
        if loop.pool is not None:
            loop.pool.check()
            arm["pool_drained"] = loop.pool.free_blocks == loop.pool.num_blocks
            arm["num_blocks"] = loop.pool.num_blocks
        arms[layout] = arm
        del loop
        torch.cuda.empty_cache()
    dense, paged = arms["dense"], arms["paged"]
    exact = dense["sig"] == paged["sig"]
    check(exact, "serve_paged: paged and dense completions differ")
    check(paged["pool_drained"], "serve_paged: the pool did not drain")
    check(paged["launches"]["K5"] > 0 and paged["launches"]["K1"] > 0
          and paged["launches"]["K2"] == 0,
          f"serve_paged: paged run launches {paged['launches']}")
    check(dense["launches"]["K2"] > 0 and dense["launches"]["K5"] == 0,
          f"serve_paged: dense run launches {dense['launches']}")
    for arm in arms.values():
        del arm["sig"]
    emit({"phase": "serve_paged", "exact": exact,
          "kv_bytes_ratio": paged["kv_bytes"] / dense["kv_bytes"],
          "dense": dense, "paged": paged})
    return paged["launches"]


def phase_serve_prefix(torch, dev, seed):
    """bench.py's serve_prefix_batching cell (row 1) at its TPU
    configuration: the full-width 8-layer bf16 model at max_seq_len 2048,
    4 slots, prefill chunk 256, block 32, steps_per_sync 8; 12 requests of
    a shared 1024-token prefix plus 4-12 suffix tokens, 32 new tokens
    each, and one more whose prompt is the bare prefix (which earlier
    prompts cached whole: a full-prompt hit, so a copy-on-write split).
    Each arm runs once to warm up (and fill the prefix cache), then once
    timed: sharing off (one-shot admission) and on (chunked)."""
    import numpy as np

    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=2048,
                            compute_dtype=torch.bfloat16)
    sd = random_model(torch, cfg, dev, seed + 8).state_dict()
    rng = np.random.default_rng(seed + 8)
    prefix = rng.integers(0, cfg.vocab_size, 1024).astype(np.int32)
    reqs = [Request(np.concatenate(
                [prefix, rng.integers(0, cfg.vocab_size,
                                      4 + i % 9).astype(np.int32)]),
                    32, rid=i) for i in range(12)]
    reqs.append(Request(prefix.copy(), 32, rid=12))
    arms = {}
    for name, sharing in (("off", False), ("on", True)):
        loop = ServeLoop(cfg, sd, num_slots=4, steps_per_sync=8,
                         prefill_chunk=256, cache_layout="paged",
                         kv_block_size=32, chunked_prefill=sharing,
                         prefix_sharing=sharing, pipeline_depth=1,
                         device=dev)
        loop.run(reqs)
        for k in loop.prefix_stats:
            loop.prefix_stats[k] = 0
        cow0 = loop.pool.cow_splits
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = loop.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = dict(loop.prefix_stats)
        arm = {"sig": {c.rid: (tuple(int(t) for t in c.tokens), c.reason)
                       for c in comps},
               "wall_s": wall, "launches": read_launches(),
               "prefix_stats": st,
               "hit_rate": st["hits"] / max(st["requests"], 1),
               "prefill_suffix_frac": (st["prefill_tokens"]
                                       / max(st["prompt_tokens"], 1)),
               "cow_splits": loop.pool.cow_splits - cow0}
        loop.pool.check()
        loop.flush_prefix_cache()
        arm["pool_drained"] = loop.pool.free_blocks == loop.pool.num_blocks
        arms[name] = arm
        del loop
    off, on = arms["off"], arms["on"]
    exact = off["sig"] == on["sig"]
    check(exact, "serve_prefix: completions differ with prefix sharing on")
    check(on["cow_splits"] >= 1, f"serve_prefix: no copy-on-write split "
          f"({on['cow_splits']})")
    check(on["prefix_stats"]["hits"] > 0 and off["prefix_stats"]["hits"] == 0,
          f"serve_prefix: hits on {on['prefix_stats']} off "
          f"{off['prefix_stats']}")
    check(on["pool_drained"] and off["pool_drained"],
          "serve_prefix: a pool did not drain after flush_prefix_cache()")
    check(on["launches"]["K5"] > 0 and on["launches"]["K2"] == 0,
          f"serve_prefix: launches {on['launches']}")
    for arm in arms.values():
        del arm["sig"]
    emit({"phase": "serve_prefix", "requests": len(reqs), "exact": exact,
          "speedup": off["wall_s"] / on["wall_s"], "off": off, "on": on})


def phase_sharded_generate(torch, dev, seed):
    """The sharded rollouts at the serve model's full width (vocab 32000,
    8 heads over 2 KV heads, embed 512, 8k context; SHARDED_GEN's depth,
    batch and lengths), f32, over one-rank NCCL groups of a model 1 x seq
    1 mesh: tp_generate, sp_generate and tp_sp_generate with
    decode_attention="flash", sample_generate at top_k=1, and
    tp_speculative_generate with bench.py's draft must give
    greedy_generate's tokens on the card; beam search at width 4 through
    K1/K2 must give the plain versions' beams and scores.  Each run's
    launches are counted (K1 = prefill chunks x layers and K2 = decode
    steps x layers, exactly), with its ms a token on the host clock (the
    second of two runs)."""
    import numpy as np

    from tpudist_torch.models.beam import beam_search_generate
    from tpudist_torch.models.generate import (
        greedy_generate,
        sample_generate,
        sp_generate,
        tp_generate,
        tp_sp_generate,
    )
    from tpudist_torch.models.speculative import tp_speculative_generate
    from tpudist_torch.runtime import make_mesh, shutdown

    G = SHARDED_GEN
    cfg = serve_config(torch, G["layers"], torch.float32)
    sd = random_model(torch, cfg, dev, seed + 19).state_dict()
    dcfg = spec_draft_config(torch, torch.float32)
    dsd = random_model(torch, dcfg, dev, seed + 20).state_dict()
    rng = np.random.default_rng(seed + 19)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (G["batch"], G["prompt"])).astype(np.int32))
    new, chunk, L = G["new"], G["chunk"], cfg.num_layers
    chunks = -(-G["prompt"] // chunk)
    want = {"K1": chunks * L, "K2": (new - 1) * L}
    runs = {}

    def timed(name, fn, expect=None):
        fn()                # warm-up: a new group's first NCCL call
        reset_launches()    # sets its communicator up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        runs[name] = {"ms_per_token": wall / new * 1e3, "wall_s": wall,
                      "launches": launches}
        if expect is not None:
            check(all(launches[k] == n for k, n in expect.items()),
                  f"sharded_generate: {name} launches {launches}, "
                  f"expected {expect}")
        return out

    greedy = timed("greedy_generate", lambda: greedy_generate(
        cfg, sd, prompt, new, prefill_chunk=chunk, device=dev), want).cpu()
    _one_rank_group(torch, dev)
    try:
        mesh = make_mesh({"model": 1, "seq": 1})
        for name, fn in (("tp_generate", tp_generate),
                         ("sp_generate", sp_generate),
                         ("tp_sp_generate", tp_sp_generate)):
            got = timed(name, lambda: fn(
                cfg, sd, prompt, new, mesh, prefill_chunk=chunk,
                decode_attention="flash", device=dev), want).cpu()
            check(torch.equal(got, greedy),
                  f"sharded_generate: {name} differs from greedy_generate")
        got = timed("sample_generate_top_k1", lambda: sample_generate(
            cfg, sd, prompt, new, torch.Generator(dev).manual_seed(seed),
            top_k=1, prefill_chunk=chunk, decode_attention="flash",
            device=dev), want).cpu()
        check(torch.equal(got, greedy), "sharded_generate: sample_generate "
              "at top_k=1 differs from greedy_generate")
        toks, st = timed("tp_speculative_generate",
                         lambda: tp_speculative_generate(
                             cfg, sd, dcfg, dsd, prompt, new, mesh,
                             num_draft=4, prefill_chunk=chunk,
                             decode_attention="flash", return_stats=True,
                             device=dev))
        runs["tp_speculative_generate"].update(st)
        check(torch.equal(toks.cpu(), greedy), "sharded_generate: "
              "tp_speculative_generate differs from greedy_generate")
        spec_l = runs["tp_speculative_generate"]["launches"]
        check(spec_l["K1"] > 0 and spec_l["K2"] > 0,
              f"sharded_generate: tp_speculative_generate launches {spec_l}")
    finally:
        shutdown()
    w = G["beam"]
    beam, scores = timed("beam_search_generate", lambda: beam_search_generate(
        cfg, sd, prompt, new, beam_size=w, prefill_chunk=chunk,
        decode_attention="flash", return_scores=True, device=dev), want)
    plain, pscores = beam_search_generate(
        cfg, sd, prompt, new, beam_size=w, prefill_chunk=chunk,
        decode_attention="dense", return_scores=True, device=dev)
    check(torch.equal(beam.cpu(), plain.cpu()),
          "sharded_generate: beam search through K1/K2 differs from the "
          "plain versions' beams")
    score_err = (scores - pscores).abs().max().item()
    check(score_err <= BEAM_SCORE_ATOL,
          f"sharded_generate: beam scores {score_err} from the plain ones")
    check(torch.equal(beam[:, 0, :G["prompt"]].cpu(), prompt.to(
        torch.int32)), "sharded_generate: beams lost the prompt")
    totals = {k: sum(r["launches"][k] for r in runs.values())
              for k in runs["greedy_generate"]["launches"]}
    emit({"phase": "sharded_generate", "exact": True, "config": G,
          "beam_score_err": score_err, "runs": runs, "launches": totals})
    torch.cuda.empty_cache()
    return totals


class _tier_env:
    """``TPUDIST_KV_HOST_TIER_BYTES`` set to ``nbytes`` while a ServeLoop
    is built (it reads the budget once)."""

    def __init__(self, nbytes: int) -> None:
        self.nbytes = nbytes

    def __enter__(self):
        import os

        self.old = os.environ.get("TPUDIST_KV_HOST_TIER_BYTES")
        os.environ["TPUDIST_KV_HOST_TIER_BYTES"] = str(int(self.nbytes))

    def __exit__(self, *exc):
        import os

        if self.old is None:
            os.environ.pop("TPUDIST_KV_HOST_TIER_BYTES", None)
        else:
            os.environ["TPUDIST_KV_HOST_TIER_BYTES"] = self.old
        return False


def phase_kv_tier(torch, dev, seed):
    """The host-RAM KV tier on serve_prefix's model (8 layers, bf16, 2k
    context, block 32) and its 1,024-token shared prefix, with a pool
    (KV_TIER["blocks"]) too small to keep the prefix cached: each round
    serves one prefix request (1,024 + 8 tokens, 32 new), then short
    prompts with long budgets whose reservations evict part of the cached
    prefix.  Once with the tier off (the evicted blocks re-prefill) and
    once on (they spill to pinned host memory and re-admit): completions
    identical; re-admits, spilled and re-admitted bytes, re-admit ms and
    the prefill tokens saved; pool and tier drained.  Then serve_roles'
    preemption (a priority-1 arrival with every lane busy) with the tier
    off and on: the parked lane's pages spill block by block into the
    tier and resume exactly."""
    import numpy as np

    from tpudist_torch.models.kv_pages import blocks_for
    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.models.transformer import TransformerConfig

    T = KV_TIER
    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=2048,
                            compute_dtype=torch.bfloat16)
    sd = random_model(torch, cfg, dev, seed + 8).state_dict()
    rng = np.random.default_rng(seed + 21)
    prefix = rng.integers(0, cfg.vocab_size, 1024).astype(np.int32)
    script = []
    for r in range(T["rounds"]):
        script.append([Request(np.concatenate([prefix, rng.integers(
            0, cfg.vocab_size, 8).astype(np.int32)]), 32, rid=f"p{r}")])
        script.append([Request(rng.integers(0, cfg.vocab_size, 16).astype(
            np.int32), T["filler_new"], rid=f"f{r}.{j}") for j in range(2)])
    arms = {}
    for name, budget in (("off", 0), ("on", 256 << 20)):
        with _tier_env(budget):
            loop = ServeLoop(cfg, sd, num_slots=2, steps_per_sync=8,
                             prefill_chunk=256, cache_layout="paged",
                             kv_block_size=32, kv_num_blocks=T["blocks"],
                             pipeline_depth=1, device=dev)
        check((loop._tier is not None) == (budget > 0),
              f"kv_tier: tier {loop._tier} with budget {budget}")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = [c for reqs in script for c in loop.run(reqs)]
        torch.cuda.synchronize()
        arm = {"sig": {c.rid: (tuple(int(t) for t in c.tokens), c.reason)
                       for c in comps},
               "wall_s": time.perf_counter() - t0,
               "launches": read_launches(),
               "prefix_stats": dict(loop.prefix_stats)}
        tier = loop._tier
        if tier is not None:
            arm.update(spilled_blocks=tier.spills,
                       spilled_bytes=tier.spilled_bytes,
                       readmitted_blocks=tier.readmits,
                       readmitted_bytes=tier.readmitted_bytes,
                       evictions=tier.evictions,
                       readmit_ms=loop.tier_stats["readmit_seconds"] * 1e3,
                       readmit_ms_per_block=(
                           loop.tier_stats["readmit_seconds"] * 1e3
                           / max(tier.readmits, 1)))
        loop.pool.check()
        loop.flush_prefix_cache()
        arm["drained"] = (loop.pool.free_blocks == loop.pool.num_blocks
                          and loop.tier_drained() in (True, None))
        arms[name] = arm
        del loop
    off, on = arms["off"], arms["on"]
    check(off["sig"] == on["sig"],
          "kv_tier: completions differ with the tier on")
    saved = (off["prefix_stats"]["prefill_tokens"]
             - on["prefix_stats"]["prefill_tokens"])
    check(on["readmitted_blocks"] > 0 and on["spilled_bytes"] > 0
          and saved > 0, f"kv_tier: nothing re-admitted ({on}, saved "
          f"{saved} prefill tokens)")
    check(off["drained"] and on["drained"],
          "kv_tier: a pool or the tier did not drain")
    check(on["launches"]["K5"] > 0 and on["launches"]["K1"] > 0,
          f"kv_tier: launches {on['launches']}")
    for arm in arms.values():
        del arm["sig"]

    # serve_roles' preemption with the tier off and on
    R = SERVE_ROLES
    rcfg = serve_config(torch, 8, torch.bfloat16)
    rsd = random_model(torch, rcfg, dev, seed + 7).state_dict()
    rrng = np.random.default_rng(seed + 7)
    v = rcfg.vocab_size
    reqs = [Request(rrng.integers(0, v, n).astype(np.int32), R["new"],
                    rid=i) for i, n in enumerate(R["lens"])]
    vip = Request(rrng.integers(0, v, R["vip"][0]).astype(np.int32),
                  R["vip"][1], rid="vip", priority=1)
    kw = dict(num_slots=R["slots"], steps_per_sync=R["steps"],
              prefill_chunk=512, cache_layout="paged",
              kv_block_size=R["block"], preempt="migrate",
              kv_num_blocks=R["slots"] * blocks_for(
                  max(R["lens"]) + R["new"], R["block"]), device=dev)
    park = {}
    for name, budget in (("off", 0), ("on", 256 << 20)):
        with _tier_env(budget):
            loop = ServeLoop(rcfg, rsd, **kw)
        polls, done = [0], []

        def source():
            polls[0] += 1
            if polls[0] == 1:
                return reqs
            if polls[0] == R["vip_at"]:
                return [vip]
            return None if len(done) == len(reqs) + 1 else []

        spills0 = loop._tier.spills if loop._tier is not None else 0
        got = {c.rid: tuple(int(t) for t in c.tokens)
               for c in loop.run(source=source, sink=done.append,
                                 idle_wait_s=0.0)}
        st = loop.stats
        park[name] = {"tokens": got, "preempted": st.preempted,
                      "resumed": st.resumed, "adoptions": st.adoptions,
                      "fallbacks": st.handoff_fallbacks}
        if loop._tier is not None:
            park[name]["tier_blocks_parked"] = loop._tier.spills - spills0
            park[name]["tier_bytes_spilled"] = loop._tier.spilled_bytes
        loop.pool.check()
        loop.flush_prefix_cache()
        check(loop.pool.free_blocks == loop.pool.num_blocks,
              f"kv_tier: preemption ({name}): pool not drained")
        del loop
    check(park["on"]["tokens"] == park["off"]["tokens"],
          "kv_tier: a preempted run through the tier differs")
    for arm in park.values():
        check(arm["preempted"] >= 1 and arm["resumed"] == arm["preempted"]
              and arm["fallbacks"] == 0,
              f"kv_tier: preemption {arm}")
        del arm["tokens"]
    check(park["on"]["tier_blocks_parked"] > 0,
          f"kv_tier: the parked lane did not go through the tier "
          f"({park['on']})")
    torch.cuda.empty_cache()
    emit({"phase": "kv_tier", "exact": True, "config": T,
          "prefill_tokens_saved": saved, "off": off, "on": on,
          "preempt": park})
    return on["launches"]


def fleet_replica_main(argv) -> int:
    """One fleet replica for the ``fleet`` phase: ``--launches-out PATH``
    then the router's own replica arguments.  Runs
    ``tpudist_torch.runtime.router.main()`` as ``python -m`` would, and
    once it returns (the fleet's stop key) writes this process's kernel
    launch counts and ``serve/*`` counters to PATH.  A SIGKILLed replica
    writes nothing."""
    from tpudist_torch import obs
    from tpudist_torch.runtime import router

    i = argv.index("--launches-out")
    out = argv[i + 1]
    reset_launches()
    sys.argv = ["tpudist_torch.runtime.router", *argv[:i], *argv[i + 2:]]
    router.main()
    counters = obs.snapshot()["counters"]
    with open(out, "w") as fh:
        json.dump({"launches": read_launches(),
                   "counters": {k: v["value"] for k, v in counters.items()
                                if k.startswith("serve/")}}, fh)
    return 0


class _DeathClock:
    """The router's store client, timestamping the death sweep: the first
    delete of ``{ns}/replica/{rid}`` is the router's death decision."""

    def __init__(self, client, ns: str):
        self._client, self._prefix = client, f"{ns}/replica/"
        self.swept: dict[str, float] = {}

    def __getattr__(self, name):
        return getattr(self._client, name)

    def delete(self, key: str) -> None:
        if key.startswith(self._prefix):
            self.swept.setdefault(key[len(self._prefix):], time.time())
        self._client.delete(key)


def _fleet_model_args(dev, seed: int) -> list:
    """The router's replica flags for FLEET's model, slots and ticks."""
    W = FLEET
    return ["--vocab", str(W["vocab"]), "--layers", str(W["layers"]),
            "--heads", str(W["heads"]), "--kv-heads", str(W["kv_heads"]),
            "--embed", str(W["embed"]), "--seq-len", str(W["seq_len"]),
            "--seed", str(seed), "--slots", str(W["slots"]),
            "--prefill-chunk", str(W["chunk"]),
            "--steps-per-sync", str(W["steps"]), "--ttl", str(W["ttl"]),
            "--device", str(dev)]


def _smoke_replica(addr: str, ns: str, i: int, args: list, out: str,
                   env: dict):
    """Replica ``r{i}`` (rank i) in chip_smoke's replica mode
    (:func:`fleet_replica_main`, dumping its launches to ``out``)."""
    p = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; "
         "sys.exit(chip_smoke.fleet_replica_main(sys.argv[1:]))",
         "--launches-out", out, "--coord", addr, "--replica-id", f"r{i}",
         "--rank", str(i), "--namespace", ns, *args],
        cwd=_repo_root(), env=env)
    p.replica_index = i
    return p


def _fleet_run(dev, seed: int, tmp: str, ns: str, roles: list,
               layout: list, reqs, kill: dict | None = None) -> dict:
    """Start one replica a role (chip_smoke's replica mode, cuda:0), route
    ``reqs`` through the port's Router, stop the fleet and read each
    surviving replica's dump.  ``kill`` = {index: segments} arms
    KILL_AFTER_SEGMENTS there; the parent watches that process to time
    its exit."""
    import os
    import threading

    from tpudist_torch import obs
    from tpudist_torch.runtime import router as rt
    from tpudist_torch.runtime.coord import CoordClient, CoordServer

    W = FLEET
    server = CoordServer(0)
    addr = f"127.0.0.1:{server.port}"
    client = CoordClient("127.0.0.1", server.port)
    env = dict(os.environ, PYTHONPATH=_repo_root())
    model = [*_fleet_model_args(dev, seed), *layout]
    procs, outs = [], []
    for i, role in enumerate(roles):
        out = f"{tmp}/{ns}_r{i}.json"
        outs.append(out)
        extra = ({"TPUDIST_FAULT_KILL_AFTER_SEGMENTS": str(kill[i])}
                 if kill and i in kill else {})
        procs.append(_smoke_replica(addr, ns, i, [*model, "--role", role],
                                    out, {**env, **extra}))
    exited: dict[int, float] = {}

    def watch(i: int, p) -> None:
        p.wait()
        exited[i] = time.time()

    watchers = [threading.Thread(target=watch, args=(i, procs[i]),
                                 daemon=True) for i in (kill or {})]
    for t in watchers:
        t.start()
    before = {k: v["value"] for k, v in obs.snapshot()["counters"].items()}
    timed = _DeathClock(client, ns)
    sent: dict[str, float] = {}
    lat: list[float] = []
    try:
        t0 = time.time()
        rt.wait_live(client, len(roles), namespace=ns, timeout_s=180.0,
                     procs=procs)
        live_s = time.time() - t0
        router = rt.Router(timed, namespace=ns, lost_after_s=10.0)

        def done(key, comp) -> None:
            lat.append(time.time() - sent[str(comp.rid)])

        t0 = time.time()
        sent.update({str(r.rid): t0 for r in reqs})
        comps = router.run(reqs, timeout_s=W["timeout_s"],
                           on_complete=done)
        wall = time.time() - t0
        kv_left = client.keys(f"{ns}/kv/")
    finally:
        codes = rt.stop_fleet(client, procs, namespace=ns, timeout_s=60.0)
    after = obs.snapshot()["counters"]
    moved = {k: v["value"] - before.get(k, 0.0) for k, v in after.items()
             if k.startswith("router/") and v["value"] - before.get(k, 0.0)}
    dumps = {}
    for i, out in enumerate(outs):
        if os.path.exists(out):
            with open(out) as fh:
                dumps[f"r{i}"] = json.load(fh)
    hist = obs.values_to_hist(lat, growth=2 ** 0.25)
    detect = {f"r{i}": timed.swept.get(f"r{i}", float("nan")) - t
              for i, t in exited.items()}
    del server
    return {"comps": comps, "codes": codes, "dumps": dumps,
            "moved": moved, "wall_s": wall, "live_s": live_s,
            "kv_left": kv_left, "detect_s": detect,
            "latency_p50_s": obs.hist_quantile(hist, 0.5),
            "latency_p99_s": obs.hist_quantile(hist, 0.99),
            "latency_max_s": max(lat) if lat else float("nan")}


def _fleet_prompts(seed: int) -> list:
    """FLEET's seeded prompts of min_prompt..max_prompt tokens."""
    import numpy as np

    W = FLEET
    rng = np.random.default_rng(seed)
    lens = rng.integers(W["min_prompt"], W["max_prompt"] + 1, W["requests"])
    return [rng.integers(0, W["vocab"], n).astype(np.int32) for n in lens]


def phase_fleet(torch, dev, seed):
    """The serve fleet on the card: the port's CoordServer and Router over
    three replica processes on cuda:0 at the serve width (FLEET: 8 layers,
    f32, 4 slots, chunk 512), 12 seeded prompts of 512-4,096 tokens with
    64 new each.  (a) Unified dense: replica r1 SIGKILLs itself after
    FLEET["kill_after"] segments; every request completes exactly once,
    token-identical to one port ServeLoop on the card with the same
    weights, one death, at least one redispatch.  (b) Disaggregated: one
    prefill and two decode replicas, paged at block 128, KV handed off
    over CoordKVTransport; every request adopted (no fallback), tokens
    identical to the paged loop, the payload refs swept.  Each surviving
    replica's kernel launches come from the replica itself: K1 > 0 where
    it prefills, K2 > 0 on dense and K5 > 0 on decode replicas, 0 of the
    other.  Wall s, requests/s, the detection s from r1's exit to the
    router's death sweep, p50/p99 of the router-side request latency,
    the handoff bytes."""
    import tempfile

    import numpy as np

    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.runtime.router import build_tiny_lm

    W = FLEET
    cfg, sd = build_tiny_lm(W["vocab"], W["layers"], W["heads"],
                            W["kv_heads"], W["embed"], W["seq_len"], seed)
    prompts = _fleet_prompts(seed)
    lens = np.array([len(p) for p in prompts])

    def reqs():
        return [Request(p, W["new"], rid=f"f{i}")
                for i, p in enumerate(prompts)]

    paged = ["--cache-layout", "paged", "--kv-block-size", str(W["block"])]
    want = {}
    for name, kw in (("dense", {}),
                     ("paged", {"cache_layout": "paged",
                                "kv_block_size": W["block"]})):
        loop = ServeLoop(cfg, sd, num_slots=W["slots"],
                         steps_per_sync=W["steps"],
                         prefill_chunk=W["chunk"], device=dev, **kw)
        want[name] = {c.rid: c.tokens.tolist() for c in loop.run(reqs())}
        del loop
    torch.cuda.empty_cache()
    launches = {"K1": 0, "K2": 0, "K5": 0}
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case, roles, layout, kill in (
                ("unified", ["both"] * 3, ["--cache-layout", "dense"],
                 {1: W["kill_after"]}),
                ("disagg", ["prefill", "decode", "decode"], paged, None)):
            r = _fleet_run(dev, seed, tmp, f"fleet_{case}", roles, layout,
                           reqs(), kill)
            comps = r["comps"]
            rids = sorted(str(c.rid) for c in comps)
            check(rids == sorted(f"f{i}" for i in range(W["requests"])),
                  f"fleet {case}: completions {rids}")
            ref = want["dense" if case == "unified" else "paged"]
            bad = [c.rid for c in comps if c.tokens.tolist() != ref[c.rid]]
            check(not bad, f"fleet {case}: requests {bad} differ from one "
                  "ServeLoop on the card")
            row = {"wall_s": r["wall_s"],
                   "requests_per_s": W["requests"] / r["wall_s"],
                   "live_s": r["live_s"],
                   "latency_p50_s": r["latency_p50_s"],
                   "latency_p99_s": r["latency_p99_s"],
                   "latency_max_s": r["latency_max_s"],
                   "exit_codes": r["codes"], "router": r["moved"],
                   "replicas": {
                       rid: {**{k: d["launches"][k]
                                for k in ("K1", "K2", "K5")},
                             **{k.split("/")[1]: d["counters"].get(k, 0)
                                for k in ("serve/requests", "serve/tokens",
                                          "serve/segments",
                                          "serve/adoptions")}}
                       for rid, d in r["dumps"].items()}}
            if case == "unified":
                check(r["codes"][1] == -9 and r["codes"][0] == 0
                      and r["codes"][2] == 0,
                      f"fleet unified: exit codes {r['codes']}")
                check(r["moved"].get("router/replica_deaths") == 1
                      and r["moved"].get("router/redispatched", 0) >= 1,
                      f"fleet unified: router {r['moved']}")
                row["detection_s"] = r["detect_s"]["r1"]
                check(0 < row["detection_s"] < 60,
                      f"fleet unified: detection {r['detect_s']}")
            else:
                check(r["codes"] == [0, 0, 0],
                      f"fleet disagg: exit codes {r['codes']}")
                check(r["moved"].get("router/handoffs", 0)
                      >= W["requests"] and not r["kv_left"],
                      f"fleet disagg: handoffs {r['moved']}, payloads "
                      f"left {r['kv_left']}")
                pre = r["dumps"]["r0"]["counters"]
                adopted = sum(d["counters"].get("serve/adoptions", 0)
                              for k, d in r["dumps"].items() if k != "r0")
                fallbacks = sum(d["counters"].get("serve/handoff_fallbacks",
                                                  0)
                                for d in r["dumps"].values())
                check(adopted == W["requests"] and fallbacks == 0,
                      f"fleet disagg: adopted {adopted}, fallbacks "
                      f"{fallbacks}")
                row["handoffs"] = pre.get("serve/handoffs", 0)
                row["handoff_bytes"] = pre.get("serve/handoff_bytes", 0)
                check(row["handoff_bytes"] > 0,
                      "fleet disagg: no handoff bytes")
            for rid, d in r["dumps"].items():
                n = d["launches"]
                role = roles[int(rid[1:])]
                dense = case == "unified"
                want_k = {"K1": role != "decode", "K2": dense,
                          "K5": role == "decode"}
                for k, on in want_k.items():
                    check((n[k] > 0) == on,
                          f"fleet {case}: {rid} ({role}) launched {k} "
                          f"{n[k]} times")
                    launches[k] += n[k]
            check(set(r["dumps"]) == ({"r0", "r2"} if case == "unified"
                                      else {"r0", "r1", "r2"}),
                  f"fleet {case}: dumps from {sorted(r['dumps'])}")
            rows[case] = row
    emit({"phase": "fleet", "width": W, "prompt_tokens": int(lens.sum()),
          **rows, "launches": launches})
    return launches, want["paged"]


def phase_fleet_autoscale(torch, dev, seed, want_paged: dict) -> dict:
    """The autoscaled fleet on the card: the ``fleet`` phase's model and
    traffic (FLEET, paged at block 128) through one replica in
    chip_smoke's replica mode and an ``Autoscaler`` with the JAX
    example's config (1-2 replicas, a 5 ms queue-wait target, 2 breach
    polls up, 4 idle polls down, 0.25 s polls) whose injected spawner
    starts the joiner in the same mode at the next chain index.  Batch 1
    breaches and buys the joiner; once it is live batch 2 spreads over
    both; the idle tail drains one replica back out.  Batch 2's 12
    prompts are drawn from ``seed + 1``: the router places a prompt whose
    blocks a replica's prefix cache holds on that replica (content
    affinity), so batch 1's prompts again would all go back to r0.
    Replicas keep queue wait in a 25 s sliding window
    (``TPUDIST_SERVE_WAIT_WINDOW_S``): longer than batch 1's last
    admission to the joiner live and batch 2 started (~15 s on the H100),
    so batch 1's waits hold the fleet up until batch 2's arrive and no
    idle streak drains a replica before the joiner serves; the tail then
    waits the window out.  Checks: every request of both batches once
    and token-identical to the paged ServeLoop (batch 1: ``want_paged``,
    from the fleet phase; batch 2: the same loop here, before the fleet),
    >= 1 scale-up and >= 1 completed drain, one live replica at the end,
    the drained replica exiting 0 with ``pool_drained``, no replica
    death and ``ReplicaLost`` never firing in an
    ``AlertManager(default_rules())`` over a ``FleetScraper`` run
    through the phase, every replica that served launching K1 and K5 and
    no K2, the joiner among them, and a console frame from a live
    ``gather`` listing both replicas.  Prints scale-up s (first breach
    poll to joiner live, watched from a thread while batch 1 runs),
    drain s (drain mark to lease gone), wall s and requests/s per batch,
    router-side p50/p99 and each replica's K1/K5.
    Returns the launches summed over the replicas."""
    import os
    import tempfile
    import threading

    from tpudist_torch import obs
    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.obs.alerts import AlertManager, default_rules
    from tpudist_torch.obs.console import gather, render
    from tpudist_torch.obs.tsdb import TSDB, FleetScraper
    from tpudist_torch.runtime import router as rt
    from tpudist_torch.runtime.autoscaler import AutoscaleConfig, Autoscaler
    from tpudist_torch.runtime.coord import CoordClient, CoordServer
    from tpudist_torch.runtime.router import build_tiny_lm

    W = FLEET
    prompts = {"a": _fleet_prompts(seed), "b": _fleet_prompts(seed + 1)}

    def reqs(tag):
        return [Request(p, W["new"], rid=f"{tag}{i}")
                for i, p in enumerate(prompts[tag])]

    cfg, sd = build_tiny_lm(W["vocab"], W["layers"], W["heads"],
                            W["kv_heads"], W["embed"], W["seq_len"], seed)
    loop = ServeLoop(cfg, sd, num_slots=W["slots"],
                     steps_per_sync=W["steps"], prefill_chunk=W["chunk"],
                     cache_layout="paged", kv_block_size=W["block"],
                     device=dev)
    want = {"a": {f"a{i}": want_paged[f"f{i}"]
                  for i in range(W["requests"])},
            "b": {c.rid: c.tokens.tolist() for c in loop.run(reqs("b"))}}
    del loop, sd
    torch.cuda.empty_cache()
    ns = "fleet_autoscale"
    server = CoordServer(0)
    addr = f"127.0.0.1:{server.port}"
    client = CoordClient("127.0.0.1", server.port)
    env = dict(os.environ, PYTHONPATH=_repo_root(),
               TPUDIST_SERVE_WAIT_WINDOW_S="25")
    args = [*_fleet_model_args(dev, seed), "--cache-layout", "paged",
            "--kv-block-size", str(W["block"])]

    def counter(name):
        return obs.snapshot()["counters"].get(name, {}).get("value", 0.0)

    def live(c=client):   # a client per thread: the scaler's is its own
        return sorted(n[len(ns) + 1:] for n in c.live()
                      if n.startswith(f"{ns}:"))

    joined: dict[str, float] = {}
    unwatch = threading.Event()

    def watch_join() -> None:
        # the joiner can go live while batch 1 still runs (router.run
        # blocks this thread), so its live time is taken here
        c = CoordClient("127.0.0.1", server.port)
        while not unwatch.is_set():
            if len(live(c)) >= 2:
                joined["t"] = time.monotonic()
                return
            time.sleep(0.1)

    with tempfile.TemporaryDirectory() as tmp:
        outs = {}

        def spawn(i):
            outs[f"r{i}"] = f"{tmp}/{ns}_r{i}.json"
            return _smoke_replica(addr, ns, i, args, outs[f"r{i}"], env)

        rt._seed_replica_index(client, 1, namespace=ns)
        procs = [spawn(0)]
        spawn_client = CoordClient("127.0.0.1", server.port)
        scaler = Autoscaler(
            CoordClient("127.0.0.1", server.port), namespace=ns,
            config=AutoscaleConfig(
                min_replicas=1, max_replicas=2, target_wait_s=0.005,
                low_wait_s=0.001, quantile=0.9, breach_polls=2,
                idle_polls=4, up_cooldown_s=60.0, down_cooldown_s=0.0,
                poll_s=0.25, max_metric_age_s=10.0),
            spawner=lambda n: [spawn(i) for i in rt.alloc_replica_indices(
                spawn_client, n, namespace=ns)],
            device=str(dev))
        tsdb = TSDB()
        alerts = AlertManager(tsdb, default_rules())
        scraper = FleetScraper(tsdb, client=CoordClient("127.0.0.1",
                                                        server.port),
                               namespace=ns, registry=obs.registry,
                               alerts=alerts, interval_s=0.5)
        before = {k: counter(k) for k in (
            "autoscale/scale_ups", "autoscale/drain_completed",
            "router/replica_deaths")}
        sent: dict[str, float] = {}
        lat: list[float] = []
        batches = {}
        try:
            t0 = time.time()
            rt.wait_live(client, 1, namespace=ns, timeout_s=180.0,
                         procs=procs)
            live_s = time.time() - t0
            scraper.start()
            scaler.start()
            router = rt.Router(client, namespace=ns, lost_after_s=10.0)

            def done(key, comp) -> None:
                lat.append(time.time() - sent[str(comp.rid)])

            def batch(tag):
                t0 = time.time()
                sent.update({f"{tag}{i}": t0
                             for i in range(W["requests"])})
                comps = router.run(reqs(tag), timeout_s=W["timeout_s"],
                                   on_complete=done)
                wall = time.time() - t0
                batches[tag] = {"comps": comps, "wall_s": wall,
                                "requests_per_s": W["requests"] / wall}

            watcher = threading.Thread(target=watch_join, daemon=True)
            watcher.start()
            batch("a")
            watcher.join(timeout=180.0)
            check("t" in joined and len(live()) == 2,
                  f"fleet_autoscale: no joiner live (scale-ups "
                  f"{counter('autoscale/scale_ups')}, live {live()})")
            frame_doc = gather(client, ns, tsdb=tsdb, alerts=alerts)
            frame = render(frame_doc)
            batch("b")
            deadline = time.monotonic() + 180.0
            drained = 0.0
            while time.monotonic() < deadline:
                drained = (counter("autoscale/drain_completed")
                           - before["autoscale/drain_completed"])
                if drained >= 1 and len(live()) == 1:
                    break
                time.sleep(0.1)
            t_drained = time.monotonic()
            live_end = live()
            time.sleep(1.0)          # one more scrape past the drain
        finally:
            unwatch.set()
            scaler.stop()
            scraper.stop()
            procs += scaler.procs
            reports = rt.exit_reports(client, namespace=ns)
            codes = rt.stop_fleet(client, procs, namespace=ns,
                                  timeout_s=60.0)
        dumps = {}
        for rid, out in outs.items():
            if os.path.exists(out):
                with open(out) as fh:
                    dumps[rid] = json.load(fh)
    del server
    log = scaler.decision_log
    first_breach = next(r["t"] for r in log if r.get("breach", 0) >= 1
                        or r["action"] is not None)
    downs = [r for r in log if r["action"] and r["action"][0] == "down"]
    ups = counter("autoscale/scale_ups") - before["autoscale/scale_ups"]
    deaths = (counter("router/replica_deaths")
              - before["router/replica_deaths"])
    for tag, b in batches.items():
        rids = sorted(str(c.rid) for c in b["comps"])
        check(rids == sorted(f"{tag}{i}" for i in range(W["requests"])),
              f"fleet_autoscale: batch {tag} completions {rids}")
        bad = [c.rid for c in b["comps"]
               if c.tokens.tolist() != want[tag][str(c.rid)]]
        check(not bad, f"fleet_autoscale: batch {tag} requests {bad} "
              "differ from the paged ServeLoop on the card")
    check(ups >= 1 and drained >= 1 and len(live_end) == 1,
          f"fleet_autoscale: scale-ups {ups}, drains {drained}, live at "
          f"the end {live_end}")
    check(len(downs) >= 1, "fleet_autoscale: no drain decision logged")
    victim = downs[0]["action"][1]
    gone = next(p for p in procs if p.replica_index == int(victim[1:]))
    check(gone.returncode == 0
          and reports.get(victim, {}).get("pool_drained") is True,
          f"fleet_autoscale: drained {victim} exit codes {codes}, report "
          f"{reports.get(victim)}")
    check(deaths == 0 and "ReplicaLost" not in alerts.fired_names,
          f"fleet_autoscale: deaths {deaths}, alerts fired "
          f"{sorted(alerts.fired_names)}")
    check({"r0", "r1"} <= set(frame_doc["replicas"])
          and "r0" in frame and "r1" in frame,
          f"fleet_autoscale: console frame lists "
          f"{sorted(frame_doc['replicas'])}")
    launches = {"K1": 0, "K2": 0, "K5": 0}
    replicas = {}
    for rid, d in dumps.items():
        n, served = d["launches"], d["counters"].get("serve/requests", 0)
        replicas[rid] = {"K1": n["K1"], "K2": n["K2"], "K5": n["K5"],
                         "requests": served}
        if served:
            check(n["K1"] > 0 and n["K5"] > 0 and n["K2"] == 0,
                  f"fleet_autoscale: {rid} launched {n}")
        for k in launches:
            launches[k] += n[k]
    check(replicas.get("r1", {}).get("requests", 0) >= 1,
          f"fleet_autoscale: the joiner served nothing ({replicas})")
    hist = obs.values_to_hist(lat, growth=2 ** 0.25)
    emit({"phase": "fleet_autoscale", "width": W,
          "replicas_live_s": live_s,
          "scale_up_s": joined["t"] - first_breach,
          "drain_s": t_drained - downs[0]["t"],
          **{f"batch_{tag}": {"wall_s": b["wall_s"],
                              "requests_per_s": b["requests_per_s"]}
             for tag, b in batches.items()},
          "latency_p50_s": obs.hist_quantile(hist, 0.5),
          "latency_p99_s": obs.hist_quantile(hist, 0.99),
          "scale_ups": ups, "drains": drained, "victim": victim,
          "exit_codes": codes, "alerts_fired": sorted(alerts.fired_names),
          "replicas": replicas, "launches": launches})
    return launches


def sp_summary(rows: list) -> dict:
    """The sp_decode rows of one kernel for the kernels line: the worst
    error over every shard and case, and the bf16 rows' times a shard
    (K2 also the merged step and the unsharded call beside it)."""
    out = {"sp_max_abs_err": max(r["max_abs_err"] for r in rows),
           "sp_tol_ratio": max(r["tol_ratio"] for r in rows)}
    for r in rows:
        if r["dtype"] != "bfloat16":
            continue
        key = f"sp_{r['case']}"
        if "shards" in r:
            out[key] = {"shard_ms": [s["ms"] for s in r["shards"]],
                        "shard_bound_ms": [s["bound_ms"]
                                           for s in r["shards"]],
                        **{k: r[k] for k in ("merged_ms", "ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "bound_by")}}
        else:
            out[key] = {"shard_ms": r["shard_ms"],
                        "shard_bound_ms": r["shard_bound_ms"]}
    return out


def _merge_virtual(torch, parts):
    """The LSE merge of ``[(out [B, 1, H, D], lse [B, H])]`` partials of
    virtual ranks in this process: :func:`lse_merge`'s arithmetic (f32
    weights ``exp(lse_i - logsumexp)``, the weighted sum, the cast back)
    with the all-gather and the all-reduce done as a stack and a sum."""
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - torch.logsumexp(lse, 0))[:, :, None, :, None]
    out = (torch.stack([p[0] for p in parts]).float() * w).sum(0)
    return out.to(parts[0][0].dtype), torch.logsumexp(lse, 0)


def phase_sp_decode(torch, dev, seed):
    """K2 and K6 at ``pos_offset`` over SP_DECODE["shards"] virtual shards
    of the serve rows' 8k cache (H=8, Hkv=2, D=64; 4 rows at 7680/5120/
    2560/300, a scalar length with a window starting mid-shard, a length
    that leaves 3 shards all masked), in f32 and bf16: each shard's out
    and LSE against the plain version by ``compare``, a dead shard exactly
    0 with LSE -1e30, the in-process LSE merge of the shards against the
    unsharded K2.  bf16 times: each shard's K2 beside its bound, the
    merged step (the shards' K2 calls and the merge) beside the unsharded
    K2 and SDPA.  Returns ``{"K2": rows, "K6": rows}``."""
    import torch.nn.functional as F

    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed + 18)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    H, HKV, D, S, B = 8, 2, 64, 8192, 4
    n = SP_DECODE["shards"]
    s_loc = S // n
    cases = (("per_row", torch.tensor([7680, 5120, 2560, 300],
                                      dtype=torch.int32, device=dev), None),
             ("window_mid_shard", torch.tensor(7000, dtype=torch.int32,
                                               device=dev), 3000),
             ("three_shards_masked", torch.tensor(1500, dtype=torch.int32,
                                                  device=dev), None))
    rows = {"K2": [], "K6": []}
    for dt in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        q, kc, vc = rnd(B, 1, H, D), rnd(B, S, HKV * D), rnd(B, S, HKV * D)
        q8 = fd.quantize_kv(kc.view(B, S, HKV, D), vc.view(B, S, HKV, D))
        for name, lens, window in cases:
            kw = dict(window=window, return_lse=True)
            live = (lens.long().expand(B) if lens.dim() == 0
                    else lens.long())
            lo = (live - window).clamp_min(0) if window else 0 * live
            parts, worst, worst8 = [], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
            shard_rows = []
            for i in range(n):
                sl = slice(i * s_loc, (i + 1) * s_loc)
                k_i, v_i = kc[:, sl], vc[:, sl]
                off = torch.tensor(i * s_loc, dtype=torch.int32, device=dev)
                o, lse = fd.flash_decode(q, k_i, v_i, lens, pos_offset=off,
                                         packed_kv_heads=HKV, **kw)
                po, plse = fd.flash_decode_plain(
                    q, k_i, v_i, lens, pos_offset=off, packed_kv_heads=HKV,
                    **kw)
                err = compare(o, lse, po, plse)
                check(err[2] <= 1.0 and err[1] <= LSE_ATOL,
                      f"K2 at pos_offset {i * s_loc} ({name}, {dt}) "
                      f"disagrees with its plain version: {err}")
                q8_i = tuple(t[:, sl] for t in q8)
                o8, lse8 = fd.flash_decode_q8(q, *q8_i, lens, pos_offset=off,
                                              **kw)
                po8, plse8 = fd.flash_decode_q8_plain(q, *q8_i, lens,
                                                      pos_offset=off, **kw)
                err8 = compare(o8, lse8, po8, plse8)
                check(err8[2] <= 1.0 and err8[1] <= LSE_ATOL,
                      f"K6 at pos_offset {i * s_loc} ({name}, {dt}) "
                      f"disagrees with its plain version: {err8}")
                shard_live = ((live.clamp(max=(i + 1) * s_loc)
                               - lo.clamp(min=i * s_loc)).clamp_min(0))
                if int(shard_live.max()) == 0:
                    dead = (bool((o == 0).all()) and bool((o8 == 0).all())
                            and bool((lse == -1e30).all())
                            and bool((lse8 == -1e30).all()))
                    check(dead, f"shard {i} ({name}, {dt}) has no live key "
                          f"but K2/K6 gave out != 0 or LSE != -1e30")
                worst = [max(a, b) for a, b in zip(worst, err)]
                worst8 = [max(a, b) for a, b in zip(worst8, err8)]
                parts.append((o, lse))
                n_live = int(shard_live.sum())
                row = {"shard": i, "pos_offset": i * s_loc,
                       "live_keys": n_live}
                if dt == torch.bfloat16:
                    nbytes = 2 * n_live * HKV * D * 2 + 2 * q.numel() * 2
                    b_ms, b_by = bound(nbytes, 4.0 * n_live * H * D)
                    # K6: int8 K and V, an f32 scale each per (token, head)
                    b8_ms, _ = bound(2 * n_live * HKV * D
                                     + 2 * n_live * HKV * 4
                                     + 2 * q.numel() * 2,
                                     4.0 * n_live * H * D)
                    row.update(
                        ms=timed_ms(lambda: fd.flash_decode(
                            q, k_i, v_i, lens, pos_offset=off,
                            packed_kv_heads=HKV, **kw), 50, flush),
                        q8_ms=timed_ms(lambda: fd.flash_decode_q8(
                            q, *q8_i, lens, pos_offset=off, **kw), 50,
                            flush),
                        bound_ms=b_ms, bound_by=b_by, q8_bound_ms=b8_ms)
                shard_rows.append(row)
            merged, mlse = _merge_virtual(torch, parts)
            whole, wlse = fd.flash_decode(q, kc, vc, lens,
                                          packed_kv_heads=HKV, **kw)
            merr = compare(merged, mlse, whole, wlse)
            check(merr[2] <= 1.0 and merr[1] <= LSE_ATOL,
                  f"the LSE merge of {n} shards ({name}, {dt}) disagrees "
                  f"with the unsharded K2: {merr}")
            row = {"case": name, "dtype": str(dt).split(".")[1],
                   "shards": shard_rows, "max_abs_err": worst[0],
                   "lse_err": worst[1], "tol_ratio": worst[2],
                   "merge_vs_unsharded": {"max_abs_err": merr[0],
                                          "lse_err": merr[1],
                                          "tol_ratio": merr[2]}}
            if dt == torch.bfloat16:
                n_live = int((live - lo).sum())
                nbytes = 2 * n_live * HKV * D * 2 + 2 * q.numel() * 2
                b_ms, b_by = bound(nbytes, 4.0 * n_live * H * D)
                offs = [torch.tensor(i * s_loc, dtype=torch.int32,
                                     device=dev) for i in range(n)]

                def sharded_step():
                    return _merge_virtual(torch, [fd.flash_decode(
                        q, kc[:, i * s_loc:(i + 1) * s_loc],
                        vc[:, i * s_loc:(i + 1) * s_loc], lens,
                        pos_offset=offs[i], packed_kv_heads=HKV, **kw)
                        for i in range(n)])

                pos = torch.arange(S, device=dev)
                mask = ((pos < live[:, None]) & (pos >= lo[:, None]))[
                    :, None, None, :]
                qt = q.transpose(1, 2)
                kt = kc.view(B, S, HKV, D).transpose(1, 2)
                vt = vc.view(B, S, HKV, D).transpose(1, 2)
                row.update(
                    merged_ms=timed_ms(sharded_step, 20, flush),
                    ms=timed_ms(lambda: fd.flash_decode(
                        q, kc, vc, lens, packed_kv_heads=HKV, **kw), 50,
                        flush),
                    plain_ms=timed_ms(lambda: fd.flash_decode_plain(
                        q, kc, vc, lens, packed_kv_heads=HKV, **kw), 10,
                        flush),
                    library_ms=timed_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, enable_gqa=True),
                        50, flush),
                    bound_ms=b_ms, bound_by=b_by)
            rows["K2"].append(row)
            rows["K6"].append({"case": name, "dtype": row["dtype"],
                               "max_abs_err": worst8[0],
                               "lse_err": worst8[1],
                               "tol_ratio": worst8[2],
                               "shard_ms": [r.get("q8_ms")
                                            for r in shard_rows],
                               "shard_bound_ms": [r.get("q8_bound_ms")
                                                  for r in shard_rows],
                               "library_ms": None})
        del kc, vc, q8
    del flush_buf
    torch.cuda.empty_cache()
    emit({"phase": "sp_decode", "shards": n, "K2": rows["K2"],
          "K6": rows["K6"],
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "lse_atol": LSE_ATOL}})
    return rows


def phase_decode_q8(torch, dev, seed):
    """flash_decode_q8 as a user calls it: the serve model's decode shape
    (4 rows, H=8, Hkv=2, D=64) over 8 layers of int8 caches quantized with
    ``quantize_kv`` from bf16 K/V at 8k, 32 decode steps at growing
    per-row lengths, counts reset just before and read just after; the
    last step's outputs held against the plain version."""
    from tpudist_torch.ops import flash_decode as fd

    g = torch.Generator(device=dev).manual_seed(seed + 9)
    B, H, HKV, D, S, layers, steps = 4, 8, 2, 64, 8192, 8, 32

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    caches = [fd.quantize_kv(rnd(B, S, HKV, D), rnd(B, S, HKV, D))
              for _ in range(layers)]
    lens0 = torch.tensor([7680, 5120, 2560, 300], dtype=torch.int32,
                         device=dev)
    reset_launches()
    t0 = time.perf_counter()
    for t in range(steps):
        lens = lens0 + t
        for kv in caches:
            q = rnd(B, 1, H, D)
            out = fd.flash_decode_q8(q, *kv, lens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    po = fd.flash_decode_q8_plain(q, *caches[-1], lens)
    ratio = ((out.float() - po.float()).abs()
             / (O_ATOL + O_RTOL * po.float().abs())).max().item()
    split = fd._SPLIT_KEYS
    so = fd._flash_decode_q8_split_plain(q, *caches[-1], lens,
                                         split_keys=split)
    split_ratio = ((out.float() - so.float()).abs()
                   / (O_ATOL + O_RTOL * so.float().abs())).max().item()
    check(launches["K6"] == steps * layers and ratio <= 1.0
          and split_ratio <= 1.0 and bool(torch.isfinite(out).all()),
          f"decode_q8: launches {launches}, ratio {ratio}, against the "
          f"split plain version ({split} keys a split) {split_ratio}")
    del caches
    torch.cuda.empty_cache()
    emit({"phase": "decode_q8", "steps": steps, "layers": layers,
          "launches": launches, "wall_s": wall, "tol_ratio_last": ratio,
          "split_plain_tol_ratio_last": split_ratio,
          "plan": {"split_keys": split}})
    return launches


def phase_profile(torch, loop, seed, name="profile"):
    """Where a decode tick's time goes: 4 lanes admitted at lengths
    7680/5120/2560/300, one 32-tick segment timed on the host clock, and
    the same segment's device kernels read with ``torch.profiler`` (CUDA
    activity only).  Device busy share = kernel time / host wall.  A paged
    loop grows its lanes' pages and stamps the table before each segment,
    as its run loop does (inside the timed window)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.models.serving import Request

    rng = np.random.default_rng(seed + 2)
    v = loop.cfg.vocab_size
    loop.chunked = False               # one-shot admission: lanes decode
    for slot, n in enumerate((7680, 5120, 2560, 300)):
        loop._admit(slot, Request(rng.integers(0, v, n).astype(np.int32),
                                  200))

    def segment():
        if loop.pool is not None:
            for slot in range(4):
                loop.pool.grow(slot, 32)
            loop._stamp_table()
        loop._segment(32)

    segment()                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segment()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        segment()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, f"{name}: the profiler saw no device time")
    families = {}
    for k, t, _ in rows:
        families[kernel_family(k)] = families.get(kernel_family(k), 0.0) + t
    emit({"phase": name, "ticks": 32, "wall_ms": wall_ms,
          "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
          "by_family_ms": families,
          "top": [{"kernel": k[:80], "ms": ms, "count": n}
                  for k, ms, n in rows[:12]]})


def grad_ratio(got, want) -> float:
    """Worst ratio of an element's error to its limit GRAD_ATOL_REL *
    max|plain| + GRAD_RTOL * |plain|; the kernel agrees at <= 1.  An
    exact match counts 0 (an all-zero gradient has a limit of 0)."""
    got, want = got.float(), want.float()
    lim = GRAD_ATOL_REL * want.abs().max() + GRAD_RTOL * want.abs()
    err = (got - want).abs()
    return (err / lim).masked_fill(err == 0, 0.0).max().item()


def live_pairs(s: int, window) -> int:
    """Live (query, key) pairs of one head under a causal mask over s
    positions, within the window when given."""
    return sum(min(r + 1, window or s) for r in range(s))


BWD_CASES = (("train", (8, 2048, 8, 2, 64, None)),
             ("train_window512", (8, 2048, 8, 2, 64, 512)),
             ("bench_flash", (4, 2048, 8, 8, 128, None)))
# a tp = 2 shard of the train cell: its 4 local query heads over 1 KV head
TP_CASES = (("tp2_shard", (8, 2048, 4, 1, 64, None)),)


def phase_backward_kernels(torch, dev, seed, cases=BWD_CASES,
                           phase="kernels_bwd", k1_case="train"):
    """K3 and K4 against their plain versions (bf16) in three cases: the
    train phase's attention shape (B=8, S=2048, H=8, Hkv=2, D=64, causal),
    the same with a 512 window, and bench.py's flash shape (B=4, S=2048,
    H=8, Hkv=8, D=128, causal); K1 at the ``k1_case`` shape held against
    its plain version too.  Returns the per-case rows and K1's row at
    that shape.  ``tp_kernels`` runs it at a tp = 2 shard's shape
    (TP_CASES)."""
    import torch.nn.functional as F

    from tpudist_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    bf = torch.bfloat16
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    rows, k1_train = [], None
    for case, (B, S, H, HKV, D, W) in cases:
        q, k, v, do = rnd(B, S, H, D), rnd(B, S, HKV, D), rnd(B, S, HKV, D), \
            rnd(B, S, H, D)
        kw = dict(causal=True, window=W)
        out, lse = fa._flash_forward(q, k, v, True, window=W)
        dq, delta = fa._flash_bwd_dq(q, k, v, do, out, lse, **kw)
        dk, dv = fa._flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        pdq, pdelta = fa._flash_bwd_dq_plain(q, k, v, do, out, lse, **kw)
        pdk, pdv = fa._flash_bwd_dkv_plain(q, k, v, do, lse, pdelta, **kw)
        torch.cuda.synchronize()
        errs = {n: ((a.float() - b.float()).abs().max().item(),
                    grad_ratio(a, b))
                for n, a, b in (("dq", dq, pdq), ("dk", dk, pdk),
                                ("dv", dv, pdv))}
        d_err = (delta - pdelta).abs().max().item()
        ratio_k3, ratio_k4 = errs["dq"][1], max(errs["dk"][1], errs["dv"][1])
        again = (fa._flash_bwd_dq(q, k, v, do, out, lse, **kw)
                 + fa._flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
        repeat = all(torch.equal(x, y)
                     for x, y in zip((dq, delta, dk, dv), again))
        del again
        check(repeat, f"K3/K4 ({case}): a second call on the same inputs "
              f"gave other bits")
        plan = fa._bwd_plan_for(q, k, **kw)
        check(ratio_k3 <= 1.0 and d_err <= DELTA_ATOL,
              f"K3 disagrees with its plain version ({case}): dq "
              f"{errs['dq']} delta {d_err}")
        check(ratio_k4 <= 1.0,
              f"K4 disagrees with its plain version ({case}): dk "
              f"{errs['dk']} dv {errs['dv']}")
        pairs = live_pairs(S, W) * B * H
        nb, nf = 2, 4   # bytes of a bf16 / f32 element
        qn, kn = q.numel(), k.numel()
        # K3 reads q k v dO O lse, writes dQ and Delta; K4 reads q k v dO
        # lse Delta, writes dK dV
        b3 = bound((3 * qn + 2 * kn) * nb + B * H * S * nf
                   + qn * nb + B * H * S * nf, 6.0 * pairs * D)
        b4 = bound((2 * qn + 2 * kn) * nb + 2 * B * H * S * nf
                   + 2 * kn * nb, 8.0 * pairs * D)
        row = {"case": case, "shape": [B, S, H, HKV, D], "window": W,
               "plan": {"K3": plan.dq_splits, "K4": plan.dkv_splits},
               "bitwise_repeat": repeat,
               "K3": {"max_abs_err": errs["dq"][0], "tol_ratio": ratio_k3,
                      "delta_err": d_err,
                      "ms": timed_ms(lambda: fa._flash_bwd_dq(
                          q, k, v, do, out, lse, **kw), 10, flush),
                      "plain_ms": timed_ms(lambda: fa._flash_bwd_dq_plain(
                          q, k, v, do, out, lse, **kw), 2, flush),
                      "bound_ms": b3[0], "bound_by": b3[1]},
               "K4": {"max_abs_err": max(errs["dk"][0], errs["dv"][0]),
                      "tol_ratio": ratio_k4,
                      "ms": timed_ms(lambda: fa._flash_bwd_dkv(
                          q, k, v, do, lse, delta, **kw), 10, flush),
                      "plain_ms": timed_ms(lambda: fa._flash_bwd_dkv_plain(
                          q, k, v, do, lse, delta, **kw), 2, flush),
                      "bound_ms": b4[0], "bound_by": b4[1]},
               "library_ms": None}
        if W is None:
            # the yardstick: SDPA's backward on the same inputs, fwd+bwd
            # minus fwd (autograd captured in the graph); once for the pair
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

            row["library_ms"] = (timed_ms(sdpa_fwd_bwd, 10, flush)
                                 - timed_ms(sdpa_fwd, 10, flush))
        if case == k1_case:
            # K1 on the training forward (q_offset 0) against its plain
            # version, and SDPA's forward
            po, plse = fa._flash_forward_plain(q, k, v, True)
            o_err, lse_err, o_ratio = compare(out, lse, po, plse)
            check(o_ratio <= 1.0 and lse_err <= LSE_ATOL,
                  f"K1 disagrees with its plain version ({case}): O "
                  f"{o_err} (ratio {o_ratio}), LSE {lse_err}")
            b1 = bound(2 * qn * nb + 2 * kn * nb + B * H * S * nf,
                       4.0 * pairs * D)
            fplan = fa._fwd_plan_for(q, k, causal=True)
            k1_train = {"case": case, "shape": [B, S, H, HKV, D],
                        "max_abs_err": o_err, "lse_err": lse_err,
                        "tol_ratio": o_ratio, "ms": timed_ms(
                            lambda: fa._flash_forward(q, k, v, True), 10,
                            flush),
                        "plain_ms": timed_ms(lambda: fa._flash_forward_plain(
                            q, k, v, True), 2, flush),
                        "plan": {"splits": fplan.splits,
                                 "chunk": fplan.chunk},
                        "bound_ms": b1[0], "bound_by": b1[1],
                        "library_ms": timed_ms(sdpa_fwd, 10, flush)}
            del po, plse
        rows.append(row)
        del q, k, v, do, out, lse, dq, dk, dv, pdq, pdk, pdv
    del flush_buf
    torch.cuda.empty_cache()
    emit({"phase": phase, "cases": rows, "K1_" + k1_case: k1_train,
          "tolerance": {"grad_atol_rel": GRAD_ATOL_REL,
                        "grad_rtol": GRAD_RTOL, "delta_atol": DELTA_ATOL,
                        "o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "lse_atol": LSE_ATOL}})
    return rows, k1_train


def train_loss_fn(torch, cfg):
    from tpudist_torch.ops.losses import cross_entropy

    def loss_fn(model, batch, _gen):
        (toks,) = batch
        logits = model(toks)
        return cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                             toks[:, 1:].reshape(-1)), {}

    return loss_fn


def phase_train_parity(torch, dev, seed):
    """Flash (K1/K3/K4) against the plain sdpa: a full-width 2-layer f32
    model (vocab 32000, H=8, Hkv=2, embed 512), B=2, S=512, 3 Adam steps
    from the same weights and batches."""
    import numpy as np

    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        sdpa,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=32000, num_layers=2, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=512,
                            compute_dtype=torch.float32)
    sd = random_model(torch, cfg, dev, seed + 4).state_dict()
    rng = np.random.default_rng(seed + 4)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512)))
               .to(dev) for _ in range(3)]
    runs = {}
    for name, attn in (("flash", flash_attention_fn()), ("sdpa", sdpa)):
        model = TransformerLM(cfg, attention_fn=attn,
                              param_dtype=torch.float32, device=dev)
        model.load_state_dict(sd)
        state = TrainState.create(model, adam(3e-4), seed=seed)
        step = make_dp_train_step(train_loss_fn(torch, cfg))
        reset_launches()
        losses, grads = [], []
        for toks in batches:
            state, m = step(state, toks)
            losses.append(float(m["loss"]))
            grads.append({n: p.grad.clone()
                          for n, p in model.named_parameters()})
        runs[name] = (losses, grads, read_launches())
        del model, state
    (fl, fg, fla), (sl, sg, sla) = runs["flash"], runs["sdpa"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(fl, sl))
    worst = max(((a[n] - b[n]).abs().max().item()
                 / max(b[n].abs().max().item(), 1e-30), i, n)
                for i, (a, b) in enumerate(zip(fg, sg)) for n in b)
    want = 3 * cfg.num_layers
    check(all(np.isfinite(fl)) and loss_err <= LOSS_RTOL,
          f"train_parity: flash losses {fl} vs sdpa {sl}")
    check(worst[0] <= PGRAD_TOL,
          f"train_parity: gradient of {worst[2]} at step {worst[1]} differs "
          f"by {worst[0]} of its max")
    check(fla["K1"] == fla["K3"] == fla["K4"] == want,
          f"train_parity: flash run launches {fla}, want {want} each")
    check(sla["K1"] == sla["K3"] == sla["K4"] == 0,
          f"train_parity: the sdpa run launched kernels {sla}")
    torch.cuda.empty_cache()
    emit({"phase": "train_parity", "losses_flash": fl, "losses_sdpa": sl,
          "loss_max_rel_err": loss_err, "grad_worst_rel_to_max": worst[0],
          "grad_worst_param": worst[2], "grad_worst_step": worst[1],
          "launches_flash": fla, "tolerance": {"loss_rtol": LOSS_RTOL,
                                               "grad_rel_to_max": PGRAD_TOL}})


def kernel_family(name: str) -> str:
    """The profiles' grouping of device kernels by name."""
    for family, keys in (("MoE grouped GEMM (K7)", ("moe_gmm",)),
                         ("decode split pass (K2, K5, K6)",
                          ("decode_partial",)),
                         ("decode merge (K2, K5, K6)", ("decode_merge",)),
                         ("attention (K1, K3, K4, K8)", ("flash_",)),
                         ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
                         ("optimizer", ("multi_tensor", "adam")),
                         ("reduction", ("reduce_kernel",))):
        if any(k in name for k in keys):
            return family
    return "elementwise and copies"


def phase_train(torch, dev, seed):
    """bench.py's serve-loop model at full width, trained: bf16 compute,
    f32 master weights, flash attention, Adam 3e-4, seq 2048, batch 8,
    the markov stream from --seed; 2 warm-up steps, then 20 measured."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam

    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    B, S, steps = 8, 2048, 20
    model = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                          param_dtype=torch.float32, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed + 5))
    tokens = torch.from_numpy(markov_tokens(B, S, cfg.vocab_size,
                                            seed)).to(dev)
    state = TrainState.create(model, adam(3e-4), seed=seed)
    step = make_dp_train_step(train_loss_fn(torch, cfg))
    for _ in range(2):                 # warm-up: cuBLAS, allocator
        state, _ = step(state, tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(x) for x in losses]
    want = steps * cfg.num_layers
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(launches["K1"] == launches["K3"] == launches["K4"] == want,
          f"train: launches {launches}, want {want} of K1, K3 and K4")
    ms = wall / steps * 1e3
    # model FLOPs: 6 per weight per token for the projections and lm_head
    # (the embeddings are lookups), and 3x the attention forward's 4 per
    # live (q, k) pair, head and head dim (no recompute counted)
    weights = sum(p.numel() for n, p in model.named_parameters()
                  if n.endswith(".weight") and "embed" not in n)
    attn = 3 * 4.0 * live_pairs(S, None) * B * cfg.num_heads \
        * cfg.head_dim * cfg.num_layers
    flops = 6.0 * weights * B * S + attn
    # one more step on the host clock, then the same under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, tokens)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, "train: the profiler saw no device time")
    families = {}
    for k, t, _ in rows:
        families[kernel_family(k)] = families.get(kernel_family(k), 0.0) + t
    emit({"phase": "train", "steps": steps, "batch": B, "seq_len": S,
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "launches": launches, "wall_s": wall,
          "ms_per_step": ms, "tokens_per_s": B * S / (ms / 1e3),
          "model_flops_per_step": flops,
          "bf16_peak_share": flops / (ms / 1e3) / BF16_FLOPS,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "profile": {"step_wall_ms": step_ms, "device_ms": device_ms,
                      "device_busy_share": device_ms / step_ms,
                      "by_family_ms": families,
                      "top": [{"kernel": k[:80], "ms": t, "count": n}
                              for k, t, n in rows[:12]]}})
    del model, state
    torch.cuda.empty_cache()
    return launches


MOE_D, MOE_F, MOE_E, MOE_K = 512, 2048, 8, 2


def phase_moe_kernels(torch, dev, seed):
    """K7 against its plain version (bf16) at bench.py's bench_moe layer
    (T=4096, d=512, f=2048, E=8, top-2, block 128, routing from random
    gates), the training shape (T=16,384), skewed routing (every token on
    experts 0 and 1, gate 0.5) and block 16: a second call bitwise equal
    to the first, the rows of the trailing pad blocks (past the groups'
    rows, which K7 is told on the device) exactly zero, and the path each
    case took (wgmma or mma.sync).  The bound counts the live slots N =
    T*k only (padding is waste, not work): 4*N*d*f FLOPs, and the rows
    read and written, both weight stacks and the gate; the design's own
    bound counts the FLOPs the path does on those slots (the wgmma path's
    first product once per 256-column half of d: 6*N*d*f at d = 512).
    Beside it, torch._grouped_mm for the two products with the GELU
    between (over the same padded groups, a yardstick only), and
    bench_moe's equal-FLOP dense twin against the port's whole fused
    MoEMLP layer.  Returns ``(rows, bench_layer)``."""
    import torch.nn.functional as F

    from tpudist_torch.models.moe import MoEConfig, MoEMLP, _gate_choices
    from tpudist_torch.ops import moe_dispatch as md

    g = torch.Generator(device=dev).manual_seed(seed + 7)
    bf = torch.bfloat16
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    D, FF, E, K = MOE_D, MOE_F, MOE_E, MOE_K
    w_up = (torch.randn(E, D, FF, generator=g, device=dev) / D ** 0.5).to(bf)
    w_down = (torch.randn(E, FF, D, generator=g, device=dev)
              / FF ** 0.5).to(bf)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    rows, bench_layer = [], None
    for case, T, bn, skewed in (("bench_moe", 4096, 128, False),
                                ("train", 16384, 128, False),
                                ("skewed", 4096, 128, True),
                                ("block16", 4096, 16, False)):
        x = torch.randn(T, D, generator=g, device=dev).to(bf)
        if skewed:
            ti = torch.stack([torch.zeros(T, dtype=torch.long, device=dev),
                              torch.ones(T, dtype=torch.long, device=dev)], 1)
            tv = torch.full((T, K), 0.5, device=dev)
        else:
            gates = torch.softmax(torch.randn(T, E, generator=g, device=dev),
                                  -1)
            tv, ti, _ = _gate_choices(gates, K)
        _, xs, gate, be, live = md._fused_layout(x, ti, tv, E, bn)
        runs = md._expert_runs(be)
        ys = md._gmm(be, xs, gate, w_up, w_down, bn, live)
        again = md._gmm(be, xs, gate, w_up, w_down, bn, live)
        want = md._gmm_plain(be, xs, gate, w_up, w_down, bn, runs=runs)
        torch.cuda.synchronize()
        diff = (ys.float() - want.float()).abs()
        lim = MOE_ATOL_REL * want.float().abs().max() \
            + MOE_RTOL * want.float().abs()
        ratio = (diff / lim).max().item()
        check(ratio <= 1.0 and bool(torch.isfinite(ys).all()),
              f"K7 disagrees with its plain version ({case}): max error "
              f"{diff.max().item()} (ratio to limit {ratio})")
        repeat = bool(torch.equal(ys, again))
        check(repeat, f"K7 ({case}): a second call on the same inputs gave "
              f"other bits")
        n_live = int(live)
        pad_zero = bool((ys[n_live:] == 0).all())
        check(pad_zero, f"K7 ({case}): the {xs.shape[0] - n_live} rows of "
              f"the trailing pad blocks are not all zero")
        variant = md.gmm_variant(bf, D, FF, bn)
        n = T * K
        b_ms, b_by = bound(2 * n * D * 2 + 2 * E * D * FF * 2 + n * 4,
                           4.0 * n * D * FF)
        halves = D // 256 if variant == "wgmma" else 1
        design_ms, _ = bound(0, 2.0 * n * D * FF * (halves + 1))
        row = {"case": case, "tokens": T, "block_rows": bn,
               "np_pad": xs.shape[0], "live_rows": n_live,
               "variant": variant, "max_abs_err": diff.max().item(),
               "tol_ratio": ratio, "bitwise_repeat": repeat,
               "pad_rows_zero": pad_zero,
               "ms": timed_ms(lambda: md._gmm(be, xs, gate, w_up, w_down,
                                              bn, live), 10, flush),
               "design_bound_ms": design_ms,
               "plain_ms": timed_ms(lambda: md._gmm_plain(
                   be, xs, gate, w_up, w_down, bn, runs=runs), 2, flush),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if grouped_mm is None:
            row["library"] = ("none: this PyTorch has no torch._grouped_mm")
        else:
            # the padded groups' row ends; the trailing pad blocks past
            # the last group are left out
            sizes = torch.bincount(ti.reshape(-1), minlength=E)
            ends = torch.cumsum((sizes + bn - 1) // bn * bn, 0).to(
                torch.int32)
            live = int(ends[-1])

            def library():
                h = F.gelu(grouped_mm(xs[:live], w_up, offs=ends),
                           approximate="tanh")
                return grouped_mm(h, w_down, offs=ends) * gate[:live]

            try:
                library()
            except RuntimeError as exc:
                row["library"] = f"torch._grouped_mm refused: {exc}"[:200]
            else:
                row["library_ms"] = timed_ms(library, 10, flush)
                row["library"] = ("torch._grouped_mm twice with the GELU "
                                  "between, over the padded groups")
        rows.append(row)
        if case == "bench_moe":
            # bench.py's moe_fused_dispatch_overhead: the whole fused MoE
            # layer (router, gating, dispatch, K7, combine) against a dense
            # MLP of equal expert FLOPs (d -> k*f -> d), f32 weights cast
            # at use in both
            layer = MoEMLP(D, FF, MoEConfig(num_experts=E, top_k=K,
                                            dispatch="fused"), device=dev)
            with torch.no_grad():
                layer.w_up.copy_(w_up)
                layer.w_down.copy_(w_down)
                layer.router.weight.normal_(0.0, D ** -0.5, generator=g)
            w1 = torch.randn(D, K * FF, generator=g, device=dev) / D ** 0.5
            w2 = torch.randn(K * FF, D, generator=g, device=dev) \
                / (K * FF) ** 0.5

            def dense():
                h = F.gelu(x @ w1.to(bf), approximate="tanh")
                return h @ w2.to(bf)

            with torch.no_grad():
                fused_ms = timed_ms(lambda: layer(x), 10, flush)
                dense_ms = timed_ms(dense, 10, flush)
            bench_layer = {"fused_layer_ms": fused_ms,
                           "dense_twin_ms": dense_ms,
                           "moe_fused_dispatch_overhead": fused_ms / dense_ms}
            del layer, w1, w2
        del x, xs, gate, be, ys, again, want
    del flush_buf, w_up, w_down
    torch.cuda.empty_cache()
    emit({"phase": "kernels_moe", "K7": rows, "bench_moe_layer": bench_layer,
          "tolerance": {"atol_rel": MOE_ATOL_REL, "rtol": MOE_RTOL}})
    return rows, bench_layer


def moe_loss_fn(torch, cfg):
    """tests/test_moe.py's MoE training loss: cross-entropy plus the
    weighted aux loss, which is also reported."""
    from tpudist_torch.ops.losses import cross_entropy

    def loss_fn(model, batch, _gen):
        (toks,) = batch
        logits, aux = model(toks)
        ce = cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                           toks[:, 1:].reshape(-1))
        return ce + aux, {"aux": aux}

    return loss_fn


def moe_model_config(torch, layers, dtype, max_seq_len):
    from tpudist_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=32000, num_layers=layers,
                             num_heads=8, num_kv_heads=2, embed_dim=MOE_D,
                             max_seq_len=max_seq_len, compute_dtype=dtype)


def phase_train_moe_parity(torch, dev, seed):
    """dispatch="fused" (K7 forward, the ragged remat backward) against
    dispatch="ragged" (all plain): a full-width 2-layer f32 MoE model
    (vocab 32000, H=8, Hkv=2, embed 512, f=2048, E=8, top-2, block 128,
    flash attention in both), B=2, S=512, 3 Adam steps from the same
    weights and batches."""
    import numpy as np

    from tpudist_torch.models.moe import MoEConfig, MoETransformerLM
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = moe_model_config(torch, 2, torch.float32, 512)

    def moe_cfg(dispatch):
        return MoEConfig(num_experts=MOE_E, top_k=MOE_K, dispatch=dispatch,
                         fused_block_rows=128)

    sd = MoETransformerLM(cfg, moe_cfg("fused"), device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed + 8)).state_dict()
    rng = np.random.default_rng(seed + 8)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512)))
               .to(dev) for _ in range(3)]
    runs = {}
    for name in ("fused", "ragged"):
        model = MoETransformerLM(cfg, moe_cfg(name),
                                 attention_fn=flash_attention_fn(),
                                 device=dev)
        model.load_state_dict(sd)
        state = TrainState.create(model, adam(3e-4), seed=seed)
        step = make_dp_train_step(moe_loss_fn(torch, cfg))
        reset_launches()
        losses, auxes, grads = [], [], []
        for toks in batches:
            state, m = step(state, toks)
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            grads.append({n: p.grad.clone()
                          for n, p in model.named_parameters()})
        runs[name] = (losses, auxes, grads, read_launches())
        del model, state
    (fl, fa, fg, fla), (rl, ra, rg, rla) = runs["fused"], runs["ragged"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(fl, rl))
    aux_err = max(abs(a - b) / abs(b) for a, b in zip(fa, ra))
    worst = max(((a[n] - b[n]).abs().max().item()
                 / max(b[n].abs().max().item(), 1e-30), i, n)
                for i, (a, b) in enumerate(zip(fg, rg)) for n in b)
    want = 3 * cfg.num_layers
    check(all(np.isfinite(fl)) and loss_err <= LOSS_RTOL
          and aux_err <= LOSS_RTOL,
          f"train_moe_parity: fused losses {fl} aux {fa} vs ragged {rl} "
          f"aux {ra}")
    check(worst[0] <= PGRAD_TOL,
          f"train_moe_parity: gradient of {worst[2]} at step {worst[1]} "
          f"differs by {worst[0]} of its max")
    check(fla["K7"] == fla["K1"] == fla["K3"] == fla["K4"] == want,
          f"train_moe_parity: fused run launches {fla}, want {want} each")
    check(rla["K7"] == 0 and rla["K1"] == want,
          f"train_moe_parity: the ragged run launches {rla}")
    torch.cuda.empty_cache()
    emit({"phase": "train_moe_parity", "losses_fused": fl,
          "losses_ragged": rl, "aux_fused": fa, "aux_ragged": ra,
          "loss_max_rel_err": loss_err, "aux_max_rel_err": aux_err,
          "grad_worst_rel_to_max": worst[0], "grad_worst_param": worst[2],
          "grad_worst_step": worst[1], "launches_fused": fla,
          "launches_ragged": rla,
          "tolerance": {"loss_rtol": LOSS_RTOL,
                        "grad_rel_to_max": PGRAD_TOL}})


def phase_train_moe(torch, dev, seed):
    """The train phase's model with every MLP an MoE MLP, trained as the
    train phase trains it (bf16 compute, f32 master weights, flash
    attention, Adam 3e-4, seq 2048, batch 8, the markov stream from
    --seed): MoEConfig(num_experts=8, top_k=2, dispatch="fused",
    fused_block_rows=128), loss = cross-entropy + aux; 2 warm-up steps,
    then 20 measured, then one under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models.moe import MoEConfig, MoETransformerLM
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam

    cfg = moe_model_config(torch, 8, torch.bfloat16, 8192)
    moe = MoEConfig(num_experts=MOE_E, top_k=MOE_K, dispatch="fused",
                    fused_block_rows=128)
    B, S, steps = 8, 2048, 20
    model = MoETransformerLM(cfg, moe, attention_fn=flash_attention_fn(),
                             device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed + 9))
    tokens = torch.from_numpy(markov_tokens(B, S, cfg.vocab_size,
                                            seed)).to(dev)
    state = TrainState.create(model, adam(3e-4), seed=seed)
    step = make_dp_train_step(moe_loss_fn(torch, cfg))
    for _ in range(2):                 # warm-up: cuBLAS, allocator
        state, _ = step(state, tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses, auxes = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, tokens)
        losses.append(m["loss"])
        auxes.append(m["aux"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(x) for x in losses]
    auxes = [float(x) for x in auxes]
    want = steps * cfg.num_layers
    check(all(np.isfinite(losses)) and all(np.isfinite(auxes)),
          f"train_moe: non-finite loss {losses} or aux {auxes}")
    check(losses[-1] < losses[0],
          f"train_moe: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(launches["K7"] == launches["K1"] == launches["K3"]
          == launches["K4"] == want,
          f"train_moe: launches {launches}, want {want} of K7, K1, K3, K4")
    ms = wall / steps * 1e3
    # model FLOPs: 6 per ACTIVE weight per token — the attention
    # projections, the router, k of E experts' two matrices and lm_head
    # (the embeddings are lookups) — plus 3x the attention forward's 4
    # per live (q, k) pair, head and head dim; the remat's extra expert
    # forward is not counted
    active = 0.0
    for n, p in model.named_parameters():
        if n.endswith(("w_up", "w_down")):
            active += p.numel() * MOE_K / MOE_E
        elif n.endswith(".weight") and "embed" not in n:
            active += p.numel()
    attn = 3 * 4.0 * live_pairs(S, None) * B * cfg.num_heads \
        * cfg.head_dim * cfg.num_layers
    flops = 6.0 * active * B * S + attn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, tokens)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, "train_moe: the profiler saw no device time")
    families = {}
    for k, t, _ in rows:
        families[kernel_family(k)] = families.get(kernel_family(k), 0.0) + t
    check(families.get("MoE grouped GEMM (K7)", 0.0) > 0,
          f"train_moe: the profiled step shows no K7 time: {families}")
    # the host's side of one more step: self time by op, the MoE
    # backward's inclusive time (its group sizes are read on the host,
    # so it waits there for the device) and the ATen calls a step makes
    with profile(activities=[ProfilerActivity.CPU]) as host_prof:
        state, _ = step(state, tokens)
        torch.cuda.synchronize()
    host = host_prof.key_averages()
    host_top = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in host), key=lambda r: -r[1])
    emit({"phase": "train_moe", "steps": steps, "batch": B, "seq_len": S,
          "experts": MOE_E, "top_k": MOE_K, "block_rows": 128,
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "aux_mean": sum(auxes) / len(auxes),
          "launches": launches, "wall_s": wall, "ms_per_step": ms,
          "tokens_per_s": B * S / (ms / 1e3),
          "active_weights": active, "model_flops_per_step": flops,
          "bf16_peak_share": flops / (ms / 1e3) / BF16_FLOPS,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "profile": {"step_wall_ms": step_ms, "device_ms": device_ms,
                      "device_busy_share": device_ms / step_ms,
                      "by_family_ms": families,
                      "top": [{"kernel": k[:80], "ms": t, "count": n}
                              for k, t, n in rows[:12]]},
          "host_profile": {
              "moe_backward_ms": sum(e.cpu_time_total for e in host
                                     if e.key == "_FusedMoEBackward") / 1e3,
              "aten_calls": sum(e.count for e in host
                                if e.key.startswith("aten::")),
              "top_self": [{"op": k[:60], "ms": t, "count": n}
                           for k, t, n in host_top[:12]]}})
    del model, state
    torch.cuda.empty_cache()
    return launches


def live_pairs_at(sq: int, sk: int, q_off: int, k_off: int, window) -> int:
    """Live (query, key) pairs of one head of a causal block whose queries
    sit at global positions q_off + [0, sq) and keys at k_off + [0, sk),
    within the window when given."""
    n = 0
    for r in range(sq):
        qp = q_off + r
        lo = k_off if window is None else max(k_off, qp - window + 1)
        n += max(0, min(k_off + sk - 1, qp) - lo + 1)
    return n


def o_ratio(got, want) -> float:
    """Worst ratio of an element's error to compare's limit O_ATOL +
    O_RTOL * |plain|."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (O_ATOL + O_RTOL * want.abs())).max().item()


def f32_ratio(got, want) -> float:
    """Worst ratio of an element's error to F32_ATOL + F32_RTOL * |ref|."""
    got, want = got.float(), want.float()
    return ((got - want).abs()
            / (F32_ATOL + F32_RTOL * want.abs())).max().item()


def phase_ring_kernels(torch, dev, seed):
    """K8 against its plain version (``_flash_bwd_dq_plain`` with Delta
    given), each dQ element within O_ATOL + O_RTOL * |plain|, at:
    train_sp's shape, the one it launches K8 at (B=1, S=8192, H=8, Hkv=2,
    D=64, offsets 0, causal, bf16); the train phase's attention shape
    (B=8, S=2048), where only the bit identity and K3's time beside K8's
    are of use (dense training launches K3 there); the ring's block kinds
    at S_loc = 2048 (B=1): diagonal (q_offset = k_offset = 2048), fully
    live (4096, 0) and fully masked (0, 2048); a 1024 window at offsets
    (4096, 2048); and the diagonal in f32.  Each backward takes final
    statistics as the ring's are: the queries' own diagonal block and the
    case's block folded by the ring's forward step (so P <= 1 over both),
    Delta from that output.  In every case K1 on the case's block (at its
    offsets) is held against its plain version as the kernels phase holds
    it, and K4 (dK, dV with the same Delta) against its plain version by
    grad_ratio's limit as kernels_bwd holds it; in f32 both by F32_ATOL +
    F32_RTOL * |plain|.  On the masked block K8 and K4 must write exact
    zeros and K1 give O = 0 and LSE = -1e30.  Fed K3's Delta, K8 must
    give K3's dQ bit for bit.  Returns the rows."""
    import torch.nn.functional as F

    from tpudist_torch.ops import flash_attention as fa
    from tpudist_torch.parallel.ring_attention import _ring_flash_fwd_step

    g = torch.Generator(device=dev).manual_seed(seed + 10)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    rows = []
    for case, (B, S, H, HKV, D, q_off, k_off, W, dt) in (
            ("train", (8, 2048, 8, 2, 64, 0, 0, None, torch.bfloat16)),
            ("diagonal", (1, 2048, 8, 2, 64, 2048, 2048, None,
                          torch.bfloat16)),
            ("fully_live", (1, 2048, 8, 2, 64, 4096, 0, None,
                            torch.bfloat16)),
            ("fully_masked", (1, 2048, 8, 2, 64, 0, 2048, None,
                              torch.bfloat16)),
            ("window1024", (1, 2048, 8, 2, 64, 4096, 2048, 1024,
                            torch.bfloat16)),
            ("diagonal_f32", (1, 2048, 8, 2, 64, 2048, 2048, None,
                              torch.float32)),
            ("train_sp", (1, 8192, 8, 2, 64, 0, 0, None, torch.bfloat16))):

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        q, do = rnd(B, S, H, D), rnd(B, S, H, D)
        k_own, v_own = rnd(B, S, HKV, D), rnd(B, S, HKV, D)
        k, v = (k_own, v_own) if q_off == k_off else (rnd(B, S, HKV, D),
                                                      rnd(B, S, HKV, D))
        # the final statistics of these queries: their own block, then the
        # case's, folded as the ring folds them (block index = offset / S)
        o = torch.zeros(q.shape, device=dev)
        lse = torch.full((B, H, S), -1e30, device=dev)
        blocks = [(k_own, v_own, q_off)] + ([(k, v, k_off)]
                                            if k_off != q_off else [])
        for kb, vb, off in blocks:
            o, lse = _ring_flash_fwd_step(q, kb, vb, o, lse, q_off // S,
                                          off // S, causal=True, window=W)
        out = o.to(dt)
        delta = fa.flash_delta(out, do)
        kw = dict(causal=True, q_offset=q_off, k_offset=k_off, window=W)
        f32 = dt == torch.float32
        # K1 on the case's block at its offsets
        fkw = {x: kw[x] for x in ("q_offset", "k_offset", "window")}
        ob, lse_b = fa._flash_forward(q, k, v, True, **fkw)
        pob, plse_b = fa._flash_forward_plain(q, k, v, True, **fkw)
        torch.cuda.synchronize()
        k1 = {"max_abs_err": (ob.float() - pob.float()).abs().max().item(),
              "tol_ratio": f32_ratio(ob, pob) if f32 else o_ratio(ob, pob),
              "lse_err": (lse_b - plse_b).abs().max().item()}
        check(k1["tol_ratio"] <= 1.0 and k1["lse_err"] <= LSE_ATOL,
              f"K1 disagrees with its plain version ({case}): {k1}")
        del pob, plse_b
        dq = fa._flash_bwd_dq_delta(q, k, v, do, lse, delta, **kw)
        pdq, _ = fa._flash_bwd_dq_plain(q, k, v, do, None, lse, delta=delta,
                                        **kw)
        torch.cuda.synchronize()
        err = (dq.float() - pdq.float()).abs().max().item()
        ratio = f32_ratio(dq, pdq) if f32 else o_ratio(dq, pdq)
        check(ratio <= 1.0 and bool(torch.isfinite(dq).all()),
              f"K8 disagrees with its plain version ({case}): dq {err} "
              f"(ratio to limit {ratio})")
        del pdq
        # K4 with the same Delta
        dk, dv = fa._flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        pdk, pdv = fa._flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        k4 = {"max_abs_err": max((a.float() - b.float()).abs().max().item()
                                 for a, b in ((dk, pdk), (dv, pdv))),
              "tol_ratio": max((f32_ratio if f32 else grad_ratio)(a, b)
                               for a, b in ((dk, pdk), (dv, pdv)))}
        check(k4["tol_ratio"] <= 1.0 and bool(torch.isfinite(dk).all())
              and bool(torch.isfinite(dv).all()),
              f"K4 disagrees with its plain version ({case}): {k4}")
        del pdk, pdv
        # a second call of each on the same inputs gives the same bits
        again = ((fa._flash_bwd_dq_delta(q, k, v, do, lse, delta, **kw),)
                 + fa._flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
        repeat = all(torch.equal(x, y)
                     for x, y in zip((dq, dk, dv), again))
        del again
        check(repeat, f"K8/K4 ({case}): a second call on the same inputs "
              f"gave other bits")
        plan = fa._bwd_plan_for(q, k, **kw)
        row = {"case": case, "shape": [B, S, H, HKV, D], "q_offset": q_off,
               "k_offset": k_off, "window": W, "dtype": str(dt),
               "plan": {"K8": plan.dq_splits, "K4": plan.dkv_splits},
               "bitwise_repeat": repeat,
               "max_abs_err": err, "tol_ratio": ratio, "K1": k1, "K4": k4}
        if q_off == k_off:
            # K3 on the same block writes a Delta; K8 fed it gives K3's dQ
            dq3, delta3 = fa._flash_bwd_dq(q, k, v, do, out, lse, **kw)
            dq8 = fa._flash_bwd_dq_delta(q, k, v, do, lse, delta3, **kw)
            torch.cuda.synchronize()
            row["bit_identical_to_k3"] = bool(torch.equal(dq8, dq3))
            check(row["bit_identical_to_k3"], f"K8 fed K3's Delta differs "
                  f"from K3's dQ ({case}) by "
                  f"{(dq8.float() - dq3.float()).abs().max().item()}")
        if case == "fully_masked":
            zeros = (not dq.any().item() and not dk.any().item()
                     and not dv.any().item())
            neg_big = torch.tensor(-1e30, dtype=torch.float32, device=dev)
            k1_dead = not ob.any().item() and bool((lse_b == neg_big).all())
            row["exact_zeros"], row["k1_dead_block"] = zeros, k1_dead
            check(zeros, "K8/K4 on a fully masked block: gradients not all "
                  "exact zeros")
            check(k1_dead, f"K1 on a fully masked block: O max "
                  f"{ob.float().abs().max().item()}, lse range "
                  f"[{lse_b.min().item()}, {lse_b.max().item()}]")
        pairs = live_pairs_at(S, S, q_off, k_off, W) * B * H
        nb = q.element_size()
        qn, kn = q.numel(), k.numel()
        # K8 reads q k v dO lse Delta and writes dQ (K3's bytes without
        # its O-tile prepass and Delta write)
        b8 = bound((2 * qn + 2 * kn) * nb + 2 * B * H * S * 4 + qn * nb,
                   6.0 * pairs * D)
        row.update({
            "live_pairs": pairs,
            "ms": timed_ms(lambda: fa._flash_bwd_dq_delta(
                q, k, v, do, lse, delta, **kw), 10, flush),
            "bound_ms": b8[0], "bound_by": b8[1]})
        if case in ("train_sp", "fully_live"):
            row["plain_ms"] = timed_ms(lambda: fa._flash_bwd_dq_plain(
                q, k, v, do, None, lse, delta=delta, **kw), 2, flush)
        if case in ("train_sp", "train"):
            row["K3_ms"] = timed_ms(lambda: fa._flash_bwd_dq(
                q, k, v, do, out, lse, **kw), 10, flush)
        if case == "train_sp":
            # K4 at the shape train_sp launches it: reads q k v dO lse
            # Delta, writes dK dV
            b4 = bound((2 * qn + 2 * kn) * nb + 2 * B * H * S * 4
                       + 2 * kn * nb, 8.0 * pairs * D)
            row["K4"].update({
                "ms": timed_ms(lambda: fa._flash_bwd_dkv(
                    q, k, v, do, lse, delta, **kw), 10, flush),
                "bound_ms": b4[0], "bound_by": b4[1]})
            # the yardstick: SDPA's whole backward on the same inputs
            # (fwd+bwd minus fwd), one call for the pair K8 + K4
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

            row["library_ms"] = (timed_ms(sdpa_fwd_bwd, 10, flush)
                                 - timed_ms(sdpa_fwd, 10, flush))
            # K1 at train_sp's shape: reads q k v, writes O and the LSE
            b1 = bound((2 * qn + 2 * kn) * nb + B * H * S * 4,
                       4.0 * pairs * D)
            fplan = fa._fwd_plan_for(q, k, causal=True)
            row["K1"].update({
                "ms": timed_ms(lambda: fa._flash_forward(q, k, v, True),
                               10, flush),
                "bound_ms": b1[0], "bound_by": b1[1],
                "library_ms": timed_ms(sdpa_fwd, 10, flush),
                "plan": {"splits": fplan.splits, "chunk": fplan.chunk}})
        rows.append(row)
        del q, k, v, do, out, lse, delta, dq, dk, dv, ob, lse_b
    del flush_buf
    torch.cuda.empty_cache()
    emit({"phase": "kernels_ring", "K8": rows,
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "f32_atol": F32_ATOL, "f32_rtol": F32_RTOL}})
    return rows


def _virtual_ring(torch, ra, q, k, v, do, n, window):
    """Ring flash attention for ``n`` virtual ranks in one process:
    rank r holds block r of q/k/v/dO (``[B, S/n, ...]``) and runs the
    module's forward and backward step functions; between steps the list
    of resident blocks (and, backward, their dK/dV accumulators) rotates
    as ``_ring_rotate`` moves them, rank r receiving rank r - 1's.
    Returns the full ``(out, dq, dk, dv)``."""
    from tpudist_torch.ops.flash_attention import flash_delta

    def split(x):
        return list(x.chunk(n, 1))

    qs, ks, vs, dos = split(q), split(k), split(v), split(do)
    b, s_loc, h, d = qs[0].shape
    o = [torch.zeros((b, s_loc, h, d), device=q.device) for _ in range(n)]
    lse = [torch.full((b, h, s_loc), -1e30, device=q.device)
           for _ in range(n)]
    kb, vb = list(ks), list(vs)

    def rotate(xs):
        return [xs[(r - 1) % n] for r in range(n)]

    for step in range(n):
        for r in range(n):
            o[r], lse[r] = ra._ring_flash_fwd_step(
                qs[r], kb[r], vb[r], o[r], lse[r], r, (r - step) % n,
                causal=True, window=window)
        if step < n - 1:
            kb, vb = rotate(kb), rotate(vb)
    outs = [x.to(q.dtype) for x in o]
    deltas = [flash_delta(outs[r], dos[r]) for r in range(n)]
    dq = [torch.zeros(x.shape, device=q.device) for x in qs]
    dk = [torch.zeros(x.shape, device=q.device) for x in ks]
    dv = [torch.zeros(x.shape, device=q.device) for x in vs]
    kb, vb = list(ks), list(vs)
    for step in range(n):
        for r in range(n):
            ra._ring_flash_bwd_step(qs[r], kb[r], vb[r], dos[r], lse[r],
                                    deltas[r], dq[r], dk[r], dv[r], r,
                                    (r - step) % n, causal=True,
                                    window=window)
        kb, vb, dk, dv = rotate(kb), rotate(vb), rotate(dk), rotate(dv)
    cat = lambda xs, dt: torch.cat(xs, 1).to(dt)
    return (cat(outs, q.dtype), cat(dq, q.dtype), cat(dk, k.dtype),
            cat(dv, v.dtype))


def phase_ring_sp4(torch, dev, seed):
    """4 virtual ranks of ring flash attention (B=1, S=8192, H=8, Hkv=2,
    D=64; S_loc = 2048), causal and with a 1024 window, in bf16 and f32:
    the ring (K1, K8, K4; counts reset just before and read just after,
    16 launches each and no K3) against one flash_attention call over the
    whole sequence under autograd (K1, K3, K4) and against the same ring
    with the step functions' kernels swapped for their plain versions.
    bf16: O by compare's limit, each element within O_ATOL + O_RTOL *
    |ref| (the ring rounds each block's O to bf16 before the f32 merge, as
    tpudist's does: a bf16 ulp of a block's O, ~1e-4 at these widths, far
    inside O_ATOL), the gradients by grad_ratio's limit, 1e-2 * max|ref|
    + 2e-2 * |ref| (as kernels_bwd holds K3 and K4); f32: every element
    within F32_ATOL + F32_RTOL * |reference|.  Returns the rows and the
    launch counts of the bf16 causal ring."""
    from tpudist_torch.ops import flash_attention as fa
    from tpudist_torch.parallel import ring_attention as ra

    g = torch.Generator(device=dev).manual_seed(seed + 11)
    B, S, H, HKV, D, n = 1, 8192, 8, 2, 64, 4
    rows, main_launches = [], None
    for dt in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        q, k, v, do = rnd(B, S, H, D), rnd(B, S, HKV, D), rnd(B, S, HKV, D), \
            rnd(B, S, H, D)
        for W in (None, 1024):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            got = _virtual_ring(torch, ra, q, k, v, do, n, W)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            check(launches["K1"] == launches["K8"] == launches["K4"]
                  == n * n and launches["K3"] == 0,
                  f"ring_sp4: launches {launches}, want {n * n} of K1, K8, "
                  f"K4 and no K3")
            # the same ring on the plain versions of the kernels
            saved = ra._flash_forward, ra.flash_block_grads
            ra._flash_forward = fa._flash_forward_plain
            ra.flash_block_grads = fa.flash_block_grads_plain
            try:
                plain = _virtual_ring(torch, ra, q, k, v, do, n, W)
            finally:
                ra._flash_forward, ra.flash_block_grads = saved
            # one flash_attention call over the whole sequence
            xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            full_out = fa.flash_attention(*xs, causal=True, window=W)
            full = (full_out,) + torch.autograd.grad(full_out, xs, do)
            torch.cuda.synchronize()
            row = {"dtype": str(dt), "window": W, "launches": launches,
                   "wall_ms": wall * 1e3}
            for ref_name, ref in (("full_flash", full), ("plain_ring",
                                                          plain)):
                ratios = {}
                for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
                    ratios[name] = (f32_ratio(a, b) if dt == torch.float32
                                    else o_ratio(a, b) if name == "out"
                                    else grad_ratio(a, b))
                    check(ratios[name] <= 1.0 and bool(
                        torch.isfinite(a).all()),
                          f"ring_sp4 ({dt}, window {W}): {name} differs "
                          f"from the {ref_name} (ratio to limit "
                          f"{ratios[name]})")
                row[ref_name] = {
                    "tol_ratio": ratios,
                    "max_abs_err": max((a.float() - b.float()).abs().max()
                                       .item() for a, b in zip(got, ref))}
            rows.append(row)
            if dt == torch.bfloat16 and W is None:
                main_launches = launches
            del got, plain, full, xs, full_out
        del q, k, v, do
    torch.cuda.empty_cache()
    emit({"phase": "ring_sp4", "ranks": n, "shape": [B, S, H, HKV, D],
          "runs": rows,
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "grad_atol_rel": GRAD_ATOL_REL,
                        "grad_rtol": GRAD_RTOL, "f32_atol": F32_ATOL,
                        "f32_rtol": F32_RTOL}})
    return rows, main_launches


def phase_train_sp(torch, dev, seed):
    """The train phase's model (vocab 32000, 8 layers, H=8, Hkv=2, embed
    512, bf16 compute, f32 master weights, Adam 3e-4, the markov stream
    from --seed) at seq 8192, batch 1, max_seq_len 8192, trained through
    make_sp_train_step with ring_flash_attention_fn on a one-rank NCCL
    group (``initialize`` with a HashStore) and a data 1 x seq 1 mesh, the
    last target masked as long_context_lm_tpu.py masks it.  Step 0 against
    the dense flash step (make_dp_train_step, flash_attention_fn(), the
    same loss) from the same weights; then a warm-up and 10 measured SP
    steps with counts reset just before and read just after; the dense
    run takes the same 12 steps from the same weights, its losses held
    against the SP run's step by step and its time beside the SP step's;
    after training one more SP and dense step from the SP run's weights,
    held as step 0 is; then one SP step under torch.profiler.  The group
    is destroyed at the end."""
    import numpy as np
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.ops.losses import cross_entropy_per_token
    from tpudist_torch.parallel import (
        make_dp_train_step,
        make_sp_train_step,
        ring_flash_attention_fn,
    )
    from tpudist_torch.runtime import (
        initialize,
        local_block,
        make_mesh,
        shutdown,
    )
    from tpudist_torch.train import TrainState, adam

    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    B, S, steps = 1, 8192, 10
    ctx = initialize(store=dist.HashStore(), world_size=1, rank=0,
                     device=dev)
    try:
        check(dist.get_backend() == "nccl" and ctx.process_count == 1,
              f"train_sp: backend {dist.get_backend()}, {ctx}")
        probe = torch.ones(4, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        check(probe.tolist() == [1.0] * 4, f"train_sp: NCCL all-reduce on "
              f"one rank gave {probe.tolist()}")
        mesh = make_mesh({"data": 1, "seq": 1})
        tokens = torch.from_numpy(markov_tokens(B, S, cfg.vocab_size,
                                                seed)).to(dev)
        targets = torch.cat([tokens[:, 1:],
                             torch.full_like(tokens[:, :1], -1)], 1)
        total = B * (S - 1)

        def loss_per_token(logits, tgt):
            mask = (tgt >= 0).float()
            return cross_entropy_per_token(logits, tgt.clamp_min(0)) * mask

        def dense_loss(model, batch, _gen):
            toks, tgt = batch
            logits = model(toks)
            return loss_per_token(logits.reshape(-1, cfg.vocab_size),
                                  tgt.reshape(-1)).sum() / total, {}

        def build(attn):
            model = TransformerLM(cfg, attention_fn=attn,
                                  param_dtype=torch.float32, device=dev)
            model.init_weights(
                torch.Generator(device=dev).manual_seed(seed + 12))
            return model, TrainState.create(model, adam(3e-4), seed=seed)

        model, state = build(ring_flash_attention_fn("seq", mesh=mesh))
        sp_step = make_sp_train_step(model, loss_per_token, mesh, total)
        batch = (local_block(tokens, mesh), local_block(targets, mesh))
        dense_model, dense_state = build(flash_attention_fn())
        dense_step = make_dp_train_step(dense_loss)

        def same_weights_step():
            """One SP step and one dense step from the SP model's weights:
            the loss and every gradient against the dense step's."""
            nonlocal state, dense_state
            dense_model.load_state_dict(model.state_dict())
            reset_launches()
            state, m = sp_step(state, *batch)
            launches = read_launches()
            sp_grads = {n: p.grad.clone()
                        for n, p in model.named_parameters()}
            dense_state, dm = dense_step(dense_state, tokens, targets)
            loss_sp, loss_dense = float(m["loss"]), float(dm["loss"])
            loss_err = abs(loss_sp - loss_dense) / abs(loss_dense)
            worst = max(((sp_grads[n] - p.grad).abs().max().item()
                         / max(p.grad.abs().max().item(), 1e-30), n)
                        for n, p in dense_model.named_parameters())
            return {"loss_sp": loss_sp, "loss_dense": loss_dense,
                    "loss_rel_err": loss_err, "grad_worst_rel_to_max":
                    worst[0], "grad_worst_param": worst[1],
                    "launches": launches}

        def check_same_weights(r, when):
            check(np.isfinite(r["loss_sp"])
                  and r["loss_rel_err"] <= SP_LOSS_RTOL,
                  f"train_sp: {when} loss {r['loss_sp']} against the dense "
                  f"flash step's {r['loss_dense']}")
            check(r["grad_worst_rel_to_max"] <= SP_GRAD_TOL,
                  f"train_sp: {when} gradient of {r['grad_worst_param']} "
                  f"differs from the dense step's by "
                  f"{r['grad_worst_rel_to_max']} of its max")
            check(r["launches"]["K3"] == 0 and r["launches"]["K8"]
                  == cfg.num_layers, f"train_sp: {when} launches "
                  f"{r['launches']}")

        # step 0: the same weights through both steps
        step0 = same_weights_step()
        check_same_weights(step0, "step-0")
        losses = [step0["loss_sp"]]
        state, m = sp_step(state, *batch)        # warm-up
        losses.append(m["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = sp_step(state, *batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [float(x) for x in losses]
        want = steps * cfg.num_layers
        check(all(np.isfinite(losses)), f"train_sp: non-finite loss "
              f"{losses}")
        check(losses[-1] < losses[0],
              f"train_sp: loss did not fall ({losses[0]} -> {losses[-1]})")
        check(launches["K1"] == launches["K8"] == launches["K4"] == want
              and launches["K3"] == 0,
              f"train_sp: launches {launches}, want {want} of K1, K8, K4 "
              f"and no K3")
        # the dense flash step at the same shape, on the same steps from
        # step 0: its losses beside the SP run's, its time beside the SP
        # step's
        dense_losses = [step0["loss_dense"]]
        dense_state, dm = dense_step(dense_state, tokens, targets)
        dense_losses.append(dm["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            dense_state, dm = dense_step(dense_state, tokens, targets)
            dense_losses.append(dm["loss"])
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) / steps * 1e3
        ms = wall / steps * 1e3
        dense_losses = [float(x) for x in dense_losses]
        traj_err = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                        dense_losses)]
        check(max(traj_err) <= SP_TRAJ_RTOL, f"train_sp: the SP run's "
              f"losses {losses} left the dense run's {dense_losses}")
        # after training: the same weights through both steps again
        final = same_weights_step()
        check_same_weights(final, f"step-{len(losses)}")
        # one more SP step under the profiler: device time by family
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, _ = sp_step(state, *batch)
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0]
        device_ms = sum(r[1] for r in rows)
        check(device_ms > 0, "train_sp: the profiler saw no device time")
        families = {}
        for k, t, _ in rows:
            families[kernel_family(k)] = families.get(kernel_family(k),
                                                      0.0) + t
        weights = sum(p.numel() for n, p in model.named_parameters()
                      if n.endswith(".weight") and "embed" not in n)
        flops = 6.0 * weights * B * S + 3 * 4.0 * live_pairs(S, None) * B \
            * cfg.num_heads * cfg.head_dim * cfg.num_layers
        emit({"phase": "train_sp", "mesh": {"data": 1, "seq": 1},
              "backend": "nccl", "steps": steps, "batch": B, "seq_len": S,
              "step0": step0, "after_training": final,
              "losses": losses, "dense_losses": dense_losses,
              "loss_rel_err_by_step": traj_err,
              "launches": launches, "wall_s": wall,
              "ms_per_step": ms, "tokens_per_s": B * S / (ms / 1e3),
              "model_flops_per_step": flops,
              "bf16_peak_share": flops / (ms / 1e3) / BF16_FLOPS,
              "max_memory_allocated_bytes": peak,
              "dense_flash_ms_per_step": dense_ms,
              "profile": {"step_wall_ms": step_ms, "device_ms": device_ms,
                          "device_busy_share": device_ms / step_ms,
                          "by_family_ms": families},
              "tolerance": {"loss_rtol": SP_LOSS_RTOL,
                            "grad_rel_to_max": SP_GRAD_TOL,
                            "trajectory_rtol": SP_TRAJ_RTOL}})
        del model, state, dense_model, dense_state
    finally:
        shutdown()
    torch.cuda.empty_cache()
    return launches



# ---- GroupNorm (K9, K10) and the ResNet50 path -----------------------------

# ResNet50's GroupNorm sites at 128 px: each (H·W, C) with the modes it
# takes (a Bottleneck tail's shape is also its projection's)
GN_SITE_SHAPES = (
    ((4096, 64), ("relu",)), ((1024, 64), ("relu",)),
    ((1024, 128), ("relu",)), ((1024, 256), ("add_relu", "plain")),
    ((256, 128), ("relu",)), ((256, 256), ("relu",)),
    ((256, 512), ("add_relu", "plain")), ((64, 256), ("relu",)),
    ((64, 512), ("relu",)), ((64, 1024), ("add_relu", "plain")),
    ((16, 512), ("relu",)), ((16, 2048), ("add_relu", "plain")))
RESNET_BATCH, RESNET_HW, RESNET_STEPS = 128, 128, 20
GN_GROUPS, GN_EPS = 32, 1e-6


def gn_bound(b, hw, c, mode, esize, backward) -> tuple[float, str]:
    """bound() of one K9 (forward) or K10 (backward) call: each tensor
    read once and written once — K9 reads x (and the residual) and writes
    y, mean, rstd; K10 reads x, dy (and the residual), scale, bias, mean,
    rstd and writes dx (and dres), dscale, dbias — at ~10 FLOPs an
    element."""
    act = b * hw * c * esize
    res = act if mode == "add_relu" else 0
    small = 4 * (2 * c + 2 * b * GN_GROUPS)
    nbytes = (3 * act + 2 * res if backward else 2 * act + res) + small
    return bound(nbytes, 10.0 * b * hw * c)


def gn_paths(gn, torch, b, hw, c, mode, dt, backward):
    """``(planned, other)``: the plan the wrapper takes for K9
    (``backward=False``) or K10 at this shape, and the other path's plan
    where the card can run it (None: the cluster path's shared memory
    does not fit)."""
    optin = gn._smem_optin(torch.device("cuda", 0))
    plan = gn._gn_plan(b, hw, c, dt, mode, backward, optin, GN_GROUPS)
    other = "two_pass" if plan.path == "cluster" else "cluster"
    try:
        return plan, gn._gn_plan(b, hw, c, dt, mode, backward, optin,
                                 GN_GROUPS, other)
    except ValueError:
        return plan, None


def phase_gn_kernels(torch, dev, seed):
    """K9 (fused GroupNorm forward) and K10 (its backward) against their
    plain versions, group 32, eps 1e-6, at every distinct GroupNorm site
    of ResNet50 at batch 128 and 128 px in bf16, in each mode the site
    shape takes (GN_SITE_SHAPES), plus the layer1 tail in f32 and the
    224 px stem's 12544 x 64 slab (6.4 MB of f32 a sample, over tpudist's
    2 MB switch); in bf16, x has a mean of its own in each channel.  K10
    and its plain version take K9's mean and rstd, as the autograd
    backward does.  Each kernel runs the planner's path (_gn_plan), which
    must be the cluster path at every site shape in bf16 and the two-pass
    path at the stem and the f32 tail, and is checked to have run it
    (LAST_PATH); a second call is bitwise equal to the first.  The
    other path, forced, is held and timed beside it where the card can
    run it.  Limits: bf16 y within O_ATOL + O_RTOL * |plain|, dx, dres,
    dscale, dbias by grad_ratio, mean and rstd within GN_STAT_RTOL of
    their max; f32 every output within GN_F32_REL of its tensor's max.
    Times: the wrappers (K10's includes its sum of the per-sample
    partials), the plain versions, and the library yardstick
    F.relu(F.group_norm(x, 32, w, b, 1e-6) [+ res]) on the channels_last
    view (forward; its autograd backward as fwd+bwd minus fwd).  Returns
    the rows."""
    import torch.nn.functional as F

    from tpudist_torch.ops import group_norm as gn

    g = torch.Generator(device=dev).manual_seed(seed + 12)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    bf = torch.bfloat16
    cases = [(f"{hw}x{c}_{mode}", RESNET_BATCH, hw, c, mode, bf)
             for (hw, c), modes in GN_SITE_SHAPES for mode in modes]
    cases += [("1024x256_add_relu_f32", 32, 1024, 256, "add_relu",
               torch.float32),
              ("224px_stem_12544x64_relu", 64, 12544, 64, "relu", bf)]
    rows = []
    for case, B, HW, C, mode, dt in cases:
        h = int(round(HW ** 0.5))
        res, dy = (torch.randn(B, h, h, C, generator=g, device=dev).to(dt)
                   for _ in range(2))
        # bf16: a mean of its own in each channel, as a conv's output has
        # (so the variance's mean² term matters)
        x = torch.randn(B, h, h, C, generator=g, device=dev)
        if dt == bf:
            x += torch.randn(C, generator=g, device=dev)
        x = x.to(dt)
        scale = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
        bias = 0.1 * torch.randn(C, generator=g, device=dev)
        r = res if mode == "add_relu" else None
        plans = {k: gn_paths(gn, torch, B, HW, C, mode, dt, bw)
                 for k, bw in (("K9", False), ("K10", True))}
        # the stem's and the f32 tail's x exceed 64 KB a CTA of 8
        want = dict.fromkeys(plans, "two_pass" if case.startswith("224px")
                             or dt == torch.float32 else "cluster")
        check(all(plans[k][0].path == want[k] for k in plans),
              f"kernels_gn {case}: planned paths "
              f"{ {k: p[0].path for k, p in plans.items()} }, want {want}")

        def flat(t):
            return None if t is None else t.reshape(B, HW, C)

        def fwd(path=None):
            return gn._fused_call_fwd(x, scale, bias, r, GN_GROUPS, GN_EPS,
                                      mode, path)

        y, mean, rstd = fwd()
        check(gn.LAST_PATH["K9"] == want["K9"],
              f"kernels_gn {case}: K9 ran {gn.LAST_PATH['K9']}")

        def bwd(path=None):
            return gn._fused_call_bwd(x, dy, scale, bias, mean, rstd, r,
                                      GN_GROUPS, mode, path)

        def plain_fwd():
            return gn._fused_fwd_plain(flat(x), scale, bias, flat(r),
                                       GN_GROUPS, GN_EPS, mode)

        def plain_bwd():
            return gn._fused_bwd_plain(flat(x), flat(dy), scale, bias, mean,
                                       rstd, flat(r), GN_GROUPS, mode)

        dx, dscale, dbias, dres = bwd()
        check(gn.LAST_PATH["K10"] == want["K10"],
              f"kernels_gn {case}: K10 ran {gn.LAST_PATH['K10']}")
        y2, mean2, rstd2 = fwd()
        again = bwd()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, e) for a, e in zip(
            (y2, mean2, rstd2) + tuple(t for t in again if t is not None),
            (y, mean, rstd) + tuple(t for t in (dx, dscale, dbias, dres)
                                    if t is not None)))
        check(bitwise, f"kernels_gn {case}: a second call is not bitwise "
              f"equal to the first")
        del y2, mean2, rstd2, again
        py, pmean, prstd = plain_fwd()
        pdx, pds, pdb, pdres = plain_bwd()
        torch.cuda.synchronize()

        def held(outs, label):
            """(errors, ratios, statistics' error) of one path's outputs
            against the plain versions; fails past the limits."""
            (y, mean, rstd), (dx, dscale, dbias, dres) = outs
            pairs = {"y": (y, py), "dx": (dx, pdx),
                     "dscale": (dscale, pds.sum(0)),
                     "dbias": (dbias, pdb.sum(0))}
            if mode == "add_relu":
                pairs["dres"] = (dres, pdres)
            errs = {n: (a.float().reshape(-1) - e.float().reshape(-1)).abs()
                    .max().item() for n, (a, e) in pairs.items()}
            stat_err = max(((a - e).abs().max() / e.abs().max()).item()
                           for a, e in ((mean, pmean), (rstd, prstd)))
            if dt == torch.float32:
                ratios = {n: errs[n] / (GN_F32_REL
                                        * e.float().abs().max().item())
                          for n, (_, e) in pairs.items()}
            else:
                ratios = {n: (o_ratio(a.reshape(e.shape), e) if n == "y"
                              else grad_ratio(a.reshape(e.shape), e))
                          for n, (a, e) in pairs.items()}
            check(max(ratios.values()) <= 1.0 and stat_err <= GN_STAT_RTOL,
                  f"K9/K10 ({label}) disagree with their plain versions "
                  f"({case}): ratios {ratios}, statistics {stat_err}")
            return errs, ratios, stat_err

        errs, ratios, stat_err = held(((y, mean, rstd),
                                       (dx, dscale, dbias, dres)), "planned")
        worst = max(ratios.values())
        # the library yardstick on the channels_last (NCHW) view
        xl, rl, dyl = (None if t is None else t.permute(0, 3, 1, 2)
                       for t in (x, r, dy))
        xg = xl.detach().requires_grad_()
        wg, bg = (t.detach().to(dt).clone().requires_grad_()
                  for t in (scale, bias))
        rg = None if rl is None else rl.detach().requires_grad_()

        def lib_fwd():
            out = F.group_norm(xg, GN_GROUPS, wg, bg, GN_EPS)
            if rg is not None:
                out = out + rg
            return out if mode == "plain" else F.relu(out)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), [t for t in (xg, wg, bg, rg)
                                            if t is not None], dyl)

        lib_f = timed_ms(lib_fwd, 10, flush)
        es = x.element_size()
        bounds = {"K9": gn_bound(B, HW, C, mode, es, False),
                  "K10": gn_bound(B, HW, C, mode, es, True)}
        # the other path, forced: held to the same limits and timed
        other = {k: p[1].path for k, p in plans.items() if p[1] is not None}
        other_ratio = None
        if other:
            f_path, b_path = other.get("K9"), other.get("K10")
            outs = (fwd(f_path) if f_path else (y, mean, rstd),
                    bwd(b_path) if b_path else (dx, dscale, dbias, dres))
            torch.cuda.synchronize()
            other_ratio = max(held(outs, "other path")[1].values())
            del outs
        lib_b = timed_ms(lib_fwd_bwd, 10, flush) - lib_f
        row = {"case": case, "shape": [B, h, h, C], "mode": mode,
               "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": max(errs.values()), "tol_ratio": worst,
               "other_path_tol_ratio": other_ratio,
               "errors": errs, "ratios": ratios, "stat_rel_err": stat_err,
               "bitwise_repeat": bitwise}
        for k, run, prun, lib in (("K9", fwd, plain_fwd, lib_f),
                                  ("K10", bwd, plain_bwd, lib_b)):
            plan, alt = plans[k]
            ms = timed_ms(run, 10, flush)
            row[k] = {"ms": ms, "plain_ms": timed_ms(prun, 3, flush),
                      "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                      "share_of_bound": bounds[k][0] / ms,
                      "library_ms": lib, "path": plan.path,
                      "cluster": plan.parts if plan.path == "cluster"
                      else None,
                      "parts": plan.parts, "threads": plan.threads,
                      "smem": plan.smem}
            if alt is not None:
                row[k]["other"] = {
                    "path": alt.path, "parts": alt.parts,
                    "ms": timed_ms(lambda: run(alt.path), 10, flush)}
        rows.append(row)
        del x, res, dy, y, dx, dres, py, pdx, pdres, xg, rg
    del flush_buf
    torch.cuda.empty_cache()
    emit({"phase": "kernels_gn", "cases": rows,
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "grad_atol_rel": GRAD_ATOL_REL,
                        "grad_rtol": GRAD_RTOL, "stat_rtol": GN_STAT_RTOL,
                        "f32_rel_to_max": GN_F32_REL}})
    return rows


def flax_resnet_tree(np, rng, num_classes: int) -> dict:
    """A ResNet50 parameter tree as flax lays it out (HWIO conv kernels,
    ``[in, out]`` Dense kernel, GroupNorm ``scale``/``bias``), drawn from
    ``rng``: kernels normal of std 1/sqrt(fan_in), scales near 1, biases
    near 0 — the input of ``from_flax_resnet_params``."""
    from tpudist_torch.models.resnet import _block_plan

    def conv(k, cin, cout):
        return {"kernel": (rng.standard_normal((k, k, cin, cout))
                           / np.sqrt(k * k * cin)).astype(np.float32)}

    def norm(c):
        return {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(
                    np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}

    tree = {"ResNetStem_0": {"Conv_0": conv(7, 3, 64),
                             "GroupNorm_0": norm(64)}}
    cin = 64
    for i, b in enumerate(_block_plan()):
        f, out = b.features, 4 * b.features
        blk = {"Conv_0": conv(1, cin, f), "GroupNorm_0": norm(f),
               "Conv_1": conv(3, f, f), "GroupNorm_1": norm(f),
               "Conv_2": conv(1, f, out), "GroupNorm_2": norm(out)}
        if cin != out or b.strides != 1:
            blk.update(Conv_3=conv(1, cin, out), GroupNorm_3=norm(out))
        tree[f"Bottleneck_{i}"] = blk
        cin = out
    tree["ResNetHead_0"] = {"Dense_0": {
        "kernel": (rng.standard_normal((cin, num_classes))
                   / np.sqrt(cin)).astype(np.float32),
        "bias": np.zeros(num_classes, np.float32)}}
    return {"params": {"ResNetSegment_0": tree}}


def resnet_loss_fn(torch):
    """The sweep's loss: softmax cross-entropy over the classes, f32."""
    from tpudist_torch.ops.losses import cross_entropy

    def loss_fn(model, batch, _gen):
        images, labels = batch
        return cross_entropy(model(images), labels), {}

    return loss_fn


def rel_l2(got, want) -> float:
    """||got − want|| / ||want|| in f64 (0 for two zero tensors)."""
    num = float((got.double() - want.double()).norm())
    den = float(want.double().norm())
    return num / den if den else (0.0 if num == 0.0 else float("inf"))


class ReplayBranches:
    """``torch.nn.functional`` as ``models/resnet.py`` calls it, with the
    model's discrete choices — each ReLU's mask and the stem max-pool's
    argmax, in call order — recorded (``record()``) on one evaluation and
    replayed (``replay()``) on another, so that two evaluations of one
    model differ only by rounding.  A replay counts the choices it
    overrode (``flips``: a ReLU input of the other sign, or a pooled
    value other than the evaluation's own maximum) out of ``choices``."""

    def __init__(self, torch):
        import torch.nn.functional as F

        self.torch, self.F = torch, F
        self.tape, self.at, self.replaying = [], 0, False
        self.flips = self.choices = 0

    def __getattr__(self, name):
        return getattr(self.F, name)

    def record(self):
        self.tape, self.replaying = [], False

    def replay(self):
        self.at, self.replaying, self.flips, self.choices = 0, True, 0, 0

    def _next(self, device):
        self.at += 1
        return self.tape[self.at - 1].to(device)

    def relu(self, x):
        if not self.replaying:
            self.tape.append((x > 0).cpu())
            return self.F.relu(x)
        keep = self._next(x.device)
        self.flips += int(((x > 0) != keep).sum())
        self.choices += keep.numel()
        return self.torch.where(keep, x, self.torch.zeros_like(x))

    def max_pool2d(self, x, k, s, padding=0):
        y, idx = self.F.max_pool2d(x, k, s, padding=padding,
                                   return_indices=True)
        if not self.replaying:
            self.tape.append(idx.cpu())
            return y
        idx = self._next(x.device)
        forced = x.flatten(2).gather(2, idx.flatten(2)).view_as(idx)
        self.flips += int((forced != y).sum())
        self.choices += idx.numel()
        return forced


def phase_resnet_parity(torch, dev, seed):
    """The model and converter on the card: full-width ResNet50 (16
    blocks, 1000 classes, norm="group") in f32 with TF32 off (cuDNN and
    cuBLAS, restored after), batch 4 at 64 px, from one flax-layout tree
    of seeded weights through from_flax_resnet_params and one
    synthetic_images batch: 3 SGD steps (lr RESNET_PARITY_LR) through
    make_dp_train_step on the CPU in f32, on the card and on the CPU in
    f64 (statistics, head and loss in f64 too).  Before each step the
    card and f64 models take the CPU model's weights and replay its
    ReLU masks and max-pool argmax (ReplayBranches), so each step
    compares one gradient at equal weights and equal choices; the card
    may differ from the CPU's choices in at most RESNET_FLIP_SHARE of
    them.  The loss within
    RESNET_LOSS_RTOL; each parameter's gradient within RESNET_NOISE_FACTOR
    times that tensor's CPU f32-to-f64 distance, or RESNET_GRAD_FLOOR
    where that is larger; and after each step the card's weights,
    updated by its own SGD, against the CPU's: apart by at most lr times
    the gradients' allowed distance plus one f32 rounding of each
    update."""
    import numpy as np

    from tpudist_torch.data import synthetic_images
    from tpudist_torch.models import ResNet50, from_flax_resnet_params
    from tpudist_torch.models import resnet
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, sgd

    branches, functional = ReplayBranches(torch), resnet.F
    resnet.F = branches
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = from_flax_resnet_params(flax_resnet_tree(
        np, np.random.default_rng(seed + 13), 1000))
    x, onehot = synthetic_images(4, hw=64, seed=seed)
    labels = onehot.argmax(-1)
    cpu, lr = torch.device("cpu"), RESNET_PARITY_LR
    models, states, batches = {}, {}, {}
    for where, d, dt in (("cuda", dev, torch.float32),
                         ("cpu", cpu, torch.float32),
                         ("cpu_f64", cpu, torch.float64)):
        models[where] = ResNet50(compute_dtype=dt, device=d)
        models[where].load_state_dict(sd)
        states[where] = TrainState.create(models[where], sgd(lr), seed=seed)
        batches[where] = (torch.from_numpy(x).to(d, dt),
                          torch.from_numpy(labels).to(d))
    step = make_dp_train_step(resnet_loss_fn(torch))
    rows = []
    for i in range(3):
        weights = {k: v.clone() for k, v in models["cpu"].state_dict().items()}
        models["cuda"].load_state_dict(weights)
        models["cpu_f64"].load_state_dict(weights)
        out, flips = {}, {}
        for where in ("cpu", "cuda", "cpu_f64"):
            if where == "cpu":
                branches.record()
            else:
                branches.replay()
            states[where], m = step(states[where], *batches[where])
            flips[where] = branches.flips / max(branches.choices, 1)
            out[where] = (float(m["loss"]),
                          {n: p.grad.detach().cpu().clone()
                           for n, p in models[where].named_parameters()},
                          {n: p.detach().cpu().clone()
                           for n, p in models[where].named_parameters()})
        (lc, gc, wc), (lh, gh, wh), (l64, g64, _) = (
            out[k] for k in ("cuda", "cpu", "cpu_f64"))
        grad, weight = [], []
        for n in gh:
            noise = rel_l2(gh[n], g64[n])
            limit = max(RESNET_NOISE_FACTOR * noise, RESNET_GRAD_FLOOR)
            got = rel_l2(gc[n], gh[n])
            grad.append((got / limit, n, got, noise, rel_l2(gc[n], g64[n]),
                         limit))
            # each model rounds w − lr·g once (half an ulp of the new
            # weight each), after lr·g's own rounding
            w = wh[n].abs()
            slack = ((torch.nextafter(w, torch.full_like(w, np.inf)) - w)
                     .double() + 2.0 ** -23 * lr * (gc[n].double().abs()
                                                    + gh[n].double().abs()))
            allowed = (lr * limit * float(gh[n].double().norm())
                       + float(slack.norm()))
            weight.append((float((wc[n].double() - wh[n].double()).norm())
                           / allowed, n))
        worst = max(grad)
        row = {"step": i, "loss_cuda": lc, "loss_cpu": lh, "loss_f64": l64,
               "loss_rel_err": abs(lc - lh) / abs(lh),
               "grad_worst_ratio": worst[0], "grad_worst_param": worst[1],
               "grad_worst_rel_l2": worst[2],
               "grad_worst_cpu_f32_vs_f64": worst[3],
               "grad_worst_cuda_vs_f64": worst[4],
               "grad_max_rel_l2": max(g[2] for g in grad),
               "cpu_f32_vs_f64_range": [min(g[3] for g in grad),
                                        max(g[3] for g in grad)],
               "grad_tensors_at_floor": sum(
                   1 for g in grad
                   if RESNET_NOISE_FACTOR * g[3] < RESNET_GRAD_FLOOR),
               "weights_worst_ratio": max(weight)[0],
               "weights_worst_param": max(weight)[1],
               "choices": branches.choices,
               "flip_share_cuda": flips["cuda"],
               "flip_share_f64": flips["cpu_f64"]}
        rows.append(row)
        check(np.isfinite(lc) and row["loss_rel_err"] <= RESNET_LOSS_RTOL,
              f"resnet_parity: step {i} card loss {lc} vs CPU {lh}")
        check(flips["cuda"] <= RESNET_FLIP_SHARE,
              f"resnet_parity: step {i} the card's own ReLU masks and "
              f"max-pool choices differ from the CPU's in {flips['cuda']} "
              f"of them")
        for ratio, n, got, _, _, limit in grad:
            check(ratio <= 1.0, f"resnet_parity: step {i} {n} gradient "
                  f"{got} apart, limit {limit}")
        for ratio, n in weight:
            check(ratio <= 1.0,
                  f"resnet_parity: step {i} {n} weights after the step "
                  f"{ratio} of their allowed distance from the CPU's")
    del models, states
    resnet.F = functional
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    torch.cuda.empty_cache()
    emit({"phase": "resnet_parity", "steps": rows,
          "tolerance": {"loss_rtol": RESNET_LOSS_RTOL,
                        "noise_factor": RESNET_NOISE_FACTOR,
                        "grad_floor": RESNET_GRAD_FLOOR,
                        "flip_share": RESNET_FLIP_SHARE}})


def resnet_train_setup(torch, dev, seed):
    """The train_resnet cell: ResNet50 (norm="group", bf16 compute, f32
    parameters) from seeded weights, and one synthetic_images batch of 128
    at 128 px with its integer labels, on the card."""
    from tpudist_torch.data import synthetic_images
    from tpudist_torch.models import ResNet50

    model = ResNet50(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed + 14))
    x, onehot = synthetic_images(RESNET_BATCH, hw=RESNET_HW, seed=seed)
    return (model, torch.from_numpy(x).to(dev),
            torch.from_numpy(onehot.argmax(-1)).to(dev))


def gn_site_inputs(torch, model, images, labels) -> list:
    """One forward and backward of ``model`` on the batch, recording each
    GroupNorm site as the step produced it: ``(name, mode, x, residual,
    scale, bias)``.  A Bottleneck's norm0 and norm1 and the stem's norm
    are ReLU sites, norm2 the tail relu(norm2(y) + residual) (residual =
    the block input, or norm3's output where the block projects), norm3
    the projection (plain)."""
    from tpudist_torch.models.resnet import Bottleneck
    from tpudist_torch.ops.group_norm import GroupNorm
    from tpudist_torch.ops.losses import cross_entropy

    seen, proj_out, block_in, hooks = {}, {}, {}, []

    def on_norm(name):
        def hook(mod, args, out):
            seen[name] = args[0].detach()
            if name.endswith("norm3"):
                proj_out[name] = out.detach()
        return hook

    def on_block(name):
        def hook(mod, args):
            block_in[name] = args[0].detach()
        return hook

    for name, m in model.named_modules():
        if isinstance(m, GroupNorm):
            hooks.append(m.register_forward_hook(on_norm(name)))
        elif isinstance(m, Bottleneck):
            hooks.append(m.register_forward_pre_hook(on_block(name)))
    cross_entropy(model(images), labels).backward()
    for hk in hooks:
        hk.remove()
    model.zero_grad(set_to_none=True)
    sites = []
    for name, x in seen.items():
        block, _, norm = name.rpartition(".")
        mode, res = "relu", None
        if norm == "norm2":
            mode = "add_relu"
            res = proj_out.get(block + ".norm3", block_in.get(block))
        elif norm == "norm3":
            mode = "plain"
        mod = model.get_submodule(name)
        sites.append((name, mode, x, res, mod.scale.detach(),
                      mod.bias.detach()))
    return sites


def gn_site_paths(torch, dev, mode, x, res, scale, bias):
    """One GroupNorm site's two paths: ``(fused, closed_form, wrt)``.
    ``fused()`` is the fused op in bf16 — GroupNorm(fused="relu" |
    "add_relu") with the site's parameters, or group_norm_act(mode=
    "plain") at a projection; ``closed_form(dt)`` the closed form
    (GroupNorm(fused="none"), then the site's add and ReLU; without the
    ReLU for ``act=False``) in dtype ``dt`` on the site's inputs cast to
    it; ``wrt(path)`` the tensors each
    takes gradients of (x, the residual, scale, bias), ``path`` being
    "fused" or a dtype."""
    import torch.nn.functional as F

    from tpudist_torch.ops import group_norm as gn

    bf, c = torch.bfloat16, x.shape[-1]

    def module(fused, dtype):
        m = gn.GroupNorm(c, GN_GROUPS, GN_EPS, dtype=dtype, fused=fused,
                         device=dev)
        with torch.no_grad():
            m.scale.copy_(scale)
            m.bias.copy_(bias)
        return m

    mods = {"fused": module("none" if mode == "plain" else mode, bf),
            bf: module("none", bf), torch.float32: module("none",
                                                          torch.float32)}
    ins = (x,) if res is None else (x, res)
    leaves = {k: [t.to(bf if k == "fused" else k).detach().requires_grad_()
                  for t in ins] for k in mods}

    def fused():
        m, xs = mods["fused"], leaves["fused"]
        if mode == "plain":
            return gn.group_norm_act(xs[0], m.scale, m.bias, GN_GROUPS,
                                     GN_EPS, "plain")
        return m(*xs)

    def closed_form(dt, act=True):
        xs = leaves[dt]
        y = mods[dt](xs[0])
        if mode == "add_relu":
            y = xs[1] + y
        return y if mode == "plain" or not act else F.relu(y)

    def wrt(path):
        return leaves[path] + [mods[path].scale, mods[path].bias]

    return fused, closed_form, wrt


def gn_site_flips(torch, mode, x, res, scale, bias):
    """K9's statistics and ReLU mask against the closed form's at one
    site: ``(flipped, stat_ratio, flip_ulps)``.  ``stat_ratio`` is K9's
    worst mean or rstd error over GN_STAT_RTOL of that statistic's max
    (a K9 launch made for this comparison).  ``flipped`` marks the
    elements whose masks differ: K9's, from its statistics through the
    expression K9 and K10 share, against the closed form's, from its f32
    pre-activation.  The closed form's pre-activation there lies within
    what the two paths' statistics move it by, ``|γ|·(|x − mean|·|Δrstd|
    + rstd·|Δmean|)``, of 0; ``flip_ulps`` is the largest, in f32 ulps of
    the terms it is computed from, ``(|x| + |mean|)·rstd·|γ| + |β| +
    |res|``.  A plain site has no mask."""
    from tpudist_torch.ops import group_norm as gn

    def per_c(v):
        return gn._expand(v, x.shape, GN_GROUPS)

    x32 = x.float()
    res32 = None if res is None else res.float()
    g32, b32 = scale.float(), bias.float()
    mean, rstd = gn._stats(x32, GN_GROUPS, GN_EPS)
    _, mean_k, rstd_k = gn._fused_call_fwd(x, scale, bias, res, GN_GROUPS,
                                           GN_EPS, mode)
    stat_ratio = max(((k - v).abs().max() / (GN_STAT_RTOL * v.abs().max())
                      ).item() for k, v in ((mean_k, mean), (rstd_k, rstd)))
    if mode == "plain":
        return (torch.zeros(x.shape, dtype=torch.bool, device=x.device),
                stat_ratio, 0.0)
    xhat, pre = gn._pre_activation(x32, per_c(mean), per_c(rstd), g32, b32,
                                   res32)
    flipped = (pre > 0) != (gn._pre_activation(
        x32, per_c(mean_k), per_c(rstd_k), g32, b32, res32)[1] > 0)
    if not bool(flipped.any()):
        return flipped, stat_ratio, 0.0
    ulp = 2.0 ** -23 * ((x32.abs() + per_c(mean.abs())) * per_c(rstd)
                        * g32.abs() + b32.abs()
                        + (0.0 if res32 is None else res32.abs()))
    ulps = torch.where(pre == 0, 0.0, pre.abs() / ulp)
    return flipped, stat_ratio, ulps[flipped].max().item()


def gn_sites_check(torch, dev, seed):
    """The correctness half of gn_sites: the 53 sites of one train_resnet
    step, the fused op forward and backward at each with launch counts
    reset just before and read just after (K9 = K10 = 53, each on the path
    the planner gives its site: the cluster path at every site), held
    against the closed form in f32.  Returns ``(sites, launches,
    checks)``; ``launches["by_path"]`` gives K9's and K10's launches by
    path.

    ``y`` within O_ATOL + O_RTOL·|closed form|; K9's mean and rstd within
    GN_STAT_RTOL of their max.  Every gradient element within
    grad_ratio's limit, except where the two paths' ReLU masks differ
    (gn_site_flips: at a pre-activation that the statistics' difference
    carries across 0), at most GN_SITE_FLIP of them: such an element
    takes or drops a whole dy in dx and dres.  A flip moves a channel's
    dscale and dbias by one term of B·H·W, so they are held everywhere,
    as is every gradient of a plain site."""
    model, images, labels = resnet_train_setup(torch, dev, seed)
    sites = gn_site_inputs(torch, model, images, labels)
    del model, images
    torch.cuda.empty_cache()
    counts = {m: sum(1 for s in sites if s[1] == m)
              for m in ("relu", "add_relu", "plain")}
    check(len(sites) == 53 and counts == {"relu": 33, "add_relu": 16,
                                          "plain": 4},
          f"gn_sites: {len(sites)} sites, modes {counts}")
    from tpudist_torch.ops import group_norm as gn

    # the paths the planner gives each site's K9 and K10
    want_paths = {k: dict.fromkeys(gn.PATHS, 0) for k in ("K9", "K10")}
    for _, mode, x, *_ in sites:
        b, hh, ww, c = x.shape
        for k, bw in (("K9", False), ("K10", True)):
            plan = gn._gn_plan(b, hh * ww, c, torch.bfloat16, mode, bw,
                               gn._smem_optin(x.device), GN_GROUPS)
            want_paths[k][plan.path] += 1
    g = torch.Generator(device=dev).manual_seed(seed + 15)
    reset_launches()
    results = []
    for name, mode, x, res, scale, bias in sites:
        fused, closed_form, wrt = gn_site_paths(torch, dev, mode, x, res,
                                                scale, bias)
        dy = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
        y = fused()
        grads = torch.autograd.grad(y, wrt("fused"), dy)
        y32 = closed_form(torch.float32)
        want = torch.autograd.grad(y32, wrt(torch.float32), dy.float())
        results.append((name, mode, y, grads, y32, want))
    torch.cuda.synchronize()
    launches = read_launches()
    paths = {k: dict(v) for k, v in gn.PATH_LAUNCHES.items()}
    check(launches["K9"] == launches["K10"] == 53,
          f"gn_sites: launches {launches}, want 53 of K9 and K10")
    check(paths == want_paths and want_paths["K9"]["cluster"]
          == want_paths["K10"]["cluster"] == 53,
          f"gn_sites: launches by path {paths}, planned {want_paths}; "
          f"every site takes the cluster path")
    launches["by_path"] = paths
    checks = []
    for (name, mode, y, grads, y32, want), site in zip(results, sites):
        with torch.no_grad():
            flipped, stat_ratio, flip_ulps = gn_site_flips(
                torch, mode, *site[2:])
        row = {"site": name, "mode": mode, "y_ratio": o_ratio(y, y32),
               "grad_ratio_held": 0.0, "beyond_share": 0.0,
               "stat_ratio": stat_ratio, "flips": int(flipped.sum()),
               "flip_ulps": flip_ulps}
        gnames = (["dx", "dres"] if mode == "add_relu" else ["dx"]) \
            + ["dscale", "dbias"]
        for gname, a, e in zip(gnames, grads, want):
            a, e = a.float(), e.float()
            lim = GRAD_ATOL_REL * e.abs().max() + GRAD_RTOL * e.abs()
            ratio = (a - e).abs() / lim
            may_flip = flipped if gname in ("dx", "dres") \
                else torch.zeros_like(ratio, dtype=torch.bool)
            over = ratio > 1.0
            share = over.float().mean().item()
            held = ratio.masked_fill(may_flip, 0.0).max().item()
            row["grad_ratio_held"] = max(row["grad_ratio_held"], held)
            row["beyond_share"] = max(row["beyond_share"], share)
            check(held <= 1.0,
                  f"gn_sites: {name} ({mode}) {gname}: ratio {held} where "
                  f"the ReLU masks agree")
            check(share <= GN_SITE_FLIP,
                  f"gn_sites: {name} ({mode}) {gname}: {share} of the "
                  f"elements beyond the limit (allowed {GN_SITE_FLIP})")
        check(stat_ratio <= 1.0,
              f"gn_sites: {name} ({mode}): K9's statistics {stat_ratio} "
              f"of their limit from the closed form's")
        check(row["y_ratio"] <= 1.0,
              f"gn_sites: {name} ({mode}) y ratio {row['y_ratio']}")
        checks.append(row)
    del results
    torch.cuda.empty_cache()
    return sites, launches, checks


def phase_gn_sites(torch, dev, seed):
    """The fused path at every one of ResNet50's 53 GroupNorm sites, on
    the activations the train_resnet cell's step produces (batch 128, 128
    px, bf16; gn_site_inputs) and a seeded bf16 dy at each
    (gn_sites_check): y within O_ATOL + O_RTOL * |closed form in f32|,
    each gradient by grad_ratio's limit but at ReLU mask flips within
    rounding of 0, K9 = K10 = 53 launches.  Then both paths as the model would
    run them in bf16, timed per site (forward, and forward + backward) and
    summed over the sites beside the summed bound."""
    sites, launches, checks = gn_sites_check(torch, dev, seed)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed + 16)
    totals, by_mode, per_site = {}, {}, []
    for (name, mode, x, res, scale, bias), chk in zip(sites, checks):
        fused, closed_form, wrt = gn_site_paths(torch, dev, mode, x, res,
                                                scale, bias)
        dy = torch.randn(x.shape, generator=g, device=dev).to(bf)
        b, hh, ww, c = x.shape
        bound_fwd = gn_bound(b, hh * ww, c, mode, 2, False)[0]
        t = {"fused_fwd_ms": timed_ms(no_grad(fused), 5, flush),
             "fused_fwd_bwd_ms": timed_ms(lambda: torch.autograd.grad(
                 fused(), wrt("fused"), dy), 5, flush),
             "closed_fwd_ms": timed_ms(no_grad(lambda: closed_form(bf)), 5,
                                       flush),
             "closed_fwd_bwd_ms": timed_ms(lambda: torch.autograd.grad(
                 closed_form(bf), wrt(bf), dy), 5, flush),
             "bound_fwd_ms": bound_fwd,
             "bound_fwd_bwd_ms": bound_fwd + gn_bound(b, hh * ww, c, mode, 2,
                                                      True)[0]}
        for k, v in t.items():
            totals[k] = totals.get(k, 0.0) + v
            by_mode.setdefault(mode, {})[k] = by_mode.get(mode, {}).get(
                k, 0.0) + v
        per_site.append({**chk, "shape": list(x.shape), **t})
    del flush_buf, sites
    torch.cuda.empty_cache()
    emit({"phase": "gn_sites", "sites": len(per_site), "launches": launches,
          "worst_y_ratio": max(c["y_ratio"] for c in checks),
          "worst_grad_ratio_held": max(c["grad_ratio_held"]
                                       for c in checks),
          "worst_stat_ratio": max(c["stat_ratio"] for c in checks),
          "flips": sum(c["flips"] for c in checks),
          "worst_flip_ulps": max(c["flip_ulps"] for c in checks),
          "worst_beyond_share": max(c["beyond_share"] for c in checks),
          **totals, "by_mode": by_mode,
          "fused_over_closed_fwd": totals["fused_fwd_ms"]
          / totals["closed_fwd_ms"],
          "fused_over_closed_fwd_bwd": totals["fused_fwd_bwd_ms"]
          / totals["closed_fwd_bwd_ms"],
          "per_site": per_site,
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "grad_atol_rel": GRAD_ATOL_REL,
                        "grad_rtol": GRAD_RTOL,
                        "share_beyond": GN_SITE_FLIP,
                        "stat_rtol": GN_STAT_RTOL}})
    return launches, per_site


def resnet_forward_flops(torch, model, images) -> float:
    """Forward FLOPs of ``model`` on ``images`` from its conv and dense
    shapes: 2 per multiply-add (output elements × fan-in)."""
    from tpudist_torch.models.resnet import Conv, ResNetHead

    total = [0.0]

    def count(fan_in):
        def hook(mod, args, out):
            total[0] += 2.0 * out.numel() * fan_in(mod)
        return hook

    hooks = []
    for m in model.modules():
        if isinstance(m, Conv):
            hooks.append(m.register_forward_hook(
                count(lambda mod: mod.weight[0].numel())))
        elif isinstance(m, ResNetHead):
            hooks.append(m.register_forward_hook(
                count(lambda mod: mod.fc.in_features)))
    with torch.no_grad():
        model(images)
    for hk in hooks:
        hk.remove()
    return total[0]


def resnet_family(name: str) -> str:
    """The train_resnet profile's grouping of device kernels by name."""
    for family, keys in (
            ("layout copies", ("nchwToNhwc", "nhwcToNchw", "nchw2nhwc",
                               "nhwc2nchw", "NchwToNhwc", "NhwcToNchw")),
            ("fused GroupNorm (K9, K10)", ("gn_fwd", "gn_bwd")),
            ("conv", ("conv", "xmma", "cudnn", "implicit", "fprop", "dgrad",
                      "wgrad", "gemm", "nvjet", "cutlass", "sm90_")),
            ("SGD", ("multi_tensor", "sgd")),
            ("pooling", ("pool",)),
            ("reductions", ("reduce_kernel",)),
            ("copies and casts", ("copy",))):
        if any(k in name for k in keys):
            return family
    return "norm and activation elementwise"


def phase_train_resnet(torch, dev, seed):
    """scripts/resnet_mfu_sweep.py's b128_128px_gn_train cell on the port:
    ResNet50, norm="group" (the closed form, as tpudist builds it), bf16
    compute and f32 parameters, sgd(0.05), cross-entropy over 1000
    classes, batch 128 at 128 px, one synthetic_images batch from --seed
    repeated; 2 warm-up steps, then 20 through make_dp_train_step with
    launch counts reset just before and read just after (the ResNet runs
    no port kernel: K9 = K10 = 0), the loss falling; ms per step,
    images/s, model FLOPs (3x the forward's, from the conv and dense
    shapes) and their share of the bf16 peak, peak memory; then one step
    under torch.profiler by kernel family, with no layout copy."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, sgd

    model, images, labels = resnet_train_setup(torch, dev, seed)
    flops = 3.0 * resnet_forward_flops(torch, model, images)
    state = TrainState.create(model, sgd(0.05), seed=seed)
    step = make_dp_train_step(resnet_loss_fn(torch))
    for _ in range(2):                 # warm-up: cuDNN plans, allocator
        state, _ = step(state, images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        state, m = step(state, images, labels)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"train_resnet: non-finite loss "
                                    f"{losses}")
    check(losses[-1] < losses[0],
          f"train_resnet: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(not any(launches.values()),
          f"train_resnet: the closed-form ResNet launched {launches}")
    ms = wall / RESNET_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, images, labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, images, labels)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, "train_resnet: the profiler saw no device time")
    families, counts = {}, {}
    for k, t, n in rows:
        fam = resnet_family(k)
        families[fam] = families.get(fam, 0.0) + t
        counts[fam] = counts.get(fam, 0) + n
    layout = [k[:100] for k, _, _ in rows
              if resnet_family(k) == "layout copies"]
    emit({"phase": "train_resnet", "steps": RESNET_STEPS,
          "batch": RESNET_BATCH, "hw": RESNET_HW, "loss_first": losses[0],
          "loss_last": losses[-1], "losses": losses, "launches": launches,
          "wall_s": wall, "ms_per_step": ms,
          "images_per_s": RESNET_BATCH / (ms / 1e3),
          "model_flops_per_step": flops,
          "bf16_peak_share": flops / (ms / 1e3) / BF16_FLOPS,
          "max_memory_allocated_bytes": peak,
          "profile": {"step_wall_ms": step_ms, "device_ms": device_ms,
                      "device_busy_share": device_ms / step_ms,
                      "by_family_ms": families, "by_family_kernels": counts,
                      "layout_copy_kernels": layout,
                      "top": [{"kernel": k[:90], "ms": t, "count": n}
                              for k, t, n in rows[:16]]}})
    check(not layout, f"train_resnet: layout copies around the convs: "
                      f"{layout}")
    del model, state
    torch.cuda.empty_cache()
    return launches

# mnist_parity: the card (TF32 off) against the CPU, f32, 20 Adam steps of
# the MLP and the ConvNet from one converted tree on the same batches,
# the CPU's discrete choices (each ReLU's mask, each max-pool's argmax)
# replayed on the card and in f64 (ReplayBranches): one pre-activation
# within rounding of 0 on the other side of the ReLU moves a whole row of
# its layer's gradients by whole terms (``first_step_unreplayed`` reports
# the first step without the replay).  Each step's
# loss within MNIST_PARITY_RTOL of the CPU's plus one f32 ulp of the
# logits' scale (2^-23 times the mean over rows of max |logit|): a row's
# loss is lse − z_y, two f32 numbers of the logits' size, so once the
# MLP is sure of its rows (losses of 1e-6 against logits of ~10) the loss
# is resolved to that ulp and no finer.  The final parameters, each
# tensor's largest difference from the CPU's over the tensor's largest
# magnitude, within MNIST_PARITY_RTOL or MNIST_NOISE_FACTOR times the CPU
# f32's own distance from f64 under the same choices, whichever is
# larger: Adam's step m/(sqrt(v) + eps) is of size lr for every element
# whose gradient is well above eps = 1e-8 and g/eps·lr near it, so an
# element whose gradient is a few eps carries its f32 rounding into its
# step as a share of lr (``param_noise_max_rel``, the CPU's f32 against
# f64, is far above 1e-4 for the MLP).  The card's own choices may
# differ from the CPU's in at most MNIST_FLIP_SHARE of them.
MNIST_PARITY_RTOL = 1e-4
MNIST_NOISE_FACTOR = 10.0
MNIST_FLIP_SHARE = 1e-4
MNIST_PARITY_STEPS = 20
MNIST_BATCH = 128
MNIST_EPOCHS = 3
MNIST_ACCURACY = 0.9
CONVNET_EPOCHS = 15
CONVNET_ACCURACY = 0.90
HOROVOD_BATCH, HOROVOD_STEPS = 1024, 20


def flax_mlp_tree(np, rng, hidden: int, features: int) -> dict:
    """An MLP parameter tree as flax lays it out (``Dense_i`` with an
    ``[in, out]`` kernel of std 1/sqrt(fan_in) and a small bias): the
    input of ``from_flax_mlp_params``."""
    widths = [784] + [features] * (hidden + 1) + [10]
    return {f"Dense_{i}": {
        "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
            np.float32),
        "bias": (0.01 * rng.standard_normal(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}


def flax_convnet_tree(np, rng) -> dict:
    """A ConvNet tree as flax lays it out (HWIO conv kernels, ``[in,
    out]`` Dense kernels): the input of ``from_flax_convnet_params``."""
    def leaf(shape, fan_in):
        return {"kernel": (rng.standard_normal(shape) / np.sqrt(fan_in)
                           ).astype(np.float32),
                "bias": (0.01 * rng.standard_normal(shape[-1])).astype(
                    np.float32)}

    return {"Conv_0": leaf((5, 5, 1, 10), 25), "Conv_1": leaf((5, 5, 10, 20),
                                                              250),
            "Dense_0": leaf((320, 50), 320), "Dense_1": leaf((50, 10), 50)}


def mnist_loss_fn(train_kwargs=None, logit_scale: bool = False):
    """Cross-entropy of the model's logits; ``logit_scale`` adds the mean
    over rows of max |logit| as an aux metric (mnist_parity's loss
    floor)."""
    from tpudist_torch.ops.losses import cross_entropy

    kwargs = train_kwargs or {}

    def loss_fn(model, batch, generator):
        images, labels = batch
        logits = model(images, generator=generator, **kwargs)
        aux = ({"logit_scale": logits.detach().abs().amax(-1).mean()}
               if logit_scale else {})
        return cross_entropy(logits, labels), aux

    return loss_fn


def profiled_steps(torch, run, steps: int, family=None) -> dict:
    """``run(steps)`` under torch.profiler, host clock around it ending in
    a synchronise: the wall ms, the device ms (every kernel and copy) and
    the device's busy share, with the kernels that take its time (and,
    given ``family(kernel name)``, the device ms by family)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, "the profiler saw no device time")
    out = {"steps": steps, "wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms,
           "top": [{"kernel": k[:80], "ms": t, "count": n}
                   for k, t, n in rows[:8]]}
    if family is not None:
        by = {}
        for k, t, _ in rows:
            by[family(k)] = by.get(family(k), 0.0) + t
        out["by_family_ms"] = dict(sorted(by.items(), key=lambda kv: -kv[1]))
    return out


def max_rel(got: dict, want: dict) -> dict:
    """Each tensor's largest |got − want| over its largest |want|."""
    return {k: float((got[k].double() - want[k].double()).abs().max()
                     / want[k].double().abs().max().clamp_min(1e-300))
            for k in want}


def mnist_first_gradients(torch, branches, cpu_model, card_model,
                          cpu_batch, card_batch) -> dict:
    """The first step's gradients on the card with its own choices and
    with the CPU's replayed, each tensor's largest difference from the
    CPU's over its largest CPU gradient, and how many of the card's own
    choices differ from the CPU's: what the replay is for.  Leaves no
    gradient behind."""
    from tpudist_torch.ops.losses import cross_entropy

    def grads(model, batch):
        x, y = batch
        cross_entropy(model(x), y).backward()
        out = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    branches.record()
    cpu = grads(cpu_model, cpu_batch)
    cpu_tape = branches.tape
    branches.record()
    own = grads(card_model, card_batch)
    differ = sum(int((a.to(b.dtype) != b).sum())
                 for a, b in zip(branches.tape, cpu_tape))
    branches.tape = cpu_tape
    branches.replay()
    replayed = grads(card_model, card_batch)
    return {"own_choices_differing": differ,
            "choices": sum(t.numel() for t in cpu_tape),
            "grad_max_rel_own": max(max_rel(own, cpu).values()),
            "grad_max_rel_replayed": max(max_rel(replayed, cpu).values())}


def phase_mnist_parity(torch, dev, seed):
    """MLP(hidden 2, features 1024) and the ConvNet (dropout off), from
    one converted flax-layout tree each: 20 Adam steps (lr 1e-3) on the
    same 20 loader batches of synthetic_mnist (the card's batches checked
    bit for bit against the CPU's) on the CPU in f32, on the card in f32
    (TF32 off in cuBLAS and cuDNN, restored after) and on the CPU in f64,
    the card and f64 replaying the CPU's choices of each step (see
    MNIST_PARITY_RTOL): each step's loss, the final parameters, the share
    of the card's own choices that differ."""
    import numpy as np

    from tpudist_torch.data import ShardedLoader
    from tpudist_torch.data.mnist import synthetic_mnist
    from tpudist_torch.models import (
        MLP,
        ConvNet,
        convnet,
        from_flax_convnet_params,
        from_flax_mlp_params,
        mlp,
    )
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam

    rng = np.random.default_rng(seed)
    ds = synthetic_mnist("train", n=MNIST_PARITY_STEPS * MNIST_BATCH,
                         seed=seed)
    cpu = torch.device("cpu")
    models = {
        "mlp": (lambda d, dt: MLP(2, 1024, compute_dtype=dt, device=d),
                from_flax_mlp_params(flax_mlp_tree(np, rng, 2, 1024))),
        "convnet": (lambda d, dt: ConvNet(compute_dtype=dt, device=d),
                    from_flax_convnet_params(flax_convnet_tree(np, rng)))}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    branches, functional = ReplayBranches(torch), mlp.F
    mlp.F = convnet.F = branches
    rows, failures = {}, []
    try:
        card_batches, cpu_batches = (list(ShardedLoader(
            [ds.images, ds.labels], MNIST_BATCH, shuffle=True, seed=seed,
            device=where).epoch(0)) for where in (dev, cpu))
        same_batches = all(
            torch.equal(a.cpu(), b) and torch.equal(la.cpu(), lb)
            for (a, la), (b, lb) in zip(card_batches, cpu_batches))
        for name, (make, sd) in models.items():
            runs = {}
            for key, where, dt in (("cpu", cpu, torch.float32),
                                   ("card", dev, torch.float32),
                                   ("f64", cpu, torch.float64)):
                model = make(where, dt).to(dt)
                model.load_state_dict(sd)
                runs[key] = (model, TrainState.create(model, adam(1e-3),
                                                      seed=seed), [])
            unreplayed = mnist_first_gradients(
                torch, branches, runs["cpu"][0], runs["card"][0],
                cpu_batches[0], card_batches[0])
            step = make_dp_train_step(mnist_loss_fn(logit_scale=True))
            flips = choices = 0
            floor = []
            for t in range(MNIST_PARITY_STEPS):
                for key in ("cpu", "card", "f64"):
                    model, state, losses = runs[key]
                    if key == "cpu":
                        branches.record()
                    else:
                        branches.replay()
                    x, y = (card_batches if key == "card"
                            else cpu_batches)[t]
                    state, m = step(state, x.to(
                        next(model.parameters()).dtype), y)
                    losses.append(float(m["loss"]))
                    if key == "cpu":
                        floor.append(2.0 ** -23 * float(m["logit_scale"]))
                    if key == "card":
                        flips += branches.flips
                        choices += branches.choices
            final = {key: {k: v.detach().cpu() for k, v in
                           runs[key][0].state_dict().items()}
                     for key in runs}
            card_l, cpu_l = runs["card"][2], runs["cpu"][2]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_l,
                                                               cpu_l))
            loss_ratio = max(abs(a - b) / (MNIST_PARITY_RTOL * abs(b) + f)
                             for a, b, f in zip(card_l, cpu_l, floor))
            got = max_rel(final["card"], final["cpu"])
            noise = max_rel(final["cpu"], final["f64"])
            ratio = {k: got[k] / max(MNIST_PARITY_RTOL,
                                     MNIST_NOISE_FACTOR * noise[k])
                     for k in got}
            rows[name] = {
                "losses_card": card_l, "losses_cpu": cpu_l,
                "loss_max_rel": loss_rel, "loss_ratio_to_limit": loss_ratio,
                "loss_floor": floor,
                "param_max_rel": max(got.values()),
                "param_noise_max_rel": max(noise.values()),
                "param_ratio_to_limit": max(ratio.values()),
                "worst_tensor": max(ratio, key=ratio.get),
                "card_choice_flips": flips, "choices": choices,
                "first_step_unreplayed": unreplayed}
            if not card_l[-1] < card_l[0]:
                failures.append(f"{name}: the loss did not fall {card_l}")
            if loss_ratio > 1.0:
                failures.append(f"{name}: a loss off, {loss_ratio} of its "
                                "limit")
            if max(ratio.values()) > 1.0:
                failures.append(f"{name}: parameters off, {ratio}")
            if flips > MNIST_FLIP_SHARE * choices:
                failures.append(f"{name}: {flips} of {choices} choices "
                                "differ")
    finally:
        mlp.F = convnet.F = functional
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    emit({"phase": "mnist_parity", "steps": MNIST_PARITY_STEPS,
          "batch": MNIST_BATCH, "batches_bitwise": same_batches, **rows,
          "tolerance": {"rtol": MNIST_PARITY_RTOL,
                        "noise_factor": MNIST_NOISE_FACTOR,
                        "flip_share": MNIST_FLIP_SHARE}})
    check(same_batches, "mnist_parity: the card's batches differ from the "
                        "CPU's")
    check(not failures, "mnist_parity: " + "; ".join(failures))


def mnist_trainer(torch, dev, seed, snapshot, epochs, train, test):
    """The DDP recipe: MLP(5, 1024) f32, Adam 1e-3, batch 128, a snapshot
    every epoch, the native gather pool feeding the loader; per-step
    losses recorded (device scalars) in ``trainer.step_losses``."""
    from tpudist_torch.data import ShardedLoader
    from tpudist_torch.models import MLP
    from tpudist_torch.train import Trainer, TrainerConfig, adam

    model = MLP(5, 1024, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    cfg = TrainerConfig(total_epochs=epochs, save_every=1,
                        batch_size=MNIST_BATCH, snapshot_path=snapshot,
                        log_every=10_000)
    trainer = Trainer(
        cfg, model, adam(1e-3), None,
        ShardedLoader([train.images, train.labels], MNIST_BATCH,
                      shuffle=True, seed=seed, prefetch=2, device=dev),
        ShardedLoader([test.images, test.labels], MNIST_BATCH,
                      drop_last=False, device=dev), seed=seed)
    trainer.step_losses = []
    step = trainer.train_step

    def recorded(state, *batch):
        state, m = step(state, *batch)
        trainer.step_losses.append(m["loss"])
        return state, m

    trainer.train_step = recorded
    return trainer


def phase_train_mnist(torch, dev, seed):
    """The DDP recipe at full width through Trainer.train(): MLP(5, 1024),
    f32, Adam 1e-3, batch 128 on synthetic_mnist (60,000 train, 10,000
    test), 2 epochs with a snapshot every epoch; a second Trainer on that
    snapshot restores epochs_run and step and trains epoch 3, whose
    per-step losses, final parameters and optimizer state equal one
    uninterrupted 3-epoch run's bit for bit (the synthetic task's f32 loss
    reaches exactly 0 in the second epoch, so the parameters and Adam's
    moments carry the check there); test accuracy >= MNIST_ACCURACY; the
    native gather pool fed every epoch; no port kernel launched (K1-K10 =
    0); the first Trainer's telemetry: ``train/steps`` equal to the steps
    it ran, ``xla/step_tflops`` (its first step's counted FLOPs over the
    mean step time) and ``xla/mem/peak_bytes_in_use/d0`` above 0.  Then
    ms per step of 100 steps after a synchronise, images/s, the seconds
    each snapshot save blocked, peak memory, 20 steps under
    torch.profiler, and the host microseconds of the Trainer's per-step
    telemetry timed alone, with their share of the step."""
    import itertools
    import tempfile

    from tpudist_torch.data.mnist import synthetic_mnist

    train = synthetic_mnist("train", seed=seed)
    test = synthetic_mnist("test", seed=seed)
    steps_per_epoch = len(train) // MNIST_BATCH
    out = {"phase": "train_mnist", "batch": MNIST_BATCH,
           "train_n": len(train), "test_n": len(test),
           "steps_per_epoch": steps_per_epoch}
    from tpudist_torch import obs

    def counter(name):
        return obs.snapshot()["counters"].get(name, {}).get("value", 0.0)

    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        first = mnist_trainer(torch, dev, seed, f"{tmp}/a.npz", 2, train,
                              test)
        obs.gauge("xla/step_tflops").set(0.0)
        obs.gauge("xla/mem/peak_bytes_in_use/d0").set(0.0)
        steps0 = counter("train/steps")
        t0 = time.perf_counter()
        s_first = first.train()
        out["first_2_epochs_s"] = time.perf_counter() - t0
        gauges = obs.snapshot()["gauges"]
        out["telemetry"] = {
            "train_steps": counter("train/steps") - steps0,
            "step_flops": first._step_flops,
            **{k: gauges.get(k, {}).get("value") for k in (
                "xla/step_tflops", "xla/mfu",
                "xla/mem/peak_bytes_in_use/d0", "xla/mem/bytes_limit/d0")}}
        check(out["telemetry"]["train_steps"] == 2 * steps_per_epoch,
              f"train_mnist: train/steps {out['telemetry']}")
        check((out["telemetry"]["xla/step_tflops"] or 0) > 0
              and (out["telemetry"]["xla/mem/peak_bytes_in_use/d0"]
                   or 0) > 0,
              f"train_mnist: telemetry {out['telemetry']}")
        resumed = mnist_trainer(torch, dev, seed, f"{tmp}/a.npz",
                                MNIST_EPOCHS, train, test)
        check(resumed.epochs_run == 2
              and resumed.state.step == 2 * steps_per_epoch,
              f"train_mnist: resumed at epoch {resumed.epochs_run}, step "
              f"{resumed.state.step}")
        s_resumed = resumed.train()
        out["allocated_before_whole_bytes"] = torch.cuda.memory_allocated(
            dev)
        torch.cuda.reset_peak_memory_stats(dev)
        whole = mnist_trainer(torch, dev, seed, f"{tmp}/w.npz",
                              MNIST_EPOCHS, train, test)
        t0 = time.perf_counter()
        by_epoch, blocked = [], []
        for e in range(1, MNIST_EPOCHS + 1):
            by_epoch.append(whole.train(max_epochs=e))
            blocked.append(whole._ckpt.last_blocked_s)
        s_whole = by_epoch[-1]
        out["whole_3_epochs_s"] = time.perf_counter() - t0
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        launches = read_launches()
        tail = torch.stack(whole.step_losses[-steps_per_epoch:]).cpu()
        got = torch.stack(resumed.step_losses).cpu()
        check(len(resumed.step_losses) == steps_per_epoch,
              f"train_mnist: the resumed run took "
              f"{len(resumed.step_losses)} steps")
        same_losses = torch.equal(got, tail)
        same_params = all(
            torch.equal(v, resumed.state.model.state_dict()[k])
            for k, v in whole.state.model.state_dict().items())
        opt_w, opt_r = (t.state.optimizer.state_dict()["state"]
                        for t in (whole, resumed))
        same_opt = opt_w.keys() == opt_r.keys() and all(
            torch.equal(opt_w[i][k], opt_r[i][k])
            for i in opt_w for k in opt_w[i])
        out.update({
            "resumed_at": {"epochs_run": 2, "step": 2 * steps_per_epoch},
            "resume_losses_bitwise": same_losses,
            "resume_params_bitwise": same_params,
            "resume_optimizer_bitwise": same_opt,
            "loss_by_epoch": [e["loss"] for e in by_epoch],
            "resumed_epoch_loss": s_resumed["loss"],
            "first_run_last_epoch_loss": s_first["loss"],
            "test_accuracy": s_whole["test_accuracy"],
            "resumed_test_accuracy": s_resumed["test_accuracy"],
            "trainer_images_per_s": s_whole["images_per_sec"],
            "snapshot_blocked_s": blocked,
            "gather_pool_jobs": whole.train_loader.pool.jobs
            if whole.train_loader.pool is not None else 0,
            "launches": launches})
        check(same_losses, "train_mnist: the resumed epoch's losses differ "
                           f"from the uninterrupted run's: max "
                           f"{float((got - tail).abs().max())}")
        check(same_params and same_opt,
              "train_mnist: the resumed parameters or optimizer state "
              "differ")
        check(s_whole["test_accuracy"] >= MNIST_ACCURACY
              and s_resumed["test_accuracy"] >= MNIST_ACCURACY,
              f"train_mnist: accuracy {s_whole['test_accuracy']}")
        check(out["gather_pool_jobs"] >= MNIST_EPOCHS * steps_per_epoch,
              f"train_mnist: the native gather pool ran "
              f"{out['gather_pool_jobs']} jobs")
        check(not any(launches.values()),
              f"train_mnist: a port kernel launched: {launches}")
        # steady state: 100 steps on batches already on the card
        feed = whole.train_loader.epoch(5)
        batches = list(itertools.islice(feed, 20))
        feed.close()
        step = whole.train_step

        def run(n):
            for i in range(n):
                whole.state, _ = step(whole.state,
                                      *batches[i % len(batches)])

        run(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(100)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 100 * 1e3
        out.update({"ms_per_step": ms,
                    "images_per_s": MNIST_BATCH / (ms / 1e3),
                    "profile": profiled_steps(torch, run, 20)})
        # the host cost of the telemetry Trainer._run_epoch adds to each
        # step (a span, the loss gauge on the step's device scalar, two
        # counters, the step-time histogram, two clock reads), timed alone
        # against the bare step; probe names keep train/* untouched
        steps_c = obs.counter("smoke/probe_steps")
        examples_c = obs.counter("smoke/probe_examples")
        loss_g = obs.gauge("smoke/probe_loss")
        step_h = obs.histogram("smoke/probe_step_time", unit="s")
        loss = whole.step_losses[-1]

        def telemetry(n):
            for i in range(n):
                t0 = time.perf_counter()
                with obs.span("telemetry_probe", step=i):
                    pass
                loss_g.set(loss)
                steps_c.inc()
                examples_c.inc(MNIST_BATCH)
                step_h.record(time.perf_counter() - t0)

        telemetry(500)
        t0 = time.perf_counter()
        telemetry(5000)
        us = (time.perf_counter() - t0) / 5000 * 1e6
        out.update({"telemetry_us_per_step": us,
                    "telemetry_share_of_step": us / 1e3 / ms})
    emit(out)
    torch.cuda.empty_cache()
    return launches


def phase_train_convnet(torch, dev, seed):
    """tpudist's real-digit recipe (tests/test_real_mnist.py): the ConvNet
    with dropout on data/real_digits.npz, batch 128, Adam 1e-3, 15 epochs
    through Trainer.train(), held-out accuracy >= CONVNET_ACCURACY; then
    the mnist_horovod shape (batch 1024, SGD 0.01, dropout on): ms per
    step of 20 steps after a synchronise, images/s, and 20 steps under
    torch.profiler."""
    import math
    import tempfile

    from tpudist_torch.data import ShardedLoader
    from tpudist_torch.data.mnist import load_real_digits, synthetic_mnist
    from tpudist_torch.models import ConvNet
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import (
        TrainState,
        Trainer,
        TrainerConfig,
        adam,
        sgd,
    )

    train, test = load_real_digits("train"), load_real_digits("test")
    model = ConvNet(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(
            TrainerConfig(total_epochs=CONVNET_EPOCHS, save_every=100,
                          batch_size=128, snapshot_path=f"{tmp}/rd.npz",
                          log_every=10_000, eval_every_epoch=False),
            model, adam(1e-3), None,
            ShardedLoader([train.images, train.labels], 128, shuffle=True,
                          seed=seed, prefetch=2, device=dev),
            ShardedLoader([test.images, test.labels], 128, drop_last=False,
                          device=dev),
            train_kwargs={"train": True}, seed=seed)
        t0 = time.perf_counter()
        summary = trainer.train()
        wall = time.perf_counter() - t0
    accuracy = trainer.test()
    out = {"phase": "train_convnet", "train_n": len(train),
           "test_n": len(test), "epochs": CONVNET_EPOCHS,
           "loss_last_epoch": summary["loss"], "test_accuracy": accuracy,
           "train_s": wall, "trainer_images_per_s": summary["images_per_sec"]}
    check(accuracy >= CONVNET_ACCURACY,
          f"train_convnet: real-digit accuracy {accuracy}")
    # the mnist_horovod shape
    ds = synthetic_mnist("train", n=HOROVOD_BATCH * 4, seed=seed)
    loader = ShardedLoader([ds.images, ds.labels], HOROVOD_BATCH,
                           device=dev)
    batches = list(loader.epoch(0))
    model = ConvNet(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    state = TrainState.create(model, sgd(0.01), seed=seed)
    step = make_dp_train_step(mnist_loss_fn({"train": True}))
    losses = []

    def run(n):
        nonlocal state
        for i in range(n):
            state, m = step(state, *batches[i % len(batches)])
            losses.append(m["loss"])

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(HOROVOD_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / HOROVOD_STEPS * 1e3
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses),
          f"train_convnet: non-finite loss {losses}")
    out["horovod_shape"] = {"batch": HOROVOD_BATCH, "lr": 0.01,
                            "ms_per_step": ms,
                            "images_per_s": HOROVOD_BATCH / (ms / 1e3),
                            "loss_first": losses[0], "loss_last": losses[-1],
                            "profile": profiled_steps(torch, run,
                                                      HOROVOD_STEPS)}
    emit(out)
    torch.cuda.empty_cache()


# ---- elastic training (ROADMAP Queue A 8) ---------------------------------

# elastic_kill9: the twin gang of tests/test_torch_elastic_ttl.py on the
# card and on the CPU, the same gang on both.  The wire is f32
# (TPUDIST_COLL_COMPRESS=none): the default bf16 wire turns the two
# devices' f32 rounding differences (~1e-7) into whole bf16 steps (2^-8)
# that compound over 30 steps.  The card's final parameters within
# ELASTIC_CPU_RTOL of each tensor's largest CPU magnitude, its loss within
# ELASTIC_CPU_RTOL relative.
ELASTIC_CPU_RTOL = 1e-4
ELASTIC_GANG_TIMEOUT_S = 300
ELASTIC_WORKER = "tests/workers/torch_ttl_elastic_worker.py"
# elastic_ici: world-1 NCCL rounds one process forms and tears down, and
# the bound on that process
ICI_NCCL_ROUNDS, ICI_NCCL_TIMEOUT_S = 3, 300
# elastic_horovod: the reference recipe (horovod_mnist_elastic.py) cut only
# in epochs; one worker SIGKILLed from outside after the round's second
# commit at world 3 (mid-epoch 0)
HVD_EPOCHS, HVD_REF_EPOCHS, HVD_ACCURACY = 2, 15, 0.9
HVD_KILL_AFTER_COMMITS, HVD_KILL_SPAWN_ID = 2, "2"
HVD_TIMEOUT_S = 600
# host_collectives: ms per op of REPS ops after WARMUP, at world 3 (flat,
# ring) and 4 (hier over 2 hosts: at 3 it would fall back to the ring);
# the results of every rank bitwise equal, and within COLL_RTOL[compress]
# of the f64 sum's largest magnitude (bf16: each of a value's at most
# 2·world encodes rounds by 2^-9)
COLL_WARMUP, COLL_REPS = 2, {"convnet": 20, "mlp": 5}
COLL_RTOL = {"none": 1e-5, "bf16": 2e-2}
COLL_TIMEOUT_S = 600


def _repo_root() -> str:
    import os

    return os.path.dirname(os.path.abspath(__file__))


def _jsonl(path) -> list:
    import os

    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _last_params(np, ckpt_dir, sid) -> dict:
    from tpudist_torch.elastic.checkpoint import latest_step

    d = f"{ckpt_dir}/w{sid}"
    with np.load(f"{d}/step_{latest_step(d)}/state.npz") as z:
        return {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}


def elastic_gang(device: str, tmp: str, env: dict | None = None,
                 label: str = "elastic_kill9") -> dict:
    """One run of the kill-9 gang on ``device`` under ``tmp`` (``env``
    added to the workers', e.g. the ici data plane): its events, loop
    records and final parameters, checked against the test's outcome."""
    import os

    import numpy as np

    from tpudist_torch.runtime.launch import launch

    out, ckpt = f"{tmp}/events", f"{tmp}/ckpt"
    os.makedirs(out)
    t0 = time.perf_counter()
    rc = launch([sys.executable, f"{_repo_root()}/{ELASTIC_WORKER}"],
                nprocs=3, min_nprocs=2, elastic_inprocess=True,
                device=device, timeout_s=ELASTIC_GANG_TIMEOUT_S,
                env={"WORKER_OUT_DIR": out, "WORKER_CKPT_DIR": ckpt,
                     "WORKER_KILL_SPAWN_ID": "2", "WORKER_KILL_AT_STEP": "13",
                     "TPUDIST_COLL_COMPRESS": "none", "OMP_NUM_THREADS": "1",
                     **(env or {})})
    wall = time.perf_counter() - t0
    device = f"{label}:{device}" if label != "elastic_kill9" else device
    check(rc == 0, f"elastic_kill9[{device}]: the gang exited {rc}")
    ev = {sid: _jsonl(f"{out}/events_{sid}.jsonl") for sid in (0, 1, 2)}
    loops = {sid: _jsonl(f"{out}/loop_{sid}.jsonl") for sid in (0, 1, 2)}
    suicide = [e for e in ev[2] if e["event"] == "suicide"]
    check(len(suicide) == 1 and suicide[0]["step"] == 13,
          f"elastic_kill9[{device}]: spawn 2 did not die at step 13")
    t_kill = suicide[0]["t"]
    done, detect, recover = {}, {}, {}
    for sid in (0, 1):
        rounds = [e for e in ev[sid] if e["event"] == "round"]
        resets = [(e["old_world"], e["new_world"], e["lr"])
                  for e in ev[sid] if e["event"] == "reset"]
        done[sid] = [e for e in ev[sid] if e["event"] == "done"][-1]
        check([r["world"] for r in rounds] == [3, 2]
              and rounds[-1]["resume_batch"] == 10,
              f"elastic_kill9[{device}]: rounds {rounds}")
        check(len(resets) == 1 and resets[0][:2] == (3, 2)
              and abs(resets[0][2] - 0.1 * 2 / 3) < 1e-12,
              f"elastic_kill9[{device}]: resets {resets}")
        check(done[sid]["steps"] == 30 and done[sid]["world"] == 2,
              f"elastic_kill9[{device}]: done {done[sid]}")
        lost = [r for r in loops[sid]
                if r["event"] in ("world_changed", "peer_lost")]
        first = [e for e in ev[sid] if e["event"] == "first_step"
                 and e["round"] == rounds[-1]["round"]]
        check(lost and first, f"elastic_kill9[{device}]: no detection or "
                              f"recovery events for spawn {sid}")
        detect[sid] = {"seconds": lost[0]["t"] - t_kill,
                       "by": lost[0]["event"]}
        recover[sid] = first[0]["t"] - t_kill
    p0, p1 = (_last_params(np, ckpt, sid) for sid in (0, 1))
    check(all(np.array_equal(p0[k], p1[k]) for k in p0)
          and done[0]["checksum"] == done[1]["checksum"]
          and done[0]["loss"] == done[1]["loss"],
          f"elastic_kill9[{device}]: survivors differ")

    def ms_per_step(sid, lo, hi):
        t = {e["step"]: e["t"] for e in ev[sid] if e["event"] == "commit"}
        return (t[hi] - t[lo]) / (hi - lo) * 1e3

    launches = {sid: {k: v for k, v in r.items() if k != "event"}
                for sid in (0, 1, 2) for r in loops[sid]
                if r["event"] == "kernel_launches"}
    return {"wall_s": wall, "params": p0, "loss": done[0]["loss"],
            "detection_s": detect, "recovery_s": recover,
            "ms_per_step": {"world3": ms_per_step(0, 5, 10),
                            "world2": ms_per_step(0, 15, 30)},
            "kernel_launches": launches, "events": ev, "loops": loops}


def phase_elastic_kill9(torch, dev, seed):
    """The kill-9 gang on the card (3 workers on cuda:0, spawn 2 SIGKILLs
    itself after step 13) and the same gang on the CPU: survivors re-form
    at world 2, resume at batch 10, rescale the lr once to 0.1·2/3 and end
    bitwise equal; the card within ELASTIC_CPU_RTOL of the CPU; detection
    and recovery seconds from the workers' event times; each worker's
    K1-K10 launches (0: the MLP runs on cuBLAS)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        card = elastic_gang(dev.type, f"{tmp}/card")
        cpu = elastic_gang("cpu", f"{tmp}/cpu")
    rel = {k: float(abs(card["params"][k] - cpu["params"][k]).max()
                    / abs(cpu["params"][k]).max()) for k in cpu["params"]}
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    check(max(rel.values()) <= ELASTIC_CPU_RTOL
          and loss_rel <= ELASTIC_CPU_RTOL,
          f"elastic_kill9: card against CPU {rel}, loss {loss_rel}")
    check(len(card["kernel_launches"]) == 3
          and all(n == 0 for r in card["kernel_launches"].values()
                  for n in r.values()),
          f"elastic_kill9: kernel launches {card['kernel_launches']}")
    emit({"phase": "elastic_kill9", "workers": 3, "device": str(dev),
          "wire": "f32 (TPUDIST_COLL_COMPRESS=none)",
          "survivors_world": 2, "resume_batch": 10, "lr": 0.1 * 2 / 3,
          "survivors_bitwise_equal": True,
          "card_vs_cpu_param_max_rel": max(rel.values()),
          "card_vs_cpu_loss_rel": loss_rel,
          **{f"{k}_{d}": v[k] for d, v in (("card", card), ("cpu", cpu))
             for k in ("detection_s", "recovery_s", "ms_per_step",
                       "wall_s")},
          "kernel_launches_by_spawn": card["kernel_launches"]})
    return card


def ici_nccl_rounds_main(argv) -> int:
    """One process through ICI_NCCL_ROUNDS world-1 NCCL rounds of the ici
    data plane (run by chip_smoke in a process of its own, which holds no
    other group): form, allreduce, abort and destroy; each round's sum
    checked and the live groups counted after each teardown."""
    import torch

    from tpudist_torch.runtime.coord import CoordClient, CoordServer
    from tpudist_torch.runtime.ici import (
        IciCollectives,
        IciDataPlane,
        live_groups,
    )

    out_path = argv[0]
    dev = torch.device("cuda", 0)
    rows = []
    with CoordServer(0) as srv, CoordClient("127.0.0.1", srv.port) as client:
        plane = IciDataPlane(client, device=dev)
        for round_id in range(ICI_NCCL_ROUNDS):
            t0 = time.perf_counter()
            group = plane.form(round_id, 0, 1)
            form_s = time.perf_counter() - t0
            coll = IciCollectives(group, device=dev)
            x = torch.full((1 << 20,), float(round_id + 1), device=dev)
            got = coll.allreduce_sum({"x": x})["x"]
            right = bool(torch.equal(got, x))
            backend = str(torch.distributed.get_backend(group))
            t0 = time.perf_counter()
            plane.teardown()
            rows.append({"round": round_id, "backend": backend,
                         "allreduce_right": right, "form_s": form_s,
                         "teardown_s": time.perf_counter() - t0,
                         "live_groups_after": live_groups(),
                         "calls": dict(coll.calls)})
        plane.finalize(0, lambda: None)
        leftover = client.keys("ici/")
    with open(out_path, "w") as fh:
        json.dump({"rounds": rows, "leftover_keys": leftover}, fh)
    return 0


def phase_elastic_ici(torch, dev, seed, host_card):
    """The kill-9 gang of elastic_kill9 with ``WORKER_DATA_PLANE=ici``: 3
    workers on cuda:0 sync gradients over each round's process group.
    Three ranks share one card, so the gang asks for gloo explicitly
    (``TPUDIST_ICI_BACKEND=gloo``: NCCL holds one rank a card) over CUDA
    tensors.  The survivors re-form at world 2 and end bitwise equal,
    within ELASTIC_CPU_RTOL of the host-plane card gang (``host_card``);
    every round's first step counted calls on its group, and the store
    carried one allreduce a round (the root election's score), no
    gradient.  Then one process takes ICI_NCCL_ROUNDS world-1 NCCL rounds
    (form, allreduce, abort, form again), each sum right and no group
    left behind."""
    import os
    import signal
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ici = elastic_gang(dev.type, f"{tmp}/ici",
                           env={"WORKER_DATA_PLANE": "ici",
                                "TPUDIST_ICI_BACKEND": "gloo"},
                           label="elastic_ici")
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; "
             "sys.exit(chip_smoke.ici_nccl_rounds_main(sys.argv[1:]))",
             f"{tmp}/nccl.json"], cwd=_repo_root(), start_new_session=True)
        try:
            rc = proc.wait(timeout=ICI_NCCL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
        check(rc == 0, f"elastic_ici: the NCCL rounds exited {rc}")
        with open(f"{tmp}/nccl.json") as fh:
            nccl = json.load(fh)
    rel = {k: float(abs(ici["params"][k] - host_card["params"][k]).max()
                    / abs(host_card["params"][k]).max())
           for k in host_card["params"]}
    loss_rel = abs(ici["loss"] - host_card["loss"]) / abs(host_card["loss"])
    check(max(rel.values()) <= ELASTIC_CPU_RTOL
          and loss_rel <= ELASTIC_CPU_RTOL,
          f"elastic_ici: against the host plane {rel}, loss {loss_rel}")
    group_calls = {}
    for sid in (0, 1):
        rounds = [e["round"] for e in ici["events"][sid]
                  if e["event"] == "round"]
        hlo = [e for e in ici["events"][sid] if e["event"] == "hlo"]
        check([e["round"] for e in hlo] == rounds
              and all(e["backend"] == "gloo" and e["calls"] > 0
                      for e in hlo),
              f"elastic_ici: spawn {sid}'s group events {hlo}")
        ctl = [r for r in ici["loops"][sid]
               if r["event"] == "control_plane"]
        check(ctl and ctl[-1]["calls"].get("allreduce") == 1
              and ctl[-1]["data_calls"].get("allreduce") == 20,
              f"elastic_ici: spawn {sid}'s control plane {ctl}")
        group_calls[sid] = {"first_step": [e["calls"] for e in hlo],
                            "formed_s": [r["seconds"] for r in ici["loops"][sid]
                                         if r["event"] == "ici_formed"],
                            "teardown_s": [
                                r["seconds"] for r in ici["loops"][sid]
                                if r["event"] == "ici_teardown"],
                            "last_round": ctl[-1]["data_calls"],
                            "last_round_bytes": ctl[-1]["data_bytes"],
                            "store_calls": ctl[-1]["calls"],
                            "store_bytes_posted": ctl[-1]["bytes_posted"]}
    rows = nccl["rounds"]
    check(len(rows) == ICI_NCCL_ROUNDS
          and all(r["backend"] == "nccl" and r["allreduce_right"]
                  and r["live_groups_after"] == 0 for r in rows)
          and not nccl["leftover_keys"],
          f"elastic_ici: NCCL rounds {nccl}")
    emit({"phase": "elastic_ici", "workers": 3, "device": str(dev),
          "backend": "gloo (TPUDIST_ICI_BACKEND=gloo: 3 ranks share one "
                     "card, NCCL holds one rank a card)",
          "survivors_world": 2, "resume_batch": 10,
          "survivors_bitwise_equal": True,
          "vs_host_plane_param_max_rel": max(rel.values()),
          "vs_host_plane_loss_rel": loss_rel,
          "detection_s": ici["detection_s"], "recovery_s": ici["recovery_s"],
          "host_plane_detection_s": host_card["detection_s"],
          "host_plane_recovery_s": host_card["recovery_s"],
          "ms_per_step": ici["ms_per_step"],
          "host_plane_ms_per_step": host_card["ms_per_step"],
          "wall_s": ici["wall_s"], "group_calls": group_calls,
          "kernel_launches_by_spawn": ici["kernel_launches"],
          "nccl_rounds": rows})


def _children_with_env(pid: int, key: str, value: str) -> list:
    """Processes whose parent is ``pid`` and whose environment holds
    ``key=value`` (read from /proc)."""
    import os

    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
            if ppid != pid:
                continue
            with open(f"/proc/{entry}/environ", "rb") as fh:
                env = fh.read().split(b"\0")
        except OSError:
            continue
        if f"{key}={value}".encode() in env:
            found.append(int(entry))
    return found


def _commit_rate(lines, world: int, batch: int) -> float | None:
    """Images/s between consecutive '[rank 0/W] epoch e batch b committed'
    lines of one epoch at world ``world`` (arrival times)."""
    import re

    pat = re.compile(rf"^\[rank 0/{world}\] epoch (\d+) batch (\d+) committed")
    pts = [(t, int(m.group(1)), int(m.group(2))) for t, line in lines
           if (m := pat.match(line))]
    images = seconds = 0.0
    for (t0, e0, b0), (t1, e1, b1) in zip(pts, pts[1:]):
        if e1 == e0 and b1 > b0:
            images += (b1 - b0) * batch * world
            seconds += t1 - t0
    return images / seconds if seconds else None


def phase_elastic_horovod(torch, dev, seed):
    """``python -m tpudist_torch.runtime.launch -n 3 --min-nprocs 2
    --elastic-inprocess -- examples/horovod_mnist_elastic_gpu.py --elastic
    ttl`` on the card: the reference recipe at full width (ConvNet,
    per-replica batch 128, AdamW 0.01/sqrt(N), a commit every 30 batches,
    synthetic_mnist 60,000/10,000) cut to HVD_EPOCHS of its 15 epochs.
    The worker of spawn HVD_KILL_SPAWN_ID is SIGKILLed from outside after
    the round's second commit at world 3; rc 0, both survivors print the
    reset to world 2 and lr 0.00707 and reach HVD_ACCURACY.  Then the
    commit and rollback cost of this state and of the DDP MLP's on the
    card (the host-copy choice)."""
    import os
    import re
    import signal
    import threading

    cmd = [sys.executable, "-m", "tpudist_torch.runtime.launch", "-n", "3",
           "--min-nprocs", "2", "--elastic-inprocess", "--device", dev.type,
           "--",
           "examples/horovod_mnist_elastic_gpu.py", "--elastic", "ttl",
           "--epochs", str(HVD_EPOCHS)]
    lines: list = []
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=_repo_root(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)

    def read():
        for line in proc.stdout:
            lines.append((time.monotonic(), line.rstrip("\n")))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    killed = None
    try:
        while proc.poll() is None and time.monotonic() - t0 < HVD_TIMEOUT_S:
            commits = [line for _, line in lines
                       if re.match(r"^\[rank 0/3\] epoch 0 batch \d+ "
                                   r"committed", line)]
            if killed is None and len(commits) >= HVD_KILL_AFTER_COMMITS:
                pids = _children_with_env(proc.pid, "TPUDIST_SPAWN_ID",
                                          HVD_KILL_SPAWN_ID)
                check(len(pids) == 1, f"elastic_horovod: spawn "
                                      f"{HVD_KILL_SPAWN_ID} pids {pids}")
                os.kill(pids[0], signal.SIGKILL)
                killed = (time.monotonic(), commits[-1])
            time.sleep(0.01)
        rc = proc.wait(timeout=max(1.0, HVD_TIMEOUT_S
                                   - (time.monotonic() - t0)))
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    reader.join(timeout=10)
    wall = time.monotonic() - t0
    text = [line for _, line in lines]
    check(killed is not None, "elastic_horovod: no worker was killed")
    check(rc == 0, f"elastic_horovod: rc {rc}; last lines {text[-20:]}")
    resets = [line for line in text if line.startswith("reset: ")]
    check(resets == ["reset: world 3 -> 2, lr -> 0.00707"] * 2,
          f"elastic_horovod: resets {resets}")
    accuracies = [float(line.split()[1].rstrip("%")) / 100
                  for line in text if line.startswith("accuracy: ")]
    check(len(accuracies) == 2 and min(accuracies) >= HVD_ACCURACY,
          f"elastic_horovod: accuracies {accuracies}")
    out = {"phase": "elastic_horovod", "cmd": " ".join(cmd[1:]),
           "epochs": HVD_EPOCHS, "reference_epochs": HVD_REF_EPOCHS,
           "cut": "epochs only (2 of the reference's 15)",
           "killed_spawn": HVD_KILL_SPAWN_ID,
           "killed_after": killed[1], "rc": rc, "resets": resets,
           "accuracies": accuracies, "wall_s": wall,
           "images_per_s_before_kill": _commit_rate(
               [x for x in lines if x[0] <= killed[0]], 3, 128),
           "images_per_s_after_kill": _commit_rate(lines, 2, 128),
           "commit_cost": commit_cost(torch, dev, seed),
           "step_parts": step_parts(torch, dev, seed)}
    emit(out)


def step_parts(torch, dev, seed) -> dict:
    """The ttl step's parts in one process on the card, each over 50
    steps ending in a synchronise: the batch (the sampler's rows gathered
    on the host and copied over), the compute (forward, backward, AdamW),
    and the gradient tree's staging through pinned memory and back (what
    the store collective adds besides its wire); then 20 steps of batch
    and compute under torch.profiler (the device's busy share)."""
    import numpy as np

    from tpudist_torch.data.mnist import synthetic_mnist
    from tpudist_torch.data.sampler import ShardedSampler
    from tpudist_torch.models import ConvNet
    from tpudist_torch.ops.losses import nll_loss
    from tpudist_torch.runtime import collectives as coll
    from tpudist_torch.train import TrainState, adamw

    ds = synthetic_mnist("train", seed=seed)
    idx = ShardedSampler(len(ds), 3, 0, shuffle=True).indices(0)
    model = ConvNet(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    state = TrainState.create(model, adamw(0.01))
    params = dict(model.named_parameters())
    n, bs = 50, 128

    def batch(b):
        sel = idx[b * bs:(b + 1) * bs]
        return (torch.from_numpy(ds.images[sel]).to(dev),
                torch.from_numpy(ds.labels[sel]).to(dev))

    def compute(x, y):
        model.zero_grad(set_to_none=True)
        loss = nll_loss(model(x, train=True, generator=state.generator(0)), y)
        loss.backward()
        state.apply_gradients()
        return loss

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(n):
            fn(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    batches = [batch(b) for b in range(n)]
    compute(*batches[0])
    out = {"batch_ms": timed(batch),
           "compute_ms": timed(lambda b: compute(*batches[b]))}
    grads = {k: p.grad for k, p in params.items()}

    def stage_roundtrip(b):
        staged = coll._stage(grads)
        staged.wait()
        coll._unstage(staged, [np.array(h) for h in staged.host])

    out["stage_roundtrip_ms"] = timed(stage_roundtrip)
    out["profile"] = profiled_steps(
        torch, lambda k: [compute(*batch(b)) for b in range(k)], 20)
    return out


def commit_cost(torch, dev, seed) -> dict:
    """ElasticState.commit (a host copy) and rollback on the card: the
    ConvNet with AdamW (the example's state) and the DDP MLP
    (784 -> 1024 x 5 -> 10) with Adam, ms each over 10 calls."""
    from tpudist_torch.elastic import ElasticState
    from tpudist_torch.models import MLP, ConvNet
    from tpudist_torch.train import TrainState, adam, adamw

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    for name, model, opt in (
            ("convnet_adamw", ConvNet(device=dev), adamw(0.01)),
            ("mlp5x1024_adam", MLP(5, 1024, device=dev), adam(1e-3))):
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        es = ElasticState(TrainState.create(model, opt))
        nbytes = sum(v.nbytes for group in es._committed_state["opt_state"]
                     .values() for v in group.values())
        nbytes += sum(v.nbytes for v in es._committed_state["params"]
                      .values())
        times = {}
        for what, fn in (("commit", es.commit), ("rollback", es.rollback)):
            sync()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            sync()
            times[f"{what}_ms"] = (time.perf_counter() - t0) / 10 * 1e3
        out[name] = {"state_bytes": nbytes, **times}
    return out


def coll_trees(torch, dev, seed, rank):
    """The two gradient trees at their models' shapes, on ``dev``, drawn
    for ``rank``: the ConvNet's (21,840 f32) and the DDP MLP's
    (``MLP(5, 1024)``, 784 -> 1024 -> 5 x (1024 -> 1024) -> 10: 6,062,090
    f32)."""
    from tpudist_torch.models import MLP, ConvNet

    g = torch.Generator(device=dev).manual_seed(seed * 1000 + rank)
    trees = {}
    for name, model in (("convnet", ConvNet(device=dev)),
                        ("mlp", MLP(5, 1024, device=dev))):
        trees[name] = {n: torch.randn(p.shape, generator=g, device=dev)
                       for n, p in model.named_parameters()}
    return trees


def coll_rank_main(argv) -> int:
    """One rank of host_collectives (run by chip_smoke in a process of
    its own): every (tree, algorithm, compression) in order, timed, its
    result's digest and its error against the f64 sum written as JSON."""
    import hashlib

    import numpy as np
    import torch

    from tpudist_torch.runtime.collectives import (
        CollectiveConfig,
        HostCollectives,
    )
    from tpudist_torch.runtime.coord import CoordClient

    rank, world, port, seed = (int(v) for v in argv[:4])
    algos, out_path, dev = argv[4].split(","), argv[5], torch.device(argv[6])
    mine = coll_trees(torch, dev, seed, rank)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rows = []
    with CoordClient("127.0.0.1", port) as client:
        rid = 0
        for tree_name in ("convnet", "mlp"):
            tree = mine[tree_name]
            want = None
            for algo in algos:
                for compress in ("none", "bf16"):
                    rid += 1
                    coll = HostCollectives(
                        client, rank, world, round_id=rid, timeout_s=120,
                        config=CollectiveConfig(algorithm=algo,
                                                compress=compress, hosts=2))
                    for _ in range(COLL_WARMUP):
                        coll.allreduce_sum(tree)
                    sync()
                    base = (coll.bytes_posted, coll.bytes_fetched,
                            coll.stage_d2h_s, coll.stage_h2d_s)
                    reps = COLL_REPS[tree_name]
                    ms = []
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        got = coll.allreduce_sum(tree)
                        sync()
                        ms.append((time.perf_counter() - t0) * 1e3)
                    coll.barrier()
                    calls = dict(coll.calls)
                    coll.close()
                    if want is None:  # the f64 sum of every rank's tree
                        every = [coll_trees(torch, dev, seed, r)[tree_name]
                                 for r in range(world)]
                        want = {n: sum(t[n].double() for t in every)
                                for n in tree}
                        del every
                    err = max(float((got[n].double() - want[n]).abs().max()
                                    / want[n].abs().max()) for n in tree)
                    digest = hashlib.sha256(b"".join(
                        got[n].cpu().numpy().tobytes()
                        for n in sorted(got))).hexdigest()
                    rows.append({
                        "tree": tree_name,
                        "f32": sum(v.numel() for v in tree.values()),
                        "algo": algo, "compress": compress,
                        "world": world, "ms": ms,
                        "posted_bytes": (coll.bytes_posted - base[0]) / reps,
                        "fetched_bytes": (coll.bytes_fetched - base[1])
                        / reps,
                        "d2h_ms": (coll.stage_d2h_s - base[2]) / reps * 1e3,
                        "h2d_ms": (coll.stage_h2d_s - base[3]) / reps * 1e3,
                        "calls": calls, "max_rel_err": err,
                        "digest": digest})
    with open(out_path, "w") as fh:
        json.dump(rows, fh)
    return 0


def coll_gang(world: int, algos: str, seed: int, tmp: str, dev) -> list:
    """Run coll_rank_main in ``world`` processes on one store; every
    process is bounded by COLL_TIMEOUT_S and stopped on the way out."""
    import os
    import signal

    from tpudist_torch.runtime.coord import CoordServer

    server = CoordServer(0)
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.coll_rank_main(sys.argv[1:]))",
                 str(rank), str(world), str(server.port), str(seed), algos,
                 f"{tmp}/coll_{world}_{rank}.json", str(dev)],
                cwd=_repo_root(), start_new_session=True))
        deadline = time.monotonic() + COLL_TIMEOUT_S
        for p in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            check(rc == 0, f"host_collectives: a rank exited {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        server.stop()
    per_rank = [json.load(open(f"{tmp}/coll_{world}_{r}.json"))
                for r in range(world)]
    return per_rank


def phase_host_collectives(torch, dev, seed):
    """HostCollectives on CUDA gradients, three processes on one card:
    the ConvNet's and the DDP MLP's gradient through flat and ring at
    world 3 and hier at world 4 (2 hosts), each with none and bf16 on the
    wire: ms per op (median of the ranks' medians), bytes posted and
    fetched per rank per op, the device-to-host and host-to-device staging
    ms apart; every rank's result bitwise equal, and within COLL_RTOL of
    the f64 sum.  The baseline the process-group plane (elastic_ici,
    scripts/elastic_nccl_check.py) is held against."""
    import statistics
    import tempfile

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for world, algos in ((3, "flat,ring"), (4, "hier")):
            per_rank = coll_gang(world, algos, seed, tmp, dev)
            for i, row in enumerate(per_rank[0]):
                ranks = [pr[i] for pr in per_rank]
                check(len({r["digest"] for r in ranks}) == 1,
                      f"host_collectives: replicas differ {row['tree']} "
                      f"{row['algo']} {row['compress']}")
                err = max(r["max_rel_err"] for r in ranks)
                check(err <= COLL_RTOL[row["compress"]],
                      f"host_collectives: {row['tree']} {row['algo']} "
                      f"{row['compress']} off by {err}")
                rows.append({
                    "tree": row["tree"], "f32": row["f32"],
                    "bytes": 4 * row["f32"], "algo": row["algo"],
                    "compress": row["compress"], "world": world,
                    "ms_per_op": statistics.median(
                        statistics.median(r["ms"]) for r in ranks),
                    "ms_min": min(min(r["ms"]) for r in ranks),
                    "posted_bytes_per_rank": statistics.mean(
                        r["posted_bytes"] for r in ranks),
                    "fetched_bytes_per_rank": statistics.mean(
                        r["fetched_bytes"] for r in ranks),
                    "d2h_ms": statistics.mean(r["d2h_ms"] for r in ranks),
                    "h2d_ms": statistics.mean(r["h2d_ms"] for r in ranks),
                    "algo_ran": sorted(k for k in row["calls"]
                                       if k.startswith("allreduce~")),
                    "max_rel_err": err})
    emit({"phase": "host_collectives", "rows": rows})


# ---- pipeline and parameter-server phases ---------------------------------

PP_SPLITS = (4, 8)
# the cells' sizes (a CPU rehearsal shrinks them): pipeline_resnet's batch
# and image side; train_pp's sequence, batch and measured steps
PP_RESNET = {"batch": 32, "hw": 128}
PP_TRAIN = {"seq": 2048, "batch": 8, "steps": 10, "parity_seq": 512}
# train_pp's parity (2 layers, f32, TF32 off): the 1F1B step's loss within
# PP_LOSS_RTOL of the unpipelined step's, each parameter's gradient within
# PP_GRAD_TOL of that gradient's largest element.  Both sum the same
# per-token terms through the same kernels (K1/K3/K4, exact f32 FMAs);
# the pipeline sums them per micro-batch of 2 sequences, scaled 1/M, and
# then over the micro-batches: other orders, f32 rounding only.  A wrong
# chunk, hop or micro-batch is off by the gradient's own size.
PP_LOSS_RTOL, PP_GRAD_TOL = 1e-5, 1e-4
# ps_hybrid: the card's steps against the CPU's, each loss and parameter
# within PS_TOL * (1 + |CPU value|)
PS_TOL = 1e-5
PS_STEPS = 10
# the bag sums of 2 virtual model shards against the whole table's: at
# most 10 f32 terms each, summed in other orders (a few ulps), within
# PS_BAG_RTOL of the largest sum
PS_BAG_RTOL = 1e-6


def split_resnet_sd(sd: dict, n0: int) -> list:
    """A ResNet50 state_dict as resnet50_stages(2)'s: the stem and blocks
    0..n0-1, then blocks n0.. numbered from 0 and the head."""
    parts = [{}, {}]
    for k, v in sd.items():
        if k.startswith("blocks."):
            i, rest = k[len("blocks."):].split(".", 1)
            s = int(int(i) >= n0)
            parts[s][f"blocks.{int(i) - n0 * s}.{rest}"] = v
        else:
            parts[0 if k.startswith("stem.") else 1][k] = v
    return parts


def join_resnet(parts: list, n0: int) -> dict:
    """Invert split_resnet_sd (for gradients and weights)."""
    out = dict(parts[0])
    for k, v in parts[1].items():
        if k.startswith("blocks."):
            i, rest = k[len("blocks."):].split(".", 1)
            k = f"blocks.{int(i) + n0}.{rest}"
        out[k] = v
    return out


def resnet_pipeline_steps(torch, dev, parts, n0, kind, split, dtype, lr):
    """A resnet50_stages(2) step factory on 2 local stages: ``kind``
    "gpipe" (every stage's module here) or "packed" (one packed row per
    stage, the stage templates on the meta device); returns ``(state,
    step, grads(), weights())``, the last two by the full model's
    names."""
    from torch.func import functional_call

    from tpudist_torch.models import resnet50_stages
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.train import TrainState, sgd

    if kind == "gpipe":
        stages = torch.nn.ModuleList(resnet50_stages(
            2, num_classes=1000, compute_dtype=dtype, device=dev))
        for st, sd in zip(stages, parts):
            st.load_state_dict(sd)
        state = TrainState.create(stages, sgd(lr))
        step = pl.make_pipeline_train_step([lambda m, a: m(a)] * 2,
                                           mse_loss, None, split,
                                           local_stages=2)

        def named(attr):
            return join_resnet([{n: attr(p) for n, p in st.named_parameters()}
                                for st in stages], n0)
    else:
        templates = resnet50_stages(2, num_classes=1000, compute_dtype=dtype,
                                    device="meta")
        fns = [lambda p, a, m=m: functional_call(m, p, (a,))
               for m in templates]
        flat, meta = pl.pack_stage_params(parts)
        state = TrainState.create(pl.ParamTree(flat, device=dev), sgd(lr))
        step = pl.make_packed_pipeline_train_step(
            fns, mse_loss, None, split, meta, state, local_stages=2)

        def named(attr):
            row = attr(state.model.tree())
            return join_resnet([dict(t) for t in
                                pl.unpack_stage_params(row, meta)], n0)
    return (state, step,
            lambda: named(lambda p: p.grad.detach().clone()),
            lambda: named(lambda p: p.detach().clone()))


def pp_gloo_probe(torch, dev) -> str:
    """A pipeline step handed CUDA tensors on a gloo group (of one) must
    raise before any work: gloo has no CUDA send/recv, and the port never
    stages a hop through the host."""
    import torch.distributed as dist

    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.runtime import initialize, pipeline_mesh, shutdown
    from tpudist_torch.train import TrainState, sgd

    check(not dist.is_initialized(), "pipeline_resnet: a process group is "
          "already up")
    initialize(store=dist.HashStore(), world_size=1, rank=0, device="cpu")
    try:
        check(dist.get_backend() == "gloo", "probe: not a gloo group")
        model = pl.ParamTree(({"w": torch.zeros(4, 4),
                               "b": torch.zeros(4)},), device=dev)
        state = TrainState.create(model, sgd(0.1))
        step = pl.make_pipeline_train_step(
            [lambda p, a: torch.tanh(a @ p["w"] + p["b"])], mse_loss,
            pipeline_mesh(1), 2)
        try:
            step(state, torch.zeros(4, 4, device=dev),
                 torch.zeros(4, 4, device=dev))
        except ValueError as e:
            msg = str(e)
        else:
            msg = ""
        check("need an NCCL group" in msg, f"probe: CUDA tensors on gloo "
              f"did not raise ({msg!r})")
        return msg
    finally:
        shutdown()


def phase_pipeline_resnet(torch, dev, seed):
    """The reference's model_parallel_ResNet50 recipe on the card:
    resnet50_stages(2) (norm="group", 1000 classes, the stem and layer1-2,
    then layer3-4 and the head) on 2 local stages, batch 32 at 128 px, SGD
    0.05, MSE on one-hot labels.  Parity, f32 with TF32 off, from one
    flax-layout tree of seeded weights: one GPipe step at splits 4 and 8
    and one packed step at split 4 against the unpipelined ResNet50 step
    on the same weights and batch; the loss within RESNET_LOSS_RTOL, each
    parameter's gradient within RESNET_NOISE_FACTOR times that tensor's
    own f32-to-f64 distance (the unpipelined step in f32 against f64 on
    the card) or RESNET_GRAD_FLOOR where that is larger, and the weights
    after the step apart by at most lr times that gradient distance plus
    one f32 rounding of each update (resnet_parity's rule: micro-batches
    of 8 and 4 may take other cuDNN algorithms and flip a ReLU whose
    input lies within rounding of 0).  Then the sweep in bf16 (f32
    parameters): GPipe and packed at splits 4 and 8, a warm-up and 3
    timed batches each, ms per batch beside the unpipelined step's at
    batch 32, peak memory, K1-K10 = 0 launches; one GPipe batch at split
    4 profiled by kernel family; and the gloo probe."""
    import numpy as np

    from tpudist_torch.data import synthetic_images
    from tpudist_torch.models import (
        ResNet50,
        from_flax_resnet_params,
        resnet50_stages,
    )
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, sgd

    B, HW, C, lr = PP_RESNET["batch"], PP_RESNET["hw"], 1000, 0.05
    x_np, y_np = synthetic_images(B, hw=HW, num_classes=C, seed=seed)
    sd = from_flax_resnet_params(flax_resnet_tree(
        np, np.random.default_rng(seed + 17), C))
    n0 = len(resnet50_stages(2, device="meta")[0].blocks)
    parts = split_resnet_sd(sd, n0)

    def mse_any(pred, target):  # mse_loss, f64 kept f64
        dt = torch.promote_types(pred.dtype, torch.float32)
        return torch.square(pred.to(dt) - target.to(dt)).mean()

    def whole_step(dtype, loss):
        model = ResNet50(num_classes=C, compute_dtype=dtype, device=dev)
        model.load_state_dict(sd)
        state = TrainState.create(model, sgd(lr))
        step = make_dp_train_step(
            lambda m, batch, _g: (loss(m(batch[0]), batch[1]), {}))
        return model, state, step

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        model, state, step = whole_step(dt, mse_loss if dt == torch.float32
                                        else mse_any)
        batch = (torch.from_numpy(x_np).to(dev, dt),
                 torch.from_numpy(y_np).to(dev, dt))
        state, m = step(state, *batch)
        runs[name] = (float(m["loss"]),
                      {n: p.grad.detach().clone()
                       for n, p in model.named_parameters()},
                      {n: p.detach().clone()
                       for n, p in model.named_parameters()})
        del model, state
    (l32, g32, w32), (l64, g64, _) = runs["f32"], runs["f64"]
    batch = (torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev))
    parity = []
    for kind, split in (("gpipe", 4), ("gpipe", 8), ("packed", 4)):
        state, step, grads, weights = resnet_pipeline_steps(
            torch, dev, parts, n0, kind, split, torch.float32, lr)
        state, m = step(state, *batch)
        lp, gp, wp = float(m["loss"]), grads(), weights()
        check(set(gp) == set(g32), f"pipeline_resnet: {kind} parameters "
              f"{sorted(set(gp) ^ set(g32))[:4]} differ from the model's")
        worst = (0.0, "")
        for n in g32:
            noise = rel_l2(g32[n], g64[n])
            limit = max(RESNET_NOISE_FACTOR * noise, RESNET_GRAD_FLOOR)
            got = rel_l2(gp[n], g32[n])
            check(got <= limit, f"pipeline_resnet: {kind} split {split} "
                  f"{n} gradient {got} from the unpipelined step's, limit "
                  f"{limit}")
            w = w32[n].abs()
            slack = ((torch.nextafter(w, torch.full_like(w, np.inf)) - w)
                     .double() + 2.0 ** -23 * lr * (gp[n].double().abs()
                                                    + g32[n].double().abs()))
            allowed = (lr * limit * float(g32[n].double().norm())
                       + float(slack.norm()))
            ratio = float((wp[n].double() - w32[n].double()).norm()) / allowed
            check(ratio <= 1.0, f"pipeline_resnet: {kind} split {split} {n} "
                  f"weights {ratio} of their allowed distance")
            worst = max(worst, (got / limit, n))
        rel = abs(lp - l32) / abs(l32)
        check(np.isfinite(lp) and rel <= RESNET_LOSS_RTOL,
              f"pipeline_resnet: {kind} split {split} loss {lp} vs {l32}")
        parity.append({"kind": kind, "split": split, "loss": lp,
                       "loss_unpipelined": l32, "loss_f64": l64,
                       "loss_rel_err": rel, "grad_worst_ratio": worst[0],
                       "grad_worst_param": worst[1]})
        del state, step
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    del runs, g32, g64, w32
    torch.cuda.empty_cache()

    def timed(step, state, batches=3):
        state, m = step(state, *batch)      # warm-up: cuDNN, allocator
        float(m["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses = []
        t0 = time.perf_counter()
        for _ in range(batches):
            state, m = step(state, *batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / batches
        losses = [float(v) for v in losses]
        check(all(np.isfinite(losses)), f"pipeline_resnet: losses {losses}")
        return state, {"ms_per_batch": ms, "losses": losses,
                       "max_memory_allocated_bytes":
                           torch.cuda.max_memory_allocated(dev)}

    reset_launches()
    sweep = []
    model, state, step = whole_step(torch.bfloat16, mse_loss)
    state, unpipelined = timed(step, state)
    del model, state, step
    profile = None
    for split in PP_SPLITS:
        for kind in ("gpipe", "packed"):
            state, step, _, _ = resnet_pipeline_steps(
                torch, dev, parts, n0, kind, split, torch.bfloat16, lr)
            state, row = timed(step, state)
            sweep.append({"kind": kind, "split": split, **row,
                          "vs_unpipelined": row["ms_per_batch"]
                          / unpipelined["ms_per_batch"]})
            if kind == "gpipe" and split == PP_SPLITS[0]:
                profile = profiled_steps(
                    torch, lambda n: [step(state, *batch) for _ in range(n)],
                    1, resnet_family)
            del state, step
            torch.cuda.empty_cache()
    launches = read_launches()
    check(all(v == 0 for v in launches.values()),
          f"pipeline_resnet: the ResNet pipeline launched kernels {launches}")
    probe = pp_gloo_probe(torch, dev)
    emit({"phase": "pipeline_resnet", "batch": B, "image_size": HW,
          "stages": 2, "parity": parity, "unpipelined": unpipelined,
          "sweep": sweep, "profile_gpipe_split4": profile,
          "launches": launches, "gloo_cuda_probe": probe,
          "tolerance": {"loss_rtol": RESNET_LOSS_RTOL,
                        "noise_factor": RESNET_NOISE_FACTOR,
                        "grad_floor": RESNET_GRAD_FLOOR}})
    return launches


def pp_lm_fns(torch, cfg):
    """The real-model 1F1B functions of a TransformerLM (tpudist's
    make_1f1b_pipeline_train_step hooks), on the model's own modules built
    on the meta device and called with the stage's tensors: a chunk is its
    k DecoderBlocks in turn (flash attention), the embedding is
    tok_embed + pos_embed, the head ln_f, lm_head and the train cell's
    loss (cross-entropy of positions 0..S-2 against the next token)."""
    from torch.func import functional_call

    from tpudist_torch.models.transformer import TransformerLM
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.ops.losses import cross_entropy

    tmpl = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                         param_dtype=torch.float32, device="meta")
    blk = tmpl.blocks[0]

    def block_fn(p, a):
        for j in range(next(iter(p.values())).shape[0]):
            a = functional_call(blk, {k: v[j] for k, v in p.items()}, (a,))
        return a

    def embed_fn(ex, x):
        pos = torch.arange(x.shape[1], device=x.device)[None]
        return (functional_call(tmpl.tok_embed,
                                {"weight": ex["tok_embed.weight"]}, (x,))
                + functional_call(tmpl.pos_embed,
                                  {"weight": ex["pos_embed.weight"]},
                                  (pos,)))

    def head_loss_fn(ex, out, y):
        h = functional_call(tmpl.ln_f, {"scale": ex["ln_f.scale"],
                                        "bias": ex["ln_f.bias"]}, (out,))
        logits = functional_call(tmpl.lm_head,
                                 {"weight": ex["lm_head.weight"]},
                                 (h,)).float()
        return cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                             y[:, :-1].reshape(-1))

    return block_fn, embed_fn, head_loss_fn


def pp_lm_step(torch, cfg, sd, dev, P, V, M, seed):
    """The 1F1B real-model step over ``P`` local stages from the model's
    state_dict ``sd``; returns ``(state, step)``."""
    from tpudist_torch.models import stack_block_params
    from tpudist_torch.parallel import pipeline as pl
    from tpudist_torch.train import TrainState, adam

    block_fn, embed_fn, head_loss_fn = pp_lm_fns(torch, cfg)
    tree = stack_block_params(sd, cfg.num_layers, P, V)
    state = TrainState.create(pl.ParamTree(tree, device=dev), adam(3e-4),
                              seed=seed)
    step = pl.make_1f1b_pipeline_train_step(
        block_fn, None, None, M, state, virtual_stages=V, embed_fn=embed_fn,
        head_loss_fn=head_loss_fn, local_stages=P)
    return state, step


def phase_train_pp(torch, dev, seed):
    """The train cell's model (vocab 32000, 8 layers, H=8, Hkv=2, embed
    512, bf16 compute on f32 master weights, Adam 3e-4, flash attention,
    the markov stream from --seed, seq 2048, batch 8) through the 1F1B
    real-model mode on 2 local stages, M = 4 micro-batches of 2, at V = 1
    (chunks of 4 layers) and V = 2 (chunks of 2).  First a parity run at
    2 layers in f32 (TF32 off), batch 8 at seq 512, V = 1: the 1F1B
    step's loss and every gradient against make_dp_train_step's on the
    same weights and batch (PP_LOSS_RTOL, PP_GRAD_TOL).  Then each V: 2
    warm-up and 10 measured steps with counts reset just before and read
    just after (K1 = 2·8·M, K3 = K4 = 8·M a step: each forward tick and
    each backward tick's recompute run K1, each backward tick K3 and K4),
    the loss falling, ms per step, tokens/s, peak memory and
    bubble_fraction, beside the unpipelined step from the same weights on
    the same batch (10 steps after 2 warm-up); one V = 1 step profiled by
    kernel family."""
    import numpy as np

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models import unstack_block_params
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import make_dp_train_step
    from tpudist_torch.train import TrainState, adam

    P, M = 2, 4

    def lm(cfg, s):
        model = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                              param_dtype=torch.float32, device=dev)
        return model.init_weights(torch.Generator(device=dev).manual_seed(s))

    # parity: 2 layers, f32
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = TransformerConfig(vocab_size=32000, num_layers=2, num_heads=8,
                             num_kv_heads=2, embed_dim=512,
                             max_seq_len=PP_TRAIN["parity_seq"],
                             compute_dtype=torch.float32)
    model = lm(cfg2, seed + 21)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tokens = torch.from_numpy(markov_tokens(
        PP_TRAIN["batch"], PP_TRAIN["parity_seq"], cfg2.vocab_size,
        seed + 21)).to(dev)
    targets = torch.roll(tokens, -1, 1)
    state = TrainState.create(model, adam(3e-4), seed=seed)
    state, m = make_dp_train_step(train_loss_fn(torch, cfg2))(state, tokens)
    l_ref = float(m["loss"])
    g_ref = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model, state
    pstate, pstep = pp_lm_step(torch, cfg2, sd, dev, P, 1, M, seed)
    reset_launches()
    pstate, m = pstep(pstate, tokens, targets)
    parity_launches = read_launches()
    l_pp = float(m["loss"])
    tree = pstate.model.tree()
    g_pp = unstack_block_params(
        {part: {k: v.grad for k, v in tree[part].items()}
         for part in ("stages", "extra")}, P, 1)
    check(set(g_pp) == set(g_ref), "train_pp: parameter names differ")
    rel = abs(l_pp - l_ref) / abs(l_ref)
    grads = {n: float((g_pp[n] - g_ref[n]).abs().max()
                      / g_ref[n].abs().max().clamp_min(1e-30))
             for n in g_ref}
    worst = max(grads.items(), key=lambda kv: kv[1])
    check(np.isfinite(l_pp) and rel <= PP_LOSS_RTOL,
          f"train_pp: parity loss {l_pp} vs {l_ref}")
    check(worst[1] <= PP_GRAD_TOL, f"train_pp: parity gradient {worst[0]} "
          f"{worst[1]} of its max from the unpipelined step's")
    want = {"K1": 2 * cfg2.num_layers * M, "K3": cfg2.num_layers * M,
            "K4": cfg2.num_layers * M}
    check(all(parity_launches[k] == v for k, v in want.items()),
          f"train_pp: parity launches {parity_launches}, want {want}")
    parity = {"layers": 2, "batch": PP_TRAIN["batch"],
              "seq_len": PP_TRAIN["parity_seq"], "loss": l_pp,
              "loss_unpipelined": l_ref, "loss_rel_err": rel,
              "grad_worst_rel_to_max": worst[1], "grad_worst_param": worst[0],
              "launches": parity_launches}
    del pstate, pstep, tree, g_pp, g_ref
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    torch.cuda.empty_cache()

    cfg = TransformerConfig(vocab_size=32000, num_layers=8, num_heads=8,
                            num_kv_heads=2, embed_dim=512, max_seq_len=8192,
                            compute_dtype=torch.bfloat16)
    B, S, steps = PP_TRAIN["batch"], PP_TRAIN["seq"], PP_TRAIN["steps"]
    model = lm(cfg, seed + 5)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tokens = torch.from_numpy(markov_tokens(B, S, cfg.vocab_size,
                                            seed)).to(dev)
    targets = torch.roll(tokens, -1, 1)

    def measure(step, state, *batch):
        for _ in range(2):
            state, _ = step(state, *batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, *batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = read_launches()
        losses = [float(v) for v in losses]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train_pp: losses {losses}")
        return state, {"ms_per_step": ms, "tokens_per_s": B * S / ms * 1e3,
                       "losses": losses,
                       "max_memory_allocated_bytes":
                           torch.cuda.max_memory_allocated(dev),
                       "launches_per_step": {k: v / steps
                                             for k, v in launches.items()}}

    state = TrainState.create(model, adam(3e-4), seed=seed)
    state, unpipelined = measure(make_dp_train_step(train_loss_fn(torch,
                                                                  cfg)),
                                 state, tokens)
    del model, state
    torch.cuda.empty_cache()
    rows, main_launches, profile = [], None, None
    for V in (1, 2):
        pstate, pstep = pp_lm_step(torch, cfg, sd, dev, P, V, M, seed)
        pstate, row = measure(pstep, pstate, tokens, targets)
        want = {"K1": 2 * cfg.num_layers * M, "K3": cfg.num_layers * M,
                "K4": cfg.num_layers * M}
        got = row["launches_per_step"]
        check(all(got[k] == v for k, v in want.items())
              and all(got[k] == 0 for k in got if k not in want),
              f"train_pp V={V}: launches a step {got}, want {want}")
        rows.append({"virtual_stages": V, "stages": P, "microbatches": M,
                     "layers_per_chunk": cfg.num_layers // (P * V),
                     "bubble_fraction": pstep.bubble_fraction,
                     "ticks": pstep.schedule.T, **row,
                     "vs_unpipelined": row["ms_per_step"]
                     / unpipelined["ms_per_step"]})
        if V == 1:
            main_launches = {k: int(v * steps) for k, v in got.items()}
            main_launches["per_step"] = got
            profile = profiled_steps(
                torch, lambda n: [pstep(pstate, tokens, targets)
                                  for _ in range(n)], 1, kernel_family)
        del pstate, pstep
        torch.cuda.empty_cache()
    emit({"phase": "train_pp", "batch": B, "seq_len": S, "steps": steps,
          "parity": parity, "unpipelined": unpipelined, "runs": rows,
          "profile_v1": profile,
          "tolerance": {"loss_rtol": PP_LOSS_RTOL,
                        "grad_rel_to_max": PP_GRAD_TOL}})
    return main_launches


def phase_ps_hybrid(torch, dev, seed):
    """The reference's server_model_data_parallel recipe
    (EmbeddingBag(100, 16) + Linear(16, 8), SGD 0.05, cross-entropy on
    ragged_embedding_batches, 10 rows a step) through
    make_ps_hybrid_train_step on a one-rank NCCL group (data 1 × model 1)
    and on the CPU without a group, from the same weights: PS_STEPS steps,
    each loss and every parameter after them within PS_TOL; ms per step on
    the card; K1-K10 = 0.  Then sharded_bag_lookup's shard function with
    2 virtual model shards (50 rows each) summed, against the whole-table
    lookup on the card.  The group is destroyed at the end."""
    import numpy as np
    import torch.distributed as dist

    from tpudist_torch.data import ragged_embedding_batches
    from tpudist_torch.models import EmbeddingBagClassifier
    from tpudist_torch.models.mlp import linear_as
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.parallel import ps_hybrid as ps
    from tpudist_torch.runtime import data_model_mesh, initialize, shutdown
    from tpudist_torch.train import TrainState, sgd

    def dense_apply(m, bag):
        return linear_as(bag, m.fc, torch.float32).float()

    cpu = torch.device("cpu")
    full = EmbeddingBagClassifier(100, 16, 8, device=cpu)
    full.init_weights(torch.Generator().manual_seed(seed + 23))
    batches = list(ragged_embedding_batches(PS_STEPS + 20, batch=10,
                                            seed=seed))
    initialize(store=dist.HashStore(), world_size=1, rank=0, device=dev)
    try:
        check(dist.get_backend() == "nccl", "ps_hybrid: not an NCCL group")
        runs = {}
        for where, d, mesh in (("cuda", dev, data_model_mesh(1)),
                               ("cpu", cpu, None)):
            model = EmbeddingBagClassifier(100, 16, 8, device=d)
            model.load_state_dict(full.state_dict())
            state = TrainState.create(model, sgd(0.05))
            step = ps.make_ps_hybrid_train_step(dense_apply, cross_entropy,
                                                mesh, state, 100)
            reset_launches()
            losses = []
            for idx, mask, tgt in batches[:PS_STEPS]:
                state, m = step(state, *(torch.from_numpy(a).to(d)
                                         for a in (idx, mask, tgt)))
                losses.append(float(m["loss"]))
            runs[where] = (losses, {k: v.detach().cpu().clone() for k, v in
                                    model.state_dict().items()},
                           read_launches(), state, step)
        (lc, wc, launches, state, step), (lh, wh, _, _, _) = \
            runs["cuda"], runs["cpu"]
        loss_err = max(abs(a - b) / (1 + abs(b)) for a, b in zip(lc, lh))
        param_err = max(float(((wc[k] - wh[k]).abs()
                               / (1 + wh[k].abs())).max()) for k in wh)
        check(loss_err <= PS_TOL and param_err <= PS_TOL,
              f"ps_hybrid: card against CPU loss {loss_err}, params "
              f"{param_err}")
        half = len(lc) // 2
        check(sum(lc[half:]) < sum(lc[:half]),
              f"ps_hybrid: loss did not fall {lc}")
        check(all(v == 0 for v in launches.values()),
              f"ps_hybrid: launched kernels {launches}")
        timed = [tuple(torch.from_numpy(a).to(dev) for a in b)
                 for b in batches[PS_STEPS:]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in timed:
            state, m = step(state, *b)
        float(m["loss"])
        ms = (time.perf_counter() - t0) * 1e3 / len(timed)
        table = runs["cuda"][3].model.embedding.detach()
        idx, mask, _ = (torch.from_numpy(a).to(dev) for a in batches[0])
        whole = torch.einsum("blh,bl->bh", table[idx.long()], mask)
        halves = sum(ps._bag_contrib(part, idx, mask, s)
                     for s, part in enumerate(table.chunk(2)))
        bag_err = float((halves - whole).abs().max()
                        / whole.abs().max())
        check(bag_err <= PS_BAG_RTOL, f"ps_hybrid: 2 virtual shards off the "
              f"whole table by {bag_err} of its max")
    finally:
        shutdown()
    emit({"phase": "ps_hybrid", "steps": PS_STEPS, "losses_cuda": lc,
          "losses_cpu": lh, "loss_max_err": loss_err,
          "param_max_err": param_err, "ms_per_step": ms,
          "timed_steps": len(timed), "virtual_shards_rel_err": bag_err,
          "launches": launches,
          "tolerance": {"steps": PS_TOL, "virtual_shards": PS_BAG_RTOL}})
    return launches


# train_spmd: the train cell (8 layers, batch 8, seq 2048), 10 timed steps
SPMD = {"layers": 8, "batch": 8, "seq": 2048, "steps": 10}
# ep_moe: the train cell's widths (embed 512, 8 heads, 2 KV heads, vocab
# 32000) with every MLP an MoE MLP (E = 8, top-2, the einsum dispatch,
# capacity factor 2); depth and batch cut to 2 layers of batch 2 at seq
# 2048, as the einsum dispatch's [T, E, C] tensors (f32 routing) take
# ~4 GB each at the cell's batch 8
EP_MOE = {"layers": 2, "batch": 2, "seq": 2048, "steps": 10}


def _one_rank_group(torch, dev):
    """A one-rank NCCL group (HashStore), checked by an all-reduce."""
    import torch.distributed as dist

    from tpudist_torch.runtime import initialize

    ctx = initialize(store=dist.HashStore(), world_size=1, rank=0,
                     device=dev)
    check(dist.get_backend() == "nccl" and ctx.process_count == 1,
          f"one-rank group: backend {dist.get_backend()}, {ctx}")
    probe = torch.ones(4, device=dev)
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    check(probe.tolist() == [1.0] * 4,
          f"NCCL all-reduce on one rank gave {probe.tolist()}")


def _measure_steps(torch, dev, step, state, batch, steps):
    """2 warm-up steps, then ``steps`` on the host clock after a
    synchronize, with the launch and collective counts reset just before
    and read just after: ms a step, losses, peak memory, launches and
    collectives a step."""
    from tpudist_torch.parallel.common import CALLS, reset_calls

    for _ in range(2):
        state, _ = step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    reset_calls()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, *batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = read_launches()
    calls = dict(CALLS)
    losses = [float(v) for v in losses]
    return state, {"ms_per_step": ms, "losses": losses,
                   "max_memory_allocated_bytes":
                       torch.cuda.max_memory_allocated(dev),
                   "launches_per_step": {k: v / steps
                                         for k, v in launches.items()},
                   "collectives_per_step": {k: v / steps
                                            for k, v in calls.items()}}


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _worst_grad(got: dict, want: dict):
    worst = max(((got[n].float() - want[n].float()).abs().max().item()
                 / max(want[n].float().abs().max().item(), 1e-30), n)
                for n in want)
    return worst


def phase_train_spmd(torch, dev, seed):
    """The composed step's sharded path (make_composed_train_step with
    explicit param_specs) on one card through one-rank groups: the train
    cell's model (vocab 32000, 8 layers, H=8, Hkv=2, embed 512, seq 2048,
    batch 8, bf16 on f32 masters, Adam 3e-4, flash attention) built with
    tp_axis="tp" over MeshSpec(rules=transformer_tp_rules("tp")).build()
    (every axis of size 1), its state sharded by fsdp_specs(tp_rules=...)
    so that every leaf is claimed by tp or fsdp: each step issues the
    ZeRO-3 all-gathers and reduce-scatters, the Megatron all-reduces and
    the logits' all-gather on one-rank NCCL groups.  Step 0 against the
    unsharded flash step (make_dp_train_step) from the same weights on
    the same batch: the loss within LOSS_RTOL, every gradient within
    PGRAD_TOL of its max; then 2 warm-up and 10 measured steps of each,
    the sharded one with launch counts reset just before and read just
    after (K1 = K3 = K4 = 8 a step), ms a step beside the unsharded step,
    peak memory, collectives a step."""
    import numpy as np

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.parallel import (
        MeshSpec,
        fsdp_specs,
        make_composed_train_step,
        make_dp_train_step,
        transformer_tp_rules,
    )
    from tpudist_torch.parallel.tensor_parallel import (
        gather_tree,
        sharded_state,
    )
    from tpudist_torch.runtime import shutdown
    from tpudist_torch.train import TrainState, adam

    cfg = TransformerConfig(vocab_size=32000, num_layers=SPMD["layers"],
                            num_heads=8, num_kv_heads=2, embed_dim=512,
                            max_seq_len=8192, compute_dtype=torch.bfloat16)
    B, S, steps = SPMD["batch"], SPMD["seq"], SPMD["steps"]
    _one_rank_group(torch, dev)
    try:
        rules = tuple(transformer_tp_rules("tp"))
        spec = MeshSpec(rules=rules)
        mesh = spec.build()
        tokens = torch.from_numpy(markov_tokens(B, S, cfg.vocab_size,
                                                seed)).to(dev)
        whole = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                              param_dtype=torch.float32, device=dev)
        whole.init_weights(torch.Generator(device=dev).manual_seed(seed + 5))
        sd = {k: v.detach().clone() for k, v in whole.state_dict().items()}
        loss_fn = train_loss_fn(torch, cfg)
        ref = TrainState.create(whole, adam(3e-4), seed=seed)
        ref_step = make_dp_train_step(loss_fn)
        ref, m = ref_step(ref, tokens)
        l_ref, g_ref = float(m["loss"]), _grads(whole)

        model = TransformerLM(cfg, attention_fn=flash_attention_fn(),
                              param_dtype=torch.float32, tp_axis="tp",
                              mesh=mesh, device=dev)
        specs = fsdp_specs(model, mesh, axis="fsdp", tp_rules=rules)
        unclaimed = [n for n, s in specs.items() if not s]
        check(not unclaimed, f"train_spmd: leaves no axis claims: "
              f"{unclaimed}")
        state = sharded_state(model, sd, adam(3e-4), mesh, specs, seed)
        step = make_composed_train_step(spec, mesh, loss_fn,
                                        param_specs=specs)
        reset_launches()
        state, m = step(state, tokens)
        parity_launches = read_launches()
        l_spmd = float(m["loss"])
        g_spmd = gather_tree({n: p.grad for n, p in
                              state.model.named_parameters()}, mesh, specs)
        rel = abs(l_spmd - l_ref) / abs(l_ref)
        worst = _worst_grad(g_spmd, g_ref)
        check(np.isfinite(l_spmd) and rel <= LOSS_RTOL,
              f"train_spmd: loss {l_spmd} vs unsharded {l_ref}")
        check(worst[0] <= PGRAD_TOL, f"train_spmd: gradient of {worst[1]} "
              f"{worst[0]} of its max from the unsharded step's")
        del g_spmd, g_ref
        ref, unsharded = _measure_steps(torch, dev, ref_step, ref,
                                        (tokens,), steps)
        del ref, whole
        torch.cuda.empty_cache()
        state, row = _measure_steps(torch, dev, step, state, (tokens,),
                                    steps)
        got = row["launches_per_step"]
        want = {"K1": cfg.num_layers, "K3": cfg.num_layers,
                "K4": cfg.num_layers}
        check(all(got[k] == v for k, v in want.items())
              and all(got[k] == 0 for k in got if k not in want),
              f"train_spmd: launches a step {got}, want {want}")
        coll = row["collectives_per_step"]
        sharded = sum(1 for s in specs.values() if "fsdp" in s)
        check(coll.get("all_gather") == sharded + 1
              and coll.get("reduce_scatter") == sharded
              and coll.get("all_reduce") == 2 + 4 * cfg.num_layers,
              f"train_spmd: collectives a step {coll} ({sharded} leaves "
              f"gathered)")
        check(all(np.isfinite(row["losses"]))
              and row["losses"][-1] < row["losses"][0],
              f"train_spmd: losses {row['losses']}")
        main_launches = {k: int(v * steps) for k, v in got.items()}
        main_launches["per_step"] = got
        emit({"phase": "train_spmd", "batch": B, "seq_len": S,
              "steps": steps, "mesh": spec.axis_sizes(),
              "leaves_fsdp_gathered": sharded,
              "parity": {"loss": l_spmd, "loss_unsharded": l_ref,
                         "loss_rel_err": rel,
                         "grad_worst_rel_to_max": worst[0],
                         "grad_worst_param": worst[1],
                         "launches": parity_launches},
              "spmd": row, "unsharded": unsharded,
              "vs_unsharded": row["ms_per_step"]
              / unsharded["ms_per_step"],
              "tokens_per_s": B * S / row["ms_per_step"] * 1e3,
              "tolerance": {"loss_rtol": LOSS_RTOL,
                            "grad_rel_to_max": PGRAD_TOL}})
        del state, step
        torch.cuda.empty_cache()
        return main_launches
    finally:
        shutdown()


def phase_ep_moe(torch, dev, seed):
    """Expert parallelism on one card through one-rank groups: the train
    cell's widths with every MLP an MoE MLP (E = 8, top-2, the einsum
    dispatch), cut as EP_MOE says, bf16 on f32 masters, Adam 3e-4.  Two
    EP steps from the same weights on the same batch — the composed step
    (make_composed_train_step over MeshSpec(rules=moe_ep_rules("ep")),
    the model built with ep_axis="ep", ep_tokens="replicated": partial
    outputs all-reduced, and routing_axes=("dp", "fsdp"): the routing
    over the global batch, its gate sums all-reduced and its counts
    all-gathered on each axis) and make_ep_shard_train_step over a data × expert
    mesh (ep_tokens="sharded": the all-to-all pair, tpudist's sum
    contract) — each at step 0 against the one-process MoE step
    (make_dp_train_step on the same model without ep_axis): the loss
    within LOSS_RTOL, every gradient within PGRAD_TOL of its max; then
    each timed (2 warm-up, 10 measured) beside the one-process step, with
    launches (K1 = K3 = K4 = layers a step, K7 = 0: EP runs the einsum
    dispatch, in tpudist too) and collectives a step, peak memory."""
    import numpy as np

    from tpudist_torch.data import markov_tokens
    from tpudist_torch.models.moe import MoEConfig, MoETransformerLM
    from tpudist_torch.ops.flash_attention import flash_attention_fn
    from tpudist_torch.ops.losses import cross_entropy_per_token
    from tpudist_torch.parallel import (
        MeshSpec,
        make_composed_train_step,
        make_dp_train_step,
        make_ep_shard_train_step,
        moe_ep_rules,
        spec_tree_from_rules,
    )
    from tpudist_torch.parallel.tensor_parallel import sharded_state
    from tpudist_torch.runtime import make_mesh, shutdown
    from tpudist_torch.train import TrainState, adam

    cfg = moe_model_config(torch, EP_MOE["layers"], torch.bfloat16, 8192)
    moe = MoEConfig(num_experts=8, top_k=2, dispatch="einsum")
    B, S, steps = EP_MOE["batch"], EP_MOE["seq"], EP_MOE["steps"]
    _one_rank_group(torch, dev)
    try:
        tokens = torch.from_numpy(markov_tokens(B, S, cfg.vocab_size,
                                                seed)).to(dev)
        whole = MoETransformerLM(cfg, moe, attention_fn=flash_attention_fn(),
                                 device=dev)
        whole.init_weights(torch.Generator(device=dev).manual_seed(seed + 7))
        sd = {k: v.detach().clone() for k, v in whole.state_dict().items()}
        mean_loss = moe_loss_fn(torch, cfg)
        ref = TrainState.create(whole, adam(3e-4), seed=seed)
        ref_step = make_dp_train_step(mean_loss)
        ref, m = ref_step(ref, tokens)
        l_ref, g_ref = float(m["loss"]), _grads(whole)
        ref, one_process = _measure_steps(torch, dev, ref_step, ref,
                                          (tokens,), steps)
        del ref, whole
        torch.cuda.empty_cache()
        total = B * (S - 1)

        def shard_loss(model, batch):
            (toks,) = batch
            logits, aux = model(toks)
            per_tok = cross_entropy_per_token(
                logits[:, :-1].reshape(-1, cfg.vocab_size),
                toks[:, 1:].reshape(-1))
            return per_tok.sum() / total + aux

        rows = {}
        for kind in ("composed", "shard"):
            if kind == "composed":
                spec = MeshSpec(rules=tuple(moe_ep_rules("ep")))
                mesh = spec.build()
                model = MoETransformerLM(cfg, moe,
                                         attention_fn=flash_attention_fn(),
                                         ep_axis="ep", mesh=mesh,
                                         ep_tokens="replicated",
                                         routing_axes=spec.data_axes(),
                                         device=dev)
                specs = spec_tree_from_rules(model, spec.rules)
                state = sharded_state(model, sd, adam(3e-4), mesh, specs,
                                      seed)
                step = make_composed_train_step(spec, mesh, mean_loss,
                                                param_specs=specs)
            else:
                mesh = make_mesh({"data": 1, "expert": 1})
                model = MoETransformerLM(cfg, moe,
                                         attention_fn=flash_attention_fn(),
                                         ep_axis="expert", mesh=mesh,
                                         device=dev)
                model.load_state_dict(sd)
                state = TrainState.create(model, adam(3e-4), seed=seed)
                step = make_ep_shard_train_step(shard_loss, mesh, state)
            reset_launches()
            state, m = step(state, tokens)
            launches0 = read_launches()
            loss = float(m["loss"])
            rel = abs(loss - l_ref) / abs(l_ref)
            worst = _worst_grad(_grads(state.model), g_ref)
            check(np.isfinite(loss) and rel <= LOSS_RTOL,
                  f"ep_moe {kind}: loss {loss} vs one-process {l_ref}")
            check(worst[0] <= PGRAD_TOL, f"ep_moe {kind}: gradient of "
                  f"{worst[1]} {worst[0]} of its max from the one-process "
                  "step's")
            state, row = _measure_steps(torch, dev, step, state, (tokens,),
                                        steps)
            got = row["launches_per_step"]
            want = {k: cfg.num_layers for k in ("K1", "K3", "K4")}
            check(all(got[k] == v for k, v in want.items())
                  and all(got[k] == 0 for k in got if k not in want),
                  f"ep_moe {kind}: launches a step {got}, want {want}")
            coll = row["collectives_per_step"]
            # composed, per layer: the partial outputs' sum and the
            # cotangents of x and the combine weights; per routing axis
            # (dp, fsdp), the gate sums' all-reduce forward and backward
            # and the counts' all-gather
            want_coll = ({"all_reduce": 7 * cfg.num_layers,
                          "all_gather": 2 * cfg.num_layers}
                         if kind == "composed"
                         else {"all_to_all": 4 * cfg.num_layers})
            check(coll == want_coll, f"ep_moe {kind}: collectives a step "
                  f"{coll}, want {want_coll}")
            check(all(np.isfinite(row["losses"]))
                  and row["losses"][-1] < row["losses"][0],
                  f"ep_moe {kind}: losses {row['losses']}")
            rows[kind] = {"loss0": loss, "loss_rel_err": rel,
                          "grad_worst_rel_to_max": worst[0],
                          "grad_worst_param": worst[1],
                          "launches_step0": launches0, **row,
                          "vs_one_process": row["ms_per_step"]
                          / one_process["ms_per_step"]}
            del state, step, model
            torch.cuda.empty_cache()
        emit({"phase": "ep_moe", "layers": cfg.num_layers, "batch": B,
              "seq_len": S, "experts": moe.num_experts, "top_k": moe.top_k,
              "dispatch": moe.dispatch, "loss_one_process": l_ref,
              "one_process": one_process, **rows,
              "tolerance": {"loss_rtol": LOSS_RTOL,
                            "grad_rel_to_max": PGRAD_TOL}})
    finally:
        shutdown()


# check_build, sim, sim_replay and mesh_bench: the port's CLIs and the
# offline fleet simulator replaying a live fleet on this card
# sim_replay: bench.py's bench_sim_replay (tpudist's AutoscaleConfig, its
# 16-request spike, a 15 s queue-wait window on the replicas); the
# replicas serve the router's default model, paged at block 16
SIM_REPLAY = {"autoscale": dict(
    min_replicas=1, max_replicas=2, target_wait_s=0.005, low_wait_s=0.001,
    quantile=0.9, breach_polls=2, idle_polls=50, up_cooldown_s=60.0,
    down_cooldown_s=600.0, poll_s=0.25, max_metric_age_s=10.0),
    "requests": 16, "new": 16, "window_s": 15,
    "replica_args": ["--cache-layout", "paged", "--kv-block-size", "16",
                     "--ttl", "1.0"]}
# mesh_bench: the real LM's schedule bubble must stay at or under this
# (tpudist's acceptance point: P=4, M=16, V=4 gives 0.0448)
MESH_BUBBLE_MAX = 0.08


def _run_module(args: list, timeout: float):
    """``python -m <args>`` from the repo root; the completed process."""
    import os

    env = dict(os.environ, PYTHONPATH=_repo_root())
    return subprocess.run([sys.executable, "-m", *args], cwd=_repo_root(),
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def phase_check_build(smi: str) -> dict:
    """``python -m tpudist_torch.check_build`` on this card: rc 0, the
    required probes (torch backend, collectives over one NCCL rank a card,
    the kernels) OK, and the kernel probe's flash forward (K1) launched on
    the card within the probe's 0.05 of the plain reference.  Prints every
    probe's line; returns K1's launch count and error."""
    import re

    t0 = time.perf_counter()
    res = _run_module(["tpudist_torch.check_build"], 600)
    wall = time.perf_counter() - t0
    probes = {}
    for line in res.stdout.splitlines():
        m = re.match(r"\[(OK  |FAIL|WARN)\] (.+?)  +(.*)$", line)
        if m:
            probes[m.group(2).strip()] = {"mark": m.group(1).strip(),
                                          "detail": m.group(3)}
    check(res.returncode == 0, f"check_build: rc {res.returncode}\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    for name in ("torch backend", "collectives", "kernels"):
        check(probes.get(name, {}).get("mark") == "OK",
              f"check_build: required probe {name!r}: {probes.get(name)}")
    kern = probes["kernels"]["detail"]
    launched = re.search(r"(\d+) launch", kern)
    err = re.search(r"max err ([0-9.eE+-]+)", kern)
    check(launched is not None and int(launched.group(1)) >= 1
          and err is not None and float(err.group(1)) < 0.05,
          f"check_build: kernel probe {kern!r}")
    row = {"launches": int(launched.group(1)),
           "max_abs_err": float(err.group(1))}
    emit({"phase": "check_build", "nvidia_smi": smi, "rc": res.returncode,
          "wall_s": wall, "probes": probes,
          "last_line": res.stdout.strip().splitlines()[-1], "K1": row})
    return row


def phase_sim(smi: str) -> None:
    """The 13 builtin scenarios through the port's FleetSim at full
    length, as ``python -m tpudist_torch.sim --all --check --jsonl f``
    runs them (a process of its own: the summary rows read the process's
    counters), with steady_state's spec once more from a file
    (``--spec``): rc 0, 13 scenarios, every envelope_ok, no lost
    request, and steady_state's second row equal to its first but for
    the two real-clock fields.  Prints each scenario's sim_wall_s and
    speedup."""
    import os
    import tempfile

    from tpudist_torch.sim.scenario import BUILTIN

    real_clock = ("sim_wall_s", "speedup")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scenarios.jsonl")
        spec = os.path.join(tmp, "steady_state.json")
        with open(spec, "w") as f:
            json.dump(BUILTIN["steady_state"], f)
        t0 = time.perf_counter()
        res = _run_module(["tpudist_torch.sim", "--all", "--spec", spec,
                           "--check", "--jsonl", out], 600)
        wall = time.perf_counter() - t0
        check(res.returncode == 0, f"sim: rc {res.returncode}\n"
              f"{res.stderr[-3000:]}")
        with open(out) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    check(len(rows) == 14 and len({r["scenario"] for r in rows}) == 13,
          f"sim: {len(rows)} rows")
    bad = {r["scenario"]: r["violations"] for r in rows
           if not r["envelope_ok"] or r["lost_requests"] != 0}
    check(not bad, f"sim: envelopes violated {bad}")
    first, second = (r for r in rows if r["scenario"] == "steady_state")
    diff = sorted(k for k in set(first) | set(second)
                  if k not in real_clock and first.get(k) != second.get(k))
    check(not diff, f"sim: steady_state rerun differs in {diff}")
    emit({"phase": "sim", "nvidia_smi": smi, "wall_s": wall,
          "scenarios": {r["scenario"]: {k: r[k] for k in (
              "sim_wall_s", "speedup", "virtual_s", "requests",
              "scale_ups", "drains", "alerts_fired")} for r in rows[:13]},
          "steady_state_rerun_equal": True})


def phase_sim_replay(torch, smi: str, seed: int) -> dict:
    """bench.py's sim_replay cell on the card: a live one-replica fleet
    (chip_smoke's replica mode, which runs the router's replica main as
    ``launch_local_fleet``'s ``python -m`` does, on ``cuda``) under an
    Autoscaler with tpudist's config takes the 16-request spike and buys
    a joiner, spawned in the same mode; the merged ``tpudist.events/1``
    document and the decision log are recorded, and
    ``FleetSim.from_trace`` replays the run.  Gate: the simulator's
    ``decision_match`` (equal scale-up counts, the first scale-up within
    one poll of the first breach on both), and every replica that served
    launching K1 and K5 (paged) and no K2, counted in the replica from
    its start.  Prints the live and sim wall seconds, the speedup, each
    replica's launches, and the live p50/p99 queue wait (the replica's
    windowed histogram) beside the sim's: printed, not gated (tpudist's
    bench explains why that agreement is loose).  Returns the launches
    summed over the replicas."""
    import os
    import tempfile

    import numpy as np

    from tpudist_torch import obs
    from tpudist_torch.models.serving import Request
    from tpudist_torch.obs.aggregate import collect, merge_snapshots
    from tpudist_torch.obs.events import collect_events, merge_events
    from tpudist_torch.obs.registry import hist_quantile
    from tpudist_torch.runtime import router as rt
    from tpudist_torch.runtime.autoscaler import AutoscaleConfig, Autoscaler
    from tpudist_torch.runtime.coord import CoordClient, CoordServer
    from tpudist_torch.sim import FleetSim
    from tpudist_torch.sim.simulator import decision_match

    cfg = SIM_REPLAY
    autoscale = cfg["autoscale"]
    server = CoordServer(0)
    ns = "sim-replay"
    addr = f"127.0.0.1:{server.port}"
    client = CoordClient("127.0.0.1", server.port)
    env = dict(os.environ, PYTHONPATH=_repo_root(),
               TPUDIST_SERVE_WAIT_WINDOW_S=str(cfg["window_s"]))
    args = ["--device", "cuda", *cfg["replica_args"]]
    rng = np.random.default_rng(seed)
    spike = [Request(rng.integers(0, 64, 4 + i % 6).astype(np.int32),
                     cfg["new"], rid=f"rp-{i}")
             for i in range(cfg["requests"])]
    # the recorded trace must hold this run's enqueue events only
    obs.events.clear()
    with tempfile.TemporaryDirectory() as tmp:
        outs = {}

        def spawn(i):
            outs[f"r{i}"] = f"{tmp}/{ns}_r{i}.json"
            return _smoke_replica(addr, ns, i, args, outs[f"r{i}"], env)

        rt._seed_replica_index(client, 1, namespace=ns)
        procs = [spawn(0)]
        spawn_client = CoordClient("127.0.0.1", server.port)
        scaler = Autoscaler(
            CoordClient("127.0.0.1", server.port), namespace=ns,
            config=AutoscaleConfig(**autoscale),
            spawner=lambda n: [spawn(i) for i in rt.alloc_replica_indices(
                spawn_client, n, namespace=ns)])
        try:
            rt.wait_live(client, 1, namespace=ns, timeout_s=180.0,
                         procs=procs)
            router = rt.Router(client, namespace=ns, lost_after_s=5.0)
            router._poll({}, {}, None)        # pin the membership baseline
            t0 = time.perf_counter()
            scaler.start()
            comps = router.run(list(spike), timeout_s=240.0)
            # the published histogram is windowed: read the spike's waits
            merged_live = merge_snapshots(collect(client, f"{ns}/metrics"))
            limit = time.perf_counter() + 90.0
            while (time.perf_counter() < limit
                   and not any(a["kind"] == "up"
                               for a in scaler.action_seq())):
                time.sleep(0.5)
            live_wall_s = time.perf_counter() - t0
            scaler.stop()
        finally:
            scaler.stop()
            codes = rt.stop_fleet(client, procs + scaler.procs,
                                  namespace=ns, timeout_s=60.0)
        doc = merge_events(collect_events(client, f"{ns}/events"),
                           router=obs.events.snapshot())
        dumps = {}
        for rid, out in outs.items():
            if os.path.exists(out):
                with open(out) as fh:
                    dumps[rid] = json.load(fh)
    server.stop()
    check(sorted(str(c.rid) for c in comps)
          == sorted(str(r.rid) for r in spike)
          and all(c.reason == "length" for c in comps),
          f"sim_replay: live completions "
          f"{sorted((str(c.rid), c.reason) for c in comps)}")
    launches = {"K1": 0, "K2": 0, "K5": 0}
    replicas = {}
    for rid, d in dumps.items():
        n, served = d["launches"], d["counters"].get("serve/requests", 0)
        replicas[rid] = {"K1": n["K1"], "K2": n["K2"], "K5": n["K5"],
                         "requests": served}
        if served:
            check(n["K1"] > 0 and n["K5"] > 0 and n["K2"] == 0,
                  f"sim_replay: {rid} launched {n}")
        for k in launches:
            launches[k] += n[k]
    check(replicas.get("r0", {}).get("requests", 0) >= 1
          and launches["K1"] > 0 and launches["K5"] > 0,
          f"sim_replay: the live replicas' launches {replicas}")

    sim = FleetSim.from_trace(doc, autoscale=autoscale, replicas=1)
    t0 = time.perf_counter()
    sim_row = sim.run()
    sim_wall_s = time.perf_counter() - t0
    match = decision_match(scaler.decision_log, scaler.action_seq(),
                           sim.scaler.decision_log, sim.scaler.action_seq(),
                           autoscale["target_wait_s"])
    check(match["decision_match"] and match["live_ups"] >= 1,
          f"sim_replay: {match}")
    check(sim_row["lost_requests"] == 0,
          f"sim_replay: the replay lost {sim_row['lost_requests']}")
    live_h = merged_live["histograms"].get("serve/queue_wait_s")
    have_live = bool(live_h) and live_h["count"] > 0
    sim_waits = [w for r in sim.replicas for w in r.all_waits]
    emit({"phase": "sim_replay", "nvidia_smi": smi,
          "requests": len(spike), "events": len(doc.get("events", [])),
          **match, "live_wall_s": live_wall_s,
          "sim_wall_s": sim_wall_s, "speedup": live_wall_s / sim_wall_s,
          "live_p50_wait_s": (hist_quantile(live_h, 0.5) if have_live
                              else None),
          "live_p99_wait_s": (hist_quantile(live_h, 0.99) if have_live
                              else None),
          "sim_p50_wait_s": (float(np.percentile(sim_waits, 50))
                             if sim_waits else None),
          "sim_p99_wait_s": (float(np.percentile(sim_waits, 99))
                             if sim_waits else None),
          "service_rates": sim.rates, "exit_codes": codes,
          "replicas": replicas, "launches": launches})
    return launches


def phase_mesh_bench(smi: str) -> None:
    """``python -m tpudist_torch.parallel.mesh_bench --force-cpu --out
    f``: 8 gloo ranks on the CPU (one NCCL rank a card needs 8 cards and
    this machine has one).  Checks: the six
    composition rows bitwise equal to their single-strategy steps, and
    the real LM through interleaved 1F1B (P=4, M=16, V=4) trained with
    its bubble at most MESH_BUBBLE_MAX.  Prints the rows and the wall
    seconds."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mesh_bench.jsonl")
        t0 = time.perf_counter()
        res = _run_module(["tpudist_torch.parallel.mesh_bench",
                           "--force-cpu", "--out", out], 900)
        wall = time.perf_counter() - t0
        check(res.returncode == 0, f"mesh_bench: rc {res.returncode}\n"
              f"{res.stderr[-3000:]}")
        with open(out) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    combos = [r for r in rows if not r["combo"].startswith("real_lm")]
    lm = next(r for r in rows if r["combo"].startswith("real_lm"))
    check(len(combos) == 6 and all(r["exact_match"] for r in combos),
          "mesh_bench: combos " + str([(r["combo"], r["exact_match"],
                                        r["max_abs_diff"]) for r in combos]))
    check(lm["trained"] and lm["bubble_fraction"] <= MESH_BUBBLE_MAX,
          f"mesh_bench: real LM {lm}")
    emit({"phase": "mesh_bench", "nvidia_smi": smi, "wall_s": wall,
          "ranks": "8 gloo (CPU)",
          "rows": rows})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_main = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from tpudist_torch.models.serving import ServeLoop
    from tpudist_torch.ops import _cuda

    _time_phases()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _cuda.build()
    PHASE_SECONDS["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": PHASE_SECONDS["build"],
          "libraries": sorted(p.name for p in libs.values())})

    k1, k2 = phase_kernels(torch, dev, args.seed)
    paged_rows = phase_paged_kernels(torch, dev, args.seed)
    sp_rows = phase_sp_decode(torch, dev, args.seed)
    phase_parity(torch, dev, args.seed)
    phase_paged_parity(torch, dev, args.seed)
    launches, loop = phase_serve(torch, dev, args.seed)
    phase_profile(torch, loop, args.seed)
    # the same tick on the paged layout (full-capacity pool, block 128)
    paged_loop = ServeLoop(loop.cfg, loop.model.state_dict(), num_slots=4,
                           steps_per_sync=32, prefill_chunk=512,
                           cache_layout="paged", kv_block_size=128,
                           pipeline_depth=1, device=dev)
    phase_profile(torch, paged_loop, args.seed, name="profile_paged")
    del loop, paged_loop
    paged_launches = phase_serve_paged(torch, dev, args.seed)
    phase_serve_prefix(torch, dev, args.seed)
    pipe_launches = phase_serve_pipelined(torch, dev, args.seed)
    spec_parity_launches, spec_worst = phase_spec_parity(torch, dev,
                                                         args.seed)
    spec_launches = {"spec_parity": spec_parity_launches,
                     "spec_serve": phase_spec_serve(torch, dev, args.seed),
                     "serve_roles": phase_serve_roles(torch, dev, args.seed)}
    spec_launches["sharded_generate"] = phase_sharded_generate(
        torch, dev, args.seed)
    spec_launches["kv_tier"] = phase_kv_tier(torch, dev, args.seed)
    spec_launches["fleet"], fleet_want = phase_fleet(torch, dev, args.seed)
    spec_launches["fleet_autoscale"] = phase_fleet_autoscale(
        torch, dev, args.seed, fleet_want)
    del fleet_want
    q8_launches = phase_decode_q8(torch, dev, args.seed)
    bwd_rows, k1_train = phase_backward_kernels(torch, dev, args.seed)
    phase_train_parity(torch, dev, args.seed)
    train_launches = phase_train(torch, dev, args.seed)
    moe_rows, _ = phase_moe_kernels(torch, dev, args.seed)
    phase_train_moe_parity(torch, dev, args.seed)
    moe_launches = phase_train_moe(torch, dev, args.seed)
    ring_rows = phase_ring_kernels(torch, dev, args.seed)
    _, sp4_launches = phase_ring_sp4(torch, dev, args.seed)
    sp_launches = phase_train_sp(torch, dev, args.seed)
    gn_rows = phase_gn_kernels(torch, dev, args.seed)
    phase_resnet_parity(torch, dev, args.seed)
    gn_launches, _ = phase_gn_sites(torch, dev, args.seed)
    phase_train_resnet(torch, dev, args.seed)
    phase_mnist_parity(torch, dev, args.seed)
    phase_train_mnist(torch, dev, args.seed)
    phase_train_convnet(torch, dev, args.seed)
    host_card = phase_elastic_kill9(torch, dev, args.seed)
    phase_elastic_ici(torch, dev, args.seed, host_card)
    del host_card
    phase_elastic_horovod(torch, dev, args.seed)
    phase_host_collectives(torch, dev, args.seed)
    phase_pipeline_resnet(torch, dev, args.seed)
    pp_launches = phase_train_pp(torch, dev, args.seed)
    phase_ps_hybrid(torch, dev, args.seed)
    tp_rows, k1_tp = phase_backward_kernels(
        torch, dev, args.seed, cases=TP_CASES, phase="tp_kernels",
        k1_case="tp2_shard")
    spmd_launches = phase_train_spmd(torch, dev, args.seed)
    phase_ep_moe(torch, dev, args.seed)
    cb_k1 = phase_check_build(smi)
    spec_launches["sim_replay"] = phase_sim_replay(torch, smi, args.seed)
    # sim (one process) and mesh_bench (8 single-threaded ranks) are host
    # work only: run them side by side on the host's cores
    with ThreadPoolExecutor(2) as pool:
        host_phases = [pool.submit(phase_sim, smi),
                       pool.submit(phase_mesh_bench, smi)]
        for phase in host_phases:
            phase.result()

    main_k1 = next(r for r in k1 if r["q_offset"] == 7168)
    main_k2 = next(r for r in k2 if r["case"] == "per_row_side")
    sp_k1 = next(r for r in ring_rows if r["case"] == "train_sp")["K1"]
    kernels = [
        {"name": "flash_forward (K1)", "route": "cuda",
         "source": "tpudist_torch/csrc/flash_attention.cu",
         "replaces": "tpudist/ops/flash_attention.py:127",
         "launches": launches["K1"],
         "max_abs_err": max([r["max_abs_err"] for r in k1]
                            + [r["K1"]["max_abs_err"] for r in ring_rows]
                            + [k1_train["max_abs_err"],
                               k1_tp["max_abs_err"],
                               spec_worst["K1"]["max_abs_err"]]),
         "tol_ratio": max([r["tol_ratio"] for r in k1]
                          + [r["K1"]["tol_ratio"] for r in ring_rows]
                          + [k1_train["tol_ratio"], k1_tp["tol_ratio"],
                             spec_worst["K1"]["tol_ratio"]]),
         **{k: main_k1[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
         "launches_train": train_launches["K1"],
         "launches_serve_pipelined": {k: v["K1"]
                                      for k, v in pipe_launches.items()},
         "launches_sp": sp_launches["K1"],
         **{f"launches_{ph}": n["K1"] for ph, n in spec_launches.items()},
         "launches_train_pp": pp_launches["K1"],
         "launches_train_pp_per_step": pp_launches["per_step"]["K1"],
         "plan": main_k1["plan"],
         "train_ms": k1_train["ms"], "train_bound_ms": k1_train["bound_ms"],
         "train_library_ms": k1_train["library_ms"],
         "sp_ms": sp_k1["ms"], "sp_bound_ms": sp_k1["bound_ms"],
         "sp_library_ms": sp_k1["library_ms"], "sp_plan": sp_k1["plan"],
         "launches_train_spmd": spmd_launches["K1"],
         "launches_train_spmd_per_step": spmd_launches["per_step"]["K1"],
         "launches_check_build": cb_k1["launches"],
         "check_build_max_abs_err": cb_k1["max_abs_err"],
         **{"tp_shard_" + k: k1_tp[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "plan", "shape")}},
        {"name": "flash_decode (K2)", "route": "cuda",
         "source": "tpudist_torch/csrc/flash_decode.cu",
         "replaces": "tpudist/ops/flash_decode.py:62",
         "launches": launches["K2"],
         "launches_serve_pipelined_depth1": pipe_launches["dense_depth1"][
             "K2"],
         "launches_serve_pipelined_depth2": pipe_launches["dense_depth2"][
             "K2"],
         **{f"launches_{ph}": n["K2"] for ph, n in spec_launches.items()},
         "max_abs_err": max([r["max_abs_err"] for r in k2]
                            + [spec_worst["K2"]["max_abs_err"]]),
         "tol_ratio": max([r["tol_ratio"] for r in k2]
                          + [spec_worst["K2"]["tol_ratio"]]),
         **{k: main_k2[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "partial_ms",
                                    "merge_ms", "plan")},
         **sp_summary(sp_rows["K2"])},
    ]
    main_bwd = next(r for r in bwd_rows if r["case"] == "train")
    tp_bwd = tp_rows[0]
    for key, name, src_line in (
            ("K3", "flash_bwd_dq (K3)", "tpudist/ops/flash_attention.py:320"),
            ("K4", "flash_bwd_dkv (K4)",
             "tpudist/ops/flash_attention.py:364")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpudist_torch/csrc/flash_attention_bwd.cu",
            "replaces": src_line, "launches": train_launches[key],
            "launches_train_pp": pp_launches[key],
            "launches_train_pp_per_step": pp_launches["per_step"][key],
            "launches_train_spmd": spmd_launches[key],
            "launches_train_spmd_per_step":
                spmd_launches["per_step"][key],
            "max_abs_err": max(r[key]["max_abs_err"] for r in bwd_rows
                               + tp_rows
                               + (ring_rows if key == "K4" else [])),
            "tol_ratio": max(r[key]["tol_ratio"] for r in bwd_rows
                             + tp_rows
                             + (ring_rows if key == "K4" else [])),
            **{k: main_bwd[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")},
            # SDPA's whole backward, one call for the pair K3 + K4
            "library_ms": main_bwd["library_ms"],
            **{"tp_shard_" + k: tp_bwd[key][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")},
            "tp_shard_library_ms": tp_bwd["library_ms"],
            "tp_shard_plan": tp_bwd["plan"][key]})
    # K8 is launched at train_sp's shape; K4 there too (sp_ms)
    main_k8 = next(r for r in ring_rows if r["case"] == "train_sp")
    kernels[-1].update({"launches_sp": sp_launches["K4"],
                        "sp_ms": main_k8["K4"]["ms"],
                        "sp_bound_ms": main_k8["K4"]["bound_ms"]})
    train_k8 = next(r for r in ring_rows if r["case"] == "train")
    kernels.append({
        "name": "flash_bwd_dq_delta (K8)", "route": "cuda",
        "source": "tpudist_torch/csrc/flash_attention_bwd.cu",
        "replaces": "tpudist/ops/flash_attention.py:286",
        "launches": sp_launches["K8"],
        "launches_ring_sp4": sp4_launches["K8"],
        "max_abs_err": max(r["max_abs_err"] for r in ring_rows),
        "tol_ratio": max(r["tol_ratio"] for r in ring_rows),
        # library_ms: SDPA's whole backward, one call for the pair K8 + K4
        **{k: main_k8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "K3_ms")},
        "train_ms": train_k8["ms"], "train_K3_ms": train_k8["K3_ms"]})
    for key, name, launched, main_case in (
            ("K5", "paged_flash_decode (K5)", paged_launches["K5"],
             "block128"),
            ("K6", "flash_decode_q8 (K6)", q8_launches["K6"], "per_row")):
        rows = paged_rows[key] + ([spec_worst["K5"]] if key == "K5" else [])
        main_row = next(r for r in rows if r.get("case") == main_case)
        sp_extra = sp_summary(sp_rows["K6"]) if key == "K6" else {}
        rows = rows + (sp_rows["K6"] if key == "K6" else [])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpudist_torch/csrc/flash_decode.cu",
            "replaces": "tpudist/ops/flash_decode.py:62",
            "launches": launched,
            **({**{f"launches_serve_pipelined_depth{d}":
                   pipe_launches[f"paged_depth{d}"]["K5"] for d in (1, 2)},
                **{f"launches_{ph}": n["K5"]
                   for ph, n in spec_launches.items()}}
               if key == "K5" else {}),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "tol_ratio": max(r["tol_ratio"] for r in rows),
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "partial_ms", "merge_ms", "plan")},
            **sp_extra})
    main_k7 = next(r for r in moe_rows if r["case"] == "train")
    kernels.append({
        "name": "moe_gmm (K7)", "route": "cuda",
        "source": "tpudist_torch/csrc/moe_gmm.cu",
        "replaces": "tpudist/ops/moe_dispatch.py:39",
        "launches": moe_launches["K7"],
        "max_abs_err": max(r["max_abs_err"] for r in moe_rows),
        "tol_ratio": max(r["tol_ratio"] for r in moe_rows),
        **{k: main_k7[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "design_bound_ms",
                                   "variant")}})
    main_gn = next(r for r in gn_rows if r["case"] == "1024x256_add_relu")
    stem_gn = next(r for r in gn_rows if r["case"].startswith("224px"))
    for key, name, line in (("K9", "group_norm_fwd (K9)", 126),
                            ("K10", "group_norm_bwd (K10)", 153)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpudist_torch/csrc/group_norm.cu",
            "replaces": f"tpudist/ops/group_norm.py:{line}",
            "launches": gn_launches[key],
            "launches_by_path": gn_launches["by_path"][key],
            "max_abs_err": max(r["max_abs_err"] for r in gn_rows),
            "tol_ratio": max(r["tol_ratio"] for r in gn_rows),
            **{k: main_gn[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
            "variant": main_gn[key]["path"],
            "cluster": main_gn[key]["cluster"],
            "share_of_bound": main_gn[key]["share_of_bound"],
            "stem_ms": stem_gn[key]["ms"],
            "stem_variant": stem_gn[key]["path"]})
    emit({"phase": "phase_seconds", **PHASE_SECONDS,
          "total": time.perf_counter() - t_main})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
