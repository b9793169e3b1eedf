// K1: flash-attention forward for Hopper (sm_90a).
//
// What it replaces.  tpudist/ops/flash_attention.py::_flash_kernel (Pallas,
// B1), reached through _flash_forward: O = softmax(scale * Q K^T) V and the
// row log-sum-exp (f32), causal or windowed at global q/k offsets, GQA by
// index.  Its callers: the autograd forward (training), every prefill chunk
// of the serve path (CausalSelfAttention._prefill_attend, q_offset = the
// cache index as a device scalar, K/V the whole packed cache) and each ring
// step (integer offsets, blocks that may be wholly in the future).
//
// What bounds it on an H100: at the training shape (B=8, S=2048, H=8,
// Hkv=2, D=64, causal) it does 4 FLOPs per live (q, k) pair and head dim,
// ~34 GFLOP against ~42 MB of tensors; a 512-query prefill chunk at 7k
// cached keys ~7.8 GFLOP against ~5 MB: far above the card's ~295
// FLOP/byte ridge, so it is bound by tensor-core operations (989 TFLOP/s
// bf16).
//
// The design, against what held the first version (mma.sync m16n8k16,
// synchronous tile loads, scalar V reads, expf, one CTA walking every key
// tile of its 64 queries) back:
//  1. wgmma.  A warpgroup (128 threads) owns 64 query rows of one (batch,
//     head).  S = Q K^T is m64n64k16 with Q and K from swizzled shared
//     tiles, K-major; O += P V takes P from registers as the rs A operand
//     (the S accumulator layout is the A-fragment layout, rounded to bf16
//     as the Pallas kernel rounds p.astype(v.dtype)) and V read MN-major
//     from the same tile (the transpose bit).  P never touches shared
//     memory; Q stays a shared (ss) operand (a register-resident A operand
//     held across a walk was clobbered by ptxas in the backward).
//  2. cp.async tiles.  K and V stream through two shared buffers each,
//     zero-filled past the Sk edge and committed as separate groups, so
//     K of tile t + 2 lands while tile t's P V runs.  cp.async rather than
//     TMA: the inputs are strided views (the packed serve cache [B, S,
//     Hkv*D], the model's unbind views), and cp.async needs no tensor map
//     per call.
//  3. Softmax on the SFU, under the products.  scale * log2(e) is folded
//     into one FMA per score, the exponentials are ex2.approx, and the
//     running max and sum live in the log2 domain.  S of tile t + 1 and
//     P V of tile t are committed as two wgmma groups back to back, so
//     tile t + 1's exponentials run while P V of tile t is in the tensor
//     cores (the last tile's P V is peeled off the loop: a product issued
//     under a branch makes ptxas serialise the whole pipeline, warning
//     C7514).  A tile wholly inside the causal band and the Sk edge skips
//     the per-element mask.
//  4. Long key walks split over CTAs.  The host planner
//     (ops/flash_attention.py::_fwd_plan: Sk, the window, B*H and the SM
//     count; never Sq or the offsets) gives `splits` CTAs (grid z) of
//     `chunk` key tiles each: split s takes the tiles [s * chunk, (s + 1) *
//     chunk) in ABSOLUTE key positions, intersected with its q-tile's walk.
//     With splits > 1 each non-empty split writes its unnormalised f32 O
//     and its (max, sum) to a workspace the wrapper allocates, and
//     flash_fwd_merge_kernel, in the same call, merges the q-tile's
//     non-empty splits in split order by the log-sum-exp identity and
//     rounds: no atomics, so two calls agree bit for bit.  A split wholly
//     past the causal limit (read on the device from the device offset) or
//     before the window band does no work; the merge skips it.  At the
//     serve shape (B=1, 8 heads, Sk = 8192) a 512-query chunk runs 256
//     CTAs of at most 32 tiles, not 64 CTAs of up to 120.
//  5. Two heads a CTA on large grids.  Where the GQA group is even and
//     the grid holds at least 4 one-head CTAs an SM (training), a CTA's
//     two warpgroups take two query heads of one group over the same rows
//     and share every streamed K/V tile, halving the tiles' L2 traffic.
//  Chunk invariance.  A query row's keys fall into the same tiles and the
//  same splits, in the same order, whatever prefill chunk the row arrives
//  in (the plan does not see Sq or the offsets, tiles sit at absolute key
//  positions), and a tile or split with no live key for the row adds
//  exactly nothing (its exponentials are 0, its max stays at -1e30).  So a
//  row's output and LSE are bit-identical across chunkings: prefix sharing
//  on or off, ServeLoop or greedy_generate.  Pairing heads changes no
//  row's arithmetic either.
//  A row with no live key at all gives O = 0 and LSE = -1e30 exactly (the
//  ring's dead blocks).  f32 inputs keep exact FMAs (no TF32) on the same
//  accumulator layout, tiles padded to D + 4 floats a row, one tile at a
//  time, through the same copies, plan and merge.
// Still left (later work): a producer warp with TMA and ping-pong
// scheduling of two consumer warpgroups (the per-tile __syncthreads pair
// is shared by every warpgroup of the CTA), 128-key tiles, all of a GQA
// group's heads on one K/V stream, and a merge-free split at train_sp's
// shape (4 splits there cost ~6% against one, the price of the serve
// shape's plan, which the planner cannot tell apart without Sq).

#include "flash_common.cuh"

namespace {

using namespace tpudist;
using namespace tpudist::sm90;
using namespace tpudist::flash;

constexpr int kBQ = 64;     // query rows per CTA
constexpr int kBK = 64;     // keys per K/V tile
constexpr int kStages = 2;  // shared buffers of the streamed K/V tiles

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;        // [B, H, Sq]
  float* o_part;     // [splits, B, H, Sq, D] f32 (splits > 1)
  float* ml_part;    // [splits, B, H, Sq, 2] f32: log2-domain max, sum
  int B, Sq, Sk, H, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  const int* q_off_ptr;  // device scalar, or null -> q_off
  const int* k_off_ptr;
  int q_off, k_off;
  int causal, window;    // window <= 0: none (applies only when causal)
  float scale;
  int splits, chunk;     // CTAs sharing a q-tile's walk; key tiles each
};

struct Offsets {
  int q, k;
};

__device__ __forceinline__ Offsets offsets(const FwdArgs& a) {
  return {a.q_off_ptr ? *a.q_off_ptr : a.q_off,
          a.k_off_ptr ? *a.k_off_ptr : a.k_off};
}

// Key tiles [lo, hi) (in units of kBK keys) of the q-tile at q0: from the
// window band's first tile to the causal limit min(Sk, q_offset + last
// row + 1 - k_offset).
struct Tiles {
  int lo, hi;
};

__device__ __forceinline__ Tiles fwd_walk(const FwdArgs& a, Offsets off,
                                          int q0) {
  const int rows = min(kBQ, a.Sq - q0);
  int lo = 0, hi = a.Sk;
  if (a.causal) {
    hi = max(0, min(a.Sk, off.q + q0 + rows - off.k));
    if (a.window > 0) lo = max(0, off.q + q0 - (a.window - 1) - off.k);
  }
  return {lo / kBK, (hi + kBK - 1) / kBK};
}

// The tiles split s takes of walk w (all of them with one split).
__device__ __forceinline__ Tiles split_tiles(const FwdArgs& a, Tiles w,
                                             int s) {
  if (a.splits == 1) return w;
  return {max(w.lo, s * a.chunk), min(w.hi, (s + 1) * a.chunk)};
}

// Whether key position kp is visible to query position qp.
__device__ __forceinline__ bool visible(const FwdArgs& a, int qp, int kp) {
  return !a.causal || (kp <= qp && (a.window <= 0 || qp - kp < a.window));
}

// WG warpgroups a CTA, one query head each (WG = 2: two heads of one GQA
// group, sharing every streamed K/V tile).
template <typename T, int D, int WG>
struct FwdSmem {
  using QT = TileOf<T, kBQ, D>;
  using KT = TileOf<T, kBK, D>;
  static constexpr int kQ = 0, kKV = WG * QT::kBytes;
  static constexpr int kStage = 2 * KT::kBytes;  // K then V
  static constexpr int kPs = kKV + kStages * kStage;  // f32 path: P rows
  static constexpr int kPld = kBK + 1;
  static constexpr size_t kBytes =
      1024 + kPs + (std::is_same<T, float>::value ? kBQ * kPld * 4 : 0);
};

// f32 scores s = Q·Kᵀ over head dim D for this thread's rows r0, r0 + 8
// against the tile's kBK keys (PadTile rows), in the accumulator layout:
// exact FMAs.
template <int D>
__device__ __forceinline__ void scores_f32(float (&s)[kBK / 2],
                                           const float* Q, const float* K,
                                           int r0, int t4) {
  constexpr int ld = D + 4;
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) {
    const float* qr = Q + ((j & 3) < 2 ? r0 : r0 + 8) * ld;
    const float* kr = K + ((j >> 2) * 8 + t4 * 2 + (j & 1)) * ld;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
    s[j] = acc;
  }
}

// One thread's share of the online softmax of its two rows.
struct Rows {
  int qp0, qp1;    // the rows' global query positions
  float m0, m1;    // running max (log2 domain, floored at -1e30)
  float l0, l1;    // this thread's share of the running sum
};

// The score tile at key kt (raw, accumulator layout) -> P = 2^(s*scale*
// log2 e - m) in place, masked scores 0, the rows' max and sums advanced;
// returns the factors (c0, c1) that rescale the output accumulator.
__device__ __forceinline__ float2 softmax_tile(float (&s)[kBK / 2], Rows& r,
                                               const FwdArgs& a, Offsets off,
                                               int q0, int kt, int t4,
                                               float sl2) {
  constexpr int NJ = kBK / 2;
  // masked scores -inf, unless every (row, key) of the tile is live
  const bool full =
      kt + kBK <= a.Sk &&
      (!a.causal ||
       (off.k + kt + kBK - 1 <= off.q + q0 &&
        (a.window <= 0 || off.q + q0 + kBQ - 1 - off.k - kt < a.window)));
  if (!full) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = kt + (j >> 2) * 8 + t4 * 2 + (j & 1);
      if (!(col < a.Sk &&
            visible(a, (j & 3) < 2 ? r.qp0 : r.qp1, off.k + col)))
        s[j] = -INFINITY;
    }
  }
  // the scale is positive, so the max of the raw scores gives the max of
  // the scaled ones
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if ((j & 3) < 2) mx0 = fmaxf(mx0, s[j]);
    else mx1 = fmaxf(mx1, s[j]);
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  const float nm0 = fmaxf(r.m0, fmaxf(mx0 * sl2, TPUDIST_NEG_BIG));
  const float nm1 = fmaxf(r.m1, fmaxf(mx1 * sl2, TPUDIST_NEG_BIG));
  const float2 c = make_float2(ex2(r.m0 - nm0), ex2(r.m1 - nm1));
  r.m0 = nm0;
  r.m1 = nm1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const bool top = (j & 3) < 2;
    s[j] = ex2(fmaf(s[j], sl2, -(top ? nm0 : nm1)));
    if (top) ps0 += s[j];
    else ps1 += s[j];
  }
  // a row's four threads are summed at the end (the factor is uniform
  // across them)
  r.l0 = r.l0 * c.x + ps0;
  r.l1 = r.l1 * c.y + ps1;
  return c;
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float2 c) {
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] *= (j & 3) < 2 ? c.x : c.y;
}

// s = Q K^T (raw) on the tensor cores, issued as its own group.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[kBK / 2],
                                             uint32_t qa, uint32_t ka) {
  using QT = SwTile<kBQ, D>;
  using KT = SwTile<kBK, D>;
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) s[j] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<kBK, 0>::ss(s, QT::desc_k(qa, kk), KT::desc_k(ka, kk));
  wgmma_commit();
}

// o += P V with P's bf16 A fragments in registers and V MN-major, issued
// as its own group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[kBK / 16][4],
                                         uint32_t va) {
  using KT = SwTile<kBK, D>;
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) fence_regs(pa[j]);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    Wgmma<D, 1>::rs(o, pa[j], KT::desc_mn(va, j));
  wgmma_commit();
}

// P rounded to bf16 (the value dtype, as the Pallas kernel rounds
// p.astype(v.dtype)) as the A fragments of the P V product.
__device__ __forceinline__ void p_frags(uint32_t (&pa)[kBK / 16][4],
                                        const float (&s)[kBK / 2]) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) acc_to_a(pa[j], s, j);
}

template <typename T, int D, int WG>
__global__ void __launch_bounds__(kThreads * WG, MinCtas<T, D, 4 / WG>::value)
    flash_fwd_kernel(const FwdArgs a) {
  using S = FwdSmem<T, D, WG>;
  using QT = typename S::QT;
  using KT = typename S::KT;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NTH = kThreads * WG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* Ps = reinterpret_cast<float*>(smem + S::kPs);

  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / (a.H / WG);
  const int h = (blockIdx.x % (a.H / WG)) * WG + wg;
  const int hk = h / (a.H / a.Hkv);
  // last q-tiles first: under a causal mask they have the most live keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int split = blockIdx.z;
  const Offsets off = offsets(a);
  const Tiles w = split_tiles(a, fwd_walk(a, off, q0), split);
  // an empty split writes nothing (the merge skips it); with one split an
  // empty walk still writes O = 0 and LSE = -1e30
  if (a.splits > 1 && w.lo >= w.hi) return;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  auto kv_slot = [&](int t) {
    return smem + S::kKV + ((t - w.lo) % kStages) * S::kStage;
  };
  auto load_k = [&](int t) {
    if (t < w.hi)
      load_tile<T, kBK, D, NTH>(kv_slot(t), kb, a.k_ss, t * kBK, a.Sk);
  };
  auto load_v = [&](int t) {
    if (t < w.hi)
      load_tile<T, kBK, D, NTH>(kv_slot(t) + KT::kBytes, vb, a.v_ss, t * kBK,
                                a.Sk);
  };
  // every warpgroup's Q tile and the first K tile in one group
#pragma unroll
  for (int i = 0; i < WG; ++i)
    load_tile<T, kBQ, D, NTH>(
        smem + S::kQ + i * QT::kBytes,
        static_cast<const T*>(a.q) + b * a.q_sb + (h - wg + i) * a.q_sh,
        a.q_ss, q0, a.Sq);
  load_k(w.lo);
  cp_async_commit();

  const int r0 = warp * 16 + g;  // this thread's rows: r0, r0 + 8
  Rows rows{off.q + q0 + r0, off.q + q0 + r0 + 8, TPUDIST_NEG_BIG,
            TPUDIST_NEG_BIG, 0.f, 0.f};
  const float sl2 = a.scale * kLog2e;
  uint8_t* Qs = smem + S::kQ + wg * QT::kBytes;
  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float s[kBK / 2];

  if constexpr (!kF32) {
    // The walk with S of tile t + 1 and P V of tile t in flight together:
    // the exponentials of tile t + 1 run under P V of tile t.  Copies are
    // committed in the order K_lo | V_lo | K_lo+1 | V_lo+1 | K_lo+2 | ...
    // (empty groups past the walk's end), so waiting for K_t+1 also waits
    // for V_t; K_t+2 reuses K_t's buffer once S_t is done, V_t+2 V_t's
    // once P V_t is.  The last tile's P V is peeled off the loop, so the
    // loop body issues both products unconditionally (a product issued
    // under a branch makes ptxas serialise the pipeline).
    const uint32_t qa = smem_u32(Qs);
    uint32_t pa[kBK / 16][4];
    load_v(w.lo);
    cp_async_commit();
    load_k(w.lo + 1);
    cp_async_commit();
    load_v(w.lo + 1);
    cp_async_commit();
    if (w.lo < w.hi) {
      cp_async_wait<3>();  // K_lo (and Q) have landed
      fence_async_shared();
      __syncthreads();
      issue_scores<D>(s, qa, smem_u32(kv_slot(w.lo)));
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, rows, a, off, q0, w.lo * kBK, t4, sl2);
      p_frags(pa, s);
    }
    __syncthreads();  // every warpgroup is done with K_lo
    load_k(w.lo + 2);
    cp_async_commit();
    for (int t = w.lo; t + 1 < w.hi; ++t) {
      cp_async_wait<2>();  // K_t+1, and before it V_t, have landed
      fence_async_shared();
      __syncthreads();
      issue_scores<D>(s, qa, smem_u32(kv_slot(t + 1)));
      issue_pv<D>(o, pa, smem_u32(kv_slot(t) + KT::kBytes));
      wgmma_wait<1>();  // S_t+1 is done; P V_t may still run
      fence_regs(s);
      const float2 c =
          softmax_tile(s, rows, a, off, q0, (t + 1) * kBK, t4, sl2);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) fence_regs(pa[j]);
      rescale<D>(o, c);
      p_frags(pa, s);
      __syncthreads();  // every warpgroup is done with V_t and K_t+1
      load_v(t + 2);
      cp_async_commit();
      load_k(t + 3);
      cp_async_commit();
    }
    if (w.lo < w.hi) {  // P V of the last tile
      cp_async_wait<0>();
      fence_async_shared();
      __syncthreads();
      issue_pv<D>(o, pa, smem_u32(kv_slot(w.hi - 1) + KT::kBytes));
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) fence_regs(pa[j]);
    }
  } else {
    // f32, one tile at a time: K and V of tile t + 1 stream in under tile
    // t.
    load_v(w.lo);
    cp_async_commit();
    for (int t = w.lo; t < w.hi; ++t) {
      load_k(t + 1);
      load_v(t + 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed (this thread's copies)
      fence_async_shared();
      __syncthreads();     // ... and every thread's
      const int kt = t * kBK;
      uint8_t* Ks = kv_slot(t);
      uint8_t* Vs = Ks + KT::kBytes;
      scores_f32<D>(s, reinterpret_cast<const float*>(Qs),
                    reinterpret_cast<const float*>(Ks), r0, t4);
      rescale<D>(o, softmax_tile(s, rows, a, off, q0, kt, t4, sl2));
      stage_f32<kBK / 8>(Ps, S::kPld, s, r0, t4);
      __syncwarp();
      acc_xy_f32<kBK, D>(o, Ps, S::kPld, reinterpret_cast<const float*>(Vs),
                         r0, t4);
      __syncwarp();
      __syncthreads();  // every warp is done with the stage before its refill
    }
  }
  cp_async_wait<0>();  // no copy may land after the CTA's exit

  float l0 = rows.l0, l1 = rows.l1;
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const long long row_base = ((long long)b * a.H + h) * a.Sq;
  const bool ok0 = q0 + r0 < a.Sq, ok1 = q0 + r0 + 8 < a.Sq;
  if (a.splits > 1) {
    const long long part = (long long)split * a.B * a.H * a.Sq + row_base;
    store_part<D>(a.o_part + part * D, o, q0, a.Sq, r0, t4);
    if (t4 == 0) {
      float2* ml = reinterpret_cast<float2*>(a.ml_part) + part + q0;
      if (ok0) ml[r0] = make_float2(rows.m0, l0);
      if (ok1) ml[r0 + 8] = make_float2(rows.m1, l1);
    }
    return;
  }
  // one split: normalise and round here; a row with no live key gives
  // O = 0 and LSE = -1e30
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* ob = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const bool top = (j & 3) < 2;
    if (top ? ok0 : ok1) {
      const float d = top ? d0 : d1;
      T* p = ob + (long long)(q0 + (top ? r0 : r0 + 8)) * a.o_ss +
             (j >> 2) * 8 + t4 * 2;
      p[0] = from_f32<T>(o[j] / d);
      p[1] = from_f32<T>(o[j + 1] / d);
    }
  }
  if (t4 == 0) {
    float* lb = a.lse + row_base + q0;
    if (ok0)
      lb[r0] = l0 > 0.f ? (rows.m0 + log2f(l0)) * kLn2 : TPUDIST_NEG_BIG;
    if (ok1)
      lb[r0 + 8] = l1 > 0.f ? (rows.m1 + log2f(l1)) * kLn2 : TPUDIST_NEG_BIG;
  }
}

// The split merge: for each row (4 columns a thread) the non-empty splits
// of its q-tile's walk, a contiguous range of split indices, merged in
// split order: M = max of the splits' maxima, L = sum of l_s 2^(m_s - M),
// O = sum of o_s 2^(m_s - M) / L, LSE = (M + log2 L) ln 2.  A split with
// no live key for the row (m_s = -1e30, l_s = 0, o_s = 0) adds exactly
// nothing; a row with none gives O = 0 and LSE = -1e30.
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_fwd_merge_kernel(
    const FwdArgs a) {
  const Offsets off = offsets(a);
  const long long rows = (long long)a.B * a.H * a.Sq;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < rows * (D / 4); i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % (D / 4)) * 4;
    const long long row = i / (D / 4);  // (b * H + h) * Sq + pos
    const int pos = (int)(row % a.Sq);
    const int h = (int)((row / a.Sq) % a.H);
    const int b = (int)(row / ((long long)a.Sq * a.H));
    const Tiles w = fwd_walk(a, off, (pos / kBQ) * kBQ);
    const int first = w.lo / a.chunk;
    const int end = w.hi > w.lo ? (w.hi + a.chunk - 1) / a.chunk : first;
    const float2* ml = reinterpret_cast<const float2*>(a.ml_part) + row;
    float M = TPUDIST_NEG_BIG;
    for (int s = first; s < end; ++s) M = fmaxf(M, ml[s * rows].x);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = first; s < end; ++s) {
      const float2 p = ml[s * rows];
      const float wt = ex2(p.x - M);
      const float4 x =
          *reinterpret_cast<const float4*>(a.o_part + (s * rows + row) * D + c);
      L += p.y * wt;
      acc.x += x.x * wt;
      acc.y += x.y * wt;
      acc.z += x.z * wt;
      acc.w += x.w * wt;
    }
    const float d = fmaxf(L, 1e-30f);
    T* dst = static_cast<T*>(a.out) + b * a.o_sb + pos * a.o_ss +
             h * a.o_sh + c;
    dst[0] = from_f32<T>(acc.x / d);
    dst[1] = from_f32<T>(acc.y / d);
    dst[2] = from_f32<T>(acc.z / d);
    dst[3] = from_f32<T>(acc.w / d);
    if (c == 0)
      a.lse[row] = L > 0.f ? (M + log2f(L)) * kLn2 : TPUDIST_NEG_BIG;
  }
}

template <typename T, int D, int WG>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  using S = FwdSmem<T, D, WG>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, WG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(a.B * a.H / WG, (a.Sq + kBQ - 1) / kBQ, a.splits);
  flash_fwd_kernel<T, D, WG><<<grid, kThreads * WG, S::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// bf16 pairs two query heads of a GQA group in one CTA where the group
// is even and the grid holds at least 4 one-head CTAs an SM (the training
// shapes; a prefill chunk keeps one head a CTA, as pairing would halve
// its CTAs on an underfilled card).  A pair shares each K/V tile; each
// warpgroup computes its rows exactly as alone, so the choice changes no
// bit.  f32 and odd groups take one head a CTA.
template <typename T, int D>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  if (a.splits < 1 || a.chunk < 1 ||
      (a.splits > 1 && (!a.o_part || !a.ml_part)))
    return cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (std::is_same<T, float>::value) {
    e = launch_fwd<T, D, 1>(a, stream);
  } else {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
    }
    const long long ctas =
        (long long)a.B * a.H * ((a.Sq + kBQ - 1) / kBQ) * a.splits;
    e = (a.H / a.Hkv) % 2 == 0 && ctas >= 4LL * sms
            ? launch_fwd<T, D, 2>(a, stream)
            : launch_fwd<T, D, 1>(a, stream);
  }
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long n4 = (long long)a.B * a.H * a.Sq * (D / 4);
  const int blocks = (int)((n4 + 255) / 256 < 8192 ? (n4 + 255) / 256 : 8192);
  flash_fwd_merge_kernel<T, D><<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const FwdArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// (head_dim) stride is 1.  splits and chunk (key tiles of 64 a split) are
// the planner's; with splits > 1, o_part ([splits, B, H, Sq, D] f32) and
// ml_part ([splits, B, H, Sq, 2] f32) are the wrapper's workspace and a
// second kernel merges them.  Returns cudaGetLastError() after the
// launches.
extern "C" int tpudist_flash_forward(
    int dtype, const void* q, const void* k, const void* v, void* out,
    float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    const int* q_off_ptr, int q_off, const int* k_off_ptr, int k_off,
    int causal, int window, float scale, float* o_part, float* ml_part,
    int splits, int chunk, void* stream) {
  FwdArgs a{q, k, v, out, lse, o_part, ml_part, B, Sq, Sk, H, Hkv,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            o_sb, o_ss, o_sh, q_off_ptr, k_off_ptr, q_off, k_off,
            causal, window, scale, splits, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? dispatch<__nv_bfloat16>(D, a, s)
                             : dispatch<float>(D, a, s);
  return static_cast<int>(e);
}
