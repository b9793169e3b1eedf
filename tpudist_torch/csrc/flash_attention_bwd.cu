// K3, K8 and K4: the flash-attention backward for Hopper (sm_90a).
//
// What they replace.  K3 replaces tpudist/ops/flash_attention.py::
// _flash_bwd_dq_fused_kernel (Pallas, B2): dQ = scale * sum_k dS K, plus
// Delta = rowsum(dO * O), computed from the O and dO rows and written out
// as [B, H, Sq] f32 for K4.  K8 replaces ::_flash_bwd_dq_kernel (B7): the
// same dQ with Delta read from the caller (the ring backward computes it
// once from the ring's final output); it is K3's kernel compiled with a
// switch that loads Delta, with K3's tiling, split and summation order, so
// fed the Delta K3 writes it gives K3's dQ bit for bit.  K4 replaces
// ::_flash_bwd_dkv_kernel (B3): dK = scale * sum dS^T Q and dV = sum P^T dO,
// summed over every query head of the KV head's GQA group.  All three
// recompute P = exp(s - lse) from the forward's (K1's) log-sum-exp, with
// dS = P * (dO V^T - Delta).  A block wholly in the future of its queries
// (a causal ring's dead blocks) has an empty walk, so they write exact
// zeros.  Two passes (dQ, then dK/dV), as the Pallas kernels: one fused
// pass would sum dQ across key-tile CTAs with atomics, whose order varies.
//
// What bounds them on an H100: at the training shape (B=8, S=2048, H=8,
// Hkv=2, D=64, causal) K3 does 6 and K4 8 FLOPs per live (q, k) pair and
// head dim, ~50 and ~67 GFLOP against ~40 MB of tensors: far above the
// card's ~295 FLOP/byte ridge, so both are bound by tensor-core operations
// (train_sp's shape, B=1, S=8192, likewise).
//
// The design, against what held the first version (mma.sync m16n8k16,
// synchronous tile loads, one CTA per output tile) back:
//  1. Long walks split over CTAs.  A CTA owns one output tile (64 query
//     rows for K3/K8, 64 keys for K4) and walks its live tiles: K3/K8 the
//     key tiles, K4 the (q-tile, group member) steps.  The host planner
//     (ops/flash_attention.py::_bwd_plan: shape, offsets, window and SM
//     count, never data) gives `splits` CTAs (grid z) `chunk` steps each
//     of a walk.  Split s takes steps [s * chunk, (s + 1) * chunk) of the
//     walk; with splits > 1 it writes its f32 partial to a workspace
//     [splits, B, heads, S, D] and a second kernel of the same call
//     (flash_bwd_split_sum_kernel) adds the non-empty partials in split
//     order, applies the scale and rounds: deterministic, no atomics.  K3's
//     splits each recompute Delta for their rows; split 0 writes it.
//  2. Asynchronous copies.  cp.async (16 bytes a thread, zero-filled past
//     the ragged Sq/Sk edge) streams the walk's tiles through a ring of
//     kStages = 2 shared buffers: K/V tiles for K3/K8, Q/dO tiles with
//     their lse/Delta slices for K4, so the next tile's copy overlaps this
//     tile's products.  cp.async rather than TMA: the [B, S, H, D] inputs
//     are strided views (the model's unbind views of one projection), and
//     cp.async needs no tensor map per call and zero-fills per row.
//  3. wgmma.  One warpgroup (128 threads) per CTA.  K3/K8: S = Q K^T and
//     dP = dO V^T (m64n64k16, both operands from shared memory, K-major),
//     then dQ += dS K with dS in registers as the A operand and K read
//     MN-major from the same tile (the transpose bit).  K4: S^T = K Q^T and
//     dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//     in registers and dO, Q MN-major.  The accumulator layout of one
//     product is the A-fragment layout of the next, so P and dS never
//     touch shared memory.  Tiles are stored in wgmma's 128B/64B/32B
//     swizzled layouts (hopper.cuh: SwTile) by the copies themselves.
//     The products overlap the CTA's own elementwise work: S and dP are
//     committed as two groups, so P's exponentials (on the SFU, ex2.approx)
//     run while dP is still in the tensor cores; K4 issues dV += P^T dO
//     before it computes dS^T.  A tile wholly inside the causal band (and
//     the Sq/Sk edge) skips the per-element mask.
//  4. Register budget (bf16, f32 accumulators per thread): K3/K8 dQ D/2
//     + S 32 + dP 32 (96 at D = 64, 128 at D = 128); K4 dK D/2 + dV D/2 +
//     S^T BQ/2 + dP^T BQ/2, with BQ = 64 queries a step (128 at D = 64)
//     and 32 at D = 128 (160), under the 255 a thread may hold.  At D =
//     64 K3/K8 are capped at 128 registers (MinCtas: 4 CTAs an SM) and
//     K4 takes 199 (2 CTAs an SM).
//  f32 inputs keep exact FMAs (no TF32) on the same accumulator layout,
//  tiles padded to D + 4 floats a row; the split and the copies apply to
//  them too.
// Still left (later work): warp specialisation with a producer warp and
// TMA, two consumer warpgroups per CTA sharing the streamed tiles, keeping
// the dQ product in flight across the next tile's S and dP products, a
// persistent grid ordered by walk length, and the resident tile (Q/dO in
// K3, K/V in K4) as a register A operand: tried at D = 64, where ptxas
// reused the fragments' registers for P^T inside the walk, so later steps
// read garbage; it needs the fragments pinned another way.
//
// Rounding points follow the Pallas kernels: dS is rounded to q's dtype
// before dS K and dS^T Q, P to dO's dtype before P^T dO; f32 accumulation.

#include <algorithm>

#include "flash_common.cuh"

namespace {

using namespace tpudist;
using namespace tpudist::sm90;
using namespace tpudist::flash;

constexpr int kRows = 64;     // K3/K8: query rows per CTA; K4: keys per CTA
constexpr int kBK = 64;       // K3/K8: keys per K/V tile
constexpr int kStages = 2;    // shared buffers of the streamed tiles

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;
  const float* lse;   // [B, H, Sq]
  float* delta;       // [B, H, Sq]: written by K3, read by K8 and K4
  void* dq;
  void* dk;
  void* dv;
  float* dq_part;     // [splits, B, H, Sq, D] f32 (splits > 1)
  float* dk_part;     // [splits, B, Hkv, Sk, D] f32 (splits > 1)
  float* dv_part;
  int B, Sq, Sk, H, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long o_sb, o_ss, o_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int q_off, k_off;
  int causal, window;  // window <= 0: none (applies only when causal)
  float scale;
  int splits, chunk;   // CTAs sharing one output tile's walk; steps each
};

// MinCtas (flash_common.cuh): K3/K8 at 4 CTAs an SM (128 registers, 32
// bytes spilled) ran 13% faster than at 3 on an H100; K4 capped for 3
// (168 registers, 140 bytes spilled) ran 10% slower at the training
// shape and 9% faster at B=1, S=8192, so it keeps its 199 registers
// (scripts/flash_bwd_compare.py).

// Whether key position kp is visible to query position qp.
__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp) {
  return !a.causal || (kp <= qp && (a.window <= 0 || qp - kp < a.window));
}

// A walk: its first position and its number of tile steps.
struct Walk {
  int lo, n;
};

// K3/K8: the key tiles of the q-tile at q0, from the window band's first
// tile to the causal limit min(Sk, q_offset + last row + 1 - k_offset).
__device__ __forceinline__ Walk dq_walk(const BwdArgs& a, int q0) {
  const int rows = min(kRows, a.Sq - q0);
  int lo = 0, hi = a.Sk;
  if (a.causal) {
    hi = max(0, min(a.Sk, a.q_off + q0 + rows - a.k_off));
    if (a.window > 0) lo = max(0, a.q_off + q0 - (a.window - 1) - a.k_off);
  }
  lo = (lo / kBK) * kBK;
  return {lo, hi > lo ? (hi - lo + kBK - 1) / kBK : 0};
}

// K4: the q-tiles (of BQ rows) of the key tile at k0, from the causal
// diagonal to the window band's end; each is one step per group member.
template <int BQ>
__device__ __forceinline__ Walk dkv_walk(const BwdArgs& a, int k0) {
  const int keys = min(kRows, a.Sk - k0);
  int lo = 0, hi = a.Sq;
  if (a.causal) {
    lo = max(0, a.k_off + k0 - a.q_off);
    if (a.window > 0)
      hi = max(0, min(a.Sq, a.k_off + k0 + keys - 1 + a.window - a.q_off));
  }
  lo = (lo / BQ) * BQ;
  return {lo, hi > lo ? (hi - lo + BQ - 1) / BQ : 0};
}

// f32 products s = X·Yᵀ and t = U·Wᵀ over head dim D for this thread's
// rows r0, r0 + 8 of X and U against 8*NT rows of Y and W (PadTile rows),
// in the accumulator layout: exact FMAs.
template <int NT, int D>
__device__ __forceinline__ void products_f32(float (&s)[NT * 4],
                                             float (&t)[NT * 4],
                                             const float* X, const float* Y,
                                             const float* U, const float* W,
                                             int r0, int t4) {
  constexpr int ld = D + 4;
#pragma unroll
  for (int j = 0; j < NT * 4; ++j) {
    const int r = (j & 3) < 2 ? r0 : r0 + 8;
    const int c = (j >> 2) * 8 + t4 * 2 + (j & 1);
    const float* xr = X + r * ld;
    const float* yr = Y + c * ld;
    const float* ur = U + r * ld;
    const float* wr = W + c * ld;
    float as = 0.f, at = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      as = fmaf(xr[d], yr[d], as);
      at = fmaf(ur[d], wr[d], at);
    }
    s[j] = as;
    t[j] = at;
  }
}

// Write a 64-row accumulator tile (rows row0 + r of a [*, D] output at
// base + row * stride, rows below `limit`) times `scale`, rounded to T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long stride,
                                           const float (&acc)[D / 2],
                                           float scale, int row0, int limit,
                                           int r0, int t4) {
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int r = row0 + ((j & 3) < 2 ? r0 : r0 + 8);
    if (r < limit) {
      T* p = base + (long long)r * stride + (j >> 2) * 8 + t4 * 2;
      p[0] = from_f32<T>(acc[j] * scale);
      p[1] = from_f32<T>(acc[j + 1] * scale);
    }
  }
}

// ---- K3 (dQ and Delta) and K8 (dQ from a given Delta) ----------------------

template <typename T, int D>
struct DqSmem {
  using QT = TileOf<T, kRows, D>;
  using KT = TileOf<T, kBK, D>;
  static constexpr int kQ = 0, kdO = QT::kBytes, kKV = 2 * QT::kBytes;
  static constexpr int kStage = 2 * KT::kBytes;  // K then V
  static constexpr int kDelta = kKV + kStages * kStage;
  static constexpr int kPs = kDelta + kRows * 4;  // f32 path: dS rows
  static constexpr int kPld = kBK + 1;
  static constexpr size_t kBytes =
      1024 + kPs + (std::is_same<T, float>::value ? kRows * kPld * 4 : 0);
};

// kGivenDelta: K8 (Delta read from a.delta); otherwise K3 (Delta computed
// from the O and dO rows, split 0 writes it to a.delta).
template <typename T, int D, bool kGivenDelta>
__global__ void __launch_bounds__(kThreads, MinCtas<T, D, 4>::value)
    flash_bwd_dq_kernel(const BwdArgs a) {
  using S = DqSmem<T, D>;
  using QT = typename S::QT;
  using KT = typename S::KT;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NT = kBK / 8;  // 8-key column groups of a score tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem + S::kQ;
  uint8_t* dOs = smem + S::kdO;
  float* Dl = reinterpret_cast<float*>(smem + S::kDelta);
  float* Ps = reinterpret_cast<float*>(smem + S::kPs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int hk = h / (a.H / a.Hkv);
  // last q-tiles first: under a causal mask they have the most live keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int split = blockIdx.z;
  const Walk w = dq_walk(a, q0);
  const int first = split * a.chunk, last = min(w.n, first + a.chunk);
  if (split > 0 && first >= last) return;  // split 0 writes Delta (K3)
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const long long row_base = ((long long)b * a.H + h) * a.Sq;

  auto kv_stage = [&](int i) {
    return smem + S::kKV + ((i - first) % kStages) * S::kStage;
  };
  auto load_kv = [&](int i) {
    uint8_t* st = kv_stage(i);
    const int kt = w.lo + i * kBK;
    load_tile<T, kBK, D>(st, kb, a.k_ss, kt, a.Sk);
    load_tile<T, kBK, D>(st + KT::kBytes, vb, a.v_ss, kt, a.Sk);
  };
  // Q, dO and the first K/V tile in one group
  load_tile<T, kRows, D>(Qs, qb, a.q_ss, q0, a.Sq);
  load_tile<T, kRows, D>(dOs, dob, a.do_ss, q0, a.Sq);
  if (first < last) load_kv(first);
  cp_async_commit();

  if constexpr (kGivenDelta) {
    for (int r = tid; r < kRows; r += kThreads)
      Dl[r] = q0 + r < a.Sq ? a.delta[row_base + q0 + r] : 0.f;
  } else {  // Delta = rowsum(dO * O) in f32: two threads per row
    const int r = tid >> 1, half = tid & 1;
    float acc = 0.f;
    if (q0 + r < a.Sq) {
      const T* orow = static_cast<const T*>(a.out) + b * a.o_sb +
                      h * a.o_sh + (long long)(q0 + r) * a.o_ss +
                      half * (D / 2);
      const T* drow = dob + (long long)(q0 + r) * a.do_ss + half * (D / 2);
#pragma unroll 8
      for (int d = 0; d < D / 2; ++d)
        acc = fmaf(to_f32<T>(drow[d]), to_f32<T>(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Dl[r] = acc;
      if (split == 0 && q0 + r < a.Sq) a.delta[row_base + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const int qp0 = a.q_off + q0 + r0, qp1 = qp0 + 8;
  const float sl2 = a.scale * kLog2e;
  const float ml0 = q0 + r0 < a.Sq ? a.lse[row_base + q0 + r0] * kLog2e : 0.f;
  const float ml1 = q0 + r1 < a.Sq ? a.lse[row_base + q0 + r1] * kLog2e : 0.f;
  const float dl0 = Dl[r0], dl1 = Dl[r1];
  const uint32_t qa = smem_u32(Qs), doa = smem_u32(dOs);
  float dq[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;

  for (int i = first; i < last; ++i) {
    if (i + 1 < last) load_kv(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i has landed (this thread's copies)
    fence_async_shared();
    __syncthreads();     // ... and every thread's
    const int kt = w.lo + i * kBK;
    uint8_t* Ks = kv_stage(i);
    uint8_t* Vs = Ks + KT::kBytes;

    // s = Q K^T, then dp = dO V^T in a second group, so that P's
    // exponentials overlap the dP product
    float s[NT * 4], dp[NT * 4];
    if constexpr (!kF32) {
      const uint32_t ka = smem_u32(Ks), va = smem_u32(Vs);
#pragma unroll
      for (int j = 0; j < NT * 4; ++j) s[j] = dp[j] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<kBK, 0>::ss(s, QT::desc_k(qa, kk), KT::desc_k(ka, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<kBK, 0>::ss(dp, QT::desc_k(doa, kk), KT::desc_k(va, kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
    } else {
      products_f32<NT, D>(s, dp, reinterpret_cast<const float*>(Qs),
                          reinterpret_cast<const float*>(Ks),
                          reinterpret_cast<const float*>(dOs),
                          reinterpret_cast<const float*>(Vs), r0, t4);
    }

    // P = exp(s*scale - lse), 0 where masked
    const bool full =
        kt + kBK <= a.Sk &&
        (!a.causal ||
         (a.k_off + kt + kBK - 1 <= a.q_off + q0 &&
          (a.window <= 0 || a.q_off + q0 + kRows - 1 - a.k_off - kt <
                                a.window)));
    if (full) {
#pragma unroll
      for (int j = 0; j < NT * 4; ++j)
        s[j] = ex2(fmaf(s[j], sl2, -((j & 3) < 2 ? ml0 : ml1)));
    } else {
#pragma unroll
      for (int j = 0; j < NT * 4; ++j) {
        const bool top = (j & 3) < 2;
        const int col = kt + (j >> 2) * 8 + t4 * 2 + (j & 1);
        const bool keep =
            col < a.Sk && visible(a, top ? qp0 : qp1, a.k_off + col);
        s[j] = keep ? ex2(fmaf(s[j], sl2, -(top ? ml0 : ml1))) : 0.f;
      }
    }
    if constexpr (!kF32) {
      wgmma_wait<0>();
      fence_regs(dp);
    }
    // dS = P * (dP - Delta)
#pragma unroll
    for (int j = 0; j < NT * 4; ++j)
      s[j] *= dp[j] - ((j & 3) < 2 ? dl0 : dl1);

    // dQ += dS K (dS rounded to q's dtype)
    if constexpr (!kF32) {
      const uint32_t ka = smem_u32(Ks);
      uint32_t af[kBK / 16][4];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        acc_to_a(af[j], s, j);
        fence_regs(af[j]);
      }
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        Wgmma<D, 1>::rs(dq, af[j], KT::desc_mn(ka, j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) fence_regs(af[j]);
    } else {
      stage_f32<NT>(Ps, S::kPld, s, r0, t4);
      __syncwarp();
      acc_xy_f32<kBK, D>(dq, Ps, S::kPld, reinterpret_cast<const float*>(Ks),
                         r0, t4);
      __syncwarp();
    }
    __syncthreads();  // every warp is done with the stage before its refill
  }
  cp_async_wait<0>();  // no copy may land after the CTA's exit

  if (a.splits == 1) {
    store_rows<T, D>(static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh,
                     a.dq_ss, dq, a.scale, q0, a.Sq, r0, t4);
  } else if (first < last) {
    store_part<D>(a.dq_part + (((long long)split * a.B + b) * a.H + h) *
                                  a.Sq * D,
                  dq, q0, a.Sq, r0, t4);
  }
}

// ---- K4: dK and dV ----------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  // queries per step: 32 at D = 128 keeps S^T and dP^T beside the dK/dV
  // accumulators inside the register file
  static constexpr int kBQ = D >= 128 ? 32 : 64;
  using KT = TileOf<T, kRows, D>;
  using QT = TileOf<T, kBQ, D>;
  static constexpr int kK = 0, kV = KT::kBytes, kQd = 2 * KT::kBytes;
  static constexpr int kStage = 2 * QT::kBytes;  // Q then dO
  static constexpr int kStat = kQd + kStages * kStage;  // lse, Delta
  static constexpr int kPs = kStat + kStages * 2 * kBQ * 4;
  static constexpr int kPld = kBQ + 1;  // f32 path: P^T and dS^T rows
  static constexpr size_t kBytes =
      1024 + kPs +
      (std::is_same<T, float>::value ? 2 * kRows * kPld * 4 : 0);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdArgs a) {
  using S = DkvSmem<T, D>;
  using KT = typename S::KT;
  using QT = typename S::QT;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int BQ = S::kBQ;
  constexpr int NT = BQ / 8;  // 8-query column groups of a score tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem + S::kK;
  uint8_t* Vs = smem + S::kV;
  float* Ps = reinterpret_cast<float*>(smem + S::kPs);  // f32: P^T
  float* Ss = Ps + kRows * S::kPld;                     // f32: dS^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int group = a.H / a.Hkv;
  const int k0 = blockIdx.y * kRows;  // early k-tiles (the heaviest) first
  const int split = blockIdx.z;
  const Walk w = dkv_walk<BQ>(a, k0);
  const int first = split * a.chunk, last = min(w.n * group, first + a.chunk);
  if (split > 0 && first >= last) return;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // step i: q-tile w.lo + (i / group) * BQ of group member i % group
  auto stage = [&](int i) { return (i - first) % kStages; };
  auto load_step = [&](int i) {
    const int st = stage(i);
    const int qt = w.lo + (i / group) * BQ, h = hk * group + i % group;
    uint8_t* qs = smem + S::kQd + st * S::kStage;
    load_tile<T, BQ, D>(qs,
                        static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh,
                        a.q_ss, qt, a.Sq);
    load_tile<T, BQ, D>(
        qs + QT::kBytes,
        static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh, a.do_ss,
        qt, a.Sq);
    float* ls = reinterpret_cast<float*>(smem + S::kStat) + st * 2 * BQ;
    const long long rb = ((long long)b * a.H + h) * a.Sq;
    for (int r = tid; r < BQ; r += kThreads) {
      const bool ok = qt + r < a.Sq;
      const long long idx = ok ? rb + qt + r : 0;
      cp_async4(smem_u32(ls + r), a.lse + idx, ok);
      cp_async4(smem_u32(ls + BQ + r), a.delta + idx, ok);
    }
  };
  // K, V and the first step's tiles in one group
  load_tile<T, kRows, D>(Ks, kb, a.k_ss, k0, a.Sk);
  load_tile<T, kRows, D>(Vs, vb, a.v_ss, k0, a.Sk);
  if (first < last) load_step(first);
  cp_async_commit();

  const int r0 = warp * 16 + g;  // this thread's keys: r0, r0 + 8
  const int kp0 = a.k_off + k0 + r0, kp1 = kp0 + 8;
  const float sl2 = a.scale * kLog2e;
  const uint32_t ka = smem_u32(Ks), va = smem_u32(Vs);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;

  for (int i = first; i < last; ++i) {
    if (i + 1 < last) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const int st = stage(i);
    const int qt = w.lo + (i / group) * BQ;
    uint8_t* Qs = smem + S::kQd + st * S::kStage;
    uint8_t* dOs = Qs + QT::kBytes;
    const float* ls = reinterpret_cast<const float*>(smem + S::kStat) +
                      st * 2 * BQ;

    // s = K Q^T, then dp = V dO^T in a second group: rows are this CTA's
    // keys, columns the step's queries
    float s[NT * 4], dp[NT * 4];
    if constexpr (!kF32) {
      const uint32_t qa = smem_u32(Qs), doa = smem_u32(dOs);
#pragma unroll
      for (int j = 0; j < NT * 4; ++j) s[j] = dp[j] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BQ, 0>::ss(s, KT::desc_k(ka, kk), QT::desc_k(qa, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BQ, 0>::ss(dp, KT::desc_k(va, kk), QT::desc_k(doa, kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
    } else {
      products_f32<NT, D>(s, dp, reinterpret_cast<const float*>(Ks),
                          reinterpret_cast<const float*>(Qs),
                          reinterpret_cast<const float*>(Vs),
                          reinterpret_cast<const float*>(dOs), r0, t4);
    }

    // this thread's columns' lse (times log2 e) and Delta
    float lc[NT * 2], dc[NT * 2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(ls + nt * 8 + t4 * 2);
      const float2 d =
          *reinterpret_cast<const float2*>(ls + BQ + nt * 8 + t4 * 2);
      lc[2 * nt] = l.x * kLog2e;
      lc[2 * nt + 1] = l.y * kLog2e;
      dc[2 * nt] = d.x;
      dc[2 * nt + 1] = d.y;
    }
    // P^T in place (s <- P), 0 where masked
    const bool full =
        qt + BQ <= a.Sq &&
        (!a.causal ||
         (a.k_off + k0 + kRows - 1 <= a.q_off + qt &&
          (a.window <= 0 ||
           a.q_off + qt + BQ - 1 - a.k_off - k0 < a.window)));
    if (full) {
#pragma unroll
      for (int j = 0; j < NT * 4; ++j)
        s[j] = ex2(fmaf(s[j], sl2, -lc[(j >> 2) * 2 + (j & 1)]));
    } else {
#pragma unroll
      for (int j = 0; j < NT * 4; ++j) {
        const int qi = (j >> 2) * 8 + t4 * 2 + (j & 1);
        const bool keep =
            qt + qi < a.Sq &&
            visible(a, a.q_off + qt + qi, (j & 3) < 2 ? kp0 : kp1);
        s[j] = keep ? ex2(fmaf(s[j], sl2, -lc[(j >> 2) * 2 + (j & 1)]))
                    : 0.f;
      }
    }

    if constexpr (!kF32) {
      const uint32_t qa = smem_u32(Qs), doa = smem_u32(dOs);
      // dV += P^T dO (P rounded to dO's dtype), overlapping dS below
      uint32_t ap[BQ / 16][4], ad[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        acc_to_a(ap[j], s, j);
        fence_regs(ap[j]);
      }
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        Wgmma<D, 1>::rs(dv, ap[j], QT::desc_mn(doa, j));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T has landed (dV may still run)
      fence_regs(dp);
      // dS^T = P^T * (dP^T - Delta), then dK += dS^T Q (dS rounded to
      // q's dtype)
#pragma unroll
      for (int j = 0; j < NT * 4; ++j)
        dp[j] = s[j] * (dp[j] - dc[(j >> 2) * 2 + (j & 1)]);
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        acc_to_a(ad[j], dp, j);
        fence_regs(ad[j]);
      }
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        Wgmma<D, 1>::rs(dk, ad[j], QT::desc_mn(qa, j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        fence_regs(ap[j]);
        fence_regs(ad[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT * 4; ++j)
        dp[j] = s[j] * (dp[j] - dc[(j >> 2) * 2 + (j & 1)]);
      stage_f32<NT>(Ps, S::kPld, s, r0, t4);
      stage_f32<NT>(Ss, S::kPld, dp, r0, t4);
      __syncwarp();
      acc_xy_f32<BQ, D>(dv, Ps, S::kPld, reinterpret_cast<const float*>(dOs),
                        r0, t4);
      acc_xy_f32<BQ, D>(dk, Ss, S::kPld, reinterpret_cast<const float*>(Qs),
                        r0, t4);
      __syncwarp();
    }
    __syncthreads();  // every warp is done with the stage before its refill
  }
  cp_async_wait<0>();

  if (a.splits == 1) {
    store_rows<T, D>(static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh,
                     a.dk_ss, dk, a.scale, k0, a.Sk, r0, t4);
    store_rows<T, D>(static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh,
                     a.dv_ss, dv, 1.f, k0, a.Sk, r0, t4);
  } else if (first < last) {
    const long long off =
        (((long long)split * a.B + b) * a.Hkv + hk) * a.Sk * D;
    store_part<D>(a.dk_part + off, dk, k0, a.Sk, r0, t4);
    store_part<D>(a.dv_part + off, dv, k0, a.Sk, r0, t4);
  }
}

// ---- the partials' sum ------------------------------------------------------

// kDkv false: dQ = scale * sum of a.dq_part over the non-empty splits of
// each row's q-tile; true: dK = scale * sum of a.dk_part and dV = sum of
// a.dv_part over the non-empty splits of each key's tile.  Splits are added
// in order, 4 columns a thread.
template <typename T, int D, bool kDkv>
__global__ void __launch_bounds__(256)
    flash_bwd_split_sum_kernel(const BwdArgs a) {
  constexpr int BQ = DkvSmem<T, D>::kBQ;
  const int heads = kDkv ? a.Hkv : a.H, len = kDkv ? a.Sk : a.Sq;
  const long long rows = (long long)a.B * heads * len;
  const long long split_stride = rows * D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < rows * (D / 4); i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % (D / 4)) * 4;
    const long long row = i / (D / 4);  // ((b * heads) + head) * len + pos
    const int pos = (int)(row % len);
    const int head = (int)((row / len) % heads);
    const int b = (int)(row / ((long long)len * heads));
    const int tile = (pos / kRows) * kRows;
    const int steps = kDkv ? dkv_walk<BQ>(a, tile).n * (a.H / a.Hkv)
                           : dq_walk(a, tile).n;
    const int parts = (steps + a.chunk - 1) / a.chunk;
    const float* src[2] = {kDkv ? a.dk_part : a.dq_part, a.dv_part};
    T* dst[2];
    if constexpr (kDkv) {
      dst[0] = static_cast<T*>(a.dk) + b * a.dk_sb + pos * a.dk_ss +
               head * a.dk_sh + c;
      dst[1] = static_cast<T*>(a.dv) + b * a.dv_sb + pos * a.dv_ss +
               head * a.dv_sh + c;
    } else {
      dst[0] = static_cast<T*>(a.dq) + b * a.dq_sb + pos * a.dq_ss +
               head * a.dq_sh + c;
    }
#pragma unroll
    for (int o = 0; o < (kDkv ? 2 : 1); ++o) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* p = src[o] + row * D + c;
      for (int sp = 0; sp < parts; ++sp) {
        const float4 x =
            *reinterpret_cast<const float4*>(p + sp * split_stride);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      const float sc = o == 0 ? a.scale : 1.f;
      dst[o][0] = from_f32<T>(acc.x * sc);
      dst[o][1] = from_f32<T>(acc.y * sc);
      dst[o][2] = from_f32<T>(acc.z * sc);
      dst[o][3] = from_f32<T>(acc.w * sc);
    }
  }
}

// ---- launch -----------------------------------------------------------------

template <typename K>
cudaError_t configure(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Kind: 0 = K3 (dQ and Delta), 1 = K8 (dQ from Delta), 2 = K4 (dK, dV).
// With splits > 1 the partials' sum follows on the same stream.
template <typename T, int D, int Kind>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr bool kDkv = Kind == 2;
  void (*kernel)(const BwdArgs);
  size_t bytes;
  dim3 grid;
  if constexpr (!kDkv) {
    kernel = flash_bwd_dq_kernel<T, D, Kind == 1>;
    bytes = DqSmem<T, D>::kBytes;
    grid = dim3(a.B * a.H, (a.Sq + kRows - 1) / kRows, a.splits);
  } else {
    kernel = flash_bwd_dkv_kernel<T, D>;
    bytes = DkvSmem<T, D>::kBytes;
    grid = dim3(a.B * a.Hkv, (a.Sk + kRows - 1) / kRows, a.splits);
  }
  if (a.splits < 1 || a.chunk < 1 ||
      (a.splits > 1 &&
       (kDkv ? (!a.dk_part || !a.dv_part) : !a.dq_part)))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = configure(kernel, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long n4 = (long long)a.B * (kDkv ? a.Hkv * (long long)a.Sk
                                              : a.H * (long long)a.Sq) *
                       (D / 4);
  const int blocks = (int)std::min<long long>((n4 + 255) / 256, 8192);
  flash_bwd_split_sum_kernel<T, D, kDkv><<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int Kind>
cudaError_t dispatch(int d, const BwdArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, Kind>(a, stream);
    case 32: return launch<T, 32, Kind>(a, stream);
    case 64: return launch<T, 64, Kind>(a, stream);
    case 128: return launch<T, 128, Kind>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int Kind>
int run(int dtype, const BwdArgs& a, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? dispatch<__nv_bfloat16, Kind>(D, a, s)
                             : dispatch<float, Kind>(D, a, s);
  return static_cast<int>(e);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, seq,
// head) for each of q k v dO O dQ dK dV; the head_dim stride is 1.  K3
// reads q k v dO O lse and writes dQ and delta; K8 reads q k v dO lse
// delta and writes dQ; K4 reads q k v dO lse delta and writes dK and dV
// (the pointers a kernel does not use may be null).  splits and chunk
// are the planner's; with splits > 1 the kernel's partials go to
// dq_part (K3, K8) or dk_part and dv_part (K4), f32 workspaces of
// [splits, B, heads, S, D], and a second kernel sums them.  Each returns
// cudaGetLastError() after its launches.
#define TPUDIST_BWD_PARAMS                                                   \
  int dtype, const void *q, const void *k, const void *v, const void *dout,  \
      const void *out, const float *lse, float *delta, void *dq, void *dk,   \
      void *dv, int B, int Sq, int Sk, int H, int Hkv, int D,                \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,        \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,     \
      long long o_sb, long long o_ss, long long o_sh, long long dq_sb,       \
      long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,    \
      long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,    \
      int q_off, int k_off, int causal, int window, float scale,             \
      float *dq_part, float *dk_part, float *dv_part, int splits, int chunk, \
      void *stream
#define TPUDIST_BWD_ARGS                                                     \
  BwdArgs{q,     k,     v,     dout,    out,     lse,     delta,   dq,       \
          dk,    dv,    dq_part, dk_part, dv_part, B,     Sq,      Sk,       \
          H,     Hkv,   q_sb,  q_ss,    q_sh,    k_sb,    k_ss,    k_sh,     \
          v_sb,  v_ss,  v_sh,  do_sb,   do_ss,   do_sh,   o_sb,    o_ss,     \
          o_sh,  dq_sb, dq_ss, dq_sh,   dk_sb,   dk_ss,   dk_sh,   dv_sb,    \
          dv_ss, dv_sh, q_off, k_off,   causal,  window,  scale,   splits,   \
          chunk}

extern "C" int tpudist_flash_bwd_dq(TPUDIST_BWD_PARAMS) {
  return run<0>(dtype, TPUDIST_BWD_ARGS, D, stream);
}

extern "C" int tpudist_flash_bwd_dq_delta(TPUDIST_BWD_PARAMS) {
  return run<1>(dtype, TPUDIST_BWD_ARGS, D, stream);
}

extern "C" int tpudist_flash_bwd_dkv(TPUDIST_BWD_PARAMS) {
  return run<2>(dtype, TPUDIST_BWD_ARGS, D, stream);
}
