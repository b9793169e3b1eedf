// K3, K8 and K4: the flash-attention backward for Hopper (sm_90a).
//
// K3 replaces tpudist/ops/flash_attention.py::_flash_bwd_dq_fused_kernel
// (Pallas, B2): dQ = scale * sum_k dS K, plus Delta = rowsum(dO * O), which
// it computes from the dO and O tiles at its first step and writes out as
// [B, H, Sq] f32 for K4.  K8 replaces ::_flash_bwd_dq_kernel (B7): the same
// dQ with Delta read from the caller (the ring backward computes it once
// from the ring's final output); it is K3's kernel compiled with a switch
// that loads Delta instead of the O-tile prepass, with K3's tiling, loop
// bounds and summation order, so fed the Delta K3 writes it gives K3's dQ
// bit for bit.  K4 replaces ::_flash_bwd_dkv_kernel (B3):
// dK = scale * sum dS^T Q and dV = sum P^T dO, summed over every query head
// of the KV head's GQA group.  All three recompute P = exp(s - lse) from
// the forward's (K1's) log-sum-exp, with dS = P * (dO V^T - Delta): K3 and
// K4 on the training step's backward (flash_block_grads, delta=None), K8
// and K4 on each step of the ring backward (delta given).  A block wholly
// in the future of its queries (a causal ring's dead blocks) has an empty
// loop in all three, so they write exact zeros.
//
// What bounds them on an H100: at the training shape (B=8, S=2048, H=8,
// Hkv=2, D=64, causal) K3 does 6 and K4 8 FLOPs per live (q, k) pair and
// head dim, ~50 and ~67 GFLOP against ~40 MB of tensors: far above the
// card's ~295 FLOP/byte ridge, so both are bound by tensor-core operations.
// This first version is the simple FlashAttention-2 form, the same as K1:
// 4 warps of 16 rows, mma.sync m16n8k16 in bf16 with f32 accumulation, the
// score tile's accumulator registers reused as the A operand of the next
// product (P and dS never touch shared memory), tiles loaded synchronously.
// f32 inputs take exact FMAs on the same layout (no TF32).  Not yet done
// (later work): cp.async/TMA double buffering, wgmma, ldmatrix.
//
// What the Pallas grids did, and what these do instead:
//  * K3's sequential K axis + VMEM dq scratch -> one block per (batch,
//    query head, 64-row q-tile) loops over the live K tiles, dQ in f32
//    registers, written once; Delta from the first step's O/dO tiles;
//  * K4's sequential (q-block x group member) axis -> one block per (batch,
//    KV head, 64-key tile) loops over every (q-tile, query head of the
//    group) pair, dK/dV in f32 registers, written once: deterministic, no
//    atomics across the group;
//  * pl.when(_block_live), _band_k, _band_q -> the loops run only over live
//    tiles: K3 from the window band's first K tile to the causal limit
//    min(Sk, q_offset + last row + 1 - k_offset), as K1; K4 from the causal
//    diagonal to the window band's last q-tile;
//  * GQA by index map -> query head h reads KV head h / (H / Hkv);
//  * BlockSpecs over fused [B*H, S, D] copies -> [B, S, H, D] tensors read
//    through their strides (the model's q/k/v are unbind views).
// Ragged Sq / Sk edges are masked in the kernels.  Rounding points follow
// the Pallas kernels: dS is rounded to q's dtype before dS K and dS^T Q, P
// to dO's dtype before P^T dO.

#include "common.cuh"

namespace {

using tpudist::from_f32;
using tpudist::load_rows;
using tpudist::mma_bf16_16816;
using tpudist::pack_bf16;
using tpudist::pack_bf16_raw;
using tpudist::to_f32;

constexpr int kRows = 64;     // K3: query rows per block; K4: keys per block
constexpr int kBK = 64;       // K3: keys per K/V tile
constexpr int kThreads = 128;

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
};

template <typename T, int D>
struct Tile {
  // shared row stride in 32-bit words: 4 words of padding keep the mma
  // fragment reads (8 rows x 4 words per warp) on distinct banks
  static constexpr int kLdw = D * (int)sizeof(T) / 4 + 4;
  static constexpr int kLde = kLdw * 4 / (int)sizeof(T);  // in elements
  static constexpr bool kF32 = std::is_same<T, float>::value;
};

// Whether key position kp is visible to query position qp.
__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp) {
  return !a.causal || (kp <= qp && (a.window <= 0 || qp - kp < a.window));
}

// A-operand fragment (16 rows from r0 = 16 * warp + g, 16 columns at kk*16)
// of a bf16 tile in shared memory.
__device__ __forceinline__ void a_frag(uint32_t f[4], const uint32_t* w,
                                       int ldw, int r0, int kk, int t4) {
  const int c = kk * 8 + t4;
  f[0] = w[r0 * ldw + c];
  f[1] = w[(r0 + 8) * ldw + c];
  f[2] = w[r0 * ldw + c + 4];
  f[3] = w[(r0 + 8) * ldw + c + 4];
}

// B-operand fragment for X·Yᵀ: 8 rows of Y (row-major in shared memory)
// from row n0 + g, depth kk*16.
__device__ __forceinline__ void bt_frag(uint32_t f[2], const uint32_t* w,
                                        int ldw, int n0, int g, int kk,
                                        int t4) {
  const uint32_t* r = w + (n0 + g) * ldw + kk * 8 + t4;
  f[0] = r[0];
  f[1] = r[4];
}

// B-operand fragment for X·Y: 16 rows of Y from row j*16, columns n*8 + g.
__device__ __forceinline__ void b_frag(uint32_t f[2], const __nv_bfloat16* y,
                                       int lde, int j, int n, int g,
                                       int t4) {
  const __nv_bfloat16* r = y + (j * 16 + t4 * 2) * lde + n * 8 + g;
  f[0] = pack_bf16_raw(r[0], r[lde]);
  f[1] = pack_bf16_raw(r[8 * lde], r[9 * lde]);
}

// Accumulate a 16 x (8*NT) C-layout tile x (rows of Y in shared memory,
// 8*NT of them) into acc[D/8][4]: acc += X·Y, X rounded to bf16 first.
template <int NT, int D>
__device__ __forceinline__ void acc_xy_bf16(float acc[D / 8][4],
                                            const float x[NT][4],
                                            const __nv_bfloat16* y, int lde,
                                            int g, int t4) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    pa[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    pa[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    pa[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bf[2];
      b_frag(bf, y, lde, j, n, g, t4);
      mma_bf16_16816(acc[n], pa, bf);
    }
  }
}

// f32 path of the same product: x staged in shared memory (this warp's 16
// rows, row stride xld), exact FMAs.
template <int NT, int D>
__device__ __forceinline__ void acc_xy_f32(float acc[D / 8][4],
                                           const float* xs, int xld,
                                           const float* y, int lde, int r0,
                                           int t4) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t4 * 2;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int kk = 0; kk < NT * 8; ++kk) {
      const float p0 = xs[r0 * xld + kk], p1 = xs[(r0 + 8) * xld + kk];
      const float y0 = y[kk * lde + c], y1 = y[kk * lde + c + 1];
      a0 = fmaf(p0, y0, a0);
      a1 = fmaf(p0, y1, a1);
      a2 = fmaf(p1, y0, a2);
      a3 = fmaf(p1, y1, a3);
    }
    acc[n][0] += a0;
    acc[n][1] += a1;
    acc[n][2] += a2;
    acc[n][3] += a3;
  }
}

// s = X·Yᵀ and t = U·Wᵀ over head dim D for this thread's rows r0, r0 + 8
// of X and U against 8*NT rows of Y and W: the score tile and dP tile.
template <typename T, int NT, int D>
__device__ __forceinline__ void two_products(float s[NT][4], float t[NT][4],
                                             const uint32_t* xw,
                                             const uint32_t* yw,
                                             const uint32_t* uw,
                                             const uint32_t* ww, int r0,
                                             int g, int t4) {
  using L = Tile<T, D>;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = t[nt][0] = t[nt][1] =
        t[nt][2] = t[nt][3] = 0.f;
  if constexpr (!L::kF32) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t xa[4], ua[4];
      a_frag(xa, xw, L::kLdw, r0, kk, t4);
      a_frag(ua, uw, L::kLdw, r0, kk, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bf[2];
        bt_frag(bf, yw, L::kLdw, nt * 8, g, kk, t4);
        mma_bf16_16816(s[nt], xa, bf);
        bt_frag(bf, ww, L::kLdw, nt * 8, g, kk, t4);
        mma_bf16_16816(t[nt], ua, bf);
      }
    }
  } else {
    const float* X = reinterpret_cast<const float*>(xw);
    const float* Y = reinterpret_cast<const float*>(yw);
    const float* U = reinterpret_cast<const float*>(uw);
    const float* W = reinterpret_cast<const float*>(ww);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r0 + 8;
        const int c = nt * 8 + t4 * 2 + (e & 1);
        const float* xr = X + r * L::kLde;
        const float* yr = Y + c * L::kLde;
        const float* ur = U + r * L::kLde;
        const float* wr = W + c * L::kLde;
        float as = 0.f, at = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          as = fmaf(xr[d], yr[d], as);
          at = fmaf(ur[d], wr[d], at);
        }
        s[nt][e] = as;
        t[nt][e] = at;
      }
    }
  }
}

// ---- K3 (dQ and Delta) and K8 (dQ from a given Delta) ----------------------

template <typename T, int D>
struct DqLayout : Tile<T, D> {
  using L = Tile<T, D>;
  static constexpr int kPld = kBK + 1;  // f32 path's dS row stride (floats)
  static constexpr size_t kBytes = (size_t)4 * kRows * L::kLdw * 4 +
                                   kRows * 4 +
                                   (L::kF32 ? kRows * kPld * 4 : 0);
};

// kGivenDelta: K8 (Delta read from a.delta); otherwise K3 (Delta computed
// from the O and dO tiles and written to a.delta).
template <typename T, int D, bool kGivenDelta>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdArgs a) {
  using L = DqLayout<T, D>;
  constexpr int NT = kBK / 8;   // 8-key column tiles of a score tile
  constexpr int ND = D / 8;     // 8-wide column tiles of dQ
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* Qw = smem;
  uint32_t* dOw = Qw + kRows * L::kLdw;
  uint32_t* Kw = dOw + kRows * L::kLdw;
  uint32_t* Vw = Kw + kBK * L::kLdw;
  float* Dl = reinterpret_cast<float*>(Vw + kBK * L::kLdw);  // Delta rows
  float* Ps = Dl + kRows;                                     // f32 dS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int hk = h / (a.H / a.Hkv);
  // last q-tiles first: under a causal mask they have the most live keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const long long row_base = ((long long)b * a.H + h) * a.Sq;

  const int rows_here = min(kRows, a.Sq - q0);
  int kv_lo = 0, kv_hi = a.Sk;
  if (a.causal) {
    kv_hi = max(0, min(a.Sk, a.q_off + q0 + rows_here - a.k_off));
    if (a.window > 0) kv_lo = max(0, a.q_off + q0 - (a.window - 1) - a.k_off);
  }
  kv_lo = (kv_lo / kBK) * kBK;

  load_rows<T>(Qw, L::kLdw, qb, a.q_ss, q0, a.Sq, kRows, D);
  load_rows<T>(dOw, L::kLdw, dob, a.do_ss, q0, a.Sq, kRows, D);
  if constexpr (kGivenDelta) {
    for (int r = tid; r < kRows; r += kThreads)
      Dl[r] = q0 + r < a.Sq ? a.delta[row_base + q0 + r] : 0.f;
    __syncthreads();
  } else {  // Delta = rowsum(dO * O) in f32: two threads per row
    const T* ob = static_cast<const T*>(a.out) + b * a.o_sb + h * a.o_sh;
    load_rows<T>(Kw, L::kLdw, ob, a.o_ss, q0, a.Sq, kRows, D);  // O, once
    __syncthreads();
    const int r = tid >> 1, half = tid & 1;
    const T* orow = reinterpret_cast<const T*>(Kw) + r * L::kLde + half * (D / 2);
    const T* drow = reinterpret_cast<const T*>(dOw) + r * L::kLde + half * (D / 2);
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D / 2; ++d)
      acc = fmaf(to_f32<T>(drow[d]), to_f32<T>(orow[d]), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Dl[r] = acc;
      if (q0 + r < a.Sq) a.delta[row_base + q0 + r] = acc;
    }
    __syncthreads();
  }

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const int qp0 = a.q_off + q0 + r0, qp1 = qp0 + 8;
  const float lse0 = q0 + r0 < a.Sq ? a.lse[row_base + q0 + r0] : 0.f;
  const float lse1 = q0 + r1 < a.Sq ? a.lse[row_base + q0 + r1] : 0.f;
  const float dl0 = Dl[r0], dl1 = Dl[r1];
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int kt = kv_lo; kt < kv_hi; kt += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<T>(Kw, L::kLdw, kb, a.k_ss, kt, a.Sk, kBK, D);
    load_rows<T>(Vw, L::kLdw, vb, a.v_ss, kt, a.Sk, kBK, D);
    __syncthreads();

    // s = Q K^T, dp = dO V^T (C-fragment layout: [nt][0..1] row r0,
    // [nt][2..3] row r1, keys nt*8 + t4*2 + {0, 1})
    float s[NT][4], dp[NT][4];
    two_products<T, NT, D>(s, dp, Qw, Kw, dOw, Vw, r0, g, t4);

    // P = exp(s*scale - lse) (0 where masked); dS = P * (dP - Delta)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt + nt * 8 + t4 * 2 + (e & 1);
        const bool keep =
            col < a.Sk && visible(a, e < 2 ? qp0 : qp1, a.k_off + col);
        const float p =
            keep ? expf(s[nt][e] * a.scale - (e < 2 ? lse0 : lse1)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += dS K (dS rounded to q's dtype)
    if constexpr (!L::kF32) {
      acc_xy_bf16<NT, D>(dq, s, reinterpret_cast<const __nv_bfloat16*>(Kw),
                         L::kLde, g, t4);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + t4 * 2;
        Ps[r0 * L::kPld + c] = s[nt][0];
        Ps[r0 * L::kPld + c + 1] = s[nt][1];
        Ps[r1 * L::kPld + c] = s[nt][2];
        Ps[r1 * L::kPld + c + 1] = s[nt][3];
      }
      __syncwarp();
      acc_xy_f32<NT, D>(dq, Ps, L::kPld, reinterpret_cast<const float*>(Kw),
                        L::kLde, r0, t4);
      __syncwarp();
    }
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
  const bool ok0 = q0 + r0 < a.Sq, ok1 = q0 + r1 < a.Sq;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t4 * 2;
    if (ok0) {
      T* row = dqb + (long long)(q0 + r0) * a.dq_ss + c;
      row[0] = from_f32<T>(dq[n][0] * a.scale);
      row[1] = from_f32<T>(dq[n][1] * a.scale);
    }
    if (ok1) {
      T* row = dqb + (long long)(q0 + r1) * a.dq_ss + c;
      row[0] = from_f32<T>(dq[n][2] * a.scale);
      row[1] = from_f32<T>(dq[n][3] * a.scale);
    }
  }
}

// ---- K4: dK and dV ----------------------------------------------------------

template <typename T, int D>
struct DkvLayout : Tile<T, D> {
  using L = Tile<T, D>;
  // queries per inner step: 32 at D = 128 keeps the score and dP tiles
  // (with the dK/dV accumulators) inside the register file
  static constexpr int kBQ = D >= 128 ? 32 : 64;
  static constexpr int kPld = kBQ + 1;  // f32 path's P^T / dS^T stride
  static constexpr size_t kBytes = (size_t)2 * kRows * L::kLdw * 4 +
                                   (size_t)2 * kBQ * L::kLdw * 4 +
                                   2 * kBQ * 4 +
                                   (L::kF32 ? 2 * kRows * kPld * 4 : 0);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdArgs a) {
  using L = DkvLayout<T, D>;
  constexpr int BQ = L::kBQ;
  constexpr int NT = BQ / 8;    // 8-query column tiles of a score tile
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* Kw = smem;
  uint32_t* Vw = Kw + kRows * L::kLdw;
  uint32_t* Qw = Vw + kRows * L::kLdw;
  uint32_t* dOw = Qw + BQ * L::kLdw;
  float* lse_s = reinterpret_cast<float*>(dOw + BQ * L::kLdw);
  float* dl_s = lse_s + BQ;
  float* Ps = dl_s + BQ;            // f32 path: P^T
  float* Ss = Ps + kRows * L::kPld;  // f32 path: dS^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int group = a.H / a.Hkv;
  const int k0 = blockIdx.y * kRows;  // early k-tiles (the heaviest) first
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // live query range: from the causal diagonal of the first key to the
  // window band's end for the last key
  const int keys_here = min(kRows, a.Sk - k0);
  int q_lo = 0, q_hi = a.Sq;
  if (a.causal) {
    q_lo = max(0, a.k_off + k0 - a.q_off);
    if (a.window > 0)
      q_hi = max(0, min(a.Sq, a.k_off + k0 + keys_here - 1 + a.window -
                                  a.q_off));
  }
  q_lo = (q_lo / BQ) * BQ;

  load_rows<T>(Kw, L::kLdw, kb, a.k_ss, k0, a.Sk, kRows, D);
  load_rows<T>(Vw, L::kLdw, vb, a.v_ss, k0, a.Sk, kRows, D);

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's two keys
  const int kp0 = a.k_off + k0 + r0, kp1 = kp0 + 8;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] =
        dv[n][2] = dv[n][3] = 0.f;

  for (int qt = q_lo; qt < q_hi; qt += BQ) {
    for (int m = 0; m < group; ++m) {
      const int h = hk * group + m;
      const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
      const T* dob =
          static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
      const long long row_base = ((long long)b * a.H + h) * a.Sq;
      __syncthreads();  // every warp is done with the previous tiles
      load_rows<T>(Qw, L::kLdw, qb, a.q_ss, qt, a.Sq, BQ, D);
      load_rows<T>(dOw, L::kLdw, dob, a.do_ss, qt, a.Sq, BQ, D);
      for (int i = tid; i < BQ; i += kThreads) {
        const bool ok = qt + i < a.Sq;
        lse_s[i] = ok ? a.lse[row_base + qt + i] : 0.f;
        dl_s[i] = ok ? a.delta[row_base + qt + i] : 0.f;
      }
      __syncthreads();

      // s = K Q^T, dp = V dO^T: rows are this warp's keys, columns the
      // tile's queries
      float s[NT][4], dp[NT][4];
      two_products<T, NT, D>(s, dp, Kw, Qw, Vw, dOw, r0, g, t4);

      // P^T and dS^T in place: s <- P, dp <- dS
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + t4 * 2 + (e & 1);
          const bool keep = qt + qi < a.Sq &&
                            visible(a, a.q_off + qt + qi, e < 2 ? kp0 : kp1);
          const float p =
              keep ? expf(s[nt][e] * a.scale - lse_s[qi]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl_s[qi]);
        }
      }

      // dV += P^T dO (P rounded to dO's dtype), dK += dS^T Q (dS rounded
      // to q's dtype)
      if constexpr (!L::kF32) {
        acc_xy_bf16<NT, D>(dv, s,
                           reinterpret_cast<const __nv_bfloat16*>(dOw),
                           L::kLde, g, t4);
        acc_xy_bf16<NT, D>(dk, dp, reinterpret_cast<const __nv_bfloat16*>(Qw),
                           L::kLde, g, t4);
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = nt * 8 + t4 * 2;
          Ps[r0 * L::kPld + c] = s[nt][0];
          Ps[r0 * L::kPld + c + 1] = s[nt][1];
          Ps[r1 * L::kPld + c] = s[nt][2];
          Ps[r1 * L::kPld + c + 1] = s[nt][3];
          Ss[r0 * L::kPld + c] = dp[nt][0];
          Ss[r0 * L::kPld + c + 1] = dp[nt][1];
          Ss[r1 * L::kPld + c] = dp[nt][2];
          Ss[r1 * L::kPld + c + 1] = dp[nt][3];
        }
        __syncwarp();
        acc_xy_f32<NT, D>(dv, Ps, L::kPld,
                          reinterpret_cast<const float*>(dOw), L::kLde, r0,
                          t4);
        acc_xy_f32<NT, D>(dk, Ss, L::kPld,
                          reinterpret_cast<const float*>(Qw), L::kLde, r0,
                          t4);
        __syncwarp();
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
  T* dvb = static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;
  const bool ok0 = k0 + r0 < a.Sk, ok1 = k0 + r1 < a.Sk;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t4 * 2;
    if (ok0) {
      T* kr = dkb + (long long)(k0 + r0) * a.dk_ss + c;
      T* vr = dvb + (long long)(k0 + r0) * a.dv_ss + c;
      kr[0] = from_f32<T>(dk[n][0] * a.scale);
      kr[1] = from_f32<T>(dk[n][1] * a.scale);
      vr[0] = from_f32<T>(dv[n][0]);
      vr[1] = from_f32<T>(dv[n][1]);
    }
    if (ok1) {
      T* kr = dkb + (long long)(k0 + r1) * a.dk_ss + c;
      T* vr = dvb + (long long)(k0 + r1) * a.dv_ss + c;
      kr[0] = from_f32<T>(dk[n][2] * a.scale);
      kr[1] = from_f32<T>(dk[n][3] * a.scale);
      vr[0] = from_f32<T>(dv[n][2]);
      vr[1] = from_f32<T>(dv[n][3]);
    }
  }
}

// ---- launch -----------------------------------------------------------------

// Kind: 0 = K3 (dQ and Delta), 1 = K8 (dQ from Delta), 2 = K4 (dK, dV).
template <typename T, int D, int Kind>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  void (*kernel)(const BwdArgs);
  size_t bytes;
  dim3 grid;
  if constexpr (Kind != 2) {
    kernel = flash_bwd_dq_kernel<T, D, Kind == 1>;
    bytes = DqLayout<T, D>::kBytes;
    grid = dim3(a.B * a.H, (a.Sq + kRows - 1) / kRows);
  } else {
    kernel = flash_bwd_dkv_kernel<T, D>;
    bytes = DkvLayout<T, D>::kBytes;
    grid = dim3(a.B * a.Hkv, (a.Sk + kRows - 1) / kRows);
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(a);
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
// (the pointers a kernel does not use may be null).  Each returns
// cudaGetLastError() after its launch.
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
      int q_off, int k_off, int causal, int window, float scale, void *stream
#define TPUDIST_BWD_ARGS                                                     \
  BwdArgs{q,     k,     v,     dout,  out,   lse,   delta, dq,    dk,        \
          dv,    B,     Sq,    Sk,    H,     Hkv,   q_sb,  q_ss,  q_sh,      \
          k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,  do_sb, do_ss, do_sh,     \
          o_sb,  o_ss,  o_sh,  dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh,     \
          dv_sb, dv_ss, dv_sh, q_off, k_off, causal, window, scale}

extern "C" int tpudist_flash_bwd_dq(TPUDIST_BWD_PARAMS) {
  return run<0>(dtype, TPUDIST_BWD_ARGS, D, stream);
}

extern "C" int tpudist_flash_bwd_dq_delta(TPUDIST_BWD_PARAMS) {
  return run<1>(dtype, TPUDIST_BWD_ARGS, D, stream);
}

extern "C" int tpudist_flash_bwd_dkv(TPUDIST_BWD_PARAMS) {
  return run<2>(dtype, TPUDIST_BWD_ARGS, D, stream);
}
