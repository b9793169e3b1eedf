// K2, K5, K6: flash decode for Hopper (sm_90a) — one query token per head
// against the KV cache, with the serve loop's side buffer.
//
// Replaces tpudist/ops/flash_decode.py::_decode_kernel (Pallas) in three of
// its forms, all from one templated partial kernel that differs only in
// how it finds a key's row and what type the rows hold:
//  * K2 (B4): the dense cache [B, S, Hkv, D] (or packed [B, S, Hkv*D]) read
//    through strides, bf16/f32, reached through flash_decode; on the serve
//    path it runs every decode tick of the dense layout
//    (_serve_attend_sided) and the scalar-length decode of greedy_generate;
//  * K5 (B5): the paged pool [N, bs, Hkv*D] read through a page table
//    [B, M] int32, reached through paged_flash_decode; it runs every decode
//    tick of the paged layout (_paged_attend);
//  * K6 (B6): an int8 cache [B, S, Hkv, D] with one f32 scale per (token,
//    head), reached through flash_decode_q8 (a public entry point; no model
//    path calls it).
//
// What bounds them on an H100: a decode step does ~4 FLOP per cached
// element it reads (q·k and p·v over one query row per head), so each is
// bound by the bytes of live K/V (3.35 TB/s), not by arithmetic.  The
// Pallas kernel streamed each (batch, KV head) row sequentially on one
// TensorCore (grid (B*Hkv, blocks), one cache or pool block per step); on
// Hopper that grid (B*Hkv = 8 blocks at the serve shapes) would leave 124
// of 132 SMs idle.  So this is a split-K (flash-decoding) grid: block
// (split, b*Hkv + hk) reads one 128-key chunk of row b's live cache —
// chunks past cache_len[b] (or before the window) exit at once and read
// nothing, not even the page table — with 16-byte coalesced loads into
// shared memory, and writes its partial (max, sum, unnormalized output)
// for the g = H/Hkv query heads of that KV head, so each KV head's cache
// streams once for the whole group.  The side buffer's live positions are
// one more split.  Dot products are plain f32 FMAs: at ~4 FLOP/byte the
// tensor cores would buy nothing here.
//
// The merge (decode_merge_kernel) combines the partials by log-sum-exp,
// which also yields return_lse.  At the serve shapes a row has 65 splits
// and the grid only B*Hkv = 8 (row, KV head) pairs, so the merge runs one
// warp per (batch row, query head), B*H warps, each a CTA of its own (four
// a CTA measured slower at the serve shape: scripts/kernel_variants.py
// merge): the lanes read
// the splits' maxima and sums, M and L come from shuffle reductions in a
// fixed tree order, the weights exp(m_i - M) of the live splits go to
// shared memory in split order (a ballot compacts them), and then each
// lane sums w_i * acc_i over the live splits, in split order, for its
// columns of D.  Splits with m_i = -inf (dead chunks, which write no
// acc) are skipped.  No atomics: two calls agree bit for bit.
//
// Sequence-sharded decode (K2 and K6): the buffer may be one rank's slice
// of a longer cache, its slot j holding global position off + j, as the
// Pallas metadata's offset does.  Validity (p < cache_len) and the window
// (p >= cache_len - window) are taken on global positions, so a split
// wholly past cache_len or wholly before the window is dead, and a slice
// with no live key writes out = 0 and lse = -1e30 (the merge's floor):
// its weight in an LSE merge across ranks is exactly zero.
//
// K5's one difference: key p of row b is pool[table[b, p / bs], p % bs].
// The block's threads first read one table entry per page that the
// chunk's live keys cover into shared memory (at bs = 16 one 128-key
// split spans 8 pages, and bs need not divide 128), then load each key's
// contiguous Hkv*D row with the same 16-byte loads.  Split boundaries and
// accumulation order are K2's, so K5 over a pool gives bit-identical
// output to K2 over the gathered view of that pool (paged_gather_kv).
//
// K6 keeps the Pallas int8 numerics: q rounded to bf16, s = (q·k_int8) ·
// (k_scale · D^-1/2) with f32 accumulation, p = exp(s - m), the value
// product over round_bf16(p · v_scale) while l sums the unscaled p.
//
// Not ported (TPU layout tricks): head pairing to fill 128 lanes, 8-row
// sublane padding of the group, the packed-cache relayout avoidance.

#include "common.cuh"

namespace {

using tpudist::load_rows;
using tpudist::round_to;
using tpudist::to_f32;

constexpr int kCK = 128;       // keys per split
constexpr int kThreads = 128;  // one key per thread in the score pass
constexpr int kMaxGroup = 32;  // query heads per KV head
constexpr int kMaxPages = kCK / 8 + 1;  // pages a split covers (bs >= 8)

// How the partial kernel finds a key's row, and what the rows hold.
enum Mode { kStrided = 0, kPaged = 1, kInt8 = 2 };

struct DecArgs {
  const void* q;        // [B, 1, H, D] through strides
  const void* k;        // kStrided/kInt8: cache [B, S, Hkv, D] through
  const void* v;        //   strides; kPaged: pool [N, bs, Hkv, D]
  const void* side_k;   // [B, cap, Hkv, D] or null
  const void* side_v;
  float* m_part;        // [B*Hkv, n_split, g]
  float* l_part;        // [B*Hkv, n_split, g]
  float* acc_part;      // [B*Hkv, n_split, g, D]
  int B, H, Hkv, S, cap, n_main, n_split;
  long long q_sb, q_sh;
  // kPaged: *_sb is the pool's block stride, *_ss its row stride
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long sk_sb, sk_ss, sk_sh, sv_sb, sv_ss, sv_sh;
  const int* len_ptr;   // [B] (len_stride 1) or scalar (0), or null
  int len_stride, len_val;
  const int* side_len_ptr;
  int side_len_val;
  const int* off_ptr;   // K2/K6: a device scalar, or null (off_val)
  int off_val;          // this buffer's first global position
  int window;           // <= 0: none
  float scale;
  const int* table;     // kPaged: [B, M] int32 pool indices
  int M, bs;
  const float* k_scale;  // kInt8: [B, S, Hkv] f32 through strides
  const float* v_scale;
  long long ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
};

template <typename KV>
__device__ __forceinline__ float kv_f32(KV x) { return to_f32<KV>(x); }
template <>
__device__ __forceinline__ float kv_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename KV, int D>
struct Layout {
  // odd row stride in words: lane j reading row j hits bank (j * ldw) % 32,
  // all distinct
  static constexpr int kLdw = D * (int)sizeof(KV) / 4 + 1;
  static size_t bytes(int g) {
    return (size_t)2 * kCK * kLdw * 4 + (size_t)g * D * 4 +
           (size_t)g * kCK * 4;
  }
};

// K5's row loads: key lo + r of the chunk lives at pool block
// blk[(lo + r) / bs - first], row (lo + r) % bs, where blk holds the
// table entries of the pages from `first` on; rows at or past n are
// zero-filled (as load_rows does)
template <typename T>
__device__ __forceinline__ void load_paged_rows(uint32_t* dst, int ld_words,
                                                const T* src, long long sb,
                                                long long ss, const int* blk,
                                                int lo, int first, int n,
                                                int bs, int cols) {
  const int vpr = cols * (int)sizeof(T) / 16;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kCK * vpr; i += blockDim.x) {
    const int r = i / vpr, c = i % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) {
      val = *reinterpret_cast<const uint4*>(
          src + (long long)blk[(lo + r) / bs - first] * sb +
          (long long)((lo + r) % bs) * ss + c * (16 / (int)sizeof(T)));
    }
    uint32_t* d = dst + r * ld_words + c * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// T: the query and output type; KV: the cache type (T, or int8_t in kInt8)
template <typename T, typename KV, int D, int kMode>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const DecArgs a) {
  using L = Layout<KV, D>;
  extern __shared__ __align__(16) uint32_t smem[];
  // K5: the chunk's pool blocks, one a page; K6: its keys' K and V scales
  __shared__ int blk_s[kMode == kPaged ? kMaxPages : 1];
  __shared__ float ksc[kMode == kInt8 ? kCK : 1];
  __shared__ float vsc[kMode == kInt8 ? kCK : 1];
  uint32_t* Kw = smem;
  uint32_t* Vw = Kw + kCK * L::kLdw;
  float* qs = reinterpret_cast<float*>(Vw + kCK * L::kLdw);  // [g, D]
  const int g = a.H / a.Hkv;
  float* sc = qs + g * D;                                      // [g, kCK]

  const int split = blockIdx.x, row = blockIdx.y;
  const int b = row / a.Hkv, hk = row % a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long pidx = (long long)row * a.n_split + split;

  // this split's key range [lo, hi) and source
  const KV* kb;
  const KV* vb;
  long long kss, vss;
  int lo, hi;
  const bool main_split = split < a.n_main;
  if (main_split) {
    // slot j holds global position off + j: the causal limit and the
    // window are global, so both move into slot terms by -off
    const int off = a.off_ptr ? *a.off_ptr : a.off_val;
    const int len =
        (a.len_ptr ? a.len_ptr[b * a.len_stride] : a.len_val) - off;
    lo = split * kCK;
    hi = min(lo + kCK, min(len, a.S));
    if (a.window > 0) lo = max(lo, len - a.window);
    kss = a.k_ss;
    vss = a.v_ss;
    if (kMode == kPaged) {  // the block index is added per key
      kb = static_cast<const KV*>(a.k) + hk * a.k_sh;
      vb = static_cast<const KV*>(a.v) + hk * a.v_sh;
    } else {
      kb = static_cast<const KV*>(a.k) + b * a.k_sb + hk * a.k_sh;
      vb = static_cast<const KV*>(a.v) + b * a.v_sb + hk * a.v_sh;
    }
  } else {
    const int sl = a.side_len_ptr ? *a.side_len_ptr : a.side_len_val;
    lo = (split - a.n_main) * kCK;
    hi = min(lo + kCK, min(sl, a.cap));
    kb = static_cast<const KV*>(a.side_k) + b * a.sk_sb + hk * a.sk_sh;
    vb = static_cast<const KV*>(a.side_v) + b * a.sv_sb + hk * a.sv_sh;
    kss = a.sk_ss;
    vss = a.sv_ss;
  }
  if (hi <= lo) {  // dead chunk: reads nothing, the merge skips it
    if (tid < g) {
      a.m_part[pidx * g + tid] = -INFINITY;
      a.l_part[pidx * g + tid] = 0.f;
    }
    return;
  }
  const int n = hi - lo;
  const int first = kMode == kPaged ? lo / a.bs : 0;  // K5: its first page

  if constexpr (kMode == kPaged) {
    if (main_split) {
      // one entry per page of the live keys: p < hi <= cache_len[b]
      const int pages = (hi - 1) / a.bs - first + 1;
      for (int i = tid; i < pages; i += kThreads)
        blk_s[i] = a.table[(long long)b * a.M + first + i];
    }
  }
  if constexpr (kMode == kInt8) {
    for (int r = tid; r < kCK; r += kThreads) {
      const bool live = r < n;
      const long long p = lo + r;
      ksc[r] = live ? a.k_scale[b * a.ks_sb + p * a.ks_ss + hk * a.ks_sh]
                    : 0.f;
      vsc[r] = live ? a.v_scale[b * a.vs_sb + p * a.vs_ss + hk * a.vs_sh]
                    : 0.f;
    }
  }
  __syncthreads();
  if (kMode == kPaged && main_split) {
    load_paged_rows<KV>(Kw, L::kLdw, kb, a.k_sb, kss, blk_s, lo, first, n,
                        a.bs, D);
    load_paged_rows<KV>(Vw, L::kLdw, vb, a.v_sb, vss, blk_s, lo, first, n,
                        a.bs, D);
  } else {
    load_rows<KV>(Kw, L::kLdw, kb, kss, lo, hi, kCK, D);
    load_rows<KV>(Vw, L::kLdw, vb, vss, lo, hi, kCK, D);
  }
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + (hk * g) * a.q_sh;
  for (int i = tid; i < g * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float x = to_f32<T>(qb[r * a.q_sh + d]);
    // K6 rounds q to bf16, as the Pallas int8 path does
    qs[i] = kMode == kInt8 ? round_to<__nv_bfloat16>(x) : x;
  }
  __syncthreads();

  // scores: thread j owns key lo + j
  {
    const int j = tid;
    const KV* kr = reinterpret_cast<const KV*>(Kw + j * L::kLdw);
    const float kscale = kMode == kInt8 ? ksc[j] * a.scale : a.scale;
    for (int r = 0; r < g; ++r) {
      float acc = 0.f;
      const float* qr = qs + r * D;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kv_f32<KV>(kr[d]), acc);
      sc[r * kCK + j] = j < n ? acc * kscale : -INFINITY;
    }
  }
  __syncthreads();

  // per query row: max, exp, sum (one warp per row)
  for (int r = warp; r < g; r += kThreads / 32) {
    float* sr = sc + r * kCK;
    float mx = -INFINITY;
    for (int j = lane; j < kCK; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < kCK; j += 32) {
      const float p = expf(sr[j] - mx);  // masked keys: exp(-inf) = 0
      sum += p;
      if constexpr (kMode == kInt8) {
        sr[j] = round_to<__nv_bfloat16>(p * vsc[j]);  // v scale folded in
      } else {
        sr[j] = round_to<T>(p);            // P in the value dtype
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      a.m_part[pidx * g + r] = mx;
      a.l_part[pidx * g + r] = sum;
    }
  }
  __syncthreads();

  // unnormalized output: thread (r, d) sums p[r, j] * v[j, d]
  const KV* Vs = reinterpret_cast<const KV*>(Vw);
  constexpr int lde = L::kLdw * 4 / (int)sizeof(KV);
  for (int i = tid; i < g * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float* pr = sc + r * kCK;
    float acc = 0.f;
    for (int j = 0; j < n; ++j)
      acc = fmaf(pr[j], kv_f32<KV>(Vs[j * lde + d]), acc);
    a.acc_part[pidx * g * D + i] = acc;
  }
}

// One warp a CTA per (batch row b, query head h = hk * g + r).  Dynamic
// shared memory: the live splits' weights and indices.
template <typename T, int D>
__global__ void __launch_bounds__(32)
    decode_merge_kernel(const float* m_part, const float* l_part,
                        const float* acc_part, void* out, float* lse, int H,
                        int Hkv, int n_split, long long o_sb, long long o_sh) {
  extern __shared__ float merge_s[];
  constexpr int kPer = (D + 31) / 32;  // columns a lane
  const int lane = threadIdx.x;
  const int g = H / Hkv, b = blockIdx.x / H, h = blockIdx.x % H, r = h % g;
  const long long base = ((long long)b * Hkv + h / g) * n_split;
  float* w_s = merge_s;
  int* idx_s = reinterpret_cast<int*>(w_s + n_split);

  // M: the lanes over the splits, then a shuffle tree
  float M = TPUDIST_NEG_BIG;
  for (int s = lane; s < n_split; s += 32)
    M = fmaxf(M, m_part[(base + s) * g + r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  // the live splits' weights, compacted in split order; L: each lane's
  // splits in order, then a shuffle tree
  float L = 0.f;
  int n_live = 0;
  for (int s0 = 0; s0 < n_split; s0 += 32) {
    const int s = s0 + lane;
    const float mi = s < n_split ? m_part[(base + s) * g + r] : -INFINITY;
    const bool live = mi != -INFINITY;
    const unsigned ball = __ballot_sync(0xffffffffu, live);
    if (live) {
      const float w = expf(mi - M);
      L += l_part[(base + s) * g + r] * w;
      const int at = n_live + __popc(ball & ((1u << lane) - 1u));
      w_s[at] = w;
      idx_s[at] = s;
    }
    n_live += __popc(ball);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, off);
  __syncwarp();
  if (lse && lane == 0) lse[(long long)b * H + h] = M + logf(fmaxf(L, 1e-30f));

  // the output: this lane's columns, summed over the live splits in order
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (int j = 0; j < n_live; ++j) {
    const float w = w_s[j];
    const float* p = acc_part + ((base + idx_s[j]) * g + r) * D + lane;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (lane + 32 * k < D) acc[k] = fmaf(w, p[32 * k], acc[k]);
  }
  T* ob = static_cast<T*>(out) + b * o_sb + (long long)h * o_sh;
  const float Lc = fmaxf(L, 1e-30f);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (lane + 32 * k < D) ob[lane + 32 * k] = tpudist::from_f32<T>(acc[k] / Lc);
}

template <typename T, typename KV, int D, int kMode>
cudaError_t launch(const DecArgs& a, void* out, float* lse, long long o_sb,
                   long long o_sh, cudaStream_t stream) {
  using L = Layout<KV, D>;
  const int g = a.H / a.Hkv;
  const size_t bytes = L::bytes(g);
  // the merge's weights and split indices
  const size_t merge_bytes = (size_t)a.n_split * 8;
  static bool configured = false;
  if (!configured) {  // once, before any graph capture
    cudaError_t e = cudaFuncSetAttribute(
        decode_partial_kernel<T, KV, D, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::bytes(kMaxGroup));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(decode_merge_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(a.n_split, a.B * a.Hkv);
  decode_partial_kernel<T, KV, D, kMode><<<grid, kThreads, bytes, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_merge_kernel<T, D><<<a.B * a.H, 32, merge_bytes, stream>>>(
      a.m_part, a.l_part, a.acc_part, out, lse, a.H, a.Hkv, a.n_split, o_sb,
      o_sh);
  return cudaGetLastError();
}

template <typename T, typename KV, int kMode>
cudaError_t dispatch(int d, const DecArgs& a, void* out, float* lse,
                     long long o_sb, long long o_sh, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, KV, 16, kMode>(a, out, lse, o_sb, o_sh, s);
    case 32: return launch<T, KV, 32, kMode>(a, out, lse, o_sb, o_sh, s);
    case 64: return launch<T, KV, 64, kMode>(a, out, lse, o_sb, o_sh, s);
    case 128: return launch<T, KV, 128, kMode>(a, out, lse, o_sb, o_sh, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (the query, output and, except in K6,
// cache type)
template <int kMode>
int run(int dtype, int d, const DecArgs& a, void* out, float* lse,
        long long o_sb, long long o_sh, void* stream) {
  if (a.H % a.Hkv != 0 || a.H / a.Hkv > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (kMode == kInt8) {
    e = dtype == 1
            ? dispatch<__nv_bfloat16, int8_t, kMode>(d, a, out, lse, o_sb,
                                                     o_sh, s)
            : dispatch<float, int8_t, kMode>(d, a, out, lse, o_sb, o_sh, s);
  } else {
    e = dtype == 1 ? dispatch<__nv_bfloat16, __nv_bfloat16, kMode>(
                         d, a, out, lse, o_sb, o_sh, s)
                   : dispatch<float, float, kMode>(d, a, out, lse, o_sb,
                                                   o_sh, s);
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" int tpudist_flash_decode_split_keys(void) { return kCK; }

// K2.  Strides in elements (head_dim stride 1).  len_ptr: per-row [B]
// int32 (len_stride 1), a device scalar (len_stride 0) or null (len_val);
// off_ptr (a device scalar) or off_val: the global position of slot 0
// (sequence-sharded decode), which len and window are measured in.
// side_k null: no side buffer.  lse may be null.  Returns
// cudaGetLastError() after the two launches.
extern "C" int tpudist_flash_decode(
    int dtype, const void* q, const void* k, const void* v,
    const void* side_k, const void* side_v, void* out, float* lse,
    float* m_part, float* l_part, float* acc_part,
    int B, int H, int Hkv, int D, int S, int cap, int n_main, int n_split,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long sk_sb, long long sk_ss, long long sk_sh,
    long long sv_sb, long long sv_ss, long long sv_sh,
    long long o_sb, long long o_sh,
    const int* len_ptr, int len_stride, int len_val,
    const int* side_len_ptr, int side_len_val, const int* off_ptr,
    int off_val, int window, float scale, void* stream) {
  DecArgs a{q, k, v, side_k, side_v, m_part, l_part, acc_part,
            B, H, Hkv, S, cap, n_main, n_split,
            q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            sk_sb, sk_ss, sk_sh, sv_sb, sv_ss, sv_sh,
            len_ptr, len_stride, len_val, side_len_ptr, side_len_val,
            off_ptr, off_val, window, scale,
            nullptr, 0, 0, nullptr, nullptr, 0, 0, 0, 0, 0, 0};
  return run<kStrided>(dtype, D, a, out, lse, o_sb, o_sh, stream);
}

// K5.  Pools [N, bs, Hkv, D] through strides (p_sn: block, p_ss: row,
// p_sh: head); table [B, M] int32 with M * bs = S, the logical capacity;
// per-row lengths len_ptr [B]; side buffers as in K2.
extern "C" int tpudist_paged_flash_decode(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* side_k, const void* side_v, void* out, float* lse,
    float* m_part, float* l_part, float* acc_part, const int* table,
    int B, int H, int Hkv, int D, int M, int bs, int cap, int n_main,
    int n_split,
    long long q_sb, long long q_sh,
    long long k_sn, long long k_ss, long long k_sh,
    long long v_sn, long long v_ss, long long v_sh,
    long long sk_sb, long long sk_ss, long long sk_sh,
    long long sv_sb, long long sv_ss, long long sv_sh,
    long long o_sb, long long o_sh, const int* len_ptr,
    const int* side_len_ptr, int side_len_val, float scale, void* stream) {
  DecArgs a{q, k_pool, v_pool, side_k, side_v, m_part, l_part, acc_part,
            B, H, Hkv, M * bs, cap, n_main, n_split,
            q_sb, q_sh, k_sn, k_ss, k_sh, v_sn, v_ss, v_sh,
            sk_sb, sk_ss, sk_sh, sv_sb, sv_ss, sv_sh,
            len_ptr, 1, 0, side_len_ptr, side_len_val, nullptr, 0, 0,
            scale,
            table, M, bs, nullptr, nullptr, 0, 0, 0, 0, 0, 0};
  return run<kPaged>(dtype, D, a, out, lse, o_sb, o_sh, stream);
}

// K6.  int8 caches [B, S, Hkv, D] and f32 scales [B, S, Hkv] through
// strides; lengths, offset and window as in K2; no side buffer.
extern "C" int tpudist_flash_decode_q8(
    int dtype, const void* q, const void* k, const float* k_scale,
    const void* v, const float* v_scale, void* out, float* lse,
    float* m_part, float* l_part, float* acc_part,
    int B, int H, int Hkv, int D, int S, int n_split,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long ks_sb, long long ks_ss, long long ks_sh,
    long long vs_sb, long long vs_ss, long long vs_sh,
    long long o_sb, long long o_sh,
    const int* len_ptr, int len_stride, int len_val, const int* off_ptr,
    int off_val, int window, float scale, void* stream) {
  DecArgs a{q, k, v, nullptr, nullptr, m_part, l_part, acc_part,
            B, H, Hkv, S, 0, n_split, n_split,
            q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            0, 0, 0, 0, 0, 0,
            len_ptr, len_stride, len_val, nullptr, 0, off_ptr, off_val,
            window, scale,
            nullptr, 0, 0, k_scale, v_scale,
            ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
  return run<kInt8>(dtype, D, a, out, lse, o_sb, o_sh, stream);
}
