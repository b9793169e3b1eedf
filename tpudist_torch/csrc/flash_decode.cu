// K2: flash decode for Hopper (sm_90a) — one query token per head against
// the KV cache, with the serve loop's side buffer.
//
// Replaces tpudist/ops/flash_decode.py::_decode_kernel (Pallas, B4) in its
// bf16/f32, unpaged, unquantized form, reached through flash_decode; on the
// serve path it runs every decode tick (_serve_attend_sided) and the
// scalar-length decode of greedy_generate.
//
// What bounds it on an H100: a decode step does ~4 FLOP per cached
// element it reads (q·k and p·v over one query row per head), so it is
// bound by the bytes of live K/V (3.35 TB/s), not by arithmetic.  The
// Pallas kernel streamed each (batch, KV head) row sequentially on one
// TensorCore; on Hopper that grid (B*Hkv = 8 blocks at the serve shapes)
// would leave 124 of 132 SMs idle.  So this is a split-K (flash-decoding)
// grid: block (split, b*Hkv + hk) reads one 128-key chunk of row b's live
// cache — chunks past cache_len[b] (or before the window) exit at once and
// read nothing — with 16-byte coalesced loads into shared memory, and
// writes its partial (max, sum, unnormalized output) for the g = H/Hkv
// query heads of that KV head, so each KV head's cache streams once for
// the whole group.  The side buffer's live positions are one more split.
// A second small kernel merges the partials by log-sum-exp, which also
// yields return_lse.  Dot products are plain f32 FMAs: at ~4 FLOP/byte the
// tensor cores would buy nothing here.
//
// Not ported (TPU layout tricks): head pairing to fill 128 lanes, 8-row
// sublane padding of the group, the packed-cache relayout avoidance.  The
// packed [B, S, Hkv*D] cache is simply read through its strides.

#include "common.cuh"

namespace {

using tpudist::load_rows;
using tpudist::round_to;
using tpudist::to_f32;

constexpr int kCK = 128;       // keys per split
constexpr int kThreads = 128;  // one key per thread in the score pass
constexpr int kMaxGroup = 32;  // query heads per KV head

struct DecArgs {
  const void* q;        // [B, 1, H, D] through strides
  const void* k;        // cache [B, S, Hkv, D] through strides
  const void* v;
  const void* side_k;   // [B, cap, Hkv, D] or null
  const void* side_v;
  float* m_part;        // [B*Hkv, n_split, g]
  float* l_part;        // [B*Hkv, n_split, g]
  float* acc_part;      // [B*Hkv, n_split, g, D]
  int B, H, Hkv, S, cap, n_main, n_split;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long sk_sb, sk_ss, sk_sh, sv_sb, sv_ss, sv_sh;
  const int* len_ptr;   // [B] (len_stride 1) or scalar (0), or null
  int len_stride, len_val;
  const int* side_len_ptr;
  int side_len_val;
  int window;           // <= 0: none
  float scale;
};

template <typename T, int D>
struct Layout {
  // odd row stride in words: lane j reading row j hits bank (j * ldw) % 32,
  // all distinct
  static constexpr int kLdw = D * (int)sizeof(T) / 4 + 1;
  static size_t bytes(int g) {
    return (size_t)2 * kCK * kLdw * 4 + (size_t)g * D * 4 +
           (size_t)g * kCK * 4;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const DecArgs a) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) uint32_t smem[];
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
  const T* kb;
  const T* vb;
  long long kss, vss;
  int lo, hi;
  if (split < a.n_main) {
    const int len = a.len_ptr ? a.len_ptr[b * a.len_stride] : a.len_val;
    lo = split * kCK;
    hi = min(lo + kCK, min(len, a.S));
    if (a.window > 0) lo = max(lo, len - a.window);
    kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
    vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
    kss = a.k_ss;
    vss = a.v_ss;
  } else {
    const int sl = a.side_len_ptr ? *a.side_len_ptr : a.side_len_val;
    lo = (split - a.n_main) * kCK;
    hi = min(lo + kCK, min(sl, a.cap));
    kb = static_cast<const T*>(a.side_k) + b * a.sk_sb + hk * a.sk_sh;
    vb = static_cast<const T*>(a.side_v) + b * a.sv_sb + hk * a.sv_sh;
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

  load_rows<T>(Kw, L::kLdw, kb, kss, lo, hi, kCK, D);
  load_rows<T>(Vw, L::kLdw, vb, vss, lo, hi, kCK, D);
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + (hk * g) * a.q_sh;
  for (int i = tid; i < g * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = to_f32<T>(qb[r * a.q_sh + d]);
  }
  __syncthreads();

  // scores: thread j owns key lo + j
  {
    const int j = tid;
    const T* kr = reinterpret_cast<const T*>(Kw + j * L::kLdw);
    for (int r = 0; r < g; ++r) {
      float acc = 0.f;
      const float* qr = qs + r * D;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], to_f32<T>(kr[d]), acc);
      sc[r * kCK + j] = j < n ? acc * a.scale : -INFINITY;
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
      sr[j] = round_to<T>(p);            // P in the value dtype
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
  const T* Vs = reinterpret_cast<const T*>(Vw);
  constexpr int lde = L::kLdw * 4 / (int)sizeof(T);
  for (int i = tid; i < g * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float* pr = sc + r * kCK;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pr[j], to_f32<T>(Vs[j * lde + d]), acc);
    a.acc_part[pidx * g * D + i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_merge_kernel(const float* m_part, const float* l_part,
                        const float* acc_part, void* out, float* lse,
                        int H, int Hkv, int D, int n_split, long long o_sb,
                        long long o_sh) {
  __shared__ float Ms[kMaxGroup], Ls[kMaxGroup];
  const int g = H / Hkv;
  const int row = blockIdx.x, b = row / Hkv, hk = row % Hkv;
  const int tid = threadIdx.x;
  const long long base = (long long)row * n_split;
  if (tid < g) {
    float M = TPUDIST_NEG_BIG;
    for (int i = 0; i < n_split; ++i) M = fmaxf(M, m_part[(base + i) * g + tid]);
    float Lsum = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float mi = m_part[(base + i) * g + tid];
      if (mi != -INFINITY) Lsum += l_part[(base + i) * g + tid] * expf(mi - M);
    }
    Ms[tid] = M;
    Ls[tid] = Lsum;
    if (lse) lse[(long long)b * H + hk * g + tid] = M + logf(fmaxf(Lsum, 1e-30f));
  }
  __syncthreads();
  T* ob = static_cast<T*>(out) + b * o_sb + (long long)(hk * g) * o_sh;
  for (int i = tid; i < g * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const float M = Ms[r];
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float mi = m_part[(base + s) * g + r];
      if (mi != -INFINITY)
        acc += acc_part[((base + s) * g + r) * D + d] * expf(mi - M);
    }
    ob[r * o_sh + d] = tpudist::from_f32<T>(acc / fmaxf(Ls[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const DecArgs& a, void* out, float* lse, long long o_sb,
                   long long o_sh, cudaStream_t stream) {
  using L = Layout<T, D>;
  const int g = a.H / a.Hkv;
  const size_t bytes = L::bytes(g);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_partial_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::bytes(kMaxGroup));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(a.n_split, a.B * a.Hkv);
  decode_partial_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_merge_kernel<T><<<a.B * a.Hkv, kThreads, 0, stream>>>(
      a.m_part, a.l_part, a.acc_part, out, lse, a.H, a.Hkv, D, a.n_split,
      o_sb, o_sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const DecArgs& a, void* out, float* lse,
                     long long o_sb, long long o_sh, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(a, out, lse, o_sb, o_sh, s);
    case 32: return launch<T, 32>(a, out, lse, o_sb, o_sh, s);
    case 64: return launch<T, 64>(a, out, lse, o_sb, o_sh, s);
    case 128: return launch<T, 128>(a, out, lse, o_sb, o_sh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tpudist_flash_decode_split_keys(void) { return kCK; }

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements (head_dim stride
// 1).  len_ptr: per-row [B] int32 (len_stride 1), a device scalar
// (len_stride 0) or null (len_val).  side_k null: no side buffer.  lse may
// be null.  Returns cudaGetLastError() after the two launches.
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
    const int* side_len_ptr, int side_len_val, int window, float scale,
    void* stream) {
  if (H % Hkv != 0 || H / Hkv > kMaxGroup) return cudaErrorInvalidValue;
  DecArgs a{q, k, v, side_k, side_v, m_part, l_part, acc_part,
            B, H, Hkv, S, cap, n_main, n_split,
            q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            sk_sb, sk_ss, sk_sh, sv_sb, sv_ss, sv_sh,
            len_ptr, len_stride, len_val, side_len_ptr, side_len_val,
            window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1
                      ? dispatch<__nv_bfloat16>(D, a, out, lse, o_sb, o_sh, s)
                      : dispatch<float>(D, a, out, lse, o_sb, o_sh, s);
  return static_cast<int>(e);
}
