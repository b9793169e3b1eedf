// K9 and K10: GroupNorm forward and backward, fused with ReLU or with a
// residual add and ReLU, for Hopper (sm_90a).
//
// K9 replaces tpudist/ops/group_norm.py::_fused_fwd_kernel (Pallas, B9a):
//
//   mean, var = E[x], E[x²] − mean²   per (sample, group), f32
//   rstd      = 1 / sqrt(var + eps)
//   y         = act(x̂·γ + β (+ res)),  x̂ = (x − mean)·rstd
//
// with act the identity (plain), or ReLU (relu, add_relu); y in x's dtype,
// mean and rstd [B, G] f32.  K10 replaces _fused_bwd_kernel (B9b): with
// dym = dy masked by pre > 0 in the ReLU modes (the pre-activation
// recomputed from x, mean and rstd, as the Pallas kernel does) and
// g = dym·γ,
//
//   dx   = rstd·(g − mean_G(g) − x̂·mean_G(g·x̂))
//   dres = dym                                 (add_relu)
//
// and per-(sample, split) partials of Σ dym·x̂ and Σ dym over rows, [C]
// each, which the wrapper sums into dγ and dβ (tpudist sums its per-sample
// partials over B outside the kernel).  The pre-activation is
// group_norm.cuh's, shared with the plain versions' expression.
//
// What bounds them on an H100: a few FLOPs per element against 2 bytes
// (bf16) read or written per element and tensor: memory bandwidth.  At
// ResNet50's GroupNorm sites (batch 128, 128 px) a forward call moves
// 16-400 MB.
//
// What the Pallas grid did, and what this does instead:
//  * one grid step per sample with the whole [H·W, C] slab in VMEM (hence
//    tpudist's 2 MB fallback switch) -> nothing is held on chip across
//    rows.  Each kernel runs two passes over a grid of (split, sample)
//    CTAs, each CTA a contiguous range of rows of one sample, enough CTAs
//    to fill the 132 SMs at batch 128 (about 8,192 elements a CTA):
//      pass 1: each thread reads 16 bytes of a row (8 bf16 or 4 f32
//        channels, coalesced along the row), accumulates per-channel sums
//        in f32 registers over its rows, and the CTA reduces them through
//        shared memory in a fixed order into per-split partials in global
//        memory (K9: per group Σx and Σx²; K10: per channel Σ dym·x̂ and
//        Σ dym);
//      pass 2: each CTA first folds its sample's partials, in split order,
//        into the group statistics (K9: mean, rstd, a thread a group; K10:
//        mean_G(g) and mean_G(g·x̂) from Σ g = γ·Σ dym per channel, a
//        thread a channel, then a thread a group), then makes its
//        elementwise pass over its rows;
//  * the one-hot [C, G] matmuls that Mosaic needed for group sums ->
//    channel ch belongs to group ch / (C / G); sums run over a group's
//    channels in order.
// No atomics: every sum has a fixed order, so results repeat run to run.
// Each pass reads its inputs once, so a call reads them twice: expect at
// least twice the bytes bound.  Not yet done (later work): one pass with
// a grid-wide barrier or a cluster reduction for slabs that fit on chip.
//
// Constraints (the wrapper checks them and raises): x, dy, res contiguous
// [B, H·W, C] of one dtype, rows of at most 512 16-byte vectors (C ≤ 4096
// bf16, ≤ 2048 f32) and a multiple of 16 bytes, C a multiple of G,
// B ≤ 65535.

#include "common.cuh"
#include "group_norm.cuh"

namespace {

using tpudist::from_f32;
using tpudist::gn_pre;
using tpudist::gn_xhat;
using tpudist::to_f32;

enum Mode { kPlain = 0, kRelu = 1, kAddRelu = 2 };
constexpr int kMinThreads = 256;
constexpr int kMaxVecsPerRow = 512;

struct Shape {
  int b, hw, c, groups, splits;
  int rows;   // rows of one split (the last may have fewer)
  int vpr;    // 16-byte vectors per row
  int slots;  // rows a CTA reads at once in pass 1: threads / vpr
};

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[kVec<T>]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) v[i] = to_f32<T>(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[kVec<T>]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// dy masked by the pre-activation in the ReLU modes (K10's mask).
template <int MODE>
__device__ __forceinline__ float masked_dy(float dy, float pre) {
  return MODE == kPlain ? dy : (pre > 0.f ? dy : 0.f);
}

// The pre-activation of channel ch of one element (res: the residual's
// value, read only in add_relu mode).
template <int MODE>
__device__ __forceinline__ float pre_act(float xh, int ch, float res,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias) {
  float pre = gn_pre(xh, __ldg(scale + ch), __ldg(bias + ch));
  if (MODE == kAddRelu) pre = __fadd_rn(pre, res);
  return pre;
}

// Pass 1's reduction: each thread's per-channel sums acc (and acc2) of
// its vector column, over the CTA's row slots, into per-channel totals in
// sm[0 .. c) (and sm[slots·c .. slots·c + c)), slot by slot in order.
// sm holds 2·slots·c floats.
template <int V>
__device__ __forceinline__ void reduce_slots(float* sm, const Shape& s,
                                             int slot, int col,
                                             const float (&acc)[V],
                                             const float (&acc2)[V]) {
  float* sm2 = sm + s.slots * s.c;
  if (slot < s.slots) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sm[slot * s.c + col * V + i] = acc[i];
      sm2[slot * s.c + col * V + i] = acc2[i];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < s.c; ch += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < s.slots; ++k) {
      a += sm[k * s.c + ch];
      a2 += sm2[k * s.c + ch];
    }
    sm[ch] = a;    // column ch is this thread's alone
    sm2[ch] = a2;
  }
  __syncthreads();
}

// K9 pass 1: per (sample, split, group) partial Σx and Σx² into
// part[((b·splits + split)·G + g)·2 + {0, 1}].
template <typename T>
__global__ void gn_fwd_stats(const T* __restrict__ x, float* __restrict__ part,
                             Shape s) {
  constexpr int V = kVec<T>;
  extern __shared__ float sm[];
  const int b = blockIdx.y, sp = blockIdx.x;
  const int r0 = sp * s.rows, r1 = min(s.hw, r0 + s.rows);
  const int col = threadIdx.x % s.vpr, slot = threadIdx.x / s.vpr;
  float acc[V], acc2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = acc2[i] = 0.f;
  if (slot < s.slots) {
    const T* xb = x + (long long)b * s.hw * s.c + col * V;
    for (int r = r0 + slot; r < r1; r += s.slots) {
      float v[V];
      load_vec<T>(xb + (long long)r * s.c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[i] += v[i];
        acc2[i] += v[i] * v[i];
      }
    }
  }
  reduce_slots<V>(sm, s, slot, col, acc, acc2);
  const int cpg = s.c / s.groups;
  const float* sm2 = sm + s.slots * s.c;
  for (int g = threadIdx.x; g < s.groups; g += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < cpg; ++k) {
      a += sm[g * cpg + k];
      a2 += sm2[g * cpg + k];
    }
    float* out = part + (((long long)b * s.splits + sp) * s.groups + g) * 2;
    out[0] = a;
    out[1] = a2;
  }
}

// K9 pass 2: the group statistics from the partials (CTA split 0 also
// writes them out), then y over the CTA's rows.
template <typename T, int MODE>
__global__ void gn_fwd_apply(const T* __restrict__ x, const T* __restrict__ res,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             const float* __restrict__ part,
                             T* __restrict__ y, float* __restrict__ mean_out,
                             float* __restrict__ rstd_out, Shape s, float eps) {
  constexpr int V = kVec<T>;
  extern __shared__ float sm[];
  float* s_mean = sm;
  float* s_rstd = sm + s.groups;
  const int b = blockIdx.y, sp = blockIdx.x;
  const int cpg = s.c / s.groups;
  const float n = (float)s.hw * (float)cpg;
  for (int g = threadIdx.x; g < s.groups; g += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < s.splits; ++k) {
      const float* p = part + (((long long)b * s.splits + k) * s.groups + g) * 2;
      a += p[0];
      a2 += p[1];
    }
    const float mean = a / n;
    const float var = a2 / n - mean * mean;
    const float rstd = 1.f / sqrtf(var + eps);
    s_mean[g] = mean;
    s_rstd[g] = rstd;
    if (sp == 0) {
      mean_out[(long long)b * s.groups + g] = mean;
      rstd_out[(long long)b * s.groups + g] = rstd;
    }
  }
  __syncthreads();
  const int r0 = sp * s.rows, r1 = min(s.hw, r0 + s.rows);
  const long long base = (long long)b * s.hw * s.c;
  for (int i = r0 * s.vpr + threadIdx.x; i < r1 * s.vpr; i += blockDim.x) {
    const int ch0 = (i % s.vpr) * V;
    const long long off = base + (long long)(i / s.vpr) * s.c + ch0;
    float v[V], rv[V];
    load_vec<T>(x + off, v);
    if (MODE == kAddRelu) load_vec<T>(res + off, rv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = ch0 + j, g = ch / cpg;
      float pre = pre_act<MODE>(gn_xhat(v[j], s_mean[g], s_rstd[g]), ch,
                                MODE == kAddRelu ? rv[j] : 0.f, scale, bias);
      if (MODE != kPlain) pre = pre < 0.f ? 0.f : pre;
      v[j] = pre;
    }
    store_vec<T>(y + off, v);
  }
}

// K10 pass 1: per (sample, split, channel) partial Σ dym·x̂ and Σ dym.
template <typename T, int MODE>
__global__ void gn_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                              const T* __restrict__ res,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              float* __restrict__ part_dscale,
                              float* __restrict__ part_dbias, Shape s) {
  constexpr int V = kVec<T>;
  extern __shared__ float sm[];
  const int b = blockIdx.y, sp = blockIdx.x;
  const int r0 = sp * s.rows, r1 = min(s.hw, r0 + s.rows);
  const int col = threadIdx.x % s.vpr, slot = threadIdx.x / s.vpr;
  const int cpg = s.c / s.groups;
  float acc_xh[V], acc_dy[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc_xh[i] = acc_dy[i] = 0.f;
  if (slot < s.slots) {
    float mu[V], rs[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = (col * V + j) / cpg;
      mu[j] = mean[(long long)b * s.groups + g];
      rs[j] = rstd[(long long)b * s.groups + g];
    }
    const long long base = (long long)b * s.hw * s.c + col * V;
    for (int r = r0 + slot; r < r1; r += s.slots) {
      const long long off = base + (long long)r * s.c;
      float v[V], d[V], rv[V];
      load_vec<T>(x + off, v);
      load_vec<T>(dy + off, d);
      if (MODE == kAddRelu) load_vec<T>(res + off, rv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = gn_xhat(v[j], mu[j], rs[j]);
        float dm = d[j];
        if (MODE != kPlain) {
          dm = masked_dy<MODE>(d[j], pre_act<MODE>(
              xh, col * V + j, MODE == kAddRelu ? rv[j] : 0.f, scale, bias));
        }
        acc_xh[j] += dm * xh;
        acc_dy[j] += dm;
      }
    }
  }
  reduce_slots<V>(sm, s, slot, col, acc_xh, acc_dy);
  const float* sm2 = sm + s.slots * s.c;
  const long long row = ((long long)b * s.splits + sp) * s.c;
  for (int ch = threadIdx.x; ch < s.c; ch += blockDim.x) {
    part_dscale[row + ch] = sm[ch];
    part_dbias[row + ch] = sm2[ch];
  }
}

// K10 pass 2: mean_G(g) and mean_G(g·x̂) of the CTA's sample from the
// partials (Σ g = γ·Σ dym and Σ g·x̂ = γ·Σ dym·x̂ per channel), then dx and
// dres over the CTA's rows.
template <typename T, int MODE>
__global__ void gn_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
                             const T* __restrict__ res,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             const float* __restrict__ part_dscale,
                             const float* __restrict__ part_dbias,
                             T* __restrict__ dx, T* __restrict__ dres,
                             Shape s) {
  constexpr int V = kVec<T>;
  extern __shared__ float sm[];
  float* s_m1 = sm;         // [C]: γ·Σ dym per channel, then mean_G(g)
  float* s_m2 = sm + s.c;   // [C]: γ·Σ dym·x̂, then mean_G(g·x̂)
  const int b = blockIdx.y, sp = blockIdx.x;
  const int cpg = s.c / s.groups;
  const float n = (float)s.hw * (float)cpg;
  for (int ch = threadIdx.x; ch < s.c; ch += blockDim.x) {
    float sd = 0.f, sx = 0.f;
    for (int t = 0; t < s.splits; ++t) {
      const long long at = ((long long)b * s.splits + t) * s.c + ch;
      sd += part_dbias[at];
      sx += part_dscale[at];
    }
    const float gam = __ldg(scale + ch);
    s_m1[ch] = gam * sd;
    s_m2[ch] = gam * sx;
  }
  __syncthreads();
  // each group's sums land in its first channel's slot, which only this
  // group's thread reads or writes
  for (int g = threadIdx.x; g < s.groups; g += blockDim.x) {
    float m1 = 0.f, m2 = 0.f;
    for (int k = 0; k < cpg; ++k) {
      m1 += s_m1[g * cpg + k];
      m2 += s_m2[g * cpg + k];
    }
    s_m1[g * cpg] = m1 / n;
    s_m2[g * cpg] = m2 / n;
  }
  __syncthreads();
  const int r0 = sp * s.rows, r1 = min(s.hw, r0 + s.rows);
  const long long base = (long long)b * s.hw * s.c;
  for (int i = r0 * s.vpr + threadIdx.x; i < r1 * s.vpr; i += blockDim.x) {
    const int ch0 = (i % s.vpr) * V;
    const long long off = base + (long long)(i / s.vpr) * s.c + ch0;
    float v[V], d[V], rv[V];
    load_vec<T>(x + off, v);
    load_vec<T>(dy + off, d);
    if (MODE == kAddRelu) load_vec<T>(res + off, rv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = ch0 + j, g = ch / cpg;
      const float rs = rstd[(long long)b * s.groups + g];
      const float xh = gn_xhat(v[j], mean[(long long)b * s.groups + g], rs);
      float dm = d[j];
      if (MODE != kPlain) {
        dm = masked_dy<MODE>(d[j], pre_act<MODE>(
            xh, ch, MODE == kAddRelu ? rv[j] : 0.f, scale, bias));
      }
      const float gg = dm * __ldg(scale + ch);
      d[j] = rs * (gg - s_m1[g * cpg] - xh * s_m2[g * cpg]);
      rv[j] = dm;
    }
    store_vec<T>(dx + off, d);
    if (MODE == kAddRelu) store_vec<T>(dres + off, rv);
  }
}

bool make_shape(int dtype, int mode, int b, int hw, int c, int groups,
                int splits, Shape* s, int* threads) {
  const int esize = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || mode < kPlain || mode > kAddRelu ||
      b <= 0 || b > 65535 || hw <= 0 || c <= 0 || groups <= 0 ||
      c % groups || (c * esize) % 16 || splits <= 0 || splits > hw) {
    return false;
  }
  const int vpr = c * esize / 16;
  if (vpr > kMaxVecsPerRow) return false;
  const int rows = (hw + splits - 1) / splits;
  if ((long long)(splits - 1) * rows >= hw) return false;  // an empty split
  const int t = vpr <= kMinThreads ? kMinThreads : (vpr + 31) / 32 * 32;
  *threads = t;
  *s = Shape{b, hw, c, groups, splits, rows, vpr, t / vpr};
  return true;
}

template <typename T, int MODE>
int launch_fwd(const void* x, const void* res, const float* scale,
               const float* bias, float* part, void* y, float* mean,
               float* rstd, const Shape& s, int threads, float eps,
               cudaStream_t st) {
  const dim3 grid(s.splits, s.b);
  const size_t sm1 = 2 * (size_t)s.slots * s.c * sizeof(float);
  const size_t sm2 = 2 * (size_t)s.groups * sizeof(float);
  gn_fwd_stats<T><<<grid, threads, sm1, st>>>(static_cast<const T*>(x), part,
                                              s);
  gn_fwd_apply<T, MODE><<<grid, threads, sm2, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), scale, bias, part,
      static_cast<T*>(y), mean, rstd, s, eps);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_bwd(const void* x, const void* dy, const void* res,
               const float* scale, const float* bias, const float* mean,
               const float* rstd, float* part_dscale, float* part_dbias,
               void* dx, void* dres, const Shape& s, int threads,
               cudaStream_t st) {
  const dim3 grid(s.splits, s.b);
  const size_t sm1 = 2 * (size_t)s.slots * s.c * sizeof(float);
  const size_t sm2 = 2 * (size_t)s.c * sizeof(float);
  gn_bwd_reduce<T, MODE><<<grid, threads, sm1, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), scale, bias, mean, rstd, part_dscale,
      part_dbias, s);
  gn_bwd_apply<T, MODE><<<grid, threads, sm2, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), scale, bias, mean, rstd, part_dscale,
      part_dbias, static_cast<T*>(dx), static_cast<T*>(dres), s);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_mode(int mode, const void* x, const void* res, const float* scale,
             const float* bias, float* part, void* y, float* mean,
             float* rstd, const Shape& s, int threads, float eps,
             cudaStream_t st) {
  switch (mode) {
    case kPlain:
      return launch_fwd<T, kPlain>(x, res, scale, bias, part, y, mean, rstd,
                                   s, threads, eps, st);
    case kRelu:
      return launch_fwd<T, kRelu>(x, res, scale, bias, part, y, mean, rstd,
                                  s, threads, eps, st);
    default:
      return launch_fwd<T, kAddRelu>(x, res, scale, bias, part, y, mean,
                                     rstd, s, threads, eps, st);
  }
}

template <typename T>
int bwd_mode(int mode, const void* x, const void* dy, const void* res,
             const float* scale, const float* bias, const float* mean,
             const float* rstd, float* pds, float* pdb, void* dx, void* dres,
             const Shape& s, int threads, cudaStream_t st) {
  switch (mode) {
    case kPlain:
      return launch_bwd<T, kPlain>(x, dy, res, scale, bias, mean, rstd, pds,
                                   pdb, dx, dres, s, threads, st);
    case kRelu:
      return launch_bwd<T, kRelu>(x, dy, res, scale, bias, mean, rstd, pds,
                                  pdb, dx, dres, s, threads, st);
    default:
      return launch_bwd<T, kAddRelu>(x, dy, res, scale, bias, mean, rstd,
                                     pds, pdb, dx, dres, s, threads, st);
  }
}

}  // namespace

// K9.  dtype 0 = f32, 1 = bf16; mode 0 plain, 1 relu, 2 add_relu (res
// given).  part: workspace of B·splits·G·2 floats.  y like x; mean, rstd
// [B, G] f32.
extern "C" int tpudist_group_norm_fwd(int dtype, int mode, const void* x,
                                      const void* res, const void* scale,
                                      const void* bias, void* part, void* y,
                                      void* mean, void* rstd, int b, int hw,
                                      int c, int groups, int splits,
                                      float eps, void* stream) {
  Shape s;
  int threads;
  if (!make_shape(dtype, mode, b, hw, c, groups, splits, &s, &threads) ||
      (mode == kAddRelu && res == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  auto pa = static_cast<float*>(part);
  auto mu = static_cast<float*>(mean);
  auto rs = static_cast<float*>(rstd);
  return dtype == 1
             ? fwd_mode<__nv_bfloat16>(mode, x, res, sc, bi, pa, y, mu, rs, s,
                                       threads, eps, st)
             : fwd_mode<float>(mode, x, res, sc, bi, pa, y, mu, rs, s,
                               threads, eps, st);
}

// K10.  part_dscale, part_dbias: [B·splits, C] f32 partials; dx like x;
// dres like x in add_relu mode (res given), else unused.
extern "C" int tpudist_group_norm_bwd(int dtype, int mode, const void* x,
                                      const void* dy, const void* res,
                                      const void* scale, const void* bias,
                                      const void* mean, const void* rstd,
                                      void* part_dscale, void* part_dbias,
                                      void* dx, void* dres, int b, int hw,
                                      int c, int groups, int splits,
                                      void* stream) {
  Shape s;
  int threads;
  if (!make_shape(dtype, mode, b, hw, c, groups, splits, &s, &threads) ||
      (mode == kAddRelu && (res == nullptr || dres == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  auto mu = static_cast<const float*>(mean);
  auto rs = static_cast<const float*>(rstd);
  auto pds = static_cast<float*>(part_dscale);
  auto pdb = static_cast<float*>(part_dbias);
  return dtype == 1
             ? bwd_mode<__nv_bfloat16>(mode, x, dy, res, sc, bi, mu, rs, pds,
                                       pdb, dx, dres, s, threads, st)
             : bwd_mode<float>(mode, x, dy, res, sc, bi, mu, rs, pds, pdb, dx,
                               dres, s, threads, st);
}
