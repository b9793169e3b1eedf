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
// and per-sample partials of Σ dym·x̂ and Σ dym over rows, [B, C] each,
// which the wrapper sums over B into dγ and dβ (tpudist sums its
// per-sample partials outside the kernel too).  The pre-activation is
// group_norm.cuh's, shared with the plain versions' expression.
//
// What bounds them on an H100: a few FLOPs per element against 2 bytes
// (bf16) read or written per element and tensor: memory bandwidth.  At
// ResNet50's GroupNorm sites (batch 128, 128 px) a forward call moves
// 16-200 MB, more than the 50 MB L2 at the large sites.  A design that
// reads its inputs twice moves 4/3 (K9) to 8/5 (K10) of the bytes bound
// and can reach at most 75% (62.5%) of it; the first port did, with
// small CTAs and serial reductions on top.
//
// The Pallas kernel held one sample's [H·W, C] slab in VMEM per grid step
// (hence tpudist's 2 MB switch).  Here, two paths, chosen per shape by
// the wrapper's planner (ops/group_norm.py::_gn_plan):
//
//  * cluster (one pass): a thread-block cluster of N <= 8 CTAs serves one
//    sample; CTA r holds rows [r·HW/N, (r+1)·HW/N) of x in its shared
//    memory, copied in by cp.async in four commit groups so that it sums
//    the first rows while the last ones arrive.  Each thread owns one
//    16-byte column of the rows (8 bf16 or 4 f32 channels) and every
//    slots-th row, and reads back only what it copied itself, so the
//    copies need no CTA barrier.  The CTA's per-channel sums go through a
//    fixed-order tree over its row slots; then the cluster barrier, and
//    every CTA adds all CTAs' partials from distributed shared memory in
//    rank order (K9: Σx, Σx² per group; K10: Σ dym·x̂, Σ dym per channel,
//    which rank 0 also writes out as the sample's [C] partial).  The
//    elementwise pass runs on the x it holds, so x is read from device
//    memory once.  K10 streams dy and the residual through registers in
//    its first phase and writes dres = dym there (the residual is read
//    once); its second phase reads dym back — dres, or dy masked again
//    from the held x with the same expression — from the L2, where a CTA's
//    few tens of KB stay between its two phases.  A CTA leaves only after
//    every CTA of its cluster has read its partials (split cluster
//    barrier: arrive after the reads, wait at the end).
//
//    Why K10 does not hold dy too: clusters of 8 are placed on one GPC, so
//    the card keeps few resident (measured on an H100: 45 clusters of 8
//    CTAs at 74 KB of shared memory, 15 at 141 KB and more, i.e. one CTA
//    an SM with 12 SMs idle); a CTA that holds x alone (at most 64 KB,
//    the planner's cap) leaves room for three an SM, whose loads overlap
//    each other's reductions and barriers.  For the same reason the
//    planner takes the smallest cluster whose CTAs hold at most 64 KB: a
//    cluster of one CTA for the small slabs of ResNet's later stages.
//  * two-pass, for slabs a cluster of 8 cannot hold within that cap (the
//    224 px stem; f32 at the largest sites): pass 1 over (split, sample)
//    CTAs writes per-split partials; a fold kernel adds a sample's
//    partials in split order once (K9: mean, rstd; K10: the sample's [C]
//    partials and the group means mean_G(g), mean_G(g·x̂)); pass 2 reads
//    the inputs again.  It reads its inputs twice by construction.
//
// Both paths keep each thread's per-channel constants (mean, rstd, γ, β,
// and K10's group means) in registers, and keep four 16-byte loads a
// thread in flight where they stream from device memory.  No atomics:
// every sum has a fixed order, so a second call is bitwise equal.  Both
// paths compute the statistics through group_stats and the mask through
// masked_dy, so the two paths share one expression of each.
//
// Constraints (the wrapper checks them and raises): x, dy, res contiguous
// [B, H·W, C] of one dtype, rows of at most 512 16-byte vectors (C ≤ 4096
// bf16, ≤ 2048 f32) and a multiple of 16 bytes, C a multiple of G,
// B ≤ 65535; a plan's parts (splits, or the cluster size ≤ 8) ≤ H·W.

#include "common.cuh"
#include "group_norm.cuh"
#include "hopper.cuh"

namespace {

using tpudist::from_f32;
using tpudist::gn_pre;
using tpudist::gn_xhat;
using tpudist::to_f32;
namespace sm90 = tpudist::sm90;

enum Mode { kPlain = 0, kRelu = 1, kAddRelu = 2 };
enum Path { kTwoPass = 0, kCluster = 1 };
constexpr int kMaxVecsPerRow = 512;
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // a CTA's opt-in shared memory on an H100
constexpr int kStages = 4;        // cp.async commit groups of a thread's rows
constexpr int kBatch = 4;         // 16-byte loads a thread keeps in flight

struct Shape {
  int b, hw, c, groups;
  int parts;  // CTAs a sample: the splits (two-pass) or the cluster size
  int rows;   // rows of the largest part: ceil(hw / parts)
  int vpr;    // 16-byte vectors a row
  int slots;  // rows a CTA visits at once: threads / vpr
  int tree;   // first step of the slot tree: half the power of 2 >= slots
};

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&v)[kVec<T>]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) v[i] = to_f32<T>(e[i]);
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[kVec<T>]) {
  unpack<T>(*reinterpret_cast<const uint4*>(p), v);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[kVec<T>]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// mean and rstd of a group from its sums a = Σx and a2 = Σx² over n
// elements: tpudist's variance, E[x²] − mean², and eps inside the rsqrt.
__device__ __forceinline__ void group_stats(float a, float a2, float n,
                                            float eps, float& mean,
                                            float& rstd) {
  mean = a / n;
  const float var = a2 / n - mean * mean;
  rstd = 1.f / sqrtf(var + eps);
}

// dy masked by the pre-activation in the ReLU modes (K10's mask).
template <int MODE>
__device__ __forceinline__ float masked_dy(float dy, float pre) {
  return MODE == kPlain ? dy : (pre > 0.f ? dy : 0.f);
}

// The pre-activation of one element (res: the residual's value, read only
// in add_relu mode).
template <int MODE>
__device__ __forceinline__ float pre_act(float xh, float gamma, float beta,
                                         float res) {
  float pre = gn_pre(xh, gamma, beta);
  if (MODE == kAddRelu) pre = __fadd_rn(pre, res);
  return pre;
}

// Rows [part_row(p), part_row(p + 1)) of a sample are part p's: balanced,
// none empty while parts <= hw.
__device__ __forceinline__ int part_row(const Shape& s, int p) {
  return (int)((long long)p * s.hw / s.parts);
}

// A thread's share of a part: its 16-byte column col, its row slot, the
// count nk of the part's rows it visits (r0 + slot + k·slots), the
// element offset of its first vector in [B, HW, C] and in the part's
// held rows, and the elements between its rows (in both).
struct Lane {
  int col, slot, nk;
  long long off;
  int held, step;
};

template <int V>
__device__ __forceinline__ Lane lane_of(const Shape& s, int b, int r0,
                                        int r1) {
  Lane l;
  l.col = threadIdx.x % s.vpr;
  l.slot = threadIdx.x / s.vpr;
  const int n = r1 - r0;
  l.nk = l.slot < s.slots && l.slot < n ? (n - l.slot + s.slots - 1) / s.slots
                                        : 0;
  l.off = ((long long)b * s.hw + r0 + l.slot) * s.c + l.col * V;
  l.held = l.slot * s.c + l.col * V;
  l.step = s.slots * s.c;
  return l;
}

// This thread's per-channel values of a [C] array (γ, β).
template <int V>
__device__ __forceinline__ void channel_vals(const float* __restrict__ p,
                                             int ch0, float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __ldg(p + ch0 + j);
}

// This thread's per-channel values of a [G] group array (mean, rstd, the
// group means), from shared or device memory.
template <int V>
__device__ __forceinline__ void group_vals(const float* p, int ch0, int cpg,
                                           float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = p[(ch0 + j) / cpg];
}

// Sums each thread's V per-channel values over the CTA's row slots into
// red[0 .. c): every slot stores its values, then slot i adds slot i + h
// for h halving from s.tree — one fixed order.  red holds slots·c floats;
// the caller syncs before red is written again.
template <int V>
__device__ __forceinline__ void slot_sum(float* red, const Shape& s,
                                         const Lane& l, const float (&v)[V]) {
  float4* mine = reinterpret_cast<float4*>(red + l.held);
  if (l.slot < s.slots) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      mine[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                            v[4 * i + 3]);
  }
  __syncthreads();
  for (int h = s.tree; h > 0; h >>= 1) {
    if (l.slot < h && l.slot + h < s.slots) {
      const float4* other = mine + h * s.c / 4;
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        const float4 a = mine[i], o = other[i];
        mine[i] = make_float4(a.x + o.x, a.y + o.y, a.z + o.z, a.w + o.w);
      }
    }
    __syncthreads();
  }
}

// Σ over group g's channels of per-channel sums, in channel order.
__device__ __forceinline__ float group_total(const float* sums, int g,
                                             int cpg) {
  float a = 0.f;
  for (int k = 0; k < cpg; ++k) a += sums[g * cpg + k];
  return a;
}

// Σ over the cluster's ranks CTAs, in rank order, of element i of the
// shared array p (the same place in each CTA); after cluster_sync.
__device__ __forceinline__ float rank_sum(const float* p, int i, int ranks) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = r < ranks ? sm90::cluster_ptr(p, r)[i] : 0.f;
  float a = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < ranks) a += v[r];
  return a;
}

// The end of commit group q of a thread's nk rows (kStages groups).
__device__ __forceinline__ int stage_end(int nk, int q) {
  return nk * (q + 1) / kStages;
}

// Waits until the copies of commit groups 0 .. q have landed.
__device__ __forceinline__ void wait_stage(int q) {
  if (q == 0) {
    sm90::cp_async_wait<kStages - 1>();
  } else if (q == 1) {
    sm90::cp_async_wait<kStages - 2>();
  } else if (q == 2) {
    sm90::cp_async_wait<kStages - 3>();
  } else {
    sm90::cp_async_wait<0>();
  }
}

// Copies this thread's rows of N tensors (src[i] + off + k·step, device)
// into shared memory (dst[i] + held + k·step) by cp.async, in kStages
// commit groups.
template <typename T, int N>
__device__ __forceinline__ void copy_rows(const T* const (&src)[N],
                                          T* const (&dst)[N], const Lane& l,
                                          long long gstep) {
  int k = 0;
#pragma unroll
  for (int q = 0; q < kStages; ++q) {
    for (const int e = stage_end(l.nk, q); k < e; ++k) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        sm90::cp_async16(sm90::smem_u32(dst[i] + l.held + k * l.step),
                         src[i] + l.off + k * gstep, true);
    }
    sm90::cp_async_commit();
  }
}

__host__ __device__ int red_floats(const Shape& s) {
  return (s.slots > 2 ? s.slots : 2) * s.c;
}

// ---- the cluster path ------------------------------------------------------

// K9, one pass.  Shared memory: x's rows [rows][c], red [max(slots, 2)][c],
// this CTA's Σx and Σx² by group [2][G], the sample's mean and rstd
// [2][G].  Grid (N, B), cluster (N, 1, 1).
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    gn_fwd_cluster(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   Shape s, float eps) {
  constexpr int V = kVec<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(xs + (size_t)s.rows * s.c);
  float* part = red + red_floats(s);
  float* stat = part + 2 * s.groups;
  const int rank = blockIdx.x, b = blockIdx.y, G = s.groups;
  const int cpg = s.c / G;
  const Lane l = lane_of<V>(s, b, part_row(s, rank), part_row(s, rank + 1));
  const long long gstep = (long long)s.slots * s.c;
  {
    const T* src[1] = {x};
    T* const dst[1] = {xs};
    copy_rows<T, 1>(src, dst, l, gstep);
  }
  float acc[V], acc2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
  int k = 0;
#pragma unroll
  for (int q = 0; q < kStages; ++q) {
    wait_stage(q);
    for (const int e = stage_end(l.nk, q); k < e; ++k) {
      float v[V];
      load_vec<T>(xs + l.held + k * l.step, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j] += v[j];
        acc2[j] += v[j] * v[j];
      }
    }
  }
  slot_sum<V>(red, s, l, acc);
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    part[g] = group_total(red, g, cpg);
  __syncthreads();
  slot_sum<V>(red, s, l, acc2);
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    part[G + g] = group_total(red, g, cpg);
  sm90::cluster_sync();
  const float n = (float)s.hw * (float)cpg;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float mean, rstd;
    group_stats(rank_sum(part, g, s.parts), rank_sum(part, G + g, s.parts),
                n, eps, mean, rstd);
    stat[g] = mean;
    stat[G + g] = rstd;
    if (rank == 0) {
      mean_out[(long long)b * G + g] = mean;
      rstd_out[(long long)b * G + g] = rstd;
    }
  }
  __syncthreads();
  sm90::cluster_arrive();  // this CTA has read the others' partials
  const int ch0 = l.col * V;
  float mu[V], rs[V], gam[V], bet[V];
  group_vals<V>(stat, ch0, cpg, mu);
  group_vals<V>(stat + G, ch0, cpg, rs);
  channel_vals<V>(scale, ch0, gam);
  channel_vals<V>(bias, ch0, bet);
  for (int k0 = 0; k0 < l.nk; k0 += kBatch) {
    uint4 rraw[kBatch];
    if (MODE == kAddRelu) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k0 + u < l.nk)
          rraw[u] = *reinterpret_cast<const uint4*>(res + l.off +
                                                    (k0 + u) * gstep);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u >= l.nk) break;
      float v[V], rv[V];
      load_vec<T>(xs + l.held + (k0 + u) * l.step, v);
      if (MODE == kAddRelu) unpack<T>(rraw[u], rv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float pre = pre_act<MODE>(gn_xhat(v[j], mu[j], rs[j]), gam[j], bet[j],
                                  MODE == kAddRelu ? rv[j] : 0.f);
        if (MODE != kPlain) pre = pre < 0.f ? 0.f : pre;
        v[j] = pre;
      }
      store_vec<T>(y + l.off + (k0 + u) * gstep, v);
    }
  }
  sm90::cluster_wait();
}

// K10, one pass.  Shared memory: the rows of x [rows][c], red
// [max(slots, 2)][c], this CTA's Σ dym·x̂ and Σ dym by channel [2][C], the
// group means mean_G(g), mean_G(g·x̂) [2][G].  dy (and the residual) stream
// through registers in the first phase, which writes dres = dym; the
// second reads dym back (dres, or dy masked again from the held x: the
// same expression), from the L2 where it has stayed since the first.
// Grid (N, B), cluster (N, 1, 1).
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_cluster(const T* __restrict__ x, const T* __restrict__ dy,
                   const T* __restrict__ res, const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd,
                   float* __restrict__ part_dscale,
                   float* __restrict__ part_dbias, T* __restrict__ dx,
                   T* dres, Shape s) {
  constexpr int V = kVec<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(xs + (size_t)s.rows * s.c);
  float* part = red + red_floats(s);
  float* gm = part + 2 * s.c;
  const int rank = blockIdx.x, b = blockIdx.y, G = s.groups, C = s.c;
  const int cpg = C / G;
  const Lane l = lane_of<V>(s, b, part_row(s, rank), part_row(s, rank + 1));
  const long long gstep = (long long)s.slots * C;
  {
    const T* src[1] = {x};
    T* const dst[1] = {xs};
    copy_rows<T, 1>(src, dst, l, gstep);
  }
  const int ch0 = l.col * V;
  float mu[V], rs[V], gam[V], bet[V];
  group_vals<V>(mean + (long long)b * G, ch0, cpg, mu);
  group_vals<V>(rstd + (long long)b * G, ch0, cpg, rs);
  channel_vals<V>(scale, ch0, gam);
  channel_vals<V>(bias, ch0, bet);
  float acc_xh[V], acc_dy[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc_xh[j] = acc_dy[j] = 0.f;
  int k = 0;
#pragma unroll
  for (int q = 0; q < kStages; ++q) {
    wait_stage(q);
    const int e = stage_end(l.nk, q);
    for (; k < e; k += kBatch) {
      uint4 draw[kBatch], rraw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k + u < e) {
          const long long at = l.off + (k + u) * gstep;
          draw[u] = *reinterpret_cast<const uint4*>(dy + at);
          if (MODE == kAddRelu)
            rraw[u] = *reinterpret_cast<const uint4*>(res + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k + u >= e) break;
        float v[V], d[V], rv[V];
        load_vec<T>(xs + l.held + (k + u) * l.step, v);
        unpack<T>(draw[u], d);
        if (MODE == kAddRelu) unpack<T>(rraw[u], rv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = gn_xhat(v[j], mu[j], rs[j]);
          if (MODE != kPlain) {
            d[j] = masked_dy<MODE>(d[j], pre_act<MODE>(
                xh, gam[j], bet[j], MODE == kAddRelu ? rv[j] : 0.f));
          }
          acc_xh[j] += d[j] * xh;
          acc_dy[j] += d[j];
        }
        if (MODE == kAddRelu)
          store_vec<T>(dres + l.off + (k + u) * gstep, d);
      }
    }
    k = e;  // the last batch may reach past the group's end
  }
  slot_sum<V>(red, s, l, acc_xh);
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) part[ch] = red[ch];
  __syncthreads();
  slot_sum<V>(red, s, l, acc_dy);
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) part[C + ch] = red[ch];
  sm90::cluster_sync();
  // Σ g = γ·Σ dym and Σ g·x̂ = γ·Σ dym·x̂ per channel, into red
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    const float sx = rank_sum(part, ch, s.parts);
    const float sd = rank_sum(part, C + ch, s.parts);
    if (rank == 0) {
      part_dscale[(long long)b * C + ch] = sx;
      part_dbias[(long long)b * C + ch] = sd;
    }
    const float gamma = __ldg(scale + ch);
    red[ch] = gamma * sd;
    red[C + ch] = gamma * sx;
  }
  __syncthreads();
  const float n = (float)s.hw * (float)cpg;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    gm[g] = group_total(red, g, cpg) / n;
    gm[G + g] = group_total(red + C, g, cpg) / n;
  }
  __syncthreads();
  sm90::cluster_arrive();  // this CTA has read the others' partials
  float m1[V], m2[V];
  group_vals<V>(gm, ch0, cpg, m1);
  group_vals<V>(gm + G, ch0, cpg, m2);
  // dym again: dres as written above, or dy masked again
  const T* dsrc = MODE == kAddRelu ? dres : dy;
  for (k = 0; k < l.nk; k += kBatch) {
    uint4 draw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (k + u < l.nk)
        draw[u] = *reinterpret_cast<const uint4*>(dsrc + l.off +
                                                  (k + u) * gstep);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k + u >= l.nk) break;
      float v[V], d[V];
      load_vec<T>(xs + l.held + (k + u) * l.step, v);
      unpack<T>(draw[u], d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = gn_xhat(v[j], mu[j], rs[j]);
        if (MODE == kRelu)
          d[j] = masked_dy<MODE>(d[j], pre_act<MODE>(xh, gam[j], bet[j], 0.f));
        const float gg = d[j] * gam[j];
        d[j] = rs[j] * (gg - m1[j] - xh * m2[j]);
      }
      store_vec<T>(dx + l.off + (k + u) * gstep, d);
    }
  }
  sm90::cluster_wait();
}

// ---- the two-pass path -----------------------------------------------------

// K9 pass 1: per (sample, split, group) partial Σx and Σx² into
// part[((b·splits + split)·G + g)·2 + {0, 1}].  Shared memory: red.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gn_fwd_stats(const T* __restrict__ x, float* __restrict__ part, Shape s) {
  constexpr int V = kVec<T>;
  extern __shared__ __align__(16) float red[];
  const int sp = blockIdx.x, b = blockIdx.y, G = s.groups;
  const Lane l = lane_of<V>(s, b, part_row(s, sp), part_row(s, sp + 1));
  const long long gstep = (long long)s.slots * s.c;
  float acc[V], acc2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
  for (int k0 = 0; k0 < l.nk; k0 += kBatch) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (k0 + u < l.nk)
        raw[u] = *reinterpret_cast<const uint4*>(x + l.off + (k0 + u) * gstep);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u >= l.nk) break;
      float v[V];
      unpack<T>(raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j] += v[j];
        acc2[j] += v[j] * v[j];
      }
    }
  }
  const int cpg = s.c / G;
  float* out = part + ((long long)b * s.parts + sp) * G * 2;
  slot_sum<V>(red, s, l, acc);
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    out[2 * g] = group_total(red, g, cpg);
  __syncthreads();
  slot_sum<V>(red, s, l, acc2);
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    out[2 * g + 1] = group_total(red, g, cpg);
}

// K9's fold: a sample's partials in split order -> mean, rstd [B, G].
// Grid B.
__global__ void gn_fwd_fold(const float* __restrict__ part,
                            float* __restrict__ mean_out,
                            float* __restrict__ rstd_out, Shape s,
                            float eps) {
  const int b = blockIdx.x, G = s.groups;
  const float n = (float)s.hw * (float)(s.c / G);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int sp = 0; sp < s.parts; ++sp) {
      const float* p = part + (((long long)b * s.parts + sp) * G + g) * 2;
      a += p[0];
      a2 += p[1];
    }
    group_stats(a, a2, n, eps, mean_out[(long long)b * G + g],
                rstd_out[(long long)b * G + g]);
  }
}

// K9 pass 2: y over the CTA's rows.
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    gn_fwd_apply(const T* __restrict__ x, const T* __restrict__ res,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd, T* __restrict__ y, Shape s) {
  constexpr int V = kVec<T>;
  const int sp = blockIdx.x, b = blockIdx.y, G = s.groups;
  const Lane l = lane_of<V>(s, b, part_row(s, sp), part_row(s, sp + 1));
  const long long gstep = (long long)s.slots * s.c;
  const int ch0 = l.col * V, cpg = s.c / G;
  float mu[V], rs[V], gam[V], bet[V];
  group_vals<V>(mean + (long long)b * G, ch0, cpg, mu);
  group_vals<V>(rstd + (long long)b * G, ch0, cpg, rs);
  channel_vals<V>(scale, ch0, gam);
  channel_vals<V>(bias, ch0, bet);
  for (int k0 = 0; k0 < l.nk; k0 += kBatch) {
    uint4 xraw[kBatch], rraw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u < l.nk) {
        const long long at = l.off + (k0 + u) * gstep;
        xraw[u] = *reinterpret_cast<const uint4*>(x + at);
        if (MODE == kAddRelu)
          rraw[u] = *reinterpret_cast<const uint4*>(res + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u >= l.nk) break;
      float v[V], rv[V];
      unpack<T>(xraw[u], v);
      if (MODE == kAddRelu) unpack<T>(rraw[u], rv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float pre = pre_act<MODE>(gn_xhat(v[j], mu[j], rs[j]), gam[j], bet[j],
                                  MODE == kAddRelu ? rv[j] : 0.f);
        if (MODE != kPlain) pre = pre < 0.f ? 0.f : pre;
        v[j] = pre;
      }
      store_vec<T>(y + l.off + (k0 + u) * gstep, v);
    }
  }
}

// K10 pass 1: per (sample, split, channel) partial Σ dym·x̂ and Σ dym into
// work_dscale, work_dbias [B·splits, C].  Shared memory: red.
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ res, const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  float* __restrict__ work_dscale,
                  float* __restrict__ work_dbias, Shape s) {
  constexpr int V = kVec<T>;
  extern __shared__ __align__(16) float red[];
  const int sp = blockIdx.x, b = blockIdx.y, G = s.groups;
  const Lane l = lane_of<V>(s, b, part_row(s, sp), part_row(s, sp + 1));
  const long long gstep = (long long)s.slots * s.c;
  const int ch0 = l.col * V, cpg = s.c / G;
  float mu[V], rs[V], gam[V], bet[V];
  group_vals<V>(mean + (long long)b * G, ch0, cpg, mu);
  group_vals<V>(rstd + (long long)b * G, ch0, cpg, rs);
  channel_vals<V>(scale, ch0, gam);
  channel_vals<V>(bias, ch0, bet);
  float acc_xh[V], acc_dy[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc_xh[j] = acc_dy[j] = 0.f;
  for (int k0 = 0; k0 < l.nk; k0 += kBatch) {
    uint4 xraw[kBatch], draw[kBatch], rraw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u < l.nk) {
        const long long at = l.off + (k0 + u) * gstep;
        xraw[u] = *reinterpret_cast<const uint4*>(x + at);
        draw[u] = *reinterpret_cast<const uint4*>(dy + at);
        if (MODE == kAddRelu)
          rraw[u] = *reinterpret_cast<const uint4*>(res + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u >= l.nk) break;
      float v[V], d[V], rv[V];
      unpack<T>(xraw[u], v);
      unpack<T>(draw[u], d);
      if (MODE == kAddRelu) unpack<T>(rraw[u], rv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = gn_xhat(v[j], mu[j], rs[j]);
        float dm = d[j];
        if (MODE != kPlain) {
          dm = masked_dy<MODE>(d[j], pre_act<MODE>(
              xh, gam[j], bet[j], MODE == kAddRelu ? rv[j] : 0.f));
        }
        acc_xh[j] += dm * xh;
        acc_dy[j] += dm;
      }
    }
  }
  const long long row = ((long long)b * s.parts + sp) * s.c;
  slot_sum<V>(red, s, l, acc_xh);
  for (int ch = threadIdx.x; ch < s.c; ch += blockDim.x)
    work_dscale[row + ch] = red[ch];
  __syncthreads();
  slot_sum<V>(red, s, l, acc_dy);
  for (int ch = threadIdx.x; ch < s.c; ch += blockDim.x)
    work_dbias[row + ch] = red[ch];
}

// K10's fold: a sample's partials in split order -> its [C] partials
// part_dscale, part_dbias, and the group means gm[(b·2 + {0, 1})·G + g]
// = mean_G(g), mean_G(g·x̂).  Shared memory [2][C].  Grid B.
__global__ void gn_bwd_fold(const float* __restrict__ work_dscale,
                            const float* __restrict__ work_dbias,
                            const float* __restrict__ scale,
                            float* __restrict__ part_dscale,
                            float* __restrict__ part_dbias,
                            float* __restrict__ gm, Shape s) {
  extern __shared__ __align__(16) float sums[];  // γ·Σ dym, γ·Σ dym·x̂
  const int b = blockIdx.x, C = s.c, G = s.groups, cpg = C / G;
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    float sx = 0.f, sd = 0.f;
    for (int sp = 0; sp < s.parts; ++sp) {
      const long long at = ((long long)b * s.parts + sp) * C + ch;
      sx += work_dscale[at];
      sd += work_dbias[at];
    }
    part_dscale[(long long)b * C + ch] = sx;
    part_dbias[(long long)b * C + ch] = sd;
    const float gamma = __ldg(scale + ch);
    sums[ch] = gamma * sd;
    sums[C + ch] = gamma * sx;
  }
  __syncthreads();
  const float n = (float)s.hw * (float)cpg;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    gm[((long long)b * 2) * G + g] = group_total(sums, g, cpg) / n;
    gm[((long long)b * 2 + 1) * G + g] = group_total(sums + C, g, cpg) / n;
  }
}

// K10 pass 2: dx and dres over the CTA's rows.
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
                 const T* __restrict__ res, const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd,
                 const float* __restrict__ gm, T* __restrict__ dx,
                 T* __restrict__ dres, Shape s) {
  constexpr int V = kVec<T>;
  const int sp = blockIdx.x, b = blockIdx.y, G = s.groups;
  const Lane l = lane_of<V>(s, b, part_row(s, sp), part_row(s, sp + 1));
  const long long gstep = (long long)s.slots * s.c;
  const int ch0 = l.col * V, cpg = s.c / G;
  float mu[V], rs[V], gam[V], bet[V], m1[V], m2[V];
  group_vals<V>(mean + (long long)b * G, ch0, cpg, mu);
  group_vals<V>(rstd + (long long)b * G, ch0, cpg, rs);
  group_vals<V>(gm + (long long)b * 2 * G, ch0, cpg, m1);
  group_vals<V>(gm + ((long long)b * 2 + 1) * G, ch0, cpg, m2);
  channel_vals<V>(scale, ch0, gam);
  channel_vals<V>(bias, ch0, bet);
  for (int k0 = 0; k0 < l.nk; k0 += kBatch) {
    uint4 xraw[kBatch], draw[kBatch], rraw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u < l.nk) {
        const long long at = l.off + (k0 + u) * gstep;
        xraw[u] = *reinterpret_cast<const uint4*>(x + at);
        draw[u] = *reinterpret_cast<const uint4*>(dy + at);
        if (MODE == kAddRelu)
          rraw[u] = *reinterpret_cast<const uint4*>(res + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u >= l.nk) break;
      float v[V], d[V], rv[V];
      unpack<T>(xraw[u], v);
      unpack<T>(draw[u], d);
      if (MODE == kAddRelu) unpack<T>(rraw[u], rv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = gn_xhat(v[j], mu[j], rs[j]);
        float dm = d[j];
        if (MODE != kPlain) {
          dm = masked_dy<MODE>(d[j], pre_act<MODE>(
              xh, gam[j], bet[j], MODE == kAddRelu ? rv[j] : 0.f));
        }
        const float gg = dm * gam[j];
        d[j] = rs[j] * (gg - m1[j] - xh * m2[j]);
        rv[j] = dm;
      }
      const long long at = l.off + (k0 + u) * gstep;
      store_vec<T>(dx + at, d);
      if (MODE == kAddRelu) store_vec<T>(dres + at, rv);
    }
  }
}

// ---- host side -------------------------------------------------------------

bool make_shape(int dtype, int mode, int b, int hw, int c, int groups,
                int path, int parts, int threads, Shape* s) {
  const int esize = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || mode < kPlain || mode > kAddRelu ||
      b <= 0 || b > 65535 || hw <= 0 || c <= 0 || groups <= 0 ||
      c % groups || (c * esize) % 16 || (path != kTwoPass && path != kCluster) ||
      parts <= 0 || parts > hw || (path == kCluster && parts > kMaxCluster)) {
    return false;
  }
  const int vpr = c * esize / 16;
  if (vpr > kMaxVecsPerRow || threads % 32 || threads < vpr ||
      threads > kMaxThreads) {
    return false;
  }
  const int slots = threads / vpr;
  int top = 1;
  while (top < slots) top *= 2;
  *s = Shape{b, hw, c, groups, parts, (hw + parts - 1) / parts, vpr, slots,
             top / 2};
  return true;
}

// Dynamic shared memory of the cluster path's kernel (K9 or K10).
size_t cluster_smem(const Shape& s, int esize, int backward) {
  const size_t tail = backward ? 2 * (size_t)s.c + 2 * s.groups
                               : 4 * (size_t)s.groups;
  return (size_t)s.rows * s.c * esize +
         sizeof(float) * ((size_t)red_floats(s) + tail);
}

int fold_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 256 ? t : 256;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

cudaLaunchConfig_t cluster_config(const Shape& s, int threads, size_t smem,
                                  cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.parts, s.b, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = s.parts;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One call's operands (a direction leaves the other's null).
struct Call {
  const void *x, *dy, *res;
  const float *scale, *bias;
  float *mean, *rstd;  // K9 writes them, K10 reads them
  float *work, *part_dscale, *part_dbias;
  void *out, *dres;    // y or dx; dres
  float eps;
  cudaStream_t st;
};

template <typename T, int MODE>
int launch_fwd(const Shape& s, int path, int threads, const Call& a) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = allow_smem(gn_fwd_cluster<T, MODE>);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  auto x = static_cast<const T*>(a.x);
  auto res = static_cast<const T*>(a.res);
  auto y = static_cast<T*>(a.out);
  if (path == kCluster) {
    const size_t smem = cluster_smem(s, sizeof(T), 0);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(s, threads, smem, a.st,
                                                  &attr);
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, gn_fwd_cluster<T, MODE>, x, res, a.scale,
                           a.bias, y, a.mean, a.rstd, s, a.eps);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const dim3 grid(s.parts, s.b);
  gn_fwd_stats<T><<<grid, threads, sizeof(float) * red_floats(s), a.st>>>(
      x, a.work, s);
  gn_fwd_fold<<<s.b, fold_threads(s.groups), 0, a.st>>>(a.work, a.mean,
                                                        a.rstd, s, a.eps);
  gn_fwd_apply<T, MODE><<<grid, threads, 0, a.st>>>(
      x, res, a.scale, a.bias, a.mean, a.rstd, y, s);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_bwd(const Shape& s, int path, int threads, const Call& a) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = allow_smem(gn_bwd_cluster<T, MODE>);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  auto x = static_cast<const T*>(a.x);
  auto dy = static_cast<const T*>(a.dy);
  auto res = static_cast<const T*>(a.res);
  auto dx = static_cast<T*>(a.out);
  auto dres = static_cast<T*>(a.dres);
  if (path == kCluster) {
    const size_t smem = cluster_smem(s, sizeof(T), 1);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(s, threads, smem, a.st,
                                                  &attr);
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, gn_bwd_cluster<T, MODE>, x, dy, res, a.scale, a.bias,
        (const float*)a.mean, (const float*)a.rstd, a.part_dscale,
        a.part_dbias, dx, dres, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  // work: [B·splits, C] twice, then the group means [B, 2, G]
  float* work_ds = a.work;
  float* work_db = work_ds + (size_t)s.b * s.parts * s.c;
  float* gm = work_db + (size_t)s.b * s.parts * s.c;
  const dim3 grid(s.parts, s.b);
  gn_bwd_reduce<T, MODE><<<grid, threads, sizeof(float) * red_floats(s),
                           a.st>>>(x, dy, res, a.scale, a.bias, a.mean,
                                   a.rstd, work_ds, work_db, s);
  gn_bwd_fold<<<s.b, fold_threads(s.c), 2 * sizeof(float) * s.c, a.st>>>(
      work_ds, work_db, a.scale, a.part_dscale, a.part_dbias, gm, s);
  gn_bwd_apply<T, MODE><<<grid, threads, 0, a.st>>>(
      x, dy, res, a.scale, a.bias, a.mean, a.rstd, gm, dx, dres, s);
  return (int)cudaGetLastError();
}

// The most clusters of the cluster path's kernel that fit on the card at
// once (0: the configuration cannot launch).
template <typename T, int MODE>
int fit_clusters(const Shape& s, int backward, int threads, int* clusters) {
  const size_t smem = cluster_smem(s, sizeof(T), backward);
  *clusters = 0;
  if (smem > (size_t)kMaxSmem) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(s, threads, smem, nullptr,
                                                &attr);
  cudaError_t e;
  if (backward) {
    e = allow_smem(gn_bwd_cluster<T, MODE>);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(clusters, gn_bwd_cluster<T, MODE>,
                                         &cfg);
  } else {
    e = allow_smem(gn_fwd_cluster<T, MODE>);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(clusters, gn_fwd_cluster<T, MODE>,
                                         &cfg);
  }
  return (int)e;
}

// Runs op.run<T, MODE>() for the call's dtype and mode.
template <typename Op>
int dispatch(int dtype, int mode, Op op) {
  if (dtype == 1) {
    switch (mode) {
      case kPlain: return op.template run<__nv_bfloat16, kPlain>();
      case kRelu: return op.template run<__nv_bfloat16, kRelu>();
      default: return op.template run<__nv_bfloat16, kAddRelu>();
    }
  }
  switch (mode) {
    case kPlain: return op.template run<float, kPlain>();
    case kRelu: return op.template run<float, kRelu>();
    default: return op.template run<float, kAddRelu>();
  }
}

struct FwdOp {
  const Shape& s;
  int path, threads;
  const Call& a;
  template <typename T, int MODE>
  int run() const { return launch_fwd<T, MODE>(s, path, threads, a); }
};
struct BwdOp {
  const Shape& s;
  int path, threads;
  const Call& a;
  template <typename T, int MODE>
  int run() const { return launch_bwd<T, MODE>(s, path, threads, a); }
};
struct FitOp {
  const Shape& s;
  int backward, threads;
  int* clusters;
  template <typename T, int MODE>
  int run() const {
    return fit_clusters<T, MODE>(s, backward, threads, clusters);
  }
};

}  // namespace

// K9.  dtype 0 = f32, 1 = bf16; mode 0 plain, 1 relu, 2 add_relu (res
// given); path 0 two-pass (parts = splits; work: B·splits·G·2 floats), 1
// cluster (parts = the cluster size; work unused).  y like x; mean, rstd
// [B, G] f32.
extern "C" int tpudist_group_norm_fwd(int dtype, int mode, const void* x,
                                      const void* res, const void* scale,
                                      const void* bias, void* work, void* y,
                                      void* mean, void* rstd, int b, int hw,
                                      int c, int groups, int path, int parts,
                                      int threads, float eps, void* stream) {
  Shape s;
  if (!make_shape(dtype, mode, b, hw, c, groups, path, parts, threads, &s) ||
      (mode == kAddRelu && res == nullptr) ||
      (path == kTwoPass && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Call a{x, nullptr, res, static_cast<const float*>(scale),
               static_cast<const float*>(bias), static_cast<float*>(mean),
               static_cast<float*>(rstd), static_cast<float*>(work), nullptr,
               nullptr, y, nullptr, eps, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, mode, FwdOp{s, path, threads, a});
}

// K10.  part_dscale, part_dbias: the per-sample partials, [B, C] f32; dx
// like x; dres like x in add_relu mode (res given), else unused; work
// (two-pass only): 2·B·splits·C + 2·B·G floats.
extern "C" int tpudist_group_norm_bwd(int dtype, int mode, const void* x,
                                      const void* dy, const void* res,
                                      const void* scale, const void* bias,
                                      const void* mean, const void* rstd,
                                      void* work, void* part_dscale,
                                      void* part_dbias, void* dx, void* dres,
                                      int b, int hw, int c, int groups,
                                      int path, int parts, int threads,
                                      void* stream) {
  Shape s;
  if (!make_shape(dtype, mode, b, hw, c, groups, path, parts, threads, &s) ||
      (mode == kAddRelu && (res == nullptr || dres == nullptr)) ||
      (path == kTwoPass && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Call a{x,
               dy,
               res,
               static_cast<const float*>(scale),
               static_cast<const float*>(bias),
               const_cast<float*>(static_cast<const float*>(mean)),
               const_cast<float*>(static_cast<const float*>(rstd)),
               static_cast<float*>(work),
               static_cast<float*>(part_dscale),
               static_cast<float*>(part_dbias),
               dx,
               dres,
               0.f,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, mode, BwdOp{s, path, threads, a});
}

// The cluster path's plan check: *smem the dynamic shared memory its
// kernel takes (K9, or K10 with backward = 1) for a cluster of `parts`
// CTAs of `threads`, *clusters how many such clusters fit on the card at
// once (0: it cannot launch).
extern "C" int tpudist_group_norm_cluster_fit(int dtype, int mode,
                                              int backward, int hw, int c,
                                              int groups, int parts,
                                              int threads, int* smem,
                                              int* clusters) {
  Shape s;
  if (!make_shape(dtype, mode, 1, hw, c, groups, kCluster, parts, threads,
                  &s)) {
    return (int)cudaErrorInvalidValue;
  }
  *smem = (int)cluster_smem(s, dtype == 1 ? 2 : 4, backward);
  return dispatch(dtype, mode, FitOp{s, backward, threads, clusters});
}
