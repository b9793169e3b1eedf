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
// bound by the bytes of live K/V (3.35 TB/s), not by arithmetic: the
// tensor cores would buy nothing.  The Pallas kernel streamed each (batch,
// KV head) row sequentially on one TensorCore (grid (B*Hkv, blocks)); on
// Hopper that grid (B*Hkv = 8 blocks at the serve shapes) would leave 124
// of 132 SMs idle.  So this is a split-K (flash-decoding) grid: block
// (split, b*Hkv + hk) takes `ck` consecutive keys of row b's cache (a
// launch argument, a multiple of 16 up to 256; the wrappers in
// ops/flash_decode.py take 128, measured against 32, 64 and 256 at the
// port's shapes) and writes its partial (max, sum, unnormalized
// output) for the g = H/Hkv query heads of that KV head, so each KV
// head's cache streams once for the whole group.  Chunks past
// cache_len[b] (or before the window) exit at once and read nothing, not
// even the page table.  The side buffer's live positions are more splits
// of ck keys.
//
// The split pass (decode_partial_kernel), four warps a CTA:
//  * Bytes in flight.  Every live key's K row, then every V row, is
//    copied into shared memory by 16-byte cp.async.cg, K (with K6's
//    scales) and V in two commit groups issued back to back, so a CTA
//    has its whole chunk (32 KB at ck = 128, bf16, D = 64) in flight at
//    once; q loads beside them.  The CTA waits for K only, scores and
//    takes the softmax while V lands, then waits for V.  (Four K and V
//    groups, each scored as it landed, measured slower: the card serves
//    every CTA's copies together, so the last group lands with the rest;
//    scripts/kernel_variants.py decode.)  Rows are dense, every one
//    16-byte aligned.  No swizzle is needed: both passes read whole rows,
//    a warp's 32 lanes covering 32 consecutive 16-byte chunks (512
//    contiguous bytes, one bank-conflict-free wavefront each 128 bytes),
//    as the copies write them.
//  * Keys over lanes.  A key's row is split over D*sizeof(KV)/16 lanes
//    (8 at bf16 D = 64; 4 for int8), 16 bytes each; a warp step takes
//    32 / lanes keys, and the warps take the chunk's steps in turn.  Each
//    lane forms partial dot products for a tile of kHeadTile query heads
//    from q held in registers, and the row's lanes reduce-scatter them
//    (each shuffle round halves the heads a lane holds, then plain rounds
//    add the rest: 4 shuffles a step at bf16 D = 64, g = 4, not 12): the
//    dependent chain is 16/sizeof(KV) FMAs plus log2(lanes) shuffles,
//    not g·D FMAs.  The group is padded to whole head tiles in shared
//    memory, so the hot loops carry no head guard.
//  * P·V.  Each lane accumulates its own 16/sizeof(KV) columns for the
//    head tile over its warp's keys in registers; a shuffle tree sums the
//    warp's keys, and the warps' sums are added in warp order through
//    shared memory.  No atomics anywhere: two calls agree bit for bit.
//
// The merge (decode_merge_kernel) combines the partials by log-sum-exp,
// which also yields return_lse.  At the serve shapes a row has tens of
// splits and the grid only B*Hkv = 8 (row, KV head) pairs, so the merge
// runs one warp per (batch row, query head), B*H warps, each a CTA of its
// own (four a CTA measured slower at the serve shape: scripts/
// kernel_variants.py decode): the lanes read the splits' maxima and sums,
// M and L come from shuffle reductions in a fixed tree order, the weights
// exp(m_i - M) of the live splits go to shared memory in split order (a
// ballot compacts them), and then each lane sums w_i * acc_i over the
// live splits, in split order, for its columns of D.  Splits with m_i =
// -inf (dead chunks, which write no acc) are skipped.
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
// chunk's live keys cover into shared memory (bs need not divide ck),
// then copy each key's contiguous Hkv*D row with the same cp.async.
// Split boundaries (the planner sees S = M * bs, K2's S over the gathered
// view) and accumulation order are K2's, so K5 over a pool gives
// bit-identical output to K2 over the gathered view (paged_gather_kv).
//
// K6 keeps the Pallas int8 numerics: q rounded to bf16, s = (q·k_int8) ·
// (k_scale · D^-1/2) with f32 accumulation, p = exp(s - m), the value
// product over round_bf16(p · v_scale) while l sums the unscaled p.
//
// Not ported (TPU layout tricks): head pairing to fill 128 lanes, 8-row
// sublane padding of the group, the packed-cache relayout avoidance.

#include "hopper.cuh"

namespace {

using tpudist::round_to;
using tpudist::to_f32;
using tpudist::sm90::cp_async16;
using tpudist::sm90::cp_async4;
using tpudist::sm90::cp_async_commit;
using tpudist::sm90::cp_async_wait;
using tpudist::sm90::smem_u32;

constexpr int kThreads = 128;                // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 32;                // query heads per KV head
constexpr int kHeadTile = 4;                 // query heads a pass holds
constexpr int kMaxSplitKeys = 256;           // keys a split, at most
constexpr int kMaxPages = kMaxSplitKeys / 8 + 1;  // pages a split covers
constexpr int kMaxSmem = 227 * 1024;

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
  int ck;               // keys a split
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

// A key's row: kBytes, split over kLanes lanes of 16 bytes (kElems
// elements each); a warp step takes kKeys keys.
template <typename KV, int D>
struct Rows {
  static constexpr int kBytes = D * (int)sizeof(KV);
  static constexpr int kLanes = kBytes / 16;
  static constexpr int kKeys = 32 / kLanes;
  static constexpr int kElems = 16 / (int)sizeof(KV);
  // shared memory: K and V tiles, q [gp, D], scores [gp, ck] (gp: g
  // rounded up to whole head tiles, so the hot loops need no head
  // guard), the warps' P·V sums [kWarps, kHeadTile, D], K6's scales [2,
  // ck], K5's pool blocks [kMaxPages] (all dynamic: a static array beside
  // the 227 KB dynamic limit would exceed the block's maximum)
  static size_t smem(int g, int ck) {
    const int gp = (g + kHeadTile - 1) / kHeadTile * kHeadTile;
    return (size_t)2 * ck * kBytes +
           (size_t)4 * (gp * D + gp * ck + kWarps * kHeadTile * D + 2 * ck +
                        kMaxPages);
  }
};

// 16 bytes of a row as f32: 4 floats, 8 bf16 or 16 int8
template <typename KV>
__device__ __forceinline__ void unpack(const uint4& x, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& x, float* f) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& x,
                                                      float* f) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& x, float* f) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * i + k] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * k)));
}

// Issue the cp.async copies of the chunk's keys lo + r, r < n, into
// dense shared rows at dst: key p's row at src + p * ss, or, with
// blk (K5), at pool block blk[p / bs - first], row p % bs (src + block *
// sb + row * ss).  Thread t copies bytes [16c, 16c + 16), c = t % kLanes,
// of every (kThreads / kLanes)-th row.
template <typename KV, int D>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const KV* src,
                                          long long sb, long long ss,
                                          const int* blk, int lo, int first,
                                          int n, int bs) {
  using R = Rows<KV, D>;
  constexpr int kStep = kThreads / R::kLanes;  // rows a pass of the CTA
  const int c = threadIdx.x % R::kLanes;
  int r = threadIdx.x / R::kLanes;
  uint32_t d = smem_u32(dst + r * R::kBytes + c * 16);
  src += c * R::kElems;
  if (blk) {
    for (; r < n; r += kStep, d += kStep * R::kBytes) {
      const int p = lo + r;
      cp_async16(d,
                 src + (long long)blk[p / bs - first] * sb +
                     (long long)(p % bs) * ss,
                 true);
    }
  } else {
    src += (long long)(lo + r) * ss;
    for (; r < n; r += kStep, d += kStep * R::kBytes, src += kStep * ss)
      cp_async16(d, src, true);
  }
}

// The partial dot products v[0 .. kHeadTile) of one key's LPK lanes (lane
// c of the row) summed over the row: while a lane holds more than one
// head, each shuffle round halves its heads (the upper half of the lanes
// keeps the upper heads, taking the partner's), then plain rounds add the
// rest.  Returns the first head the lane's v[0 ..) now holds the totals
// of: kHeadTile / LPK heads each (one, if LPK >= kHeadTile).
template <int LPK>
__device__ __forceinline__ int reduce_heads(float* v, int c) {
  int base = 0;
#pragma unroll
  for (int off = LPK / 2, width = kHeadTile; off > 0; off >>= 1) {
    if (width > 1) {
      const int half = width / 2;
      const bool upper = (c & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      base += upper ? half : 0;
      width = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
  return base;
}

// T: the query and output type; KV: the cache type (T, or int8_t in kInt8)
template <typename T, typename KV, int D, int kMode>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const DecArgs a) {
  using R = Rows<KV, D>;
  constexpr int E = R::kElems, LPK = R::kLanes, KPS = R::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = a.H / a.Hkv, ck = a.ck;
  const int gp = (g + kHeadTile - 1) / kHeadTile * kHeadTile;
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + (size_t)ck * R::kBytes;
  float* qs = reinterpret_cast<float*>(Vs + (size_t)ck * R::kBytes);
  float* sc = qs + gp * D;                      // [gp, ck]
  float* red = sc + gp * ck;                    // [kWarps, kHeadTile, D]
  float* ksc = red + kWarps * kHeadTile * D;    // K6: [ck] each
  float* vsc = ksc + ck;
  int* blk_s = reinterpret_cast<int*>(vsc + ck);  // K5: a page's pool block

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
    lo = split * ck;
    hi = min(lo + ck, min(len, a.S));
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
    lo = (split - a.n_main) * ck;
    hi = min(lo + ck, min(sl, a.cap));
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
  const bool paged = kMode == kPaged && main_split;
  const int first = paged ? lo / a.bs : 0;  // K5: the chunk's first page
  if (paged) {
    // one entry per page of the live keys: p < hi <= cache_len[b]
    const int pages = (hi - 1) / a.bs - first + 1;
    for (int i = tid; i < pages; i += kThreads)
      blk_s[i] = a.table[(long long)b * a.M + first + i];
    __syncthreads();
  }

  // the copies: K (and K6's scales), then V, two groups issued at once
  const int* blk = paged ? blk_s : nullptr;
  copy_rows<KV, D>(Ks, kb, a.k_sb, kss, blk, lo, first, n, a.bs);
  if constexpr (kMode == kInt8) {
    // both scales ride with K: the softmax folds the V scale into p
    for (int r = tid; r < n; r += kThreads) {
      const long long p = lo + r;
      cp_async4(smem_u32(ksc + r),
                a.k_scale + b * a.ks_sb + p * a.ks_ss + hk * a.ks_sh, true);
      cp_async4(smem_u32(vsc + r),
                a.v_scale + b * a.vs_sb + p * a.vs_ss + hk * a.vs_sh, true);
    }
  }
  cp_async_commit();
  copy_rows<KV, D>(Vs, vb, a.v_sb, vss, blk, lo, first, n, a.bs);
  cp_async_commit();

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + (hk * g) * a.q_sh;
  for (int i = tid; i < gp * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float x = r < g ? to_f32<T>(qb[r * a.q_sh + d]) : 0.f;
    // K6 rounds q to bf16, as the Pallas int8 path does
    qs[i] = kMode == kInt8 ? round_to<__nv_bfloat16>(x) : x;
  }
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();

  // scores: lane (kk, c) takes bytes [16c, 16c + 16) of key j0 + kk, its
  // warp the steps j0 = (warp + kWarps * i) * KPS
  const int c = lane % LPK, kk = lane / LPK;
  for (int h0 = 0; h0 < g; h0 += kHeadTile) {
    float qr[kHeadTile][E];
#pragma unroll
    for (int t = 0; t < kHeadTile; ++t) {
      const float4* q4 =
          reinterpret_cast<const float4*>(qs + (h0 + t) * D + c * E);
#pragma unroll
      for (int e = 0; e < E / 4; ++e) {
        const float4 x = q4[e];
        qr[t][4 * e] = x.x;
        qr[t][4 * e + 1] = x.y;
        qr[t][4 * e + 2] = x.z;
        qr[t][4 * e + 3] = x.w;
      }
    }
#pragma unroll 2
    for (int j0 = warp * KPS; j0 < n; j0 += kWarps * KPS) {
      const int j = j0 + kk;
      float kf[E];
      unpack<KV>(j < n ? *reinterpret_cast<const uint4*>(
                             Ks + j * R::kBytes + c * 16)
                       : make_uint4(0u, 0u, 0u, 0u),
                 kf);
      float dot[kHeadTile];
#pragma unroll
      for (int t = 0; t < kHeadTile; ++t) {
        dot[t] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot[t] = fmaf(qr[t][e], kf[e], dot[t]);
      }
      // the row's lanes reduce-scatter the heads, then sum what is left:
      // lane c ends with the totals of heads h0 + hb .. h0 + hb + kHeld,
      // and kDup lanes of a row hold the same ones
      const int hb = reduce_heads<LPK>(dot, c);
      constexpr int kHeld = LPK >= kHeadTile ? 1 : kHeadTile / LPK;
      constexpr int kDup = LPK >= kHeadTile ? LPK / kHeadTile : 1;
      if (c % kDup == 0 && j < n) {
        const float ks = kMode == kInt8 ? ksc[j] * a.scale : a.scale;
#pragma unroll
        for (int t = 0; t < kHeld; ++t)
          sc[(h0 + hb + t) * ck + j] = dot[t] * ks;
      }
    }
  }
  __syncthreads();

  // per query row: max, exp, sum (one warp per row) while V lands
  for (int r = warp; r < g; r += kWarps) {
    float* sr = sc + r * ck;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sr[j] - mx);
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

  cp_async_wait<0>();  // this thread's V copies have landed
  __syncthreads();

  // unnormalized output: lane (kk, c) sums p[h, j] * v[j, its E columns]
  // over its warp's keys, then the lanes of a column and the warps add up
  for (int h0 = 0; h0 < g; h0 += kHeadTile) {
    float acc[kHeadTile][E];
#pragma unroll
    for (int t = 0; t < kHeadTile; ++t)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[t][e] = 0.f;
#pragma unroll 2
    for (int j0 = warp * KPS; j0 < n; j0 += kWarps * KPS) {
      const int j = j0 + kk;
      if (j < n) {
        float vf[E];
        unpack<KV>(
            *reinterpret_cast<const uint4*>(Vs + j * R::kBytes + c * 16), vf);
#pragma unroll
        for (int t = 0; t < kHeadTile; ++t) {
          const float p = sc[(h0 + t) * ck + j];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[t][e] = fmaf(p, vf[e], acc[t][e]);
        }
      }
    }
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
      for (int t = 0; t < kHeadTile; ++t)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[t][e] += __shfl_xor_sync(0xffffffffu, acc[t][e], off);
    if (kk == 0) {
#pragma unroll
      for (int t = 0; t < kHeadTile; ++t) {
        float4* o4 = reinterpret_cast<float4*>(
            red + (warp * kHeadTile + t) * D + c * E);
#pragma unroll
        for (int e = 0; e < E / 4; ++e)
          o4[e] = make_float4(acc[t][4 * e], acc[t][4 * e + 1],
                              acc[t][4 * e + 2], acc[t][4 * e + 3]);
      }
    }
    __syncthreads();
    for (int i = tid; i < kHeadTile * D; i += kThreads) {
      const int t = i / D;
      if (h0 + t < g) {
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) o += red[w * kHeadTile * D + i];
        a.acc_part[(pidx * g + h0 + t) * D + i % D] = o;
      }
    }
    if (h0 + kHeadTile < g) __syncthreads();  // red is written again
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
  const int g = a.H / a.Hkv;
  const size_t bytes = Rows<KV, D>::smem(g, a.ck);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  // the merge's weights and split indices
  const size_t merge_bytes = (size_t)a.n_split * 8;
  static bool configured = false;
  if (!configured) {  // once, before any graph capture
    cudaError_t e = cudaFuncSetAttribute(
        decode_partial_kernel<T, KV, D, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(decode_merge_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
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
  if (a.H % a.Hkv != 0 || a.H / a.Hkv > kMaxGroup || a.ck < 16 ||
      a.ck > kMaxSplitKeys || a.ck % 16 != 0)
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
    int split_keys, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long sk_sb, long long sk_ss, long long sk_sh,
    long long sv_sb, long long sv_ss, long long sv_sh,
    long long o_sb, long long o_sh,
    const int* len_ptr, int len_stride, int len_val,
    const int* side_len_ptr, int side_len_val, const int* off_ptr,
    int off_val, int window, float scale, void* stream) {
  DecArgs a{q, k, v, side_k, side_v, m_part, l_part, acc_part,
            B, H, Hkv, S, cap, n_main, n_split, split_keys,
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
    int n_split, int split_keys, long long q_sb, long long q_sh,
    long long k_sn, long long k_ss, long long k_sh,
    long long v_sn, long long v_ss, long long v_sh,
    long long sk_sb, long long sk_ss, long long sk_sh,
    long long sv_sb, long long sv_ss, long long sv_sh,
    long long o_sb, long long o_sh, const int* len_ptr,
    const int* side_len_ptr, int side_len_val, float scale, void* stream) {
  DecArgs a{q, k_pool, v_pool, side_k, side_v, m_part, l_part, acc_part,
            B, H, Hkv, M * bs, cap, n_main, n_split, split_keys,
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
    int B, int H, int Hkv, int D, int S, int n_split, int split_keys,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long ks_sb, long long ks_ss, long long ks_sh,
    long long vs_sb, long long vs_ss, long long vs_sh,
    long long o_sb, long long o_sh,
    const int* len_ptr, int len_stride, int len_val, const int* off_ptr,
    int off_val, int window, float scale, void* stream) {
  DecArgs a{q, k, v, nullptr, nullptr, m_part, l_part, acc_part,
            B, H, Hkv, S, 0, n_split, n_split, split_keys,
            q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            0, 0, 0, 0, 0, 0,
            len_ptr, len_stride, len_val, nullptr, 0, off_ptr, off_val,
            window, scale,
            nullptr, 0, 0, k_scale, v_scale,
            ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh};
  return run<kInt8>(dtype, D, a, out, lse, o_sb, o_sh, stream);
}
