// Pieces the flash-attention kernels share (flash_attention.cu: K1;
// flash_attention_bwd.cu: K3, K8, K4): warpgroups of 128 threads, tiles
// streamed by cp.async into wgmma's swizzled layouts (bf16) or padded rows
// (f32), the SFU exponential, f32 FMA products on the accumulator layout,
// and the f32 partials a split walk writes.
#pragma once

#include "hopper.cuh"

namespace tpudist {
namespace flash {

using sm90::cp_async16;
using sm90::smem_u32;
using sm90::SwTile;

constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// f32 tiles: rows of D + 4 floats (the FMA products read row-per-lane
// without bank conflicts); 16-byte chunk c of row r at r * (D + 4) * 4 +
// c * 16.
template <int ROWS, int D>
struct PadTile {
  static constexpr int kLd = D + 4;
  static constexpr int kBytes = ROWS * kLd * 4;
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    return r * kLd * 4 + c * 16;
  }
};

template <typename T, int ROWS, int D>
using TileOf = typename std::conditional<std::is_same<T, float>::value,
                                         PadTile<ROWS, D>,
                                         SwTile<ROWS, D>>::type;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Start the copy of rows row0 .. row0 + ROWS - 1 of a [*, D] matrix (row r
// at src + r * stride elements) into a tile, by the CTA's NTH threads;
// rows at or past `limit` are zero-filled.  The caller commits the group.
template <typename T, int ROWS, int D, int NTH = kThreads>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* src,
                                          long long stride, int row0,
                                          int limit) {
  using L = TileOf<T, ROWS, D>;
  constexpr int kVec = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int kPer = 16 / (int)sizeof(T);
  const uint32_t base = smem_u32(dst);
  for (int i = threadIdx.x; i < ROWS * kVec; i += NTH) {
    const int r = i / kVec, c = i % kVec;
    const bool ok = row0 + r < limit;
    cp_async16(base + L::offset(r, c),
               src + (ok ? (long long)(row0 + r) * stride : 0) + c * kPer,
               ok);
  }
}

// 2^x on the SFU (ex2.approx, relative error ~2^-22; flushes results
// below 2^-126 to 0; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The CTAs an SM must hold (a register cap for ptxas): N for bf16 at D <=
// 64, none otherwise.
template <typename T, int D, int N>
struct MinCtas {
  static constexpr int value =
      !std::is_same<T, float>::value && D <= 64 ? N : 1;
};

// f32: acc (this warp's 16 rows x D, accumulator layout) += X·Y with X
// staged in shared memory (row stride xld, KN columns) and Y a PadTile of
// KN rows.
template <int KN, int D>
__device__ __forceinline__ void acc_xy_f32(float (&acc)[D / 2],
                                           const float* xs, int xld,
                                           const float* y, int r0, int t4) {
  constexpr int ld = D + 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t4 * 2;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int kk = 0; kk < KN; ++kk) {
      const float p0 = xs[r0 * xld + kk], p1 = xs[(r0 + 8) * xld + kk];
      const float y0 = y[kk * ld + c], y1 = y[kk * ld + c + 1];
      a0 = fmaf(p0, y0, a0);
      a1 = fmaf(p0, y1, a1);
      a2 = fmaf(p1, y0, a2);
      a3 = fmaf(p1, y1, a3);
    }
    acc[4 * n] += a0;
    acc[4 * n + 1] += a1;
    acc[4 * n + 2] += a2;
    acc[4 * n + 3] += a3;
  }
}

// f32: stage this thread's accumulator-layout values of x (NT 8-column
// groups) into rows r0, r0 + 8 of xs (row stride xld).
template <int NT>
__device__ __forceinline__ void stage_f32(float* xs, int xld,
                                          const float (&x)[NT * 4], int r0,
                                          int t4) {
#pragma unroll
  for (int j = 0; j < NT * 4; ++j)
    xs[((j & 3) < 2 ? r0 : r0 + 8) * xld + (j >> 2) * 8 + t4 * 2 + (j & 1)] =
        x[j];
}

// A 64-row accumulator tile as an unscaled f32 partial of a [*, D]
// contiguous workspace slice (rows row0 + r below `limit`).
template <int D>
__device__ __forceinline__ void store_part(float* base,
                                           const float (&acc)[D / 2],
                                           int row0, int limit, int r0,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int r = row0 + ((j & 3) < 2 ? r0 : r0 + 8);
    if (r < limit)
      *reinterpret_cast<float2*>(base + (long long)r * D + (j >> 2) * 8 +
                                 t4 * 2) = make_float2(acc[j], acc[j + 1]);
  }
}

}  // namespace flash
}  // namespace tpudist
