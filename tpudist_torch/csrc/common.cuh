// Shared helpers of the port's kernels (tpudist_torch/csrc).
//
// Each .cu file builds into its own shared library with a plain C
// interface (tpudist_torch/ops/_cuda.py); every entry point returns the
// launch's cudaGetLastError() as an int, 0 on success.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Masked scores are -inf; the running max is floored at this value so a
// row with no live key yet never computes (-inf) - (-inf).
#define TPUDIST_NEG_BIG (-1e30f)

extern "C" const char* tpudist_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace tpudist {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the kernels cast probabilities to the value
// dtype before the P·V product, as the Pallas kernels do.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// One m16n8k16 bf16 tensor-core product with f32 accumulation, c += a·b.
// Fragment layouts (g = lane / 4, t4 = lane % 4): A row-major 16x16, a[0]
// row g cols 2t4..+1, a[1] row g+8, a[2] row g cols 2t4+8..+9, a[3] row g+8
// cols 2t4+8..+9; B col-major 16x8, b[0] rows 2t4..+1 col g, b[1] rows
// 2t4+8..+9; C 16x8, c[0..1] row g cols 2t4..+1, c[2..3] row g+8.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of `cols` elements (cols * sizeof(T) a multiple of 16
// bytes) from global memory, row r at src + (row0 + r) * stride, into
// shared memory rows of `ld_words` 32-bit words; rows at or past `limit`
// are zero-filled.  16-byte global loads, 32-bit shared stores (so the
// shared row stride may be odd in words, which keeps row-per-lane reads
// free of bank conflicts).
template <typename T>
__device__ __forceinline__ void load_rows(uint32_t* dst, int ld_words,
                                          const T* src, long long stride,
                                          int row0, int limit, int rows,
                                          int cols) {
  const int vpr = cols * (int)sizeof(T) / 16;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = i % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * stride + c * (16 / (int)sizeof(T)));
    }
    uint32_t* d = dst + r * ld_words + c * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

}  // namespace tpudist
