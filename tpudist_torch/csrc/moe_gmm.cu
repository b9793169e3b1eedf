// K7: the fused MoE grouped GEMM for Hopper (sm_90a).
//
// Replaces tpudist/ops/moe_dispatch.py::_gmm_kernel (Pallas, B8).  Input
// rows are the MoE layer's (token, choice) slots sorted by expert, each
// expert's group padded to a multiple of `block_rows`, so every block of
// `block_rows` rows belongs to one expert, block_expert[b].  For each row:
//
//   y = (round_T(gelu_tanh(xs @ w_up[e]) in f32) @ w_down[e]) * gate
//
// in f32, cast to T: the Pallas kernel's rounding points (h rounded to the
// input dtype between the two products, the gate multiplied on the f32
// accumulator).  Pad slots carry gate 0.
//
// What bounds it on an H100: at the training shape (32,768 live slots,
// d = 512, f = 2048, 8 experts) it does 4·N·d·f = 137 GFLOP against
// ~100 MB of rows and weights, far above the card's ~295 FLOP/byte ridge:
// bound by tensor-core operations (0.139 ms at 989 TFLOP/s).
//
// What the Pallas grid did, and what this does instead:
//  * one grid step per [block_rows, d] block with the whole [bn, f]
//    intermediate in VMEM -> the intermediate does not fit an SM (128 x
//    2048 bf16 is 512 KB against 227 KB of shared memory), so one CTA
//    takes a row tile of one expert, stages its rows once, and loops over
//    f in chunks of FC columns: h_c = gelu(xs_tile @ w_up[e][:, c]) in f32,
//    rounded to T into shared memory, then y += h_c @ w_down[e][c, :] into
//    an f32 accumulator over the whole d, kept in registers.  The
//    intermediate never goes to global memory;
//  * scalar-prefetched block_expert + index maps -> each CTA reads its
//    tile's expert id and offsets its weight pointers;
//  * tiles never span two experts: the row tile is 64 rows when
//    block_rows is a multiple of 64 (16 warps: 4 along rows x 4 along d,
//    each warp a 16 x 128 slice of y = 64 f32 registers a thread), else
//    16 rows (4 warps), or 8 live rows of a 16-row tile for block_rows a
//    multiple of 8 only.  All three divide block_rows.
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulate); f32
// runs exact FMAs on the same register layout (no TF32).  Tiles are loaded
// synchronously.  Not yet done (later work): cp.async/TMA double
// buffering, wgmma, ldmatrix, skipping pad-only tiles.
//
// Constraints (the wrapper checks them and raises): d a multiple of 16 up
// to 512 (4 warps x 128 columns of accumulator), f a multiple of 16,
// block_rows a multiple of 8, np_pad a multiple of block_rows.

#include "common.cuh"

namespace {

using tpudist::from_f32;
using tpudist::mma_bf16_16816;
using tpudist::pack_bf16;
using tpudist::pack_bf16_raw;

constexpr int kWarpsN = 4;                    // warps along d
constexpr int kMaxD = 512;
constexpr int kColsPerWarp = kMaxD / kWarpsN;  // 128
constexpr int kNT2 = kColsPerWarp / 8;         // y n-tiles per warp
constexpr int kPadWords = 4;                   // shared row padding

struct GmmArgs {
  const void* xs;           // [np_pad, d] T
  const float* gate;        // [np_pad] f32
  const void* w_up;         // [e, d, f] T
  const void* w_down;       // [e, f, d] T
  const int* block_expert;  // [np_pad / block_rows]
  void* ys;                 // [np_pad, d] T
  int np_pad, d, f, e, block_rows;
  int tile_rows;            // live rows of one CTA's tile
};

template <typename T, int WARPS_M, int FC>
struct Layout {
  static constexpr int kTileM = 16 * WARPS_M;
  static constexpr int kThreads = 32 * WARPS_M * kWarpsN;
  static constexpr int kNT1 = FC / (8 * kWarpsN);  // h n-tiles per warp
  // shared row stride of a chunk in 32-bit words (padding keeps the
  // fragment reads of 8 rows on distinct banks)
  static constexpr int kLdF = FC * (int)sizeof(T) / 4 + kPadWords;
  __host__ __device__ static int ld_d(int d) {
    return d * (int)sizeof(T) / 4 + kPadWords;
  }
  // xs tile [kTileM][ld_d] + w_up chunk [d][kLdF] + w_down chunk
  // [FC][ld_d] + h chunk [kTileM][kLdF]
  __host__ static size_t smem_bytes(int d) {
    return 4ull * ((size_t)kTileM * ld_d(d) + (size_t)d * kLdF +
                   (size_t)FC * ld_d(d) + (size_t)kTileM * kLdF);
  }
  static_assert(kNT1 >= 1 && FC % 16 == 0, "FC must cover the warps");
};

// Copy a [rows x cols] tile (cols * sizeof(T) a multiple of 16 bytes) from
// global memory (row r at src + r * stride) into shared memory rows of
// ld_words words; rows at or past row_limit and columns at or past
// col_limit (a multiple of 16 bytes' worth) are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t* dst, int ld_words,
                                          const T* src, long long stride,
                                          int rows, int cols, int row_limit,
                                          int col_limit) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int vpr = cols / kVec;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < row_limit && c < col_limit) {
      val = *reinterpret_cast<const uint4*>(src + (long long)r * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld_words + c * (int)sizeof(T) / 4) =
        val;
  }
}

// A-operand fragment of rows r0, r0 + 8 at depth kk*16 of a bf16 tile in
// shared memory (row stride ldw words).
__device__ __forceinline__ void a_frag(uint32_t f[4], const uint32_t* w,
                                       int ldw, int r0, int kk, int t4) {
  const int c = kk * 8 + t4;
  f[0] = w[r0 * ldw + c];
  f[1] = w[(r0 + 8) * ldw + c];
  f[2] = w[r0 * ldw + c + 4];
  f[3] = w[(r0 + 8) * ldw + c + 4];
}

// B-operand fragment of X·Y: rows kk*16 + 2t4, +1, +8, +9 of Y (bf16,
// row-major in shared memory, row stride lde elements) at column col.
__device__ __forceinline__ void b_frag(uint32_t f[2], const __nv_bfloat16* y,
                                       int lde, int kk, int col, int t4) {
  const __nv_bfloat16* r = y + (kk * 16 + t4 * 2) * lde + col;
  f[0] = pack_bf16_raw(r[0], r[lde]);
  f[1] = pack_bf16_raw(r[8 * lde], r[9 * lde]);
}

// jax.nn.gelu's default, the tanh approximation, in f32.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <typename T, int WARPS_M, int FC>
__global__ void __launch_bounds__(Layout<T, WARPS_M, FC>::kThreads, 1)
    moe_gmm_kernel(GmmArgs a) {
  using L = Layout<T, WARPS_M, FC>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) uint32_t smem[];
  const int d = a.d, f = a.f, ldd = L::ld_d(d);
  const int ldde = ldd * 4 / (int)sizeof(T);
  uint32_t* Xw = smem;                    // xs tile
  uint32_t* Uw = Xw + L::kTileM * ldd;    // w_up[e][:, c0:c0+FC]
  uint32_t* Dw = Uw + d * L::kLdF;        // w_down[e][c0:c0+FC, :]
  uint32_t* Hw = Dw + FC * ldd;           // round_T(gelu(h chunk))

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = wm * 16 + g;             // rows r0 and r0 + 8 of the tile
  const int c1 = wn * L::kNT1 * 8;        // this warp's first h column
  const int c2 = wn * kColsPerWarp;       // this warp's first y column
  const long long row0 = (long long)blockIdx.x * a.tile_rows;
  const int ex = min(max(a.block_expert[row0 / a.block_rows], 0), a.e - 1);
  const T* wu = static_cast<const T*>(a.w_up) + (long long)ex * d * f;
  const T* wd = static_cast<const T*>(a.w_down) + (long long)ex * f * d;

  load_tile<T>(Xw, ldd, static_cast<const T*>(a.xs) + row0 * d, d, L::kTileM,
               d, a.tile_rows, d);

  float acc[kNT2][4];
#pragma unroll
  for (int n = 0; n < kNT2; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.f;

  for (int c0 = 0; c0 < f; c0 += FC) {
    __syncthreads();  // the previous chunk's readers are done
    load_tile<T>(Uw, L::kLdF, wu + c0, f, d, FC, d, f - c0);
    load_tile<T>(Dw, ldd, wd + (long long)c0 * d, d, FC, d, f - c0, d);
    __syncthreads();

    // h = xs_tile · w_up chunk: rows r0, r0 + 8, columns c1 + n*8 + 2t4..+1
    float h[L::kNT1][4];
#pragma unroll
    for (int n = 0; n < L::kNT1; ++n) h[n][0] = h[n][1] = h[n][2] = h[n][3] =
        0.f;
    if constexpr (!kF32) {
      const __nv_bfloat16* U = reinterpret_cast<const __nv_bfloat16*>(Uw);
      for (int kk = 0; kk < d / 16; ++kk) {
        uint32_t xa[4];
        a_frag(xa, Xw, ldd, r0, kk, t4);
#pragma unroll
        for (int n = 0; n < L::kNT1; ++n) {
          uint32_t bf[2];
          b_frag(bf, U, 2 * L::kLdF, kk, c1 + n * 8 + g, t4);
          mma_bf16_16816(h[n], xa, bf);
        }
      }
    } else {
      const float* X = reinterpret_cast<const float*>(Xw);
      const float* U = reinterpret_cast<const float*>(Uw);
      for (int k = 0; k < d; ++k) {
        const float x0 = X[r0 * ldd + k], x1 = X[(r0 + 8) * ldd + k];
#pragma unroll
        for (int n = 0; n < L::kNT1; ++n) {
          const int c = c1 + n * 8 + 2 * t4;
          const float u0 = U[k * L::kLdF + c], u1 = U[k * L::kLdF + c + 1];
          h[n][0] = fmaf(x0, u0, h[n][0]);
          h[n][1] = fmaf(x0, u1, h[n][1]);
          h[n][2] = fmaf(x1, u0, h[n][2]);
          h[n][3] = fmaf(x1, u1, h[n][3]);
        }
      }
    }
    // GELU in f32, rounded to T into shared memory
#pragma unroll
    for (int n = 0; n < L::kNT1; ++n) {
      const int c = c1 + n * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const float v0 = gelu_tanh(h[n][2 * i]), v1 = gelu_tanh(h[n][2 * i + 1]);
        if constexpr (kF32) {
          float* H = reinterpret_cast<float*>(Hw);
          H[r * L::kLdF + c] = v0;
          H[r * L::kLdF + c + 1] = v1;
        } else {
          Hw[r * L::kLdF + c / 2] = pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();

    // y += h chunk · w_down chunk: rows r0, r0 + 8, columns c2 + n*8 + 2t4
    if constexpr (!kF32) {
      const __nv_bfloat16* Dn = reinterpret_cast<const __nv_bfloat16*>(Dw);
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk) {
        uint32_t ha[4];
        a_frag(ha, Hw, L::kLdF, r0, kk, t4);
#pragma unroll
        for (int n = 0; n < kNT2; ++n) {
          if (c2 + n * 8 < d) {
            uint32_t bf[2];
            b_frag(bf, Dn, ldde, kk, c2 + n * 8 + g, t4);
            mma_bf16_16816(acc[n], ha, bf);
          }
        }
      }
    } else {
      const float* H = reinterpret_cast<const float*>(Hw);
      const float* Dn = reinterpret_cast<const float*>(Dw);
      for (int k = 0; k < FC; ++k) {
        const float h0 = H[r0 * L::kLdF + k], h1 = H[(r0 + 8) * L::kLdF + k];
#pragma unroll
        for (int n = 0; n < kNT2; ++n) {
          const int c = c2 + n * 8 + 2 * t4;
          if (c2 + n * 8 < d) {
            const float w0 = Dn[k * ldd + c], w1 = Dn[k * ldd + c + 1];
            acc[n][0] = fmaf(h0, w0, acc[n][0]);
            acc[n][1] = fmaf(h0, w1, acc[n][1]);
            acc[n][2] = fmaf(h1, w0, acc[n][2]);
            acc[n][3] = fmaf(h1, w1, acc[n][3]);
          }
        }
      }
    }
  }

  // epilogue: the gate on the f32 accumulator, then the cast
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r < a.tile_rows) {
      const float gt = a.gate[row0 + r];
      T* y = static_cast<T*>(a.ys) + (row0 + r) * d;
#pragma unroll
      for (int n = 0; n < kNT2; ++n) {
        const int c = c2 + n * 8 + 2 * t4;
        if (c2 + n * 8 < d) {
          y[c] = from_f32<T>(acc[n][2 * i] * gt);
          y[c + 1] = from_f32<T>(acc[n][2 * i + 1] * gt);
        }
      }
    }
  }
}

template <typename T, int WARPS_M, int FC>
int launch(const GmmArgs& a, cudaStream_t stream) {
  using L = Layout<T, WARPS_M, FC>;
  static bool smem_set = false;
  if (!smem_set) {  // once, before any graph capture: the largest d
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_kernel<T, WARPS_M, FC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::smem_bytes(kMaxD));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  moe_gmm_kernel<T, WARPS_M, FC>
      <<<a.np_pad / a.tile_rows, L::kThreads, L::smem_bytes(a.d), stream>>>(
          a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns the launch's cudaGetLastError().
extern "C" int tpudist_moe_gmm(int dtype, const void* xs, const void* gate,
                               const void* w_up, const void* w_down,
                               const void* block_expert, void* ys,
                               int np_pad, int d, int f, int e,
                               int block_rows, void* stream) {
  if (d % 16 || d <= 0 || d > kMaxD || f % 16 || f <= 0 || e <= 0 ||
      block_rows <= 0 || block_rows % 8 || np_pad % block_rows ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (np_pad == 0) return 0;
  GmmArgs a{xs,     static_cast<const float*>(gate), w_up, w_down,
            static_cast<const int*>(block_expert),   ys,   np_pad,
            d,      f,  e,  block_rows,  0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && block_rows % 64 == 0) {
    a.tile_rows = 64;
    return launch<__nv_bfloat16, 4, 64>(a, s);
  }
  a.tile_rows = block_rows % 16 == 0 ? 16 : 8;
  return dtype == 1 ? launch<__nv_bfloat16, 1, 64>(a, s)
                    : launch<float, 1, 32>(a, s);
}
