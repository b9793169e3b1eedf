// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces tpudist/ops/flash_attention.py::_flash_kernel (Pallas, B1),
// reached through _flash_forward; on the serve path it runs every prefill
// chunk (CausalSelfAttention._prefill_attend at q_offset = cache index).
//
// What bounds it on an H100: a prefill chunk of 512 queries against a
// 7.7k-token context is ~8 GFLOP a layer against ~2 MB of K/V, far above
// the card's ~295 FLOP/byte ridge, so it is bound by tensor-core
// operations (989 TFLOP/s bf16).  This first version is the simple form of
// the FlashAttention-2 recurrence: one block of 4 warps owns 64 query rows
// of one (batch, head); each warp keeps its 16 rows' scores, running max,
// running sum and output accumulator in registers, and K/V stream through
// shared memory in 64-key tiles.  bf16 products run on the tensor cores
// with mma.sync (m16n8k16, f32 accumulation); the score tile's register
// layout is reused directly as the P operand of the P·V product, so P
// never touches shared memory.  f32 inputs take plain FMAs on the same
// layout (exact f32, no TF32).  Not yet done (later work): cp.async/TMA
// double buffering of the K/V tiles, wgmma, ldmatrix.
//
// What the Pallas kernel's grid did, and what this does instead:
//  * the sequential K grid axis + VMEM scratch carry  -> a loop over K/V
//    tiles inside the block, state in registers;
//  * pl.when(_block_live) / _band_k pruning           -> the loop runs only
//    from the window band's first tile to the causal limit
//    min(Sk, q_offset + last row + 1 - k_offset): dead tiles are never read;
//  * GQA by index map                                 -> query head h reads
//    KV head h / (H / Hkv); K/V are never expanded;
//  * BlockSpecs over a fused [B*H, S, D] copy         -> the kernel reads
//    [B, S, H, D] tensors through their strides, so the packed serve cache
//    [B, S, Hkv*D] is read in place;
//  * the SMEM offsets operand                         -> q/k offsets are a
//    device int32 scalar (the cache index) or an immediate.
// Ragged Sq / Sk edges are masked in the kernel (no padding to a block).

#include "common.cuh"

namespace {

using tpudist::load_rows;
using tpudist::mma_bf16_16816;
using tpudist::pack_bf16;
using tpudist::pack_bf16_raw;
using tpudist::to_f32;

constexpr int kBQ = 64;       // query rows per block (4 warps x 16)
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 128;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;        // [B, H, Sq]
  int B, Sq, Sk, H, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  const int* q_off_ptr;  // device scalar, or null -> q_off
  const int* k_off_ptr;
  int q_off, k_off;
  int causal, window;    // window <= 0: none (applies only when causal)
  float scale;
};

template <typename T, int D>
struct Layout {
  // shared row stride in 32-bit words: 4 words of padding keep the mma
  // fragment reads (8 rows x 4 words per warp) on distinct banks
  static constexpr int kLdw = D * (int)sizeof(T) / 4 + 4;
  static constexpr int kLde = kLdw * 4 / (int)sizeof(T);  // in elements
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kPld = kBK + 1;  // f32 path's P row stride (floats)
  static constexpr size_t kBytes =
      (size_t)(kBQ + 2 * kBK) * kLdw * 4 + (kF32 ? kBQ * kPld * 4 : 0);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FwdArgs a) {
  using L = Layout<T, D>;
  constexpr int NT = kBK / 8;   // 8-key column tiles of a score tile
  constexpr int ND = D / 8;     // 8-wide column tiles of the output
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* Qw = smem;
  uint32_t* Kw = Qw + kBQ * L::kLdw;
  uint32_t* Vw = Kw + kBK * L::kLdw;
  float* Ps = reinterpret_cast<float*>(Vw + kBK * L::kLdw);
  const T* Qs = reinterpret_cast<const T*>(Qw);
  const T* Ks = reinterpret_cast<const T*>(Kw);
  const T* Vs = reinterpret_cast<const T*>(Vw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int qoff = a.q_off_ptr ? *a.q_off_ptr : a.q_off;
  const int koff = a.k_off_ptr ? *a.k_off_ptr : a.k_off;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // live key range of this block: from the window band's first tile to
  // the causal limit of its last real row
  const int rows_here = min(kBQ, a.Sq - q0);
  int kv_lo = 0, kv_hi = a.Sk;
  if (a.causal) {
    kv_hi = max(0, min(a.Sk, qoff + q0 + rows_here - koff));
    if (a.window > 0) kv_lo = max(0, qoff + q0 - (a.window - 1) - koff);
  }
  kv_lo = (kv_lo / kBK) * kBK;

  load_rows<T>(Qw, L::kLdw, qb, a.q_ss, q0, a.Sq, kBQ, D);
  __syncthreads();

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const int qp0 = qoff + q0 + r0, qp1 = qoff + q0 + r1;
  float m0 = TPUDIST_NEG_BIG, m1 = TPUDIST_NEG_BIG, l0 = 0.f, l1 = 0.f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  uint32_t qf[L::kF32 ? 1 : D / 16][4];
  if constexpr (!L::kF32) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int w = kk * 8 + t4;  // word of columns kk*16 + t4*2, +1
      qf[kk][0] = Qw[r0 * L::kLdw + w];
      qf[kk][1] = Qw[r1 * L::kLdw + w];
      qf[kk][2] = Qw[r0 * L::kLdw + w + 4];
      qf[kk][3] = Qw[r1 * L::kLdw + w + 4];
    }
  }

  for (int kt = kv_lo; kt < kv_hi; kt += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<T>(Kw, L::kLdw, kb, a.k_ss, kt, a.Sk, kBK, D);
    load_rows<T>(Vw, L::kLdw, vb, a.v_ss, kt, a.Sk, kBK, D);
    __syncthreads();

    // S = Q K^T: s[nt][0..1] row r0, s[nt][2..3] row r1, columns
    // nt*8 + t4*2 + {0, 1} (the mma C-fragment layout)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (!L::kF32) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* kr = Kw + (nt * 8 + g) * L::kLdw + kk * 8 + t4;
          const uint32_t bf[2] = {kr[0], kr[4]};
          mma_bf16_16816(s[nt], qf[kk], bf);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* qr = reinterpret_cast<const float*>(Qs) +
                            (e < 2 ? r0 : r1) * L::kLde;
          const float* kr = reinterpret_cast<const float*>(Ks) +
                            (nt * 8 + t4 * 2 + (e & 1)) * L::kLde;
          float acc = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
          s[nt][e] = acc;
        }
      }
    }

    // scale, mask by global position, online-softmax update
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt + nt * 8 + t4 * 2 + (e & 1);
        const int qp = e < 2 ? qp0 : qp1, kp = koff + col;
        bool keep = col < a.Sk;
        if (a.causal) {
          keep = keep && kp <= qp && (a.window <= 0 || qp - kp < a.window);
        }
        const float v = keep ? s[nt][e] * a.scale : -INFINITY;
        s[nt][e] = v;
        if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float nm0 = fmaxf(m0, fmaxf(mx0, TPUDIST_NEG_BIG));
    const float nm1 = fmaxf(m1, fmaxf(mx1, TPUDIST_NEG_BIG));
    const float c0 = expf(m0 - nm0), c1 = expf(m1 - nm1);
    m0 = nm0;
    m1 = nm1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - nm0);
      s[nt][1] = expf(s[nt][1] - nm0);
      s[nt][2] = expf(s[nt][2] - nm1);
      s[nt][3] = expf(s[nt][3] - nm1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    // per-thread partial sums; the four threads of a row are summed at
    // the end (the correction factor is uniform across them)
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P V, P rounded to the value dtype first (as the Pallas kernel)
    if constexpr (!L::kF32) {
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const __nv_bfloat16* vr = reinterpret_cast<const __nv_bfloat16*>(Vs) +
                                    (j * 16 + t4 * 2) * L::kLde + n * 8 + g;
          const uint32_t bf[2] = {
              pack_bf16_raw(vr[0], vr[L::kLde]),
              pack_bf16_raw(vr[8 * L::kLde], vr[9 * L::kLde])};
          mma_bf16_16816(o[n], pa, bf);
        }
      }
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
      const float* Vf = reinterpret_cast<const float*>(Vs);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + t4 * 2;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int kk = 0; kk < kBK; ++kk) {
          const float p0 = Ps[r0 * L::kPld + kk], p1 = Ps[r1 * L::kPld + kk];
          const float v0 = Vf[kk * L::kLde + c], v1 = Vf[kk * L::kLde + c + 1];
          a0 = fmaf(p0, v0, a0);
          a1 = fmaf(p0, v1, a1);
          a2 = fmaf(p1, v0, a2);
          a3 = fmaf(p1, v1, a3);
        }
        o[n][0] += a0;
        o[n][1] += a1;
        o[n][2] += a2;
        o[n][3] += a3;
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* ob = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  const bool ok0 = q0 + r0 < a.Sq, ok1 = q0 + r1 < a.Sq;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t4 * 2;
    if (ok0) {
      T* orow = ob + (long long)(q0 + r0) * a.o_ss + c;
      orow[0] = tpudist::from_f32<T>(o[n][0] / d0);
      orow[1] = tpudist::from_f32<T>(o[n][1] / d0);
    }
    if (ok1) {
      T* orow = ob + (long long)(q0 + r1) * a.o_ss + c;
      orow[0] = tpudist::from_f32<T>(o[n][2] / d1);
      orow[1] = tpudist::from_f32<T>(o[n][3] / d1);
    }
  }
  if (t4 == 0) {
    float* lb = a.lse + ((long long)b * a.H + h) * a.Sq + q0;
    if (ok0) lb[r0] = m0 + logf(d0);
    if (ok1) lb[r1] = m1 + logf(d1);
  }
}

template <typename T, int D>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  using L = Layout<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(a.B * a.H, (a.Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const FwdArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// (head_dim) stride is 1.  Returns cudaGetLastError() after the launch.
extern "C" int tpudist_flash_forward(
    int dtype, const void* q, const void* k, const void* v, void* out,
    float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    const int* q_off_ptr, int q_off, const int* k_off_ptr, int k_off,
    int causal, int window, float scale, void* stream) {
  FwdArgs a{q, k, v, out, lse, B, Sq, Sk, H, Hkv,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            o_sb, o_ss, o_sh, q_off_ptr, k_off_ptr, q_off, k_off,
            causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? dispatch<__nv_bfloat16>(D, a, s)
                             : dispatch<float>(D, a, s);
  return static_cast<int>(e);
}
