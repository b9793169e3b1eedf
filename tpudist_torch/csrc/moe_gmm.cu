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
// The Pallas grid step held a [block_rows, f] intermediate in VMEM; 128 x
// 2048 bf16 is 512 KB, against 227 KB of shared memory and a 256 KB
// register file, so a CTA here loops over f in chunks of 64 columns and
// never holds h whole.  Two paths, chosen by dtype and shape in
// tpudist_moe_gmm (never on a failure):
//
// The wgmma path: bf16, block_rows a multiple of 64, d 256 or 512, f a
// multiple of 16.
//  1. Tile.  A CTA owns 64 * WG sorted rows of one expert (WG = 2
//     consumer warpgroups when block_rows is a multiple of 128, else 1)
//     and one 256-column half of d.  Each consumer warpgroup holds its 64
//     rows' f32 y accumulator, 64 x 256 = 128 registers a thread (two
//     m64n128 accumulators).  Both halves of a row tile compute the tile's
//     h in full, so the first product runs twice: 1.5x the function's
//     FLOPs at d = 512 (the design's own bound, 0.208 ms at the training
//     shape).  The alternative, 64-row tiles over the whole d with h
//     exchanged through shared memory, has no repeated product but reads
//     the weights once per 64 rows: 30% more L2 traffic.
//  2. Products.  h_c = xs_tile · w_up[e][:, c:c+64] is m64n64k16 with the
//     xs tile K-major and the w_up piece MN-major, both from swizzled
//     shared tiles (SwTile).  GELU runs in f32 in registers (2^x on the
//     SFU), and the result, rounded to bf16, is the register A operand of
//     y += h_c · w_down[e][c:c+64, half] (two m64n128k16 rs products, the
//     w_down piece MN-major): h never leaves the registers.
//  3. Streaming, warp-specialised.  A producer warpgroup (56 registers a
//     thread, setmaxnreg) copies the xs tile [64 * WG, d] once (128 KB at
//     d = 512, WG = 2; it stays for the whole walk) and then the weights as
//     one sequence of 16 KB pieces through a ring of 6 slots (96 KB) with
//     cp.async, each piece's landing signalled on an mbarrier
//     (cp.async.mbarrier.arrive).  A w_up piece is 128 rows of d x 64
//     columns of f, a w_down piece 32 rows of f x 256 columns of d.  The
//     sequence is w_up(0), then for each chunk c the pieces of w_up(c + 1)
//     and then of w_down(c).  The consumer warpgroups (224 registers a
//     thread) each take every piece as one wgmma group, keep two groups in
//     flight, and give a slot back (an mbarrier arrival per warp) as soon
//     as their products on it have completed, so the two run out of step
//     and one's GELU overlaps the other's products.  Chunk c + 1's first
//     product is issued before chunk c's second, so chunk c + 1's GELU
//     also runs while the tensor cores work on chunk c's w_down.  The
//     split keeps the copies' address arithmetic out of the consumers'
//     registers: a version where every thread copied and computed, with
//     a __syncthreads a piece, spilled.
//  4. Trailing pad blocks.  np_pad = (N // bn + E) · bn leaves up to E
//     blocks past the last group with no slot.  The wrapper passes the
//     live row count (the groups' padded sizes summed, on the device: no
//     host sync); a tile at or past it reads nothing and writes exact
//     zeros, which is what the plain version's 0 · finite gives.
//  5. f not a multiple of 64: the last chunk's columns past f are
//     zero-filled by cp.async (GELU(0) = 0, and w_down's rows past f are
//     zero too), so f needs only 16-byte rows.
//  No atomics: two calls agree bit for bit.
// What bounds it now: the shared-memory reads of the first product.  An
// m64n64k16 with both operands in shared memory reads 4 KB per 64K
// multiply-adds, the SM's whole 128 bytes a clock at the tensor cores'
// rate, and the copies' writes come on top; the L2 is not the limit (the
// weight stream alone, without products, takes about half the kernel's
// time).  A wider first product (n128) needs registers the y accumulator
// holds (scripts/kernel_variants.py k7 times the stream and the products
// apart).  Left for later work: a cluster of 2 (the two halves of a row
// tile) that computes each h column once and shares it through
// distributed shared memory (no repeated product), with the xs tile and
// the w_up pieces multicast by TMA.
//
// The mma.sync path (f32, block_rows not a multiple of 64, or d not 256 or
// 512): one CTA of 4 warps takes a row tile of one expert (16 rows, or 8
// live rows of a 16-row tile), stages its rows once, and loops over f in
// chunks: h_c = gelu(xs_tile @ w_up[e][:,
// c]) in f32, rounded to T into shared memory, then y += h_c @ w_down[e][c,
// :] into an f32 accumulator over the whole d (d up to 512).  bf16 runs
// mma.sync m16n8k16; f32 runs exact FMAs on the same register layout (no
// TF32).  Tiles are loaded synchronously.  It skips trailing pad tiles as
// the wgmma path does.
//
// Constraints (the wrapper checks them and raises): d a multiple of 16 up
// to 512, f a multiple of 16, block_rows a multiple of 8, np_pad a
// multiple of block_rows.

#include "hopper.cuh"

namespace {

using tpudist::from_f32;
using tpudist::mma_bf16_16816;
using tpudist::pack_bf16;
using tpudist::pack_bf16_raw;
using namespace tpudist::sm90;

struct GmmArgs {
  const void* xs;           // [np_pad, d] T
  const float* gate;        // [np_pad] f32
  const void* w_up;         // [e, d, f] T
  const void* w_down;       // [e, f, d] T
  const int* block_expert;  // [np_pad / block_rows]
  const int* live_rows;     // device scalar: the rows the groups cover
  void* ys;                 // [np_pad, d] T
  int np_pad, d, f, e, block_rows;
  int tile_rows;            // live rows of one CTA's tile
};

// ---- the wgmma path --------------------------------------------------------

constexpr int kFC = 64;     // f columns a chunk
constexpr int kNT = 256;    // d columns a CTA
constexpr int kUR = 128;    // d rows of a w_up piece
constexpr int kDR = 32;     // f rows of a w_down piece
constexpr int kRing = 6;    // shared slots of the weight stream
using UTile = SwTile<kUR, kFC>;
using DTile = SwTile<kDR, kNT>;
constexpr int kPiece = UTile::kBytes;
static_assert(DTile::kBytes == kPiece, "pieces share the ring's slots");

template <int D, int WG>
struct WgSmem {
  using XT = SwTile<64, D>;                 // one warpgroup's xs rows
  static constexpr int kRingOff = WG * XT::kBytes;
  // mbarriers: full[kRing], empty[kRing], the xs tile's
  static constexpr int kBarOff = kRingOff + kRing * kPiece;
  static constexpr size_t kBytes = 1024 + kBarOff + (2 * kRing + 1) * 8;
};

// jax.nn.gelu's default, the tanh approximation, in f32:
// 0.5 x (1 + tanh(u)) = x / (1 + e^(-2u)), u = sqrt(2 / pi) (x + 0.044715
// x^3), with e^(-2u) on the SFU.
__device__ __forceinline__ float gelu_fast(float x) {
  constexpr float k = 0.7978845608028654f;       // sqrt(2 / pi)
  constexpr float m2log2e = -2.f * 1.4426950408889634f;
  const float u = x * fmaf(0.044715f * k, x * x, k);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(m2log2e * u));
  return __fdividef(x, 1.f + e);
}

// desc + bytes / 16: a descriptor `bytes` further on in shared memory,
// computed where it is used (a volatile add: the compiler neither hoists
// it out of the walk nor keeps every k-step's descriptor live).
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  uint64_t out;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(out) : "l"(desc),
               "l"((uint64_t)(bytes >> 4)));
  return out;
}

// A position in the ring: the slot and the parity of its fill.
struct Ring {
  int slot = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == kRing) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// Warp-specialised: warpgroup 0 streams (cp.async; 40 registers a thread
// when WG = 2), warpgroups 1 .. WG compute (232: the 128 of y).  The
// stream is w_up(0), then for each chunk c the pieces of w_up(c + 1) (if
// any) and of w_down(c), in the order the consumers take them.
template <int D, int WG>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
    moe_gmm_wgmma_kernel(const GmmArgs a) {
  using S = WgSmem<D, WG>;
  using XT = typename S::XT;
  using bf16 = __nv_bfloat16;
  constexpr int NTH = 128 * (WG + 1), NU = D / kUR;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, role = tid / 128, ptid = tid % 128;
  const int half = blockIdx.x;
  const long long row0 = (long long)blockIdx.y * 64 * WG;
  const int f = a.f;
  bf16* ys = static_cast<bf16*>(a.ys);

  if (row0 >= *a.live_rows) {  // a trailing pad tile: exact zeros
    for (int i = tid; i < 64 * WG * kNT / 8; i += NTH) {
      const int r = i / (kNT / 8), c = i % (kNT / 8);
      *reinterpret_cast<uint4*>(ys + (row0 + r) * D + half * kNT + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int nc = (f + kFC - 1) / kFC;
  const uint32_t ring = smem_u32(smem + S::kRingOff);
  const uint32_t bars = smem_u32(smem + S::kBarOff);
  // full[slot] at bars + 8 slot, empty[slot] at bars + 8 (kRing + slot)
  const uint32_t xs_full = bars + 2 * kRing * 8;
  if (tid == 0) {
    for (int j = 0; j < kRing; ++j) {
      mbar_init(bars + 8 * j, 128);               // the producer's threads
      mbar_init(bars + 8 * (kRing + j), 4 * WG);  // the consumers' warps
    }
    mbar_init(xs_full, 128);
  }
  __syncthreads();

  if (role == 0) {
    // ---- producer: the xs tile, then the weight stream ----
    if constexpr (WG > 1) regs_dec<56>();
    const int ex = min(max(a.block_expert[row0 / a.block_rows], 0), a.e - 1);
    {
      const bf16* src = static_cast<const bf16*>(a.xs) + row0 * D;
      const uint32_t xb = smem_u32(smem);
      for (int j = ptid; j < 64 * WG * D / 8; j += 128) {
        const int r = j / (D / 8), ch = j % (D / 8);
        cp_async16(xb + (r / 64) * XT::kBytes + XT::offset(r % 64, ch),
                   src + (long long)r * D + ch * 8, true);
      }
      cp_async_arrive(xs_full);
    }
    // this thread's rows and 16-byte columns of a piece
    const int ur = ptid / (kFC / 8), uch = ptid % (kFC / 8);
    const int dr = ptid / (kNT / 8), dch = ptid % (kNT / 8);
    const bf16* wu = static_cast<const bf16*>(a.w_up) +
                     (long long)ex * D * f + (long long)ur * f + uch * 8;
    const bf16* wd = static_cast<const bf16*>(a.w_down) +
                     (long long)ex * f * D + half * kNT + dch * 8;
    Ring w;
    auto claim = [&]() {
      mbar_wait(bars + 8 * (kRing + w.slot), w.phase ^ 1u);
      return ring + w.slot * kPiece;
    };
    auto done = [&]() {
      cp_async_arrive(bars + 8 * w.slot);
      w.next();
    };
    // w_up(c), d rows 128 q .., f columns 64 c ..
    auto load_up = [&](int c, int q) {
      const uint32_t dst = claim();
      const bool ok = c * kFC + uch * 8 < f;
      const bf16* src = wu + (long long)(q * kUR) * f + c * kFC;
#pragma unroll
      for (int k = 0; k < kUR * kFC / 8 / 128; ++k) {
        const int r = ur + k * (128 * 8 / kFC);
        cp_async16(dst + UTile::offset(r, uch),
                   ok ? src + (long long)k * (128 * 8 / kFC) * f : wu, ok);
      }
      done();
    };
    // w_down(c), f rows 64 c + 32 q .., this CTA's half of d
    auto load_down = [&](int c, int q) {
      const uint32_t dst = claim();
      const int f0 = c * kFC + q * kDR;
#pragma unroll
      for (int k = 0; k < kDR * kNT / 8 / 128; ++k) {
        const int r = dr + k * (128 * 8 / kNT);
        const bool ok = f0 + r < f;
        cp_async16(dst + DTile::offset(r, dch),
                   ok ? wd + (long long)(f0 + r) * D : wd, ok);
      }
      done();
    };
    for (int q = 0; q < NU; ++q) load_up(0, q);
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc)
        for (int q = 0; q < NU; ++q) load_up(c + 1, q);
      for (int q = 0; q < kFC / kDR; ++q) load_down(c, q);
    }
    cp_async_wait<0>();  // no copy may land after the thread's exit
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 ----
  if constexpr (WG > 1) regs_inc<224>();  // one consumer has 255 anyway
  const int cw = role - 1, warp = ptid / 32, lane = ptid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint64_t xd = XT::desc_k(smem_u32(smem + cw * XT::kBytes), 0);
  float h[kFC / 2];          // h_c, this warpgroup's 64 rows x 64 columns
  float y0[64], y1[64];      // y, columns 0..127 and 128..255 of the half
  uint32_t ha[kFC / 16][4];  // round_bf16(gelu(h_c)) as A fragments
#pragma unroll
  for (int j = 0; j < 64; ++j) y0[j] = y1[j] = 0.f;
  Ring r;  // the next piece to take

  // The next piece's slot, once its copies have landed.
  auto acquire = [&]() {
    mbar_wait(bars + 8 * r.slot, r.phase);
    fence_async_shared();
    const uint32_t at = ring + r.slot * kPiece;
    return at;
  };
  // Give back the slot `back` pieces before the next one to take.
  auto release = [&](int back) {
    if (lane == 0)
      mbar_arrive(bars + 8 * (kRing + (r.slot - back + kRing) % kRing));
  };
  // After the k-th product since the last pack_h is committed: the one
  // before it has completed (two groups in flight at most; more measured
  // slower), and its slot goes back to the producer (pack_h released the
  // products before).
  auto retire = [&](int k) {
    wgmma_wait<1>();
    r.next();
    if (k > 0) release(2);
  };
  auto issue_up = [&](int q) {
    const uint32_t slot = acquire();
    const uint64_t ud = UTile::desc_mn(slot, 0);
    fence_regs(h);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kUR / 16; ++j)
      Wgmma<kFC, 1>::ss(
          h,
          desc_at(xd, ((q * (kUR / 16) + j) / 4) * XT::kAtomBytes +
                          ((q * (kUR / 16) + j) % 4) * 32),
          desc_at(ud, j * 16 * UTile::kRowB));
    wgmma_commit();
    retire(q);
  };
  auto issue_down = [&](int q, int k) {
    const uint32_t slot = acquire();
    const uint64_t dd = DTile::desc_mn(slot, 0);
#pragma unroll
    for (int j = 0; j < kFC / 16; ++j) fence_regs(ha[j]);
    fence_regs(y0);
    fence_regs(y1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kDR / 16; ++j) {
      Wgmma<128, 1>::rs(y0, ha[q * (kDR / 16) + j],
                        desc_at(dd, j * 16 * DTile::kRowB));
      Wgmma<128, 1>::rs(y1, ha[q * (kDR / 16) + j],
                        desc_at(dd, j * 16 * DTile::kRowB +
                                        2 * DTile::kAtomBytes));
    }
    wgmma_commit();
    retire(k);
  };
  auto zero_h = [&]() {
#pragma unroll
    for (int j = 0; j < kFC / 2; ++j) h[j] = 0.f;
  };
  // h_c -> GELU in f32 (the first product has completed)
  auto gelu_h = [&]() {
    fence_regs(h);
#pragma unroll
    for (int j = 0; j < kFC / 2; ++j) h[j] = gelu_fast(h[j]);
  };
  // ... rounded to bf16 as the next product's A fragments, once the
  // previous w_down products, which read them, have completed
  auto pack_h = [&]() {
    wgmma_wait<0>();
    release(1);
    fence_regs(y0);
    fence_regs(y1);
#pragma unroll
    for (int j = 0; j < kFC / 16; ++j) {
      fence_regs(ha[j]);
      acc_to_a(ha[j], h, j);
    }
  };

  mbar_wait(xs_full, 0);
  zero_h();
#pragma unroll
  for (int q = 0; q < NU; ++q) issue_up(q);
  wgmma_wait<0>();
  gelu_h();
  pack_h();
  for (int c = 0; c + 1 < nc; ++c) {
    zero_h();
#pragma unroll
    for (int q = 0; q < NU; ++q) issue_up(q);
#pragma unroll
    for (int q = 0; q < kFC / kDR; ++q) issue_down(q, NU + q);
    // the first product of chunk c + 1 completed in the last retire():
    // its GELU runs under chunk c's w_down products
    gelu_h();
    pack_h();
  }
#pragma unroll
  for (int q = 0; q < kFC / kDR; ++q) issue_down(q, q);
  wgmma_wait<0>();
  fence_regs(y0);
  fence_regs(y1);

  // epilogue: the gate on the f32 accumulator, then the cast
  const int r0 = cw * 64 + warp * 16 + g;
  const float g0 = a.gate[row0 + r0], g1 = a.gate[row0 + r0 + 8];
  const long long out_col = (long long)half * kNT;
  bf16* ya = ys + (row0 + r0) * D + out_col + 2 * t4;
  bf16* yb = ya + 8 * D;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(ya + 8 * j) =
        pack_bf16(y0[4 * j] * g0, y0[4 * j + 1] * g0);
    *reinterpret_cast<uint32_t*>(yb + 8 * j) =
        pack_bf16(y0[4 * j + 2] * g1, y0[4 * j + 3] * g1);
    *reinterpret_cast<uint32_t*>(ya + 128 + 8 * j) =
        pack_bf16(y1[4 * j] * g0, y1[4 * j + 1] * g0);
    *reinterpret_cast<uint32_t*>(yb + 128 + 8 * j) =
        pack_bf16(y1[4 * j + 2] * g1, y1[4 * j + 3] * g1);
  }
}

template <int D, int WG>
int launch_wgmma(const GmmArgs& a, cudaStream_t stream) {
  using S = WgSmem<D, WG>;
  static bool smem_set = false;
  if (!smem_set) {  // once, before any graph capture
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_wgmma_kernel<D, WG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid(D / kNT, a.np_pad / (64 * WG));
  moe_gmm_wgmma_kernel<D, WG>
      <<<grid, 128 * (WG + 1), S::kBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the mma.sync path -----------------------------------------------------

constexpr int kWarpsN = 4;                    // warps along d
constexpr int kMaxD = 512;
constexpr int kColsPerWarp = kMaxD / kWarpsN;  // 128
constexpr int kNT2 = kColsPerWarp / 8;         // y n-tiles per warp
constexpr int kPadWords = 4;                   // shared row padding

template <typename T, int FC>
struct Layout {
  static constexpr int kTileM = 16;
  static constexpr int kThreads = 32 * kWarpsN;
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

template <typename T, int FC>
__global__ void __launch_bounds__(Layout<T, FC>::kThreads, 1)
    moe_gmm_kernel(GmmArgs a) {
  using L = Layout<T, FC>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) uint32_t smem[];
  const int d = a.d, f = a.f, ldd = L::ld_d(d);
  const int ldde = ldd * 4 / (int)sizeof(T);
  uint32_t* Xw = smem;                    // xs tile
  uint32_t* Uw = Xw + L::kTileM * ldd;    // w_up[e][:, c0:c0+FC]
  uint32_t* Dw = Uw + d * L::kLdF;        // w_down[e][c0:c0+FC, :]
  uint32_t* Hw = Dw + FC * ldd;           // round_T(gelu(h chunk))

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = g;                       // rows r0 and r0 + 8 of the tile
  const int c1 = wn * L::kNT1 * 8;        // this warp's first h column
  const int c2 = wn * kColsPerWarp;       // this warp's first y column
  const long long row0 = (long long)blockIdx.x * a.tile_rows;
  if (row0 >= *a.live_rows) {  // a trailing pad tile: exact zeros
    T* y = static_cast<T*>(a.ys) + row0 * d;
    for (int i = threadIdx.x; i < a.tile_rows * d; i += blockDim.x)
      y[i] = from_f32<T>(0.f);
    return;
  }
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

template <typename T, int FC>
int launch(const GmmArgs& a, cudaStream_t stream) {
  using L = Layout<T, FC>;
  static bool smem_set = false;
  if (!smem_set) {  // once, before any graph capture: the largest d
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_kernel<T, FC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::smem_bytes(kMaxD));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  moe_gmm_kernel<T, FC>
      <<<a.np_pad / a.tile_rows, L::kThreads, L::smem_bytes(a.d), stream>>>(
          a);
  return (int)cudaGetLastError();
}

// 1 = the wgmma path, 0 = mma.sync, -1 = a shape no path takes.
int variant(int dtype, int d, int f, int block_rows) {
  if (d % 16 || d <= 0 || d > kMaxD || f % 16 || f <= 0 || block_rows <= 0 ||
      block_rows % 8 || (dtype != 0 && dtype != 1))
    return -1;
  return dtype == 1 && block_rows % 64 == 0 && d % kNT == 0 ? 1 : 0;
}

}  // namespace

// The path tpudist_moe_gmm takes for a dtype (0 = f32, 1 = bf16) and shape:
// 1 = wgmma, 0 = mma.sync, -1 = none (the launch would fail).
extern "C" int tpudist_moe_gmm_variant(int dtype, int d, int f,
                                       int block_rows) {
  return variant(dtype, d, f, block_rows);
}

// dtype: 0 = f32, 1 = bf16.  live_rows: a device int32 scalar, the rows
// the groups cover (tiles past it are pad and written as zeros).  Returns
// the launch's cudaGetLastError().
extern "C" int tpudist_moe_gmm(int dtype, const void* xs, const void* gate,
                               const void* w_up, const void* w_down,
                               const void* block_expert,
                               const void* live_rows, void* ys, int np_pad,
                               int d, int f, int e, int block_rows,
                               void* stream) {
  const int path = variant(dtype, d, f, block_rows);
  if (path < 0 || e <= 0 || np_pad % block_rows)
    return (int)cudaErrorInvalidValue;
  if (np_pad == 0) return 0;
  GmmArgs a{xs,     static_cast<const float*>(gate), w_up, w_down,
            static_cast<const int*>(block_expert),
            static_cast<const int*>(live_rows), ys, np_pad, d, f, e,
            block_rows, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const bool two = block_rows % 128 == 0;
    if (d == 512) return two ? launch_wgmma<512, 2>(a, s)
                             : launch_wgmma<512, 1>(a, s);
    return two ? launch_wgmma<256, 2>(a, s) : launch_wgmma<256, 1>(a, s);
  }
  a.tile_rows = block_rows % 16 == 0 ? 16 : 8;
  return dtype == 1 ? launch<__nv_bfloat16, 64>(a, s)
                    : launch<float, 32>(a, s);
}
