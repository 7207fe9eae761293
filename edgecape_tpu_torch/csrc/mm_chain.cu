// The matmul-chain kernel of edgecape_tpu_torch (ops/mm_chain.py), the
// counterpart of the TPU kernel of scripts/probe_m_fold.py (`run`, body
// `make_kernel` / `_mm_chain`): reps times
//     h = bf16(x @ w1);  y = h @ w2 (fp32);  x = bf16(f32(x) + y)
// per row, x [rows, C] bf16, w1 [C, F], w2 [F, C] bf16, fp32 accumulation.
//
// Bound on this card: operations (4 * rows * C * F * reps against x in and
// out and the weights once: hundreds of operations per byte). The TPU
// kernel keeps a whole image group and both weights in VMEM; an SM has
// 227 KB, so here one block owns a tile of 128 rows for the whole chain:
//   * 256 threads, two warpgroups of 64 rows each and no producer warps,
//     so that a thread may hold 255 registers (y alone takes 192 at
//     C 384);
//   * the x tile [128, C] bf16 lands by TMA in C / 64 swizzled slabs
//     (96 KB at C 384) and stays there for every step: it is the shared
//     memory A operand of x @ w1, the residual, and, written back by each
//     warpgroup into its own rows after a step (then a proxy fence and a
//     warpgroup barrier before the next step's products read it), the
//     next step's x; a 3-D tensor map [segments, rows, C] zero-fills rows
//     past a segment's end, and the result leaves by TMA stores that
//     write no row past it;
//   * F is walked in chunks of 64: h_chunk = x_tile @ w1[:, chunk] as
//     wgmma m64n64 into 32 fp32 registers, rounded to bf16 and packed in
//     place as the register A fragments of y += h_chunk @ w2[chunk, :]
//     (wgmma m64n128 from registers), so h never leaves the registers;
//   * y [64, C] fp32 per warpgroup stays in registers over all chunks;
//   * w1 and w2 stream by TMA through a ring of 16 KB slots (CountRing:
//     the warp whose release of a slot is the eighth issues its next
//     load), per chunk C / 128 slots of w1 then C / 128 of w2, both read
//     MN-major by the transpose bit of wgmma, in the same order for every
//     block and step from chunk 0: a row's sums over C and over F run in
//     the same order wherever the row sits, so both cuts of the rows give
//     the same bits (a block that started at another chunk would sum y in
//     another order);
//   * a 128-row tile reads the weights from L2 once per step: at C 384,
//     F 1536 that is 2.36 MB for 302 MFLOP, 128 flop a byte.
// The row tiles are cut either inside each image (`loop`: segment = n
// rows) or from the flat rows of a group of images (`fold`: segment =
// g * n); one block per tile, one block an SM (225 KB of shared memory).
//
// Plain C interface; the entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for a refused shape), allocates nothing and does
// not synchronise.

#include "hopper.cuh"

namespace {

constexpr int MC_ROWS = 128;     // rows of a tile
constexpr int MC_CHUNK = 64;     // columns of w1 / rows of w2 per chunk
constexpr int MC_THREADS = 256;  // two warpgroups
constexpr int SMEM_LIMIT = 232448;

// Shared memory for C = 64 NT (from a 1024-byte-aligned base): the x tile
// (NT slabs), the ring's slots, the x barrier, then the ring's full
// barriers and release counters; as many slots as fit, at most 12.
template <int NT>
struct McLayout {
  static constexpr int STAGES =
      (SMEM_LIMIT - 1024 - NT * SW_SLAB - 64) / (SW_SLAB + 12) < 12
          ? (SMEM_LIMIT - 1024 - NT * SW_SLAB - 64) / (SW_SLAB + 12)
          : 12;
  static constexpr int bars = (NT + STAGES) * SW_SLAB;
  static constexpr int total = 1024 + bars + 8 + ((STAGES * 12 + 7) & ~7);
  static_assert(total <= SMEM_LIMIT, "mm_chain_kernel exceeds the shared memory of a block");
};

// The ring's loads: a step's chunks in turn from chunk 0, each KS slots of
// w1 (slot r: its k rows 128 r .. + 127 of the chunk's 64 columns) then KS
// slots of w2 (slot r: the chunk's 64 rows, output columns 128 r .. +
// 127), each as two boxes of [64 x 64].
template <int KS>
struct McLoader {
  static constexpr unsigned kBytes = SW_SLAB;
  const CUtensorMap *w1, *w2;
  unsigned chunks;

  __device__ __forceinline__ void operator()(unsigned i, unsigned char* dst,
                                             uint64_t* bar) const {
    const int r = (int)(i % (2 * KS));
    const int f0 = MC_CHUNK * (int)((i / (2 * KS)) % chunks);
    mbar_expect_tx(bar, SW_SLAB);
    if (r < KS) {
      tma_load_3d(dst, w1, bar, f0, 128 * r, 0);
      tma_load_3d(dst + SW_SLAB / 2, w1, bar, f0, 128 * r + 64, 0);
    } else {
      tma_load_3d(dst, w2, bar, 128 * (r - KS), f0, 0);
      tma_load_3d(dst + SW_SLAB / 2, w2, bar, 128 * (r - KS) + 64, f0, 0);
    }
  }
};

// h chunk += the warpgroup's rows of x (slabs 2 s, 2 s + 1 from the A
// descriptor xd) times one w1 slot w, MN-major.
__device__ __forceinline__ void mc_fc1_slot(float (&f)[32], uint64_t xd, unsigned w, int s) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<1>(f, xd + (((2 * s + ks) * SW_SLAB + kk * 32) >> 4),
                         wg_desc(w + ks * (SW_SLAB / 2) + kk * 2048, SW_SLAB / 2));
}

template <int NT>
__global__ void __launch_bounds__(MC_THREADS, 1)
    mm_chain_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_w2,
                    const __grid_constant__ CUtensorMap map_out, int tiles_per_seg, int chunks,
                    int reps) {
  constexpr int KS = NT / 2;
  using L = McLayout<NT>;
  extern __shared__ unsigned char mc_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(mc_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* xbar = reinterpret_cast<uint64_t*>(xs + L::bars);
  CountRing<L::STAGES, McLoader<KS>> ring;
  ring.place(xs + NT * SW_SLAB, xs + L::bars + 8, (unsigned)(reps * chunks * 2 * KS));
  ring.ld.w1 = &map_w1;
  ring.ld.w2 = &map_w2;
  ring.ld.chunks = (unsigned)chunks;
  const int seg = (int)blockIdx.x / tiles_per_seg;
  const int row0 = ((int)blockIdx.x % tiles_per_seg) * MC_ROWS;
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(xbar, NT * SW_SLAB);
#pragma unroll
    for (int s = 0; s < NT; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tma_load_3d(xs + s * SW_SLAB + h * (SW_SLAB / 2), &map_x, xbar, 64 * s, row0 + 64 * h,
                    seg);
    ring.prime();
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = wg * 64 + warp * 16 + (lane >> 2);    // the thread's first row in the tile
  const uint64_t xd = wg_desc(smem_u32(xs) + wg * 64 * 128, 16);
  mbar_wait(xbar, 0);
  for (int rep = 0; rep < reps; ++rep) {
    float acc[KS][64];
#pragma unroll
    for (int h = 0; h < KS; ++h) {
      acc_zero(acc[h]);
      reg_fence(acc[h]);
    }
    for (int j = 0; j < chunks; ++j) {
      // h chunk = x @ w1 chunk in an m64n64 accumulator; rounded to bf16,
      // its registers become the four k16 A fragments of y's product
      float f[32];
      acc_zero(f);
      reg_fence(f);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        mc_fc1_slot(f, xd, ring.next(), s);
        ring.issued(lane, s == 0);
      }
      ring.drain(lane);
      reg_fence(f);
      unsigned a[4][4];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        a[n8 >> 1][2 * (n8 & 1)] = pack_bf16(f[4 * n8], f[4 * n8 + 1]);          // row g
        a[n8 >> 1][2 * (n8 & 1) + 1] = pack_bf16(f[4 * n8 + 2], f[4 * n8 + 3]);  // row g + 8
      }
#pragma unroll
      for (int h = 0; h < KS; ++h) reg_fence(acc[h]);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const unsigned b = ring.next();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_m64n128k16<1>(acc[s], a[kk], wg_desc(b + kk * 2048, SW_SLAB / 2));
        ring.issued(lane, s == 0);
      }
      ring.drain(lane);
#pragma unroll
      for (int h = 0; h < KS; ++h) reg_fence(acc[h]);
    }
    // x = bf16(f32(x) + y) in place: acc[h][4 j + 2 rh + e] is column
    // 128 h + 8 j + 2 t + e of row lr + 8 rh
#pragma unroll
    for (int h = 0; h < KS; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          unsigned* px =
              reinterpret_cast<unsigned*>(xs + sw_off(lr + 8 * rh, 128 * h + 8 * j + 2 * t));
          const unsigned u = *px;
          const int i = 4 * j + 2 * rh;
          *px = pack_bf16(__fadd_rn(__uint_as_float(u << 16), acc[h][i]),
                          __fadd_rn(__uint_as_float(u & 0xffff0000u), acc[h][i + 1]));
        }
    fence_view_async();
    bar_wg(wg);
  }
  // the warpgroup's 64 rows out, in NT boxes; rows past the segment's end
  // are not written
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int s = 0; s < NT; ++s)
      tma_store_3d(&map_out, xs + s * SW_SLAB + wg * (SW_SLAB / 2), 64 * s, row0 + 64 * wg, seg);
    tma_store_wait();
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int NT>
int launch(const void* x, const void* w1, const void* w2, void* out, int segs, int seg_rows,
           int F, int reps, cudaStream_t s) {
  constexpr int C = 64 * NT;
  static bool configured = false;
  const int tiles = (seg_rows + MC_ROWS - 1) / MC_ROWS;
  const long blocks = (long)segs * tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  CUtensorMap m_x, m_w1, m_w2, m_out;
  if (!encode_map(&m_x, x, C, seg_rows, C, (long)seg_rows * C, segs, 64) ||
      !encode_map(&m_w1, w1, F, C, F, 0, 1, 64) || !encode_map(&m_w2, w2, C, F, C, 0, 1, 64) ||
      !encode_map(&m_out, out, C, seg_rows, C, (long)seg_rows * C, segs, 64))
    return (int)cudaErrorInvalidValue;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(mm_chain_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         McLayout<NT>::total);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  mm_chain_kernel<NT><<<(unsigned)blocks, MC_THREADS, McLayout<NT>::total, s>>>(
      m_x, m_w1, m_w2, m_out, tiles, F / MC_CHUNK, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [segs * seg_rows, C] contiguous bf16 (out may not alias x: a
// block reads only its own rows, but the call keeps its input); w1 [C, F],
// w2 [F, C] contiguous bf16; every base on 16 bytes. C is 128, 256 or 384
// and F a multiple of 64.
extern "C" int ec_mm_chain(const void* x, const void* w1, const void* w2, void* out,
                           int segs, int seg_rows, int C, int F, int reps, void* stream) {
  if (segs <= 0 || seg_rows <= 0 || F <= 0 || F % MC_CHUNK != 0 || reps < 0 ||
      !aligned16(x) || !aligned16(w1) || !aligned16(w2) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch<2>(x, w1, w2, out, segs, seg_rows, F, reps, s);
    case 256: return launch<4>(x, w1, w2, out, segs, seg_rows, F, reps, s);
    case 384: return launch<6>(x, w1, w2, out, segs, seg_rows, F, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
