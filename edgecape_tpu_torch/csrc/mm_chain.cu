// The matmul-chain kernel of edgecape_tpu_torch (ops/mm_chain.py), the
// counterpart of the TPU kernel of scripts/probe_m_fold.py (`run`, body
// `make_kernel` / `_mm_chain`): reps times
//     h = bf16(x @ w1);  y = h @ w2 (fp32);  x = bf16(f32(x) + y)
// per row, x [rows, C] bf16, w1 [C, F], w2 [F, C] bf16, fp32 accumulation.
//
// Bound on this card: operations (4 * rows * C * F * reps against
// 2 * rows * C * 2 bytes of activations and the weights once: hundreds of
// operations per byte). The TPU kernel keeps a whole image group and both
// weights in VMEM; an SM has 227 KB, so here one block owns a tile of 64
// rows for the whole chain:
//   * the x tile [64, C] stays in shared memory from the first step to the
//     last, so x is read once and written once;
//   * F is walked in chunks of 64: h_chunk = bf16(x_tile @ w1[:, chunk])
//     goes to shared memory and is consumed at once by
//     y += h_chunk @ w2[chunk, :], so h never reaches device memory;
//   * y [64, C] fp32 lives in the WMMA accumulators of the 8 warps
//     (2 row halves x 4 column quarters, 2 x C/64 fragments each);
//   * the weight chunks stream from L2 with cp.async: w2's chunk lands
//     while the first product runs, the next w1 chunk while the second.
// The row tiles are cut either inside each image (`loop`: segment = n rows)
// or from the flat rows of a group of images (`fold`: segment = g * n).
// A row's sums over C and over F run in the same order wherever the row
// sits in a tile, so both cuts give the same bits; padded rows are zero.
//
// Plain C interface; the entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for a refused shape), allocates nothing and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TM = 64;         // rows per block
constexpr int FC = 64;         // columns of w1 / rows of w2 per chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int W1_LD = FC + 8;
constexpr int H_LD = FC + 8;
constexpr int HS_LD = FC + 4;  // fp32 staging of one h chunk

template <int NT>              // C = 64 * NT
struct Layout {
  static constexpr int C = 64 * NT;
  static constexpr int X_LD = C + 8;
  static constexpr int W2_LD = C + 8;
  static constexpr int Y_LD = C + 4;
  static constexpr size_t xs = 0;
  static constexpr size_t hs = xs + (size_t)TM * X_LD * 2;
  static constexpr size_t hstage = hs + (size_t)TM * H_LD * 2;
  static constexpr size_t w1s = hstage + (size_t)TM * HS_LD * 4;
  static constexpr size_t w2s = w1s + (size_t)C * W1_LD * 2;
  static constexpr size_t total = w2s + (size_t)FC * W2_LD * 2;
  // after the last chunk of a step the fp32 y tile is staged over the
  // weight buffers
  static_assert((size_t)TM * Y_LD * 4 <= total - w1s, "y staging does not fit");
  static_assert(xs % 128 == 0 && hs % 128 == 0 && hstage % 128 == 0 &&
                w1s % 128 == 0 && w2s % 128 == 0, "buffers must stay aligned");
};

// 8 bf16 values into shared memory: an asynchronous 16-byte copy, or
// zeros for a padded row.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, bool valid) {
  if (valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
mm_chain_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const bf16* __restrict__ w2, bf16* __restrict__ out, int seg_rows,
                int tiles_per_seg, int F, int reps) {
  using L = Layout<NT>;
  constexpr int C = L::C;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + L::xs);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::hs);
  float* hstage = reinterpret_cast<float*>(smem + L::hstage);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L::w1s);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L::w2s);
  float* ystage = reinterpret_cast<float*>(smem + L::w1s);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 1;     // rows 32 * wm .. + 32
  const int wn = warp >> 1;    // columns 16 * NT * wn .. + 16 * NT (second product)
  const int seg = blockIdx.x / tiles_per_seg;
  const int row0 = (blockIdx.x % tiles_per_seg) * TM;
  const int valid = min(TM, seg_rows - row0);
  const long base = ((long)seg * seg_rows + row0) * C;
  const int nchunks = F / FC;

  auto load_w1 = [&](int j) {          // w1[:, j*FC .. +FC] -> w1s [C, FC]
    for (int i = tid; i < C * (FC / 8); i += THREADS) {
      const int r = i / (FC / 8), c8 = (i % (FC / 8)) * 8;
      copy8(&w1s[r * W1_LD + c8], w1 + (long)r * F + j * FC + c8, true);
    }
  };
  auto load_w2 = [&](int j) {          // w2[j*FC .. +FC, :] -> w2s [FC, C]
    for (int i = tid; i < FC * (C / 8); i += THREADS) {
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      copy8(&w2s[r * L::W2_LD + c8], w2 + (long)(j * FC + r) * C + c8, true);
    }
  };

  for (int i = tid; i < TM * (C / 8); i += THREADS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    copy8(&xs[r * L::X_LD + c8], x + base + (long)r * C + c8, r < valid);
  }

  for (int rep = 0; rep < reps; ++rep) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NT];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    load_w1(0);
    cp_async_commit();
    for (int j = 0; j < nchunks; ++j) {
      load_w2(j);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();                 // w1 chunk j (and the x tile) landed

      // h chunk [64, 64] = x tile @ w1 chunk: this warp's rows, columns 16 * wn
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> hc[2];
        wmma::fill_fragment(hc[0], 0.0f);
        wmma::fill_fragment(hc[1], 0.0f);
#pragma unroll 4
        for (int kk = 0; kk < C; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a[0], &xs[(wm * 32) * L::X_LD + kk], L::X_LD);
          wmma::load_matrix_sync(a[1], &xs[(wm * 32 + 16) * L::X_LD + kk], L::X_LD);
          wmma::load_matrix_sync(b, &w1s[kk * W1_LD + wn * 16], W1_LD);
          wmma::mma_sync(hc[0], a[0], b, hc[0]);
          wmma::mma_sync(hc[1], a[1], b, hc[1]);
        }
        wmma::store_matrix_sync(&hstage[(wm * 32) * HS_LD + wn * 16], hc[0], HS_LD,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(&hstage[(wm * 32 + 16) * HS_LD + wn * 16], hc[1], HS_LD,
                                wmma::mem_row_major);
      }
      __syncthreads();                 // w1s is free, the fp32 h chunk is whole
      if (j + 1 < nchunks) load_w1(j + 1);
      cp_async_commit();
      for (int i = tid; i < TM * (FC / 4); i += THREADS) {
        const int r = i / (FC / 4), c4 = (i % (FC / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(&hstage[r * HS_LD + c4]);
        __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(&hs[r * H_LD + c4]);
        d[0] = __floats2bfloat162_rn(v.x, v.y);
        d[1] = __floats2bfloat162_rn(v.z, v.w);
      }
      cp_async_wait<1>();
      __syncthreads();                 // w2 chunk j landed, the bf16 h chunk is whole

      // y += h chunk @ w2 chunk
#pragma unroll
      for (int kk = 0; kk < FC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::load_matrix_sync(a[0], &hs[(wm * 32) * H_LD + kk], H_LD);
        wmma::load_matrix_sync(a[1], &hs[(wm * 32 + 16) * H_LD + kk], H_LD);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, &w2s[kk * L::W2_LD + (wn * NT + jn) * 16], L::W2_LD);
          wmma::mma_sync(acc[0][jn], a[0], b, acc[0][jn]);
          wmma::mma_sync(acc[1][jn], a[1], b, acc[1][jn]);
        }
      }
      __syncthreads();                 // w2s and hs are free
    }
    cp_async_wait<0>();

    // x tile = bf16(f32(x tile) + y), through the fp32 staging
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
        wmma::store_matrix_sync(&ystage[(wm * 32 + i * 16) * L::Y_LD + (wn * NT + jn) * 16],
                                acc[i][jn], L::Y_LD, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < TM * (C / 2); i += THREADS) {
      const int r = i / (C / 2), c2 = (i % (C / 2)) * 2;
      __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(&xs[r * L::X_LD + c2]);
      const float2 xv = __bfloat1622float2(*px);
      const float2 yv = *reinterpret_cast<const float2*>(&ystage[r * L::Y_LD + c2]);
      *px = __floats2bfloat162_rn(xv.x + yv.x, xv.y + yv.y);
    }
    __syncthreads();                   // the staging is free for the next step's w1
  }

  cp_async_wait<0>();                  // reps == 0: the x tile's own copies
  __syncthreads();
  for (int i = tid; i < valid * (C / 8); i += THREADS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(out + base + (long)r * C + c8) =
        *reinterpret_cast<const uint4*>(&xs[r * L::X_LD + c8]);
  }
}

template <int NT>
int launch(const bf16* x, const bf16* w1, const bf16* w2, bf16* out, int segs, int seg_rows,
           int F, int reps, cudaStream_t s) {
  const int tiles = (seg_rows + TM - 1) / TM;
  const long blocks = (long)segs * tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mm_chain_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Layout<NT>::total);
  if (e != cudaSuccess) return (int)e;
  mm_chain_kernel<NT><<<(unsigned)blocks, THREADS, Layout<NT>::total, s>>>(
      x, w1, w2, out, seg_rows, tiles, F, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [segs * seg_rows, C] contiguous bf16 (out may not alias x: a
// block reads only its own rows, but the call keeps its input); w1 [C, F],
// w2 [F, C] contiguous bf16. C is 128, 256 or 384 and F a multiple of 64.
extern "C" int ec_mm_chain(const void* x, const void* w1, const void* w2, void* out,
                           int segs, int seg_rows, int C, int F, int reps, void* stream) {
  if (segs <= 0 || seg_rows <= 0 || F <= 0 || F % FC != 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const bf16* px = static_cast<const bf16*>(x);
  const bf16* p1 = static_cast<const bf16*>(w1);
  const bf16* p2 = static_cast<const bf16*>(w2);
  bf16* po = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch<2>(px, p1, p2, po, segs, seg_rows, F, reps, s);
    case 256: return launch<4>(px, p1, p2, po, segs, seg_rows, F, reps, s);
    case 384: return launch<6>(px, p1, p2, po, segs, seg_rows, F, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
