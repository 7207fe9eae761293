// Hand-written Hopper kernels of edgecape_tpu_torch: the building blocks
// of the four eval-path ops (ops/fused_vit_block.py, ops/fused_encoder.py,
// ops/fused_decoder.py, ops/flash_attention.py flash_mha) and the
// forward / backward pair of the training attention
// (ops/flash_attention.py flash_mha_train).
//
// Each TPU kernel of the JAX package becomes a short chain of these
// launches, with the TPU kernel's rounding points kept:
//   * ec_gemm       tiled bf16 GEMM, fp32 accumulation, strided-batched,
//                   with a fused epilogue (bias, pre-activation add,
//                   exact-erf GELU / ReLU, fp32 LayerScale residual, bf16
//                   or fp32 store). Two mainloops: 128x128x64 tiles loaded
//                   by TMA into swizzled shared memory and multiplied by
//                   wgmma with the epilogue applied to the accumulator
//                   registers, and, for operands a tensor map cannot
//                   describe, tiles copied by the threads (cp.async) and
//                   multiplied by WMMA;
//   * ec_layernorm  row LayerNorm of any width with fp32 statistics and an
//                   optional residual input, fp32 and/or bf16 outputs, its
//                   sums in the order vit_mlp_kernel's epilogue shares;
//   * ec_vit_mlp    the ViT MLP half as one kernel: y = x + ls * (bf16(
//                   gelu(bf16(LN(x)) . W1 + b1)) . W2 + b2), the hidden on
//                   chip, optionally the next block's bf16 LN(bf16(y));
//   * ec_vit_qkv, ec_vit_attn  the ViT attention half as two kernels:
//                   q | k | v = bf16(bf16(LN(bf16(x))) . Wqkv^T + b), then
//                   attention over all keys of a row in one pass, the
//                   projection and the LayerScale residual, h and the
//                   attention output kept on chip;
//   * ec_attention  short-sequence attention on mma.sync tensor-core
//                   tiles with every score kept in registers: a warp per
//                   16-row query tile, query tiles split over blocks,
//                   cp.async keys and values, the bool key mask read in
//                   the kernel, optional [B, H, Nq, Nk] fp32 bias read,
//                   fp32 softmax, P rounded to bf16 before P.V, output
//                   rounded to bf16;
//   * ec_add_pos    src = bf16(bf16(x) + pos) for the joint encoder;
//   * ec_sine_feats, ec_bias_attention, ec_kpt_head  the decoder stack's
//                   own kernels (ops/fused_decoder.py fused_decoder_stack):
//                   coordinates to bf16 sine features; the self-attention
//                   with the Markov bias formed once for all heads from
//                   the bf16 hop stack; the final norm, both kpt_branch
//                   passes and the sigmoid coordinate update as one kernel;
//   * ec_attn_train_fwd / ec_attn_train_bwd  the differentiable attention
//                   of the training step with key mask, [B, H, Nq, Nk]
//                   bias and Philox dropout on the probabilities (see
//                   "training attention" below); ec_dropout_mask writes
//                   the keep mask they draw.
//
// Plain C interface, loaded with ctypes; every entry point returns
// cudaGetLastError() (or cudaErrorInvalidValue for a refused shape).
// Nothing allocates or synchronises: the Python wrappers own the buffers
// and the stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attention.cuh"

using namespace nvcuda;

enum { ACT_NONE = 0, ACT_GELU = 1, ACT_RELU = 2 };

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------ GEMM
// C[z] = epilogue(A[z] @ op(B[z])), A [M, K] bf16 row-major (row stride
// lda), B either [N, K] (torch Linear weight, b_nk = 1) or [K, N]
// (b_nk = 0), row stride ldb. z is the batch index (grid.z); a batch
// stride of 0 shares the operand across the batch.
//
// epilogue: y = acc + bias[n] + pre[m, n]; y = act(y);
//           y = res[m, n] + ls[n] * y (when res is given; ls may be null);
//           C[m, n] = y as fp32 or bf16.
//
// Two mainloops compute it. gemm_kernel (below) copies its tiles with
// every thread's cp.async and multiplies them with WMMA; it takes any
// operand. gemm_tma_kernel (further down) is the one the paths' large
// GEMMs run; it needs operands that a tensor map can describe. The
// caller names the mainloop (ops/kernels.py gemm_mainloop) and ec_gemm
// refuses the TMA one for operands it cannot take.

#define GBM 128
#define GBN 128
#define GBK 64
#define GSTAGES 2          // k-tiles in flight
#define GTHREADS 256       // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each
#define A_LD (GBK + 8)
#define BNK_LD (GBK + 8)
#define BKN_LD (GBN + 8)
#define C_LD (GBN + 4)
#define A_STAGE (GBM * A_LD)
#define B_STAGE (GBN * BNK_LD > GBK * BKN_LD ? GBN * BNK_LD : GBK * BKN_LD)
#define GEMM_PIPE_BYTES (GSTAGES * (A_STAGE + B_STAGE) * 2)
#define GEMM_C_BYTES (GBM * C_LD * 4)
#define GEMM_SMEM (GEMM_PIPE_BYTES > GEMM_C_BYTES ? GEMM_PIPE_BYTES : GEMM_C_BYTES)

struct GemmArgs {
  const bf16* A; long lda, sA;
  const bf16* B; long ldb, sB;
  void* C; long ldc, sC; int c_dt;
  int M, N, K;
  const float* bias;
  const void* pre; int pre_dt; long ldpre, sPre;
  int act;
  const void* res; int res_dt; long ldres, sRes;
  const float* ls;
};

// One k-tile of A and B into stage buffers As / Bs.
template <bool B_NK>
__device__ __forceinline__ void gemm_load_tile(const GemmArgs& p, const bf16* A,
                                               const bf16* B, int m0, int n0, int k0,
                                               bf16* As, bf16* Bs) {
  const int tid = threadIdx.x;
  for (int c = tid; c < GBM * GBK / 8; c += GTHREADS) {
    const int r = c / (GBK / 8), kc = (c % (GBK / 8)) * 8;
    const int gm = m0 + r, gk = k0 + kc;
    copy8(&As[r * A_LD + kc], A + (long)gm * p.lda + gk, gm < p.M ? min(8, p.K - gk) : 0);
  }
  if constexpr (B_NK) {
    for (int c = tid; c < GBN * GBK / 8; c += GTHREADS) {
      const int r = c / (GBK / 8), kc = (c % (GBK / 8)) * 8;
      const int gn = n0 + r, gk = k0 + kc;
      copy8(&Bs[r * BNK_LD + kc], B + (long)gn * p.ldb + gk, gn < p.N ? min(8, p.K - gk) : 0);
    }
  } else {
    for (int c = tid; c < GBK * GBN / 8; c += GTHREADS) {
      const int r = c / (GBN / 8), nc = (c % (GBN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      copy8(&Bs[r * BKN_LD + nc], B + (long)gk * p.ldb + gn, gk < p.K ? min(8, p.N - gn) : 0);
    }
  }
}

// 128 x 128 output tile per block, k in steps of GBK, GSTAGES k-tiles of
// copies in flight while the oldest is multiplied.
template <bool B_NK>
__global__ void __launch_bounds__(GTHREADS) gemm_kernel(GemmArgs p) {
  extern __shared__ __align__(128) unsigned char gsmem[];
  bf16* As0 = reinterpret_cast<bf16*>(gsmem);
  bf16* Bs0 = As0 + GSTAGES * A_STAGE;
  float* Cs = reinterpret_cast<float*>(gsmem);     // after the k loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const long z = blockIdx.z;
  const bf16* A = p.A + z * p.sA;
  const bf16* B = p.B + z * p.sB;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (p.K + GBK - 1) / GBK;
#pragma unroll
  for (int st = 0; st < GSTAGES - 1; ++st) {
    if (st < nk)
      gemm_load_tile<B_NK>(p, A, B, m0, n0, st * GBK, As0 + st * A_STAGE,
                           Bs0 + st * B_STAGE);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();     // tile kt landed; tile kt-1's stage is free
    const int next = kt + GSTAGES - 1;
    if (next < nk)
      gemm_load_tile<B_NK>(p, A, B, m0, n0, next * GBK,
                           As0 + (next % GSTAGES) * A_STAGE,
                           Bs0 + (next % GSTAGES) * B_STAGE);
    cp_async_commit();
    const bf16* As = As0 + (kt % GSTAGES) * A_STAGE;
    const bf16* Bs = Bs0 + (kt % GSTAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * 64 + i * 16) * A_LD + kk], A_LD);
      if constexpr (B_NK) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[j], &Bs[(wn * 32 + j * 16) * BNK_LD + kk], BNK_LD);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[j], &Bs[kk * BKN_LD + wn * 32 + j * 16], BKN_LD);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();       // every warp is done with the stages before Cs

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 64 + i * 16) * C_LD + wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  // epilogue: each thread takes runs of 8 columns of one row
  for (int e = tid; e < GBM * (GBN / 8); e += GTHREADS) {
    const int r = e / (GBN / 8), c = (e % (GBN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= p.M || gn >= p.N) continue;
    const int cnt = min(8, p.N - gn);
    float y[8];
    const float4 lo = *reinterpret_cast<const float4*>(&Cs[r * C_LD + c]);
    const float4 hi = *reinterpret_cast<const float4*>(&Cs[r * C_LD + c + 4]);
    y[0] = lo.x; y[1] = lo.y; y[2] = lo.z; y[3] = lo.w;
    y[4] = hi.x; y[5] = hi.y; y[6] = hi.z; y[7] = hi.w;
    const long pre_off = z * p.sPre + (long)gm * p.ldpre + gn;
    const long res_off = z * p.sRes + (long)gm * p.ldres + gn;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i >= cnt) break;
      float v = y[i];
      if (p.bias) v += p.bias[gn + i];
      if (p.pre) v += ld_val(p.pre, p.pre_dt, pre_off + i);
      if (p.act == ACT_GELU) {
        v = 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
      } else if (p.act == ACT_RELU) {
        v = fmaxf(v, 0.0f);
      }
      if (p.res) v = ld_val(p.res, p.res_dt, res_off + i) + (p.ls ? p.ls[gn + i] : 1.0f) * v;
      y[i] = v;
    }
    const long off = z * p.sC + (long)gm * p.ldc + gn;
    if (p.c_dt == DT_BF16) {
      bf16* dst = static_cast<bf16*>(p.C) + off;
      if (cnt == 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        __align__(16) bf16 pack[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pack[i] = __float2bfloat16(y[i]);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(pack);
      } else {
        for (int i = 0; i < cnt; ++i) dst[i] = __float2bfloat16(y[i]);
      }
    } else {
      float* dst = static_cast<float*>(p.C) + off;
      if (cnt == 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(y[0], y[1], y[2], y[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(y[4], y[5], y[6], y[7]);
      } else {
        for (int i = 0; i < cnt; ++i) dst[i] = y[i];
      }
    }
  }
}

// ------------------------------------------------- GEMM: TMA + wgmma mainloop
// What bounds the paths' GEMMs on this card: at K = 256..384 and N up to
// 1536 a GEMM of the eval chunk reads and writes about as many bytes as
// the tensor cores need time for its products (M = 131070, N = 1152,
// K = 384: 0.12 ms of traffic, 0.12 ms of products), so neither the loads
// nor the stores may cost the threads anything. The thread-copied
// mainloop above spends its instruction slots on address arithmetic, bounds
// checks and a round trip of the accumulators through shared memory. The
// design here:
//   * one producer warp asks the Tensor Memory Accelerator for whole
//     128 x 64 tiles of A and B (cp.async.bulk.tensor, three-dimensional
//     maps: k or n, row, batch) into 128-byte-swizzled shared memory, three
//     stages deep, each stage with a "full" mbarrier that the copy
//     completes and an "empty" one that the consumers release. Rows and
//     columns beyond M, N or K are zero-filled by the hardware, so ragged
//     edges cost nothing in the loop.
//   * two consumer warpgroups (64 rows each) multiply with
//     wgmma.mma_async m64n128k16 straight from shared memory through
//     matrix descriptors (B as [N, K] is K-major; B as [K, N] is loaded
//     as two 64-column boxes and read MN-major through the descriptor's
//     transpose bit), one group of wgmma in flight while the next stage is
//     awaited, fp32 accumulators in 64 registers a thread.
//   * the epilogue runs on the accumulator registers in wgmma's own
//     layout (thread (warp w, lane 4g + t) holds rows 16w + g and + 8,
//     column pairs 8j + 2t): bias, pre, activation, residual and
//     LayerScale are applied there and the pairs stored straight to C.
//   * 288 threads and 97 KB of shared memory a block: two blocks share an
//     SM (112 registers a thread, no setmaxnreg needed at this tile
//     size), so one block's epilogue runs under the other's mainloop. The
//     grid is persistent (two blocks an SM walk the tiles, N fastest, so
//     an A tile is read from L2 by its neighbours), which saves the launch
//     of 9000 blocks a call and lets the producer load the next tile under
//     the epilogue.
// Measured on an H100 (tools/bench_gemm.py): two other schedules of the
// same mainloop, one block an SM with the warpgroups taking tiles in turn
// (6 stages) and one block an SM with a 256 x 128 tile (4 stages), came
// within 3% of this one at the eval shapes and were slower at small M.
// The maps are encoded per call on the host (cuTensorMapEncodeTiled,
// fetched through the runtime, so nothing links against libcuda
// itself) and passed as __grid_constant__ parameters.

#define TG_BM 128
#define TG_BN 128
#define TG_BK 64
#define TG_STAGES 3
#define TG_THREADS 288      // two consumer warpgroups and the producer warp
#define TG_A_BYTES (TG_BM * TG_BK * 2)
#define TG_B_BYTES (TG_BN * TG_BK * 2)
#define TG_STAGE_BYTES (TG_A_BYTES + TG_B_BYTES)
// the stages (aligned to 1024 bytes in the kernel), then the barriers
#define TG_SMEM (TG_STAGES * TG_STAGE_BYTES + 1024 + 2 * TG_STAGES * 8)
#define TG_MIN_N 32         // narrower outputs take the thread-copy loader

// Two neighbouring values of an epilogue operand (fp32 or bf16) at element
// offset `off`, through the read-only path (so that the compiler may
// start the epilogue's loads ahead of its stores): one load when `vec`
// says base and strides keep the pair aligned; `two`: the second value
// exists.
__device__ __forceinline__ void ld_pair(const void* p, int dt, long off, bool vec, bool two,
                                        float& a, float& b) {
  if (dt == DT_F32) {
    const float* f = static_cast<const float*>(p) + off;
    if (vec && two) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(f));
      a = v.x; b = v.y;
    } else {
      a = __ldg(f);
      b = two ? __ldg(f + 1) : 0.0f;
    }
  } else {
    const bf16* h = static_cast<const bf16*>(p) + off;
    if (vec && two) {
      const unsigned v = __ldg(reinterpret_cast<const unsigned*>(h));
      a = __uint_as_float(v << 16);          // a bf16 is the top half of a float
      b = __uint_as_float(v & 0xffff0000u);
    } else {
      const unsigned short* u = reinterpret_cast<const unsigned short*>(h);
      a = __uint_as_float((unsigned)__ldg(u) << 16);
      b = two ? __uint_as_float((unsigned)__ldg(u + 1) << 16) : 0.0f;
    }
  }
}

// Is a pair at an even element offset from `p` aligned, whatever the row
// and the batch? (2 bf16 = 4 bytes, 2 fp32 = 8 bytes)
__device__ __forceinline__ bool pair_aligned(const void* p, int dt, long ld, long sz) {
  const uintptr_t bytes = dt == DT_F32 ? 8 : 4;
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0 && ld % 2 == 0 && sz % 2 == 0;
}

// The epilogue of a tile that lies whole inside N, with every operand
// pair-aligned: straight-line code, so the loads of a step are started
// eight pairs at a time and nothing waits on a bounds check. Rows beyond M
// load row M - 1 (and are not stored).
template <bool F32>
__device__ __forceinline__ void epi_add_rows(float (&acc)[64], const void* base, long off0,
                                             long off1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long off = half ? off1 : off0;
#pragma unroll
    for (int jb = 0; jb < TG_BN / 8; jb += 8) {
      float2 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (F32) {
          v[j] = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(base) + off
                                                       + 8 * (jb + j)));
        } else {
          const unsigned u = __ldg(reinterpret_cast<const unsigned*>(
              static_cast<const bf16*>(base) + off + 8 * (jb + j)));
          v[j] = make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * (jb + j) + 2 * half] += v[j].x;
        acc[4 * (jb + j) + 2 * half + 1] += v[j].y;
      }
    }
  }
}

// acc (+ or *)= vec[col] for a per-column fp32 vector, both rows.
template <bool MUL>
__device__ __forceinline__ void epi_columns(float (&acc)[64], const float* vec) {
#pragma unroll
  for (int jb = 0; jb < TG_BN / 8; jb += 8) {
    float2 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldg(reinterpret_cast<const float2*>(vec + 8 * (jb + j)));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* a = &acc[4 * (jb + j)];
      if constexpr (MUL) {
        a[0] *= v[j].x; a[1] *= v[j].y; a[2] *= v[j].x; a[3] *= v[j].y;
      } else {
        a[0] += v[j].x; a[1] += v[j].y; a[2] += v[j].x; a[3] += v[j].y;
      }
    }
  }
}

__device__ __forceinline__ void epi_activation(float (&acc)[64], int act) {
  if (act == ACT_GELU) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = 0.5f * acc[i] * (1.0f + erff(acc[i] * 0.70710678118654752f));
  } else if (act == ACT_RELU) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = fmaxf(acc[i], 0.0f);
  }
}

__device__ __forceinline__ void gemm_epilogue_full(float (&acc)[64], const GemmArgs& p, int z,
                                                   int row0, int col0) {
  const int r0 = min(row0, p.M - 1), r1 = min(row0 + 8, p.M - 1);
  if (p.bias) epi_columns<false>(acc, p.bias + col0);
  if (p.pre) {
    const long b = (long)z * p.sPre + col0;
    if (p.pre_dt == DT_F32)
      epi_add_rows<true>(acc, p.pre, b + (long)r0 * p.ldpre, b + (long)r1 * p.ldpre);
    else
      epi_add_rows<false>(acc, p.pre, b + (long)r0 * p.ldpre, b + (long)r1 * p.ldpre);
  }
  epi_activation(acc, p.act);
  if (p.res) {
    if (p.ls) epi_columns<true>(acc, p.ls + col0);
    const long b = (long)z * p.sRes + col0;
    if (p.res_dt == DT_F32)
      epi_add_rows<true>(acc, p.res, b + (long)r0 * p.ldres, b + (long)r1 * p.ldres);
    else
      epi_add_rows<false>(acc, p.res, b + (long)r0 * p.ldres, b + (long)r1 * p.ldres);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row0 + 8 * half >= p.M) continue;
    const long off = (long)z * p.sC + (long)(row0 + 8 * half) * p.ldc + col0;
    if (p.c_dt == DT_BF16) {
      unsigned* c = reinterpret_cast<unsigned*>(static_cast<bf16*>(p.C) + off);
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j)
        c[4 * j] = pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    } else {
      float2* c = reinterpret_cast<float2*>(static_cast<float*>(p.C) + off);
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j)
        c[4 * j] = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// The epilogue of any tile: every column and pair is checked.
__device__ __forceinline__ void gemm_epilogue_edge(float (&acc)[64], const GemmArgs& p, int z,
                                                   int row0, int col0) {
  const bool vec_n = (reinterpret_cast<uintptr_t>(p.bias) & 7) == 0 &&
                     (reinterpret_cast<uintptr_t>(p.ls) & 7) == 0;
  if (p.bias) {
#pragma unroll
    for (int j = 0; j < TG_BN / 8; ++j) {
      const int gn = col0 + 8 * j;
      if (gn >= p.N) continue;
      float a, b;
      ld_pair(p.bias, DT_F32, gn, vec_n, gn + 1 < p.N, a, b);
      acc[4 * j] += a; acc[4 * j + 1] += b;
      acc[4 * j + 2] += a; acc[4 * j + 3] += b;
    }
  }
  if (p.pre) {
    const bool vec = pair_aligned(p.pre, p.pre_dt, p.ldpre, p.sPre);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = row0 + 8 * half;
      if (gm >= p.M) continue;
      const long row = (long)z * p.sPre + (long)gm * p.ldpre;
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j) {
        const int gn = col0 + 8 * j;
        if (gn >= p.N) continue;
        float a, b;
        ld_pair(p.pre, p.pre_dt, row + gn, vec, gn + 1 < p.N, a, b);
        acc[4 * j + 2 * half] += a; acc[4 * j + 2 * half + 1] += b;
      }
    }
  }
  epi_activation(acc, p.act);
  if (p.res) {
    if (p.ls) {
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j) {
        const int gn = col0 + 8 * j;
        if (gn >= p.N) continue;
        float a, b;
        ld_pair(p.ls, DT_F32, gn, vec_n, gn + 1 < p.N, a, b);
        acc[4 * j] *= a; acc[4 * j + 1] *= b;
        acc[4 * j + 2] *= a; acc[4 * j + 3] *= b;
      }
    }
    const bool vec = pair_aligned(p.res, p.res_dt, p.ldres, p.sRes);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = row0 + 8 * half;
      if (gm >= p.M) continue;
      const long row = (long)z * p.sRes + (long)gm * p.ldres;
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j) {
        const int gn = col0 + 8 * j;
        if (gn >= p.N) continue;
        float a, b;
        ld_pair(p.res, p.res_dt, row + gn, vec, gn + 1 < p.N, a, b);
        acc[4 * j + 2 * half] += a; acc[4 * j + 2 * half + 1] += b;
      }
    }
  }
  const bool c_vec = pair_aligned(p.C, p.c_dt, p.ldc, p.sC);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gm = row0 + 8 * half;
    if (gm >= p.M) continue;
    const long row = (long)z * p.sC + (long)gm * p.ldc;
#pragma unroll
    for (int j = 0; j < TG_BN / 8; ++j) {
      const int gn = col0 + 8 * j;
      if (gn >= p.N) continue;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (c_vec && gn + 1 < p.N) {
        if (p.c_dt == DT_BF16) {
          *reinterpret_cast<unsigned*>(static_cast<bf16*>(p.C) + row + gn) =
              pack_bf16(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(p.C) + row + gn) =
              make_float2(v0, v1);
        }
      } else {
        st_val(p.C, p.c_dt, row + gn, v0);
        if (gn + 1 < p.N) st_val(p.C, p.c_dt, row + gn + 1, v1);
      }
    }
  }
}

// A persistent grid: block x takes the output tiles x, x + gridDim.x, ...,
// numbered with N fastest, then M, then the batch. The k-tile count `it`
// runs on across a block's tiles, so the stages and their barriers' phases
// carry over and the producer loads the next tile under the epilogue.
//
// SLABS (ec_gemm's mainloop 2, the split route's long products above 512
// channels): wgmma rounds each 16-deep step of its sum toward zero, so one
// accumulator over a K of 1024-2048 drifts by tens of ulps and flips more
// bf16 roundings of the output than fp32 sums do (csrc/kpt_wide.cu found
// the same at 512). There each 64-deep k tile goes into a fresh
// accumulator, added into an fp32 sum on the CUDA cores once its products
// are done; the 64 more registers a thread leave one block an SM.
template <bool B_NK, bool SLABS>
__global__ void __launch_bounds__(TG_THREADS, SLABS ? 1 : 2)
    gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, GemmArgs p, int batch) {
  extern __shared__ unsigned char tg_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tg_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + TG_STAGES * TG_STAGE_BYTES);
  uint64_t* empty = full + TG_STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (p.K + TG_BK - 1) / TG_BK;
  const int tiles_n = (p.N + TG_BN - 1) / TG_BN, tiles_m = (p.M + TG_BM - 1) / TG_BM;
  const long total = (long)tiles_n * tiles_m * batch;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < TG_STAGES; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrive; the copies add bytes
      mbar_init(&empty[s], 8);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: one lane keeps TG_STAGES tiles of copies in flight
    if (lane == 0) {
      unsigned it = 0;
      for (long tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int n0 = (int)(tile % tiles_n) * TG_BN;
        const int m0 = (int)(tile / tiles_n % tiles_m) * TG_BM;
        const int z = (int)(tile / tiles_n / tiles_m);
        const int za = p.sA ? z : 0, zb = p.sB ? z : 0;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const unsigned s = it % TG_STAGES;
          if (it >= TG_STAGES) mbar_wait(&empty[s], ((it / TG_STAGES) - 1) & 1);
          unsigned char* As = tiles + s * TG_STAGE_BYTES;
          unsigned char* Bs = As + TG_A_BYTES;
          mbar_expect_tx(&full[s], TG_STAGE_BYTES);
          tma_load_3d(As, &map_a, &full[s], kt * TG_BK, m0, za);
          if constexpr (B_NK) {
            tma_load_3d(Bs, &map_b, &full[s], kt * TG_BK, n0, zb);
          } else {
            tma_load_3d(Bs, &map_b, &full[s], n0, kt * TG_BK, zb);
            tma_load_3d(Bs + TG_B_BYTES / 2, &map_b, &full[s], n0 + 64, kt * TG_BK, zb);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  // the straight-line epilogue needs every operand's pairs aligned
  const bool aligned = pair_aligned(p.C, p.c_dt, p.ldc, p.sC) &&
                       (reinterpret_cast<uintptr_t>(p.bias) & 7) == 0 &&
                       (reinterpret_cast<uintptr_t>(p.ls) & 7) == 0 &&
                       (!p.pre || pair_aligned(p.pre, p.pre_dt, p.ldpre, p.sPre)) &&
                       (!p.res || pair_aligned(p.res, p.res_dt, p.ldres, p.sRes));
  unsigned it = 0;
  for (long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int n0 = (int)(tile % tiles_n) * TG_BN;
    const int m0 = (int)(tile / tiles_n % tiles_m) * TG_BM;
    const int z = (int)(tile / tiles_n / tiles_m);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    float sum[SLABS ? 64 : 1];     // SLABS: the k tiles' fp32 sum
#pragma unroll
    for (int i = 0; i < (SLABS ? 64 : 1); ++i) sum[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const unsigned s = it % TG_STAGES;
      mbar_wait(&full[s], (it / TG_STAGES) & 1);
      const unsigned a_base = smem_u32(tiles + s * TG_STAGE_BYTES) + wg * 64 * 128;
      const unsigned b_base = smem_u32(tiles + s * TG_STAGE_BYTES + TG_A_BYTES);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TG_BK / 16; ++kk) {
        const uint64_t da = wg_desc(a_base + kk * 32, 16);
        const int keep = SLABS ? (kk > 0) : 1;     // SLABS: a fresh sum a tile
        if constexpr (B_NK) {
          wgmma_m64n128k16<0>(acc, da, wg_desc(b_base + kk * 32, 16), keep);
        } else {
          wgmma_m64n128k16<1>(acc, da, wg_desc(b_base + kk * 2048, TG_B_BYTES / 2), keep);
        }
      }
      wg_commit();
      wg_wait<0>();              // the stage is read: hand it back to the producer
      if (lane == 0) mbar_arrive(&empty[s]);
      if constexpr (SLABS) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }
    }
    if constexpr (SLABS) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = sum[i];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // the epilogue on the accumulator registers: this thread's rows row0
    // and row0 + 8, column pairs col0 + 8 j
    const int row0 = m0 + wg * 64 + (warp & 3) * 16 + g;
    const int col0 = n0 + 2 * t;
    if (aligned && n0 + TG_BN <= p.N) {
      gemm_epilogue_full(acc, p, z, row0, col0);
    } else {
      gemm_epilogue_edge(acc, p, z, row0, col0);
    }
  }
}

// Can a tensor map describe a bf16 operand with this base, row stride and
// batch stride (both in elements)? 16-byte alignment of all three.
static bool tma_operand_ok(const void* ptr, long ld, long sz, int batch) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && ld > 0 && ld % 8 == 0 &&
         (batch == 1 || (sz >= 0 && sz % 8 == 0));
}

template <bool B_NK, bool SLABS>
static int launch_gemm_tma(const GemmArgs& p, int batch, cudaStream_t s) {
  static bool configured = false;
  if (p.N < TG_MIN_N || !tma_operand_ok(p.A, p.lda, p.sA, batch) ||
      !tma_operand_ok(p.B, p.ldb, p.sB, batch))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!encode_map(&map_a, p.A, p.K, p.M, p.lda, p.sA, batch, TG_BM))
    return (int)cudaErrorInvalidValue;
  if (!(B_NK ? encode_map(&map_b, p.B, p.K, p.N, p.ldb, p.sB, batch, TG_BN)
             : encode_map(&map_b, p.B, p.N, p.K, p.ldb, p.sB, batch, TG_BK)))
    return (int)cudaErrorInvalidValue;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gemm_tma_kernel<B_NK, SLABS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, TG_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  static int slots = 0;       // blocks the card holds at once, two an SM
  if (!slots) {                // (one with SLABS)
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
    slots = (SLABS ? 1 : 2) * sms;
  }
  const long total = (long)((p.N + TG_BN - 1) / TG_BN) * ((p.M + TG_BM - 1) / TG_BM) * batch;
  const unsigned grid = (unsigned)(total < slots ? total : slots);
  gemm_tma_kernel<B_NK, SLABS><<<grid, TG_THREADS, TG_SMEM, s>>>(map_a, map_b, p, batch);
  return (int)cudaGetLastError();
}

template <bool B_NK>
static int launch_gemm_copy(const GemmArgs& p, int batch, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gemm_kernel<B_NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((p.N + GBN - 1) / GBN, (p.M + GBM - 1) / GBM, batch);
  gemm_kernel<B_NK><<<grid, GTHREADS, GEMM_SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

// mainloop: 0 the thread-copy loader with WMMA, 1 TMA with wgmma, 2 the same
// summing each 64-deep k tile apart (SLABS; 1 and 2 refused with
// cudaErrorInvalidValue for operands a tensor map cannot describe).
extern "C" int ec_gemm(const void* A, long lda, long sA,
                       const void* B, long ldb, long sB, int b_nk,
                       void* C, long ldc, long sC, int c_dt,
                       int M, int N, int K, int batch,
                       const void* bias,
                       const void* pre, int pre_dt, long ldpre, long sPre,
                       int act,
                       const void* res, int res_dt, long ldres, long sRes,
                       const void* ls, int mainloop, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0 || (M + GBM - 1) / GBM > 65535 ||
      batch > 65535 || mainloop < 0 || mainloop > 2)
    return (int)cudaErrorInvalidValue;
  GemmArgs p;
  p.A = static_cast<const bf16*>(A); p.lda = lda; p.sA = sA;
  p.B = static_cast<const bf16*>(B); p.ldb = ldb; p.sB = sB;
  p.C = C; p.ldc = ldc; p.sC = sC; p.c_dt = c_dt;
  p.M = M; p.N = N; p.K = K;
  p.bias = static_cast<const float*>(bias);
  p.pre = pre; p.pre_dt = pre_dt; p.ldpre = ldpre; p.sPre = sPre;
  p.act = act;
  p.res = res; p.res_dt = res_dt; p.ldres = ldres; p.sRes = sRes;
  p.ls = static_cast<const float*>(ls);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mainloop == 1)
    return b_nk ? launch_gemm_tma<true, false>(p, batch, s)
                : launch_gemm_tma<false, false>(p, batch, s);
  if (mainloop == 2)
    return b_nk ? launch_gemm_tma<true, true>(p, batch, s)
                : launch_gemm_tma<false, true>(p, batch, s);
  return b_nk ? launch_gemm_copy<true>(p, batch, s) : launch_gemm_copy<false>(p, batch, s);
}

// ------------------------------------------------------------- LayerNorm
// One warp per row of any C: y = LN(x + r) * gamma + beta with fp32 mean
// and (two-pass) variance; writes fp32 and/or bf16 rows (each with its
// own row stride). It replaces no TPU kernel by itself: it is the
// residual + LayerNorm step of the post-attention work of
// edgecape_tpu/ops/fused_encoder.py _run and fused_decoder.py
// fused_decoder_layer / _stack_chunk above 512 channels (the split route,
// ops/kernels.py post_plan), between the GEMMs that take the products.
// Bound: bytes (a row read once, written once or twice).
//
// One summation order, shared with vit_mlp_kernel's epilogue (a quad of
// threads a row there) so that the two give the same bits: lane l = 4 v +
// t holds the columns 64 k + 2 l + e (k ascending, then e < 2) and sums
// them in that order; the 32 partial sums meet in the butterfly of lanes
// 16, 8, 4, 2 and 1 apart (warp_sum). Every step is rounded on its own
// (the _rn intrinsics), so that the compiler contracts nothing
// differently in the two kernels (the steps: hopper.cuh ln_mean, ln_inv,
// ln_sq, ln_apply; vit_wide.cu sums in the same order).
//
// Up to 32 * LN_MAXV = 512 channels a lane keeps its values in registers;
// above, the same three passes (sum, squares, apply) loop over the 64-
// column groups and read the row again in each (from L1 / L2), forming
// each value as the first pass did, so the order and the bits are the
// register form's at any C.

#define LN_MAXV 16

__device__ __forceinline__ float ln_in(const void* x, int x_dt, long xo, const void* r,
                                       int r_dt, long ro) {
  float t = ld_val(x, x_dt, xo);
  if (r) t = __fadd_rn(t, ld_val(r, r_dt, ro));
  return t;
}

__global__ void layernorm_kernel(const void* x, int x_dt, long ldx,
                                 const void* r, int r_dt, long ldr,
                                 const float* gamma, const float* beta,
                                 float eps, float* of, long ldof,
                                 bf16* ob, long ldob, int rows, int C) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  if (C > 32 * LN_MAXV) {
    const int n = 2 * ((C + 63) / 64);
    float s = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int c = 64 * (i >> 1) + 2 * lane + (i & 1);
      if (c < C) s = __fadd_rn(s, ln_in(x, x_dt, row * ldx + c, r, r_dt, row * ldr + c));
    }
    const float mean = ln_mean(warp_sum(s), C);
    float q = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int c = 64 * (i >> 1) + 2 * lane + (i & 1);
      if (c < C) q = ln_sq(q, ln_in(x, x_dt, row * ldx + c, r, r_dt, row * ldr + c), mean);
    }
    const float inv = ln_inv(warp_sum(q), C, eps);
    for (int i = 0; i < n; ++i) {
      const int c = 64 * (i >> 1) + 2 * lane + (i & 1);
      if (c < C) {
        const float y = ln_apply(ln_in(x, x_dt, row * ldx + c, r, r_dt, row * ldr + c), mean,
                                 inv, gamma[c], beta[c]);
        if (of) of[row * ldof + c] = y;
        if (ob) ob[row * ldob + c] = __float2bfloat16(y);
      }
    }
    return;
  }
  float v[LN_MAXV];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = 64 * (i >> 1) + 2 * lane + (i & 1);
    v[i] = 0.0f;
    if (c < C) {
      const float t = ln_in(x, x_dt, row * ldx + c, r, r_dt, row * ldr + c);
      v[i] = t;
      s = __fadd_rn(s, t);
    }
  }
  const float mean = ln_mean(warp_sum(s), C);
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = 64 * (i >> 1) + 2 * lane + (i & 1);
    if (c < C) q = ln_sq(q, v[i], mean);
  }
  const float inv = ln_inv(warp_sum(q), C, eps);
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int c = 64 * (i >> 1) + 2 * lane + (i & 1);
    if (c < C) {
      const float y = ln_apply(v[i], mean, inv, gamma[c], beta[c]);
      if (of) of[row * ldof + c] = y;
      if (ob) ob[row * ldob + c] = __float2bfloat16(y);
    }
  }
}

extern "C" int ec_layernorm(const void* x, int x_dt, long ldx,
                            const void* r, int r_dt, long ldr,
                            const void* gamma, const void* beta, float eps,
                            void* of, long ldof, void* ob, long ldob,
                            int rows, int C, void* stream) {
  if (C <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long blocks = ((long)rows * 32 + threads - 1) / threads;
  layernorm_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_dt, ldx, r, r_dt, ldr, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps, static_cast<float*>(of), ldof,
      static_cast<bf16*>(ob), ldob, rows, C);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- add position
__global__ void add_pos_kernel(const void* x, int x_dt, const bf16* pos,
                               bf16* out, long row_elems, long total) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const float a = __bfloat162float(__float2bfloat16(ld_val(x, x_dt, i)));
    out[i] = __float2bfloat16(a + __bfloat162float(pos[i % row_elems]));
  }
}

extern "C" int ec_add_pos(const void* x, int x_dt, const void* pos, void* out,
                          long row_elems, long total, void* stream) {
  if (row_elems <= 0 || total <= 0) return (int)cudaErrorInvalidValue;
  long blocks = (total + 255) / 256;
  if (blocks > 65535L * 16) blocks = 65535L * 16;
  add_pos_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_dt, static_cast<const bf16*>(pos), static_cast<bf16*>(out),
      row_elems, total);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- attention
// attn_kernel replaces the attention step of every TPU eval kernel
// (edgecape_tpu/ops/flash_attention.py flash_mha, and the attention inside
// fused_vit_block, fused_encoder, fused_decoder, fused_attn_block):
//   out[b, i, h*D:(h+1)*D] = bf16(P . v),
//   P = bf16(softmax(q.k^T * scale + key mask[b] + bias[b, h, i])),
// with q/k/v read (bf16, or fp32 rounded to bf16 at the load) at element
// offset b*s?b + n*s?n + h*D of the fused projections, fp32 softmax, and
// a fully masked row giving 0 (the TPU kernels give NaN; the model never
// masks a whole row). train_fwd_kernel replaces _flash_train_fwd of the
// same JAX file: the same scores, p kept fp32 through the dropout and
// rounded to bf16 only as the operand of p.v, fp32 output, and each row's
// max and reciprocal exp-sum saved for the backward.
//
// What bounds them on this card: at the path's shapes (100..356 tokens,
// head dim 32 or 64) the operands of a call are read once from device
// memory in 4..120 microseconds and the two products take less than that
// on the tensor cores, so the least time is set by bytes; what a kernel
// actually spends is latency and issue slots: shared-memory round trips,
// the wait for a head's keys before the first product, too few warps in
// flight, and the softmax's scalar arithmetic, which at head dim 32 or 64
// outweighs the products. The design therefore keeps every score in
// registers:
//   * both products are mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed
//     by ldmatrix; its accumulator layout is fixed, so the scores of a
//     16-row query tile become the A operand of P.V by a pack in
//     registers. No score or probability is written to shared or device
//     memory, and no warp synchronises inside the key loop.
//   * one warp owns a 16-row query tile. Where the key row fits in
//     registers (at most ATT_ROW16 * 16 = 128 keys: K = 100 everywhere
//     the model attends over keypoints) the scores are formed once, the
//     softmax runs on the registers, and the bias and key mask are
//     touched once.
//     Longer rows (257, 356, 256 keys) would need 128..192 registers a
//     thread for the scores alone, so they take two passes over 32-key
//     chunks, both from registers: the first keeps a per-lane running max
//     and exp-sum (no shuffles in the loop), the second recomputes the
//     scores and normalises by the row's final max and sum before the
//     rounding to bf16, which keeps the TPU kernels' rounding point (an
//     online softmax that rounds exp(s - running max) would not). Measured
//     on an H100 (tools/bench_attention.py modes): at 100 keys one pass
//     takes 0.0115 ms where two passes take 0.0120 (34 x 8 heads);
//     chunks of 32 keys beat chunks of 64 (ViT 0.56
//     against 0.84 ms, encoder 0.82 against 1.17) because 80..96 registers
//     a thread let two blocks share an SM where 128 let one. Splitting a
//     row's keys over warps to make long rows one pass is not done.
//   * the query tiles of a (batch, head) are split over the blocks of
//     gridDim.y as well as over a block's warps (the plan is made by
//     ops/kernels.py attention_plan from the shapes alone), so that small
//     batches still fill the card and several blocks share an SM; the
//     second block's keys and values come from L2. A block takes 4 tiles
//     in one pass and up to 12 (head dim 32) or 9 (head dim 64) in two:
//     fewer, larger blocks measured faster wherever keys and values are
//     long (ViT 9 x 2 blocks 0.56 ms, 6 x 3 0.68), because each block
//     copies the head's keys and values again. Cross-attention (100
//     queries, 256 keys, head dim 64) has 7 tiles a head and 90 KB of
//     shared memory a block: 14 warps an SM, the one path shape under 16.
//   * keys and the query tile arrive by cp.async in one group, values in a
//     second: the scores start when the keys have landed and the values
//     land under them. fp32 operands take a converting load instead.
//   * the bool key mask [B, Nk] is read by the kernel (one byte a key,
//     once a block, into an additive row in shared memory that also holds
//     -inf for the padded keys), so a call is one launch.
// Hazards: keys are padded to a multiple of 16 with -inf scores and zero
// value rows (never uninitialised shared memory: 0 x NaN); the output may be a strided view of a caller's buffer, so 16-byte
// stores are used only when its base and strides allow them; dropout
// bits depend on (row, column / 4, batch * H + head) alone, whatever the
// tiling, so the backward regenerates the forward's mask. The exponentials
// are single ex2 instructions on scores kept in base 2, and p is
// normalised by a multiplication with the row's reciprocal sum (that
// alone took the ViT shape from 1.62 to 0.84 ms).
// The building blocks (AttnArgs, attn_scores, attn_pv, the Philox bits,
// the backward's chunks) are in attention.cuh, shared with attn_long.cu,
// whose kernels stream the keys where a head's do not fit shared memory.

// CH16: 16-key tiles held in registers at a time. ATT_ROW16: the whole key
// row, one pass; ATT_CH16: two passes over chunks of that many tiles. TRAIN:
// dropout, fp32 output and saved row statistics.
template <int D, bool TRAIN, int CH16>
__device__ __forceinline__ void attn_body(const AttnArgs& p) {
  constexpr bool ONE = CH16 == ATT_ROW16;
  constexpr int KLD = D + 8;
  constexpr int NT = 2 * CH16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int NKP = p.NK16 * 16;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // K and V [NKP][KLD] bf16, a query tile [16][KLD] per warp (reused to
  // stage a bf16 output), the additive key mask [NKP]
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)NKP * KLD;
  bf16* Qs = Vs + (size_t)NKP * KLD + (size_t)warp * 16 * KLD;
  float* kbs = reinterpret_cast<float*>(Vs + (size_t)NKP * KLD + (size_t)nwarps * 16 * KLD);

  const long bh = blockIdx.x;
  const long b = bh / p.H;
  const int h = (int)(bh % p.H);
  const int tile = blockIdx.y * nwarps + warp;
  const bool active = tile * 16 < p.Nq;
  const int q0 = tile * 16;

  if (active) {
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int rr = c / (D / 8), d8 = (c % (D / 8)) * 8;
      stage8(&Qs[rr * KLD + d8], p.q, p.in_dt,
             b * p.sqb + (long)(q0 + rr) * p.sqn + h * D + d8, q0 + rr < p.Nq);
    }
  }
  for (int c = threadIdx.x; c < NKP * (D / 8); c += blockDim.x) {
    const int n = c / (D / 8), d8 = (c % (D / 8)) * 8;
    stage8(&Ks[n * KLD + d8], p.k, p.in_dt, b * p.skb + (long)n * p.skn + h * D + d8,
           n < p.Nk);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < NKP * (D / 8); c += blockDim.x) {
    const int n = c / (D / 8), d8 = (c % (D / 8)) * 8;
    stage8(&Vs[n * KLD + d8], p.v, p.in_dt, b * p.svb + (long)n * p.svn + h * D + d8,
           n < p.Nk);
  }
  cp_async_commit();
  for (int j = threadIdx.x; j < NKP; j += blockDim.x) {
    const bool on = j < p.Nk && (p.kvalid == nullptr || p.kvalid[b * p.skvb + j] != 0);
    kbs[j] = on ? 0.0f : -INFINITY;
  }
  cp_async_wait<1>();          // the query tiles and the keys have landed
  __syncthreads();

  const int r0 = q0 + g, r1 = q0 + g + 8;
  unsigned qa[D / 16][4];
  AttnRows rw;
  rw.brow[0] = rw.brow[1] = nullptr;
  rw.bias_vec = p.Nk % 4 == 0 && (reinterpret_cast<uintptr_t>(p.bias) & 15) == 0;
  float s[NT][4];
  // running max (base 2) and exp-sum of the lane's two rows
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  if (active) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(Qs + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * KLD + kk * 16
                  + (lane >> 4) * 8,
              qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
    if (p.bias) {
      if (r0 < p.Nq) rw.brow[0] = p.bias + ((size_t)bh * p.Nq + r0) * p.Nk;
      if (r1 < p.Nq) rw.brow[1] = p.bias + ((size_t)bh * p.Nq + r1) * p.Nk;
    }
    if constexpr (ONE) {
      attn_scores<D, NT>(s, qa, Ks, kbs, 0, NKP, p, rw, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      // a fully masked row has max -inf: subtract 0, so every 2^-inf is 0
      const float z0 = m0 == -INFINITY ? 0.0f : m0, z1 = m1 == -INFINITY ? 0.0f : m1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = ex2(s[j][0] - z0);
        s[j][1] = ex2(s[j][1] - z0);
        s[j][2] = ex2(s[j][2] - z1);
        s[j][3] = ex2(s[j][3] - z1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
    } else {
      // pass 1: per-lane running max and exp-sum, joined over the quad
      for (int n0 = 0; n0 < NKP; n0 += NT * 8) {
        attn_scores<D, NT>(s, qa, Ks, kbs, n0, NKP, p, rw, lane);
        attn_stats_chunk<NT>(s, m0, m1, l0, l1);
      }
      attn_stats_join(m0, m1, l0, l1);
    }
  }
  cp_async_wait<0>();          // the values have landed
  __syncthreads();
  if (!active) return;

  const float z0 = m0 == -INFINITY ? 0.0f : m0, z1 = m1 == -INFINITY ? 0.0f : m1;
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f, inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  unsigned long long seed = 0ull;
  if constexpr (TRAIN) {
    if (p.thresh) seed = *p.seed;
    attn_save_stats(p, (size_t)bh, r0, r1, m0, m1, inv0, inv1, t);
  }
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;

  for (int n0 = 0; n0 < NKP; n0 += NT * 8) {   // one round when ONE
    if constexpr (!ONE) {
      attn_scores<D, NT>(s, qa, Ks, kbs, n0, NKP, p, rw, lane);
      attn_exp<NT>(s, z0, z1);
    }
    attn_probs<TRAIN, NT>(s, n0, NKP, inv0, inv1, p, seed, (unsigned)bh, r0, r1, t);
    attn_pv<D, NT>(o, s, Vs, n0 / 16, p.NK16, lane);
  }
  attn_store<D, TRAIN>(o, p, Qs, b, h, q0, r0, r1, lane);
}

// Threads a block may have and blocks an SM should hold, which set the
// registers a thread gets: one pass 8 warps (up to 255 registers); two
// passes two blocks of 12 warps (head dim 32: 85 registers) or 9 warps
// (head dim 64: 113 registers), as many as two heads' keys and values
// leave room for in an SM's shared memory; head dim 128 (the padded form
// of head dims 65..128) two blocks of 4 warps (255 registers: its query
// fragments and output tile alone take 96).
constexpr int att_max_threads(int d, int ch16) {
  return ch16 == ATT_ROW16 ? 256 : d == 32 ? 384 : d == 64 ? 288 : 128;
}
constexpr int att_min_blocks(int ch16) { return ch16 == ATT_ROW16 ? 1 : 2; }

template <int D, int CH16>
__global__ void __launch_bounds__(att_max_threads(D, CH16), att_min_blocks(CH16))
    attn_kernel(AttnArgs p) {
  attn_body<D, false, CH16>(p);
}

template <int D, int CH16>
__global__ void __launch_bounds__(att_max_threads(D, CH16), att_min_blocks(CH16))
    train_fwd_kernel(AttnArgs p) {
  attn_body<D, true, CH16>(p);
}

// Shared memory the layout in attn_body needs.
static size_t attn_smem_need(int D, int nk16, int warps) {
  const size_t kld = D + 8, nkp = (size_t)nk16 * 16;
  return 4 * nkp * kld + 32 * (size_t)warps * kld + 4 * nkp;
}

// Checks the plan against the shape and the card's limits and launches.
// `configured`: the instantiation's dynamic shared-memory limit was raised.
template <typename Kern>
static int launch_attn_plan(Kern kern, bool& configured, const AttnArgs& p, int B, int D,
                            const AttnPlan& pl, cudaStream_t s) {
  if (pl.warps < 1 || pl.warps * 32 > att_max_threads(D, pl.chunk16) || pl.qsplit < 1 ||
      pl.qsplit > 65535 || (long)pl.qsplit * pl.warps * 16 < p.Nq ||
      (pl.chunk16 == ATT_ROW16 && p.NK16 > ATT_ROW16) ||
      pl.smem < (long)attn_smem_need(D, p.NK16, pl.warps) || pl.smem > ATT_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ATT_SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<dim3((unsigned)((long)B * p.H), (unsigned)pl.qsplit), pl.warps * 32,
         (size_t)pl.smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_attn(const AttnArgs& p, int B, const AttnPlan& pl, cudaStream_t s) {
  static bool configured[2] = {false, false};
  if (pl.chunk16 == ATT_ROW16)
    return launch_attn_plan(attn_kernel<D, ATT_ROW16>, configured[0], p, B, D, pl, s);
  if (pl.chunk16 == ATT_CH16)
    return launch_attn_plan(attn_kernel<D, ATT_CH16>, configured[1], p, B, D, pl, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
static int launch_train_fwd(const AttnArgs& p, int B, const AttnPlan& pl, cudaStream_t s) {
  static bool configured[2] = {false, false};
  if (pl.chunk16 == ATT_ROW16)
    return launch_attn_plan(train_fwd_kernel<D, ATT_ROW16>, configured[0], p, B, D, pl, s);
  if (pl.chunk16 == ATT_CH16)
    return launch_attn_plan(train_fwd_kernel<D, ATT_CH16>, configured[1], p, B, D, pl, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ec_attention(const void* q, const void* k, const void* v, int in_dt,
                            long sqb, long sqn, long skb, long skn, long svb, long svn,
                            int B, int H, int D, int Nq, int Nk,
                            const void* kvalid, long skvb, const void* bias, float scale,
                            void* out, int out_dt, long sob, long son,
                            int qsplit, int warps, int chunk16, long smem,
                            void* stream) {
  AttnArgs p;
  if (!attn_args(p, q, k, v, in_dt, sqb, sqn, skb, skn, svb, svn, B, H, Nq, Nk, kvalid,
                 skvb, bias, scale))
    return (int)cudaErrorInvalidValue;
  p.out = out; p.out_dt = out_dt; p.sob = sob; p.son = son;
  const AttnPlan pl = {qsplit, warps, chunk16, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_attn<32>(p, B, pl, s);
  if (D == 64) return launch_attn<64>(p, B, pl, s);
  if (D == 128) return launch_attn<128>(p, B, pl, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------ decoder-stack glue
// feats[r] = bf16([sin(ay) | cos(ay) | sin(ax) | cos(ax)]), each F wide,
// with a? = (c? * 2 pi) * rdt[i] in fp32 for the normalised coordinates
// ct[r] = (x, y): the sine embedding of the decoder's current points in
// the column order that the pre-permuted ref_point_head fc1 expects.
__global__ void sine_feats_kernel(const float* ct, const float* rdt, bf16* out,
                                  long rows, int F) {
  const long total = rows * F;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long r = idx / F;
    const int i = (int)(idx % F);
    const float ax = (ct[2 * r] * 6.283185307179586f) * rdt[i];
    const float ay = (ct[2 * r + 1] * 6.283185307179586f) * rdt[i];
    bf16* o = out + r * 4 * F + i;
    o[0] = __float2bfloat16(sinf(ay));
    o[F] = __float2bfloat16(cosf(ay));
    o[2 * F] = __float2bfloat16(sinf(ax));
    o[3 * F] = __float2bfloat16(cosf(ax));
  }
}

extern "C" int ec_sine_feats(const void* ct, const void* rdt, void* out, long rows,
                             int F, void* stream) {
  if (rows <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  long blocks = (rows * F + 255) / 256;
  if (blocks > 65535L * 16) blocks = 65535L * 16;
  sine_feats_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ct), static_cast<const float*>(rdt),
      static_cast<bf16*>(out), rows, F);
  return (int)cudaGetLastError();
}

// --------------------------------- decoder-stack self-attention, bias once
// bias_attn_kernel replaces the Markov-biased self-attention of the TPU
// kernel edgecape_tpu/ops/fused_decoder.py _stack_kernel (:363-407) for the
// 8 heads of d 32 of the fused projection qkv [B, K, 768] (q | k | v):
//   bias[h, i, j] = b2[h] + sum_m relu(b1[m] + sum_n hops[b, i, j, n]
//                   w1[n, m]) w2[m, h],
//   out[b, i, 32 h:32 h + 32] = bf16(bf16(softmax(q.k^T / sqrt(32) + key
//                   mask + bias)) . v).
// Like the TPU kernel it forms the MLP's hidden layer once per (query,
// key) and derives all heads' biases from it (5 x 12 + 12 x 8 multiply-adds
// at n_hop 5, hidden 12), where a per-head attention would form it 8 times
// and read the hop stack 8 times. One block per (batch row, run of 16-query
// tiles), a warp per head:
//   * the row's keys and values of all heads arrive once by cp.async
//     ([NKP][264] bf16 each: 118 KB at K = 100), while the first tile's
//     bias is formed;
//   * phase 1, per tile: a thread takes (query, 4 keys), reads their
//     4 x n_hop hop values (8 x n_hop contiguous bytes of the stack in its
//     own [B, K, K, n_hop] layout), forms the hidden units once and writes
//     the 8 heads' fp32 biases into shared memory [8][16][NKP] (57 KB);
//   * phase 2: warp h forms its head's scores on mma.sync (attn_scores,
//     the register-resident form of attn_kernel, whole key row in one
//     pass) and adds the bias from shared memory in the key permutation,
//     softmax and P.V in registers, and stores through its columns of the
//     tile's query rows.
// The bias is summed in the order of the attention kernel's former
// in-kernel MLP (b1, the hop terms ascending, ReLU, then b2 and the hidden
// terms ascending, fp32 fused multiply-adds).
// What bounds it on this card: at [510, K 100] a call moves 155 MB (hops
// 51, qkv 78, output 26 MB: 0.046 ms) and does 1.6 GFLOP of fp32 MLP
// (0.024 ms); with 185 KB of shared memory a block, one block an SM, its
// time is latency: the key / value copy is hidden under the first tile's
// bias, the rest is the 8 warps' dependent arithmetic.

#define BA_H 8                 // heads
#define BA_D 32                // head dim
#define BA_C (BA_H * BA_D)     // channels of q, k, v
#define BA_LD (BA_C + 8)       // row stride of K, V and the query tile
#define BA_HOP_MAX 8           // hop planes
#define BA_HID_MAX 32          // hidden units of the bias MLP
// w1 [hid][8] | w2 [hid][8] | b1 [hid] | b2 [8], zero past nhop / hid
#define BA_MLP_FLOATS (2 * BA_HID_MAX * 8 + BA_HID_MAX + BA_H)

struct BiasArgs {
  const bf16* hops;            // [B, N, N, nhop]
  const float *w1, *b1, *w2, *b2;
  int nhop, hid, tiles_per_block;
};

// The hop values of keys k0 .. k0 + 3 of one query row (src: the first of
// them, nhop planes a key), as hv[plane][key]; 0 past n keys or nhop
// planes. vec: NHOP == nhop and the run of 8 x NHOP bytes is aligned.
template <int NHOP>
__device__ __forceinline__ void load_hops(const bf16* src, int k0, int n, int nhop, bool vec,
                                          float (&hv)[NHOP][4]) {
  if (vec && k0 + 3 < n) {
    unsigned u[2 * NHOP];
#pragma unroll
    for (int i = 0; i < NHOP; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(src + 4 * i);
      u[2 * i] = v.x;
      u[2 * i + 1] = v.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < NHOP; ++j) {
        const int i = e * NHOP + j;
        hv[j][e] = (i & 1) ? __uint_as_float(u[i >> 1] & 0xffff0000u)
                           : __uint_as_float(u[i >> 1] << 16);
      }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < NHOP; ++j)
        hv[j][e] = k0 + e < n && j < nhop ? __bfloat162float(src[e * nhop + j]) : 0.0f;
  }
}

template <int NHOP>
__global__ void __launch_bounds__(BA_H * 32, 1) bias_attn_kernel(AttnArgs p, BiasArgs w) {
  constexpr int D = BA_D, LD = BA_LD, NT = 2 * ATT_ROW16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int NKP = p.NK16 * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;

  // K and V [NKP][LD], the tile's queries [16][LD] (reused to stage the
  // output), the bias [H][16][NKP], the additive key mask, the MLP
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)NKP * LD;
  bf16* Qs = Vs + (size_t)NKP * LD;
  float* bs = reinterpret_cast<float*>(Qs + 16 * LD);
  float* kbs = bs + (size_t)BA_H * 16 * NKP;
  float* w1s = kbs + NKP;
  float* w2s = w1s + BA_HID_MAX * 8;
  float* b1s = w2s + BA_HID_MAX * 8;
  float* b2s = b1s + BA_HID_MAX;

  const long b = blockIdx.x;
  const bf16* qkv = static_cast<const bf16*>(p.q) + b * p.sqb;
  for (int c = threadIdx.x; c < NKP * (BA_C / 8); c += blockDim.x) {
    const int n = c / (BA_C / 8), d8 = (c % (BA_C / 8)) * 8;
    copy8(&Ks[n * LD + d8], qkv + (long)n * p.sqn + BA_C + d8, n < p.Nk ? 8 : 0);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < NKP * (BA_C / 8); c += blockDim.x) {
    const int n = c / (BA_C / 8), d8 = (c % (BA_C / 8)) * 8;
    copy8(&Vs[n * LD + d8], qkv + (long)n * p.sqn + 2 * BA_C + d8, n < p.Nk ? 8 : 0);
  }
  cp_async_commit();
  for (int j = threadIdx.x; j < NKP; j += blockDim.x) {
    const bool on = j < p.Nk && (p.kvalid == nullptr || p.kvalid[b * p.skvb + j] != 0);
    kbs[j] = on ? 0.0f : -INFINITY;
  }
  for (int i = threadIdx.x; i < BA_HID_MAX * 8; i += blockDim.x) {
    const int m = i >> 3, j = i & 7;
    w1s[i] = m < w.hid && j < w.nhop ? w.w1[j * w.hid + m] : 0.0f;
    w2s[i] = m < w.hid ? w.w2[m * BA_H + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < BA_HID_MAX; i += blockDim.x)
    b1s[i] = i < w.hid ? w.b1[i] : 0.0f;
  if (threadIdx.x < BA_H) b2s[threadIdx.x] = w.b2[threadIdx.x];
  __syncthreads();

  const int tiles = (p.Nq + 15) / 16;
  const int t_end = min(tiles, (int)(blockIdx.y + 1) * w.tiles_per_block);
  const int nq4 = (p.Nk + 3) / 4;
  const bool hvec = w.nhop == NHOP && p.Nk % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(w.hops) & 7) == 0;
  for (int tile = blockIdx.y * w.tiles_per_block; tile < t_end; ++tile) {
    const int q0 = tile * 16;
    for (int c = threadIdx.x; c < 16 * (BA_C / 8); c += blockDim.x) {
      const int rr = c / (BA_C / 8), d8 = (c % (BA_C / 8)) * 8;
      copy8(&Qs[rr * LD + d8], qkv + (long)(q0 + rr) * p.sqn + d8, q0 + rr < p.Nq ? 8 : 0);
    }
    cp_async_commit();

    // phase 1: the tile's bias for every head, the hidden layer once
    for (int i = threadIdx.x; i < 16 * nq4; i += blockDim.x) {
      const int rr = i / nq4, k0 = 4 * (i % nq4), q = q0 + rr;
      if (q >= p.Nq) continue;
      float hv[NHOP][4];
      load_hops<NHOP>(w.hops + ((b * p.Nq + q) * (long)p.Nk + k0) * w.nhop, k0, p.Nk, w.nhop,
                      hvec, hv);
      float acc[BA_H][4];
#pragma unroll
      for (int h = 0; h < BA_H; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][e] = b2s[h];
      for (int m = 0; m < w.hid; ++m) {
        const float4 wa = *reinterpret_cast<const float4*>(w1s + 8 * m);
        const float4 wb = *reinterpret_cast<const float4*>(w1s + 8 * m + 4);
        const float4 va = *reinterpret_cast<const float4*>(w2s + 8 * m);
        const float4 vb = *reinterpret_cast<const float4*>(w2s + 8 * m + 4);
        const float w1m[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const float w2m[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
        const float b1m = b1s[m];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = b1m;
#pragma unroll
          for (int j = 0; j < NHOP; ++j) a = fmaf(hv[j][e], w1m[j], a);
          a = fmaxf(a, 0.0f);
#pragma unroll
          for (int h = 0; h < BA_H; ++h) acc[h][e] = fmaf(a, w2m[h], acc[h][e]);
        }
      }
#pragma unroll
      for (int h = 0; h < BA_H; ++h)
        *reinterpret_cast<float4*>(bs + ((size_t)h * 16 + rr) * NKP + k0) =
            make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
    }
    cp_async_wait<0>();          // keys, values (first tile) and queries
    __syncthreads();

    // phase 2: warp h, head h, the whole key row in registers
    const int h = warp;
    const int r0 = q0 + g, r1 = q0 + g + 8;
    unsigned qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(Qs + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * LD + h * D + kk * 16
                  + (lane >> 4) * 8,
              qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
    AttnRows rw;
    rw.brow[0] = r0 < p.Nq ? bs + ((size_t)h * 16 + g) * NKP : nullptr;
    rw.brow[1] = r1 < p.Nq ? bs + ((size_t)h * 16 + g + 8) * NKP : nullptr;
    rw.bias_vec = p.Nk % 4 == 0;
    float s[NT][4];
    attn_scores<D, NT, LD>(s, qa, Ks + h * D, kbs, 0, NKP, p, rw, lane);
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    const float z0 = m0 == -INFINITY ? 0.0f : m0, z1 = m1 == -INFINITY ? 0.0f : m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = ex2(s[j][0] - z0);
      s[j][1] = ex2(s[j][1] - z0);
      s[j][2] = ex2(s[j][2] - z1);
      s[j][3] = ex2(s[j][3] - z1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f, inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] *= inv0; s[j][1] *= inv0;
      s[j][2] *= inv1; s[j][3] *= inv1;
    }
    float o[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
    attn_pv<D, NT, LD>(o, s, Vs + h * D, 0, p.NK16, lane);

    // the output through this head's columns of the query tile: 16-byte
    // stores of whole rows
    const int t = lane & 3;
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<unsigned*>(&Qs[g * LD + h * D + dt * 8 + 2 * t]) =
          pack_bf16(o[dt][0], o[dt][1]);
      *reinterpret_cast<unsigned*>(&Qs[(g + 8) * LD + h * D + dt * 8 + 2 * t]) =
          pack_bf16(o[dt][2], o[dt][3]);
    }
    __syncwarp();
    bf16* out = static_cast<bf16*>(p.out) + b * p.sob + h * D;
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int rr = c / (D / 8), d8 = (c % (D / 8)) * 8;
      if (q0 + rr < p.Nq)
        *reinterpret_cast<uint4*>(out + (long)(q0 + rr) * p.son + d8) =
            *reinterpret_cast<const uint4*>(&Qs[rr * LD + h * D + d8]);
    }
    __syncthreads();             // the query tile and the bias are free again
  }
}

// Shared memory of bias_attn_kernel for nk16 16-key tiles.
static size_t bias_attn_smem_need(int nk16) {
  const size_t nkp = (size_t)nk16 * 16;
  return 2 * nkp * BA_LD * 2 + 16 * BA_LD * 2 + (size_t)BA_H * 16 * nkp * 4 + nkp * 4 +
         BA_MLP_FLOATS * 4;
}

template <int NHOP>
static int launch_bias_attn(const AttnArgs& p, const BiasArgs& w, int B, int qsplit, long smem,
                            cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(bias_attn_kernel<NHOP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ATT_SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  bias_attn_kernel<NHOP><<<dim3((unsigned)B, (unsigned)qsplit), BA_H * 32, (size_t)smem, s>>>(
      p, w);
  return (int)cudaGetLastError();
}

// qkv: contiguous bf16 [B, N, 768], 16-byte aligned; kvalid: bool [B, N]
// (row stride skvb) or null; hops: contiguous bf16 [B, N, N, nhop]; w1
// [nhop, hid], b1 [hid], w2 [hid, 8], b2 [8] fp32; out: contiguous bf16
// [B, N, 256]. The plan (ops/kernels.py bias_attention_plan): qsplit
// blocks a batch row of tiles_per_block 16-query tiles each, smem bytes.
extern "C" int ec_bias_attention(const void* qkv, int B, int N, const void* kvalid, long skvb,
                                 const void* hops, int nhop, int hid, const void* w1,
                                 const void* b1, const void* w2, const void* b2, float scale,
                                 void* out, int qsplit, int tiles_per_block, long smem,
                                 void* stream) {
  const int nk16 = (N + 15) / 16;
  if (B <= 0 || N <= 0 || nk16 > ATT_ROW16 || nhop <= 0 || nhop > BA_HOP_MAX || hid <= 0 ||
      hid > BA_HID_MAX || !qkv || !hops || !w1 || !b1 || !w2 || !b2 || !out ||
      (reinterpret_cast<uintptr_t>(qkv) & 15) || (reinterpret_cast<uintptr_t>(out) & 15) ||
      qsplit < 1 || qsplit > 65535 || tiles_per_block < 1 ||
      (long)qsplit * tiles_per_block * 16 < N || smem < (long)bias_attn_smem_need(nk16) ||
      smem > ATT_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  AttnArgs p;
  if (!attn_args(p, qkv, qkv, qkv, DT_BF16, (long)N * 3 * BA_C, 3 * BA_C, (long)N * 3 * BA_C,
                 3 * BA_C, (long)N * 3 * BA_C, 3 * BA_C, B, BA_H, N, N, kvalid, skvb, nullptr,
                 scale))
    return (int)cudaErrorInvalidValue;
  p.out = out; p.out_dt = DT_BF16; p.sob = (long)N * BA_C; p.son = BA_C;
  BiasArgs w;
  w.hops = static_cast<const bf16*>(hops);
  w.w1 = static_cast<const float*>(w1); w.b1 = static_cast<const float*>(b1);
  w.w2 = static_cast<const float*>(w2); w.b2 = static_cast<const float*>(b2);
  w.nhop = nhop; w.hid = hid; w.tiles_per_block = tiles_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nhop == 5 ? launch_bias_attn<5>(p, w, B, qsplit, smem, s)
                   : launch_bias_attn<BA_HOP_MAX>(p, w, B, qsplit, smem, s);
}

// ---------------------------------------------------- training attention
// Backward of the training attention (ops/flash_attention.py
// flash_mha_train; the forward is train_fwd_kernel above): dq, dk, dv and
// dbias of out = dropout(softmax(q.k^T * scale + key mask[b] + bias[b, h]))
// . v, replacing _flash_train_bwd / _train_bwd_kernel of
// edgecape_tpu/ops/flash_attention.py with its rounding points: `do`, the
// dropped probabilities pd and ds are rounded to bf16 as matmul operands,
// every gradient is accumulated and stored in fp32.
//
// Dropout bits come from Philox-4x32-10 keyed by a 64-bit seed (read from
// device memory, so drawing it never waits for the device) and
// counted by (column / 4, row, batch * H + head): one call gives the bits
// of four neighbouring key columns of one query row, whatever the tiling,
// so the backward regenerates the forward's mask. keep = bits >= thresh.
// The forward saves each row's max and reciprocal exp-sum; the backward
// reads them instead of making a statistics pass of its own, and turns
// the max to base 2 once per row so that a probability is one ex2.
//
// What bounds it on this card: a call moves 2..12 MB once (0.002..0.012 ms)
// and its five products are less still, so, as in the forward, the time
// goes to instruction slots and latency: recomputing p, the Philox rounds, and
// getting tiles in and out of the tensor cores. The design keeps s, p, dp
// and ds in mma.sync accumulator registers and splits the sequence over
// the grid, in two launches that need no atomics and sum in a fixed order:
//   * train_bwd_q_kernel, query-major: a warp owns a 16-row query tile,
//     blocks split the query tiles of a (batch, head) over gridDim.y, keys
//     and values lie in shared memory (cp.async). s = q.k^T and
//     dp = do.v^T are formed in the accumulator layout with the forward's
//     key permutation, so a lane's mask, bias, dbias and Philox group are
//     the same four neighbouring keys. Up to 128 keys the row stays in
//     registers and is formed once (3 products an element); longer rows
//     take a first pass over 32-key chunks for delta = rowsum(dp * p) and
//     a second that recomputes s and dp, forms ds = p * (dp - delta),
//     stores it as dbias and feeds dq += bf16(ds) . k by a pack in
//     registers (5 products). delta goes to device memory, 4 bytes a row.
//   * train_bwd_k_kernel, key-major: a warp owns a 16-key tile, blocks
//     split the key tiles over gridDim.y, queries and do lie in shared
//     memory with each row's (max, 1 / sum, delta). It forms the
//     transposed tiles s^T = k.q^T and dp^T = v.do^T, whose accumulators
//     are again A operands: dv += bf16(pd^T) . do and dk += bf16(ds^T) . q
//     (4 products). The tile's key rows are permuted so that a lane's two
//     keys share a Philox group with its neighbour lane's two; the pair
//     draws one group each for its two query columns and exchanges the
//     keep bits by a shuffle, so a group is still drawn once.
// Computing delta in the key-major kernel instead would cost every key
// block a full score pass (2 products an element per block of the split);
// delta = rowsum(do * o) would save the first pass (7 products instead of
// 9) but sums bf16(pd) where the TPU kernel and the plain version sum
// fp32 p, so it is not taken. One launch would need either one block per
// (batch, head) (no split: what this replaces) or blocks that wait for
// each other.
// Hazards: padded keys carry -inf in the mask row and zero K and V rows,
// padded queries zero q and do rows and zero statistics, so every padded
// p, pd and ds is exactly 0; a fully masked row has max -inf and
// reciprocal sum 0 and gives zero gradients.

__global__ void dropout_mask_kernel(const unsigned long long* seed_ptr, unsigned thresh,
                                    long BH, int Nq, int Nk, unsigned char* keep) {
  const unsigned long long seed = *seed_ptr;
  const int ncg = (Nk + 3) / 4;
  const long total = BH * Nq * ncg;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int cg = (int)(i % ncg);
    const long rest = i / ncg;
    const int row = (int)(rest % Nq);
    const long bh = rest / Nq;
    unsigned bits[4];
    dropout_bits(seed, (unsigned)bh, (unsigned)row, (unsigned)cg, bits);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = cg * 4 + a;
      if (j < Nk) keep[(bh * Nq + row) * Nk + j] = bits[a] >= thresh ? 1 : 0;
    }
  }
}

// The keep mask the training kernels use for (seed, thresh): uint8
// [BH, Nq, Nk], so that a plain version can be fed the kernels' own mask.
extern "C" int ec_dropout_mask(const void* seed, unsigned thresh, long BH, int Nq, int Nk,
                               void* keep, void* stream) {
  if (!seed || BH <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  const long total = BH * Nq * ((Nk + 3) / 4);
  long blocks = (total + 255) / 256;
  if (blocks > 65535L * 16) blocks = 65535L * 16;
  dropout_mask_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(seed), thresh, BH, Nq, Nk,
      static_cast<unsigned char*>(keep));
  return (int)cudaGetLastError();
}

// CH16 as in attn_body: ATT_ROW16 the whole key row in registers, one
// pass; ATT_CH16 two passes over chunks of that many 16-key tiles.
// Head dim 128 holds one block an SM (255 registers a thread): its dq tile
// and query and do fragments alone take 128.
template <int D, int CH16>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32, CH16 == ATT_ROW16 || D > 64 ? 1 : 2)
    train_bwd_q_kernel(AttnArgs p, BwdArgs w) {
  constexpr bool ONE = CH16 == ATT_ROW16;
  constexpr int KLD = D + 8;
  constexpr int NT = 2 * CH16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int NKP = p.NK16 * 16;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // K and V [NKP][KLD], a query tile and a do tile [16][KLD] per warp,
  // the additive key mask [NKP]
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)NKP * KLD;
  bf16* Qs = Vs + (size_t)NKP * KLD + (size_t)warp * 32 * KLD;
  bf16* Gs = Qs + 16 * KLD;
  float* kbs = reinterpret_cast<float*>(Vs + (size_t)NKP * KLD + (size_t)nwarps * 32 * KLD);

  const long bh = blockIdx.x;
  const long b = bh / p.H;
  const int h = (int)(bh % p.H);
  const int tile = blockIdx.y * nwarps + warp;
  const bool active = tile * 16 < p.Nq;
  const int q0 = tile * 16;

  if (active) {
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int rr = c / (D / 8), d8 = (c % (D / 8)) * 8;
      const bool in = q0 + rr < p.Nq;
      stage8(&Qs[rr * KLD + d8], p.q, p.in_dt,
             b * p.sqb + (long)(q0 + rr) * p.sqn + h * D + d8, in);
      stage8(&Gs[rr * KLD + d8], w.dout, w.do_dt,
             b * w.sdb + (long)(q0 + rr) * w.sdn + h * D + d8, in);
    }
  }
  for (int c = threadIdx.x; c < NKP * (D / 8); c += blockDim.x) {
    const int n = c / (D / 8), d8 = (c % (D / 8)) * 8;
    stage8(&Ks[n * KLD + d8], p.k, p.in_dt, b * p.skb + (long)n * p.skn + h * D + d8,
           n < p.Nk);
    stage8(&Vs[n * KLD + d8], p.v, p.in_dt, b * p.svb + (long)n * p.svn + h * D + d8,
           n < p.Nk);
  }
  cp_async_commit();
  for (int j = threadIdx.x; j < NKP; j += blockDim.x) {
    const bool on = j < p.Nk && (p.kvalid == nullptr || p.kvalid[b * p.skvb + j] != 0);
    kbs[j] = on ? 0.0f : -INFINITY;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  const int r0 = q0 + g, r1 = q0 + g + 8;
  unsigned qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const size_t off = (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * KLD + kk * 16
                       + (lane >> 4) * 8;
    ldsm_x4(Qs + off, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
    ldsm_x4(Gs + off, da[kk][0], da[kk][1], da[kk][2], da[kk][3]);
  }
  AttnRows rw;
  float* dbrow[2];
  float z0, z1, inv0, inv1;
  bwd_q_rows(rw, dbrow, z0, z1, inv0, inv1, p, w, (size_t)bh, r0, r1);
  const unsigned long long seed = p.thresh ? *p.seed : 0ull;

  float s[NT][4], dpv[NT][4];
  float delta0 = 0.0f, delta1 = 0.0f;
  if constexpr (!ONE) {
    for (int n0 = 0; n0 < NKP; n0 += NT * 8) {
      bwd_q_chunk<D, NT>(s, dpv, qa, da, Ks, Vs, kbs, n0, NKP, p, rw, lane, z0, z1, inv0,
                         inv1, seed, (unsigned)bh, r0, r1);
      bwd_q_delta<NT>(s, dpv, delta0, delta1);
    }
    delta0 = quad_sum(delta0);
    delta1 = quad_sum(delta1);
  }
  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.0f;
  for (int n0 = 0; n0 < NKP; n0 += NT * 8) {     // one round when ONE
    bwd_q_chunk<D, NT>(s, dpv, qa, da, Ks, Vs, kbs, n0, NKP, p, rw, lane, z0, z1, inv0, inv1,
                       seed, (unsigned)bh, r0, r1);
    if constexpr (ONE) {
      bwd_q_delta<NT>(s, dpv, delta0, delta1);
      delta0 = quad_sum(delta0);
      delta1 = quad_sum(delta1);
    }
    bwd_q_ds<NT>(s, dpv, delta0, delta1, n0, dbrow, p, w, t);
    attn_pv<D, NT>(dq, s, Ks, n0 / 16, p.NK16, lane);   // dq += bf16(ds) . k
  }

  bwd_q_store<D>(dq, delta0, delta1, w, p, b, h, r0, r1, t);
}

template <int D>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32, D > 64 ? 1 : 2)
    train_bwd_k_kernel(AttnArgs p, BwdArgs w) {
  constexpr int KLD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int NQP = w.NQ16 * 16;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;

  // Q and do [NQP][KLD], each query's (max in base 2, 1 / sum, delta, 0),
  // a key tile and a value tile [16][KLD] per warp
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + (size_t)NQP * KLD;
  float4* sts = reinterpret_cast<float4*>(Gs + (size_t)NQP * KLD);
  bf16* Kt = reinterpret_cast<bf16*>(sts + NQP) + (size_t)warp * 32 * KLD;
  bf16* Vt = Kt + 16 * KLD;

  const long bh = blockIdx.x;
  const long b = bh / p.H;
  const int h = (int)(bh % p.H);
  const int tile = blockIdx.y * nwarps + warp;
  const bool active = tile * 16 < p.Nk;
  const int k0 = tile * 16;

  if (active) {
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int rr = c / (D / 8), d8 = (c % (D / 8)) * 8;
      const bool in = k0 + rr < p.Nk;
      stage8(&Kt[rr * KLD + d8], p.k, p.in_dt,
             b * p.skb + (long)(k0 + rr) * p.skn + h * D + d8, in);
      stage8(&Vt[rr * KLD + d8], p.v, p.in_dt,
             b * p.svb + (long)(k0 + rr) * p.svn + h * D + d8, in);
    }
  }
  for (int c = threadIdx.x; c < NQP * (D / 8); c += blockDim.x) {
    const int n = c / (D / 8), d8 = (c % (D / 8)) * 8;
    stage8(&Qs[n * KLD + d8], p.q, p.in_dt, b * p.sqb + (long)n * p.sqn + h * D + d8,
           n < p.Nq);
    stage8(&Gs[n * KLD + d8], w.dout, w.do_dt, b * w.sdb + (long)n * w.sdn + h * D + d8,
           n < p.Nq);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < NQP; i += blockDim.x) {
    float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < p.Nq) {
      const size_t row = (size_t)bh * p.Nq + i;
      const float m = p.stats[row * 2] * LOG2E_F;
      st.x = m == -INFINITY ? 0.0f : m;
      st.y = p.stats[row * 2 + 1];
      st.z = w.delta[row];
    }
    sts[i] = st;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  unsigned ka[D / 16][4], va[D / 16][4], cg;
  int key[2];
  float kadd[2];
  bwd_k_tile<D>(ka, va, key, kadd, cg, Kt, Vt, p, b, k0, lane);
  const float* bias = p.bias ? p.bias + (size_t)bh * p.Nq * p.Nk : nullptr;
  const unsigned long long seed = p.thresh ? *p.seed : 0ull;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.0f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.0f;
  }
  for (int q0 = 0; q0 < NQP; q0 += BWD_KCH * 8)
    bwd_k_chunk<D>(dk, dv, ka, va, Qs, Gs, sts, q0, 0, NQP, p, bias, key, kadd, seed,
                   (unsigned)bh, cg, lane);
  bwd_k_store<D>(dk, dv, w, p, b, h, key, t);
}

// Shared memory the two layouts need.
static size_t bwd_q_smem_need(int D, int nk16, int warps) {
  const size_t kld = D + 8, nkp = (size_t)nk16 * 16;
  return 4 * nkp * kld + 64 * (size_t)warps * kld + 4 * nkp;
}
static size_t bwd_k_smem_need(int D, int nq16, int warps) {
  const size_t kld = D + 8, nqp = (size_t)nq16 * 16;
  return 4 * nqp * kld + 16 * nqp + 64 * (size_t)warps * kld;
}

template <typename Kern>
static int launch_bwd_part(Kern kern, bool& configured, const AttnArgs& p, const BwdArgs& w,
                           int B, int split, int warps, long smem, cudaStream_t s) {
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ATT_SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<dim3((unsigned)((long)B * p.H), (unsigned)split), warps * 32, (size_t)smem, s>>>(p, w);
  return (int)cudaGetLastError();
}

// Checks the plan against the shape and the card's limits, then launches
// the query-major kernel and the key-major one behind it.
template <int D>
static int launch_train_bwd(const AttnArgs& p, const BwdArgs& w, int B, const BwdPlan& pl,
                            cudaStream_t s) {
  static bool configured[3] = {false, false, false};
  const bool one = pl.chunk16 == ATT_ROW16;
  if ((!one && pl.chunk16 != ATT_CH16) || (one && p.NK16 > ATT_ROW16) || pl.qwarps < 1 ||
      pl.qwarps > BWD_MAX_WARPS || pl.kwarps < 1 || pl.kwarps > BWD_MAX_WARPS ||
      pl.qsplit < 1 || pl.qsplit > 65535 || pl.ksplit < 1 || pl.ksplit > 65535 ||
      (long)pl.qsplit * pl.qwarps * 16 < p.Nq || (long)pl.ksplit * pl.kwarps * 16 < p.Nk ||
      pl.qsmem < (long)bwd_q_smem_need(D, p.NK16, pl.qwarps) || pl.qsmem > ATT_SMEM_LIMIT ||
      pl.ksmem < (long)bwd_k_smem_need(D, w.NQ16, pl.kwarps) || pl.ksmem > ATT_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int rc = one ? launch_bwd_part(train_bwd_q_kernel<D, ATT_ROW16>, configured[0], p, w,
                                       B, pl.qsplit, pl.qwarps, pl.qsmem, s)
                     : launch_bwd_part(train_bwd_q_kernel<D, ATT_CH16>, configured[1], p, w,
                                       B, pl.qsplit, pl.qwarps, pl.qsmem, s);
  if (rc != 0) return rc;
  return launch_bwd_part(train_bwd_k_kernel<D>, configured[2], p, w, B, pl.ksplit, pl.kwarps,
                         pl.ksmem, s);
}

extern "C" int ec_attn_train_fwd(const void* q, const void* k, const void* v, int in_dt,
                                 long sqb, long sqn, long skb, long skn, long svb, long svn,
                                 int B, int H, int D, int Nq, int Nk,
                                 const void* kvalid, long skvb, const void* bias,
                                 float scale, const void* seed, unsigned thresh,
                                 float inv_keep, void* out, long sob, long son, void* stats,
                                 int qsplit, int warps, int chunk16, long smem,
                                 void* stream) {
  AttnArgs p;
  if (!attn_args(p, q, k, v, in_dt, sqb, sqn, skb, skn, svb, svn, B, H, Nq, Nk, kvalid,
                 skvb, bias, scale) || (thresh && !seed) || !stats)
    return (int)cudaErrorInvalidValue;
  p.seed = static_cast<const unsigned long long*>(seed);
  p.thresh = thresh; p.inv_keep = inv_keep;
  p.stats = static_cast<float*>(stats);
  p.out = out; p.out_dt = DT_F32; p.sob = sob; p.son = son;
  const AttnPlan pl = {qsplit, warps, chunk16, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_train_fwd<32>(p, B, pl, s);
  if (D == 64) return launch_train_fwd<64>(p, B, pl, s);
  if (D == 128) return launch_train_fwd<128>(p, B, pl, s);
  return (int)cudaErrorInvalidValue;
}

// dq, dk, dv: fp32 [B, N, H * D], contiguous; dbias [B, H, Nq, Nk] or
// null; delta: fp32 scratch [B * H, Nq]; kvalid: the forward's bool mask.
extern "C" int ec_attn_train_bwd(const void* q, const void* k, const void* v, int in_dt,
                                 long sqb, long sqn, long skb, long skn, long svb, long svn,
                                 int B, int H, int D, int Nq, int Nk,
                                 const void* kvalid, long skvb, const void* bias, float scale,
                                 const void* seed, unsigned thresh, float inv_keep,
                                 const void* dout, int do_dt, long sdb, long sdn,
                                 const void* stats, void* dq, void* dk, void* dv, void* dbias,
                                 void* delta,
                                 int qsplit, int qwarps, int chunk16, long qsmem,
                                 int ksplit, int kwarps, long ksmem, void* stream) {
  AttnArgs p;
  const int nq16 = (Nq + 15) / 16;
  if (!attn_args(p, q, k, v, in_dt, sqb, sqn, skb, skn, svb, svn, B, H, Nq, Nk, kvalid,
                 skvb, bias, scale) || (thresh && !seed) || !stats || !dout || !dq || !dk ||
      !dv || !delta || nq16 * 16 > ATT_MAX_NK)
    return (int)cudaErrorInvalidValue;
  p.seed = static_cast<const unsigned long long*>(seed);
  p.thresh = thresh; p.inv_keep = inv_keep;
  p.stats = static_cast<float*>(const_cast<void*>(stats));
  BwdArgs w;
  w.dout = dout; w.do_dt = do_dt; w.sdb = sdb; w.sdn = sdn;
  w.dq = static_cast<float*>(dq); w.dk = static_cast<float*>(dk);
  w.dv = static_cast<float*>(dv); w.dbias = static_cast<float*>(dbias);
  w.delta = static_cast<float*>(delta);
  w.NQ16 = nq16;
  const BwdPlan pl = {qsplit, qwarps, chunk16, qsmem, ksplit, kwarps, ksmem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_train_bwd<32>(p, w, B, pl, s);
  if (D == 64) return launch_train_bwd<64>(p, w, B, pl, s);
  if (D == 128) return launch_train_bwd<128>(p, w, B, pl, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------ post-attention layer kernels
// A layer's work after its attention as one kernel: enc_post_kernel for the
// joint encoder (ops/fused_encoder.py), dec_post_self_kernel and
// dec_post_cross_kernel for the graph decoder (ops/fused_decoder.py
// fused_decoder_layer). They replace the GEMM / LayerNorm chains that ran
// there, with the TPU kernels' rounding points
// (edgecape_tpu/ops/fused_encoder.py _layer_body, fused_decoder.py
// _kernel): bf16 operands, fp32 accumulation and LayerNorm statistics.
//
// What bounds them on this card: at the eval chunk's shapes each moves
// about as many bytes through device memory as its products take on the
// tensor cores (the encoder's at [181560 rows, 256], F 384: 95 GFLOP and
// 280-370 MB, about 0.1 ms either way), while the chains they replace
// carried fp32 [rows, 256] intermediates through device memory between
// 5-12 launches. C = 256 and F = 384 are small, so the design keeps whole
// rows on chip:
//   * 384 threads: a producer warpgroup, one thread of which issues every
//     TMA copy, and two consumer warpgroups of 64 rows each; setmaxnreg
//     moves registers from the producer (24 a thread) to the consumers
//     (240). Without it ptxas holds every thread of a 384-thread block to
//     168 registers, and a 288-thread block (a producer warp) got the same
//     168 and spilled 1-2 KB a thread;
//   * a tile's input rows arrive by TMA in 128-byte-swizzled slabs of
//     [128 rows x 64] bf16 (an "in" barrier pair, released by the
//     consumers once the rows are read); the weights stream through a ring
//     of 16 KB slots (a [128 x 64] box or two [64 x 64]) in the order the
//     consumers use them, the same for every tile, so they come from L2;
//   * products on wgmma from shared memory, one group kept in flight while
//     the next slot is awaited, into fp32 accumulators that hold
//     whole 256-channel rows (two 128-column halves, 128 registers a
//     thread): bias, residual and LayerNorm run on them, a row's 64 values
//     a thread summed over the quad by shuffles;
//   * an intermediate that feeds another product (bf16(x), one F chunk of
//     the hidden, o2, y) is rounded to bf16 and written by the threads into
//     a swizzled slab in the layout wgmma reads, then a proxy fence and a
//     barrier of the warpgroup (of both where both read it);
//   * a tile's residual rows are prefetched into L2 when the tile starts,
//     so the epilogue's loads of them wait on L2 and not on device memory;
//   * the FFN's second product accumulates onto the LayerNorm output x
//     that its residual adds (x + sum h w2 + b2, where the TPU kernel forms
//     x + (sum h w2 + b2)): this saves the 128 registers of a separate
//     accumulator and moves one fp32 summation point.
// The grid is persistent, one block an SM (224 KB of shared memory each).

#define PA_C 256              // channels of a row
#define PA_ROWS 128           // rows of a tile
#define PA_THREADS 384        // the producer warpgroup + two consumer warpgroups
#define PA_SLAB 16384         // a swizzled [128 rows x 64] bf16 slab
#define PA_UNIT 16384         // a ring slot
#define EP_STAGES 8           // ring slots: encoder, decoder self, decoder cross
#define DS_STAGES 6
#define DC_STAGES 4
// the slabs and the slots (aligned to 1024 bytes in the kernel), then the
// barriers: full and empty per slot, in_full and in_empty
#define PA_SMEM(slabs, stages) (1024 + ((slabs) + (stages)) * PA_SLAB + (2 * (stages) + 2) * 8)
#define EP_SMEM PA_SMEM(6, EP_STAGES)
#define DS_SMEM PA_SMEM(8, DS_STAGES)
#define DC_SMEM PA_SMEM(10, DC_STAGES)
static_assert(EP_SMEM <= 232448 && DS_SMEM <= 232448 && DC_SMEM <= 232448,
              "a post-attention kernel exceeds the shared memory of a block");
static_assert(PA_SLAB == SW_SLAB, "sw_off (hopper.cuh) lays out slabs of PA_SLAB bytes");

// acc += A . B^T over one 64-deep k slab: A the warpgroup's 64 rows of a
// K-major slab at shared address a, B 128 (mma_n128) or 64 (mma_n64)
// K-major rows at b.
__device__ __forceinline__ void mma_n128(float (&acc)[64], unsigned a, unsigned b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16<0>(acc, wg_desc(a + kk * 32, 16), wg_desc(b + kk * 32, 16), 1);
}

__device__ __forceinline__ void mma_n64(float (&acc)[32], unsigned a, unsigned b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16<0>(acc, wg_desc(a + kk * 32, 16), wg_desc(b + kk * 32, 16));
}

// The weight ring: slot i % S of S, a "full" barrier that the copies
// complete and an "empty" one that the 8 consumer warps release.
template <int S>
struct PaRing {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  unsigned it;     // the next slot to fill (producer) or to take (consumers)
  unsigned done;   // consumers: the next slot to hand back

  // producer: wait until the next slot is free and arm it for `bytes`
  __device__ __forceinline__ uint64_t* arm(unsigned bytes) {
    const unsigned s = it % S;
    if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
    mbar_expect_tx(&full[s], bytes);
    return &full[s];
  }
  // producer: one [128 x 64] box at (column c, row r) into the next slot
  __device__ __forceinline__ void load(const CUtensorMap* map, int c, int r) {
    uint64_t* bar = arm(PA_UNIT);
    tma_load_3d(slots + (it % S) * PA_UNIT, map, bar, c, r, 0);
    ++it;
  }
  // producer: two [64 x 64] boxes (columns c and c + 64, row r)
  __device__ __forceinline__ void load2(const CUtensorMap* map, int c, int r) {
    uint64_t* bar = arm(PA_UNIT);
    unsigned char* dst = slots + (it % S) * PA_UNIT;
    tma_load_3d(dst, map, bar, c, r, 0);
    tma_load_3d(dst + PA_UNIT / 2, map, bar, c + 64, r, 0);
    ++it;
  }
  // producer: two [64 x 64] boxes (column c, rows r and r + 64)
  __device__ __forceinline__ void load2_rows(const CUtensorMap* map, int c, int r) {
    uint64_t* bar = arm(PA_UNIT);
    unsigned char* dst = slots + (it % S) * PA_UNIT;
    tma_load_3d(dst, map, bar, c, r, 0);
    tma_load_3d(dst + PA_UNIT / 2, map, bar, c, r + 64, 0);
    ++it;
  }
  // consumers: wait for the next slot; its shared address, ready for
  // products (wgmma.fence issued)
  __device__ __forceinline__ unsigned next() {
    const unsigned s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    ++it;
    wg_fence();
    return smem_u32(slots + s * PA_UNIT);
  }
  // consumers, after issuing a slot's products: commit them as a group
  // and hand back the slot before it, whose group is then complete
  // (`first`: there is none in this run of slots)
  __device__ __forceinline__ void issued(int lane, bool first) {
    wg_commit();
    if (!first) {
      wg_wait<1>();
      give(lane);
    }
  }
  // consumers, after a run of slots: wait for its last group
  __device__ __forceinline__ void drain(int lane) {
    wg_wait<0>();
    give(lane);
  }
  __device__ __forceinline__ void give(int lane) {
    if (lane == 0) mbar_arrive(&empty[done % S]);
    ++done;
  }
};

// Lays out the dynamic shared memory (`slabs` slabs, then the ring, then
// the barriers) and initialises the barriers; returns the first slab.
template <int S>
__device__ __forceinline__ unsigned char* pa_init(unsigned char* raw, int slabs, PaRing<S>& ring,
                                                  uint64_t*& in_full, uint64_t*& in_empty) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  ring.slots = base + slabs * PA_SLAB;
  ring.full = reinterpret_cast<uint64_t*>(ring.slots + S * PA_UNIT);
  ring.empty = ring.full + S;
  ring.it = ring.done = 0;
  in_full = ring.empty + S;
  in_empty = in_full + 1;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 8);
    }
    mbar_init(in_full, 1);
    mbar_init(in_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return base;
}

__device__ __forceinline__ void regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// Starts rows r0 and r1 (skipped when < 0) of a [*, 256] matrix of
// el_bytes-wide elements on their way into L2: the quad's four threads
// take every fourth 128-byte line.
__device__ __forceinline__ void prefetch_rows(const void* m, int el_bytes, long r0, long r1,
                                              int t) {
  const long row_bytes = (long)PA_C * el_bytes;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const long r = rh ? r1 : r0;
    if (r < 0) continue;
    const char* row = static_cast<const char*>(m) + r * row_bytes;
    for (long off = 128 * t; off < row_bytes; off += 512)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + off));
  }
}

// Row helpers on a warpgroup's 64 x 256 tile v[2][64] in wgmma's
// accumulator layout: half h holds columns 128 h + 8 j + 2 t + e in
// v[h][4 j + 2 rh + e] of rows lr + 8 rh (lane = 4 g + t).

// v += vec[column] for a per-column fp32 vector
__device__ __forceinline__ void rows_add_cols(float (&v)[2][64], const float* vec, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(vec + 128 * h + 8 * j + 2 * t));
      v[h][4 * j] += b.x; v[h][4 * j + 1] += b.y;
      v[h][4 * j + 2] += b.x; v[h][4 * j + 3] += b.y;
    }
  }
}

// v += rows r0 and r1 (a row < 0 adds nothing) of a [*, 256] bf16 matrix
__device__ __forceinline__ void rows_add(float (&v)[2][64], const bf16* m, long r0, long r1,
                                         int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const long r = rh ? r1 : r0;
    if (r < 0) continue;
    const bf16* row = m + r * PA_C + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int jb = 0; jb < 16; jb += 8) {
        unsigned u[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          u[j] = __ldg(reinterpret_cast<const unsigned*>(row + 128 * h + 8 * (jb + j)));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[h][4 * (jb + j) + 2 * rh] += __uint_as_float(u[j] << 16);
          v[h][4 * (jb + j) + 2 * rh + 1] += __uint_as_float(u[j] & 0xffff0000u);
        }
      }
    }
  }
}

// the same for a [*, 256] fp32 matrix
__device__ __forceinline__ void rows_add(float (&v)[2][64], const float* m, long r0, long r1,
                                         int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const long r = rh ? r1 : r0;
    if (r < 0) continue;
    const float* row = m + r * PA_C + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int jb = 0; jb < 16; jb += 8) {
        float2 u[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          u[j] = __ldg(reinterpret_cast<const float2*>(row + 128 * h + 8 * (jb + j)));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[h][4 * (jb + j) + 2 * rh] += u[j].x;
          v[h][4 * (jb + j) + 2 * rh + 1] += u[j].y;
        }
      }
    }
  }
}

// LayerNorm of each row with fp32 statistics and the two-pass variance:
// (v - mean) * rsqrt(var + eps) * gamma + beta.
__device__ __forceinline__ void rows_layernorm(float (&v)[2][64], const float* gamma,
                                               const float* beta, float eps, int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float s = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) s += v[h][4 * j + 2 * rh] + v[h][4 * j + 2 * rh + 1];
    const float mean = quad_sum(s) * (1.0f / PA_C);
    float q = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float d0 = v[h][4 * j + 2 * rh] - mean, d1 = v[h][4 * j + 2 * rh + 1] - mean;
        q += d0 * d0 + d1 * d1;
      }
    const float inv = rsqrtf(quad_sum(q) * (1.0f / PA_C) + eps);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[h][4 * j + 2 * rh] = (v[h][4 * j + 2 * rh] - mean) * inv;
        v[h][4 * j + 2 * rh + 1] = (v[h][4 * j + 2 * rh + 1] - mean) * inv;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 128 * h + 8 * j + 2 * t;
      const float2 g = __ldg(reinterpret_cast<const float2*>(gamma + c));
      const float2 b = __ldg(reinterpret_cast<const float2*>(beta + c));
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        v[h][4 * j + 2 * rh] = v[h][4 * j + 2 * rh] * g.x + b.x;
        v[h][4 * j + 2 * rh + 1] = v[h][4 * j + 2 * rh + 1] * g.y + b.y;
      }
    }
  }
}

// rows r0, r1 (skipped when < 0) of v into a bf16 or fp32 matrix with row
// stride ld
__device__ __forceinline__ void rows_store(const float (&v)[2][64], void* out, int dt, long ld,
                                           long r0, long r1, int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const long r = rh ? r1 : r0;
    if (r < 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long off = r * ld + 128 * h + 8 * j + 2 * t;
        const float a = v[h][4 * j + 2 * rh], b = v[h][4 * j + 2 * rh + 1];
        if (dt == DT_BF16)
          *reinterpret_cast<unsigned*>(static_cast<bf16*>(out) + off) = pack_bf16(a, b);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(a, b);
      }
    }
  }
}

// bf16 of v's rows lr, lr + 8 into swizzled slabs (256 columns: 4 slabs)
__device__ __forceinline__ void rows_to_slabs(const float (&v)[2][64], unsigned char* slabs,
                                              int lr, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        *reinterpret_cast<unsigned*>(slabs + sw_off(lr + 8 * rh, 128 * h + 8 * j + 2 * t)) =
            pack_bf16(v[h][4 * j + 2 * rh], v[h][4 * j + 2 * rh + 1]);
}

// An accumulator of N / 2 columns (N = 64: 128 columns, N = 32: 64):
// + bias[column], optional ReLU, then bf16 into swizzled slabs.
template <int N>
__device__ __forceinline__ void acc_to_slabs(float (&a)[N], const float* bias, bool relu,
                                             unsigned char* slabs, int lr, int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float2 b = make_float2(0.0f, 0.0f);
    if (bias) b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float x = a[4 * j + 2 * rh] + b.x, y = a[4 * j + 2 * rh + 1] + b.y;
      if (relu) {
        x = fmaxf(x, 0.0f);
        y = fmaxf(y, 0.0f);
      }
      *reinterpret_cast<unsigned*>(slabs + sw_off(lr + 8 * rh, 8 * j + 2 * t)) = pack_bf16(x, y);
    }
  }
}

// ---- joint encoder: a = att . Wo^T + bo; x = LN1(src + a);
// y = LN2(x + relu(bf16(x) . W1^T + b1) . W2^T + b2) with the hidden in F
// chunks of 128; y written in the tokens' type and / or the next layer's
// src = bf16(bf16(y) + pos[row % n_tok]).
struct EncPostArgs {
  const bf16* src;
  const float *bo, *g1, *be1, *b1, *b2, *g2, *be2;
  const bf16* pos;
  void* out; int out_dt;
  bf16* nxt;
  int R, F, n_tok;
  float eps;
};

__global__ void __launch_bounds__(PA_THREADS, 1)
    enc_post_kernel(const __grid_constant__ CUtensorMap map_att,
                    const __grid_constant__ CUtensorMap map_wo,
                    const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_w2, EncPostArgs p) {
  extern __shared__ unsigned char pa_raw[];
  PaRing<EP_STAGES> ring;
  uint64_t *in_full, *in_empty;
  unsigned char* xs = pa_init(pa_raw, 6, ring, in_full, in_empty);  // att, then bf16(x)
  unsigned char* hs = xs + 4 * PA_SLAB;                               // one chunk of the hidden
  const int tiles = (p.R + PA_ROWS - 1) / PA_ROWS, chunks = p.F / 128;

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      unsigned n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        if (n) mbar_wait(in_empty, (n - 1) & 1);
        mbar_expect_tx(in_full, 4 * PA_SLAB);
        for (int ks = 0; ks < 4; ++ks)
          tma_load_3d(xs + ks * PA_SLAB, &map_att, in_full, 64 * ks, tile * PA_ROWS, 0);
        for (int ks = 0; ks < 4; ++ks)
          for (int h = 0; h < 2; ++h) ring.load(&map_wo, 64 * ks, 128 * h);
        for (int j = 0; j < chunks; ++j) {
          for (int ks = 0; ks < 4; ++ks) ring.load(&map_w1, 64 * ks, 128 * j);
          for (int ks = 0; ks < 2; ++ks)
            for (int h = 0; h < 2; ++h) ring.load(&map_w2, 128 * j + 64 * ks, 128 * h);
        }
      }
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const unsigned xa = smem_u32(xs) + wg * 64 * 128, ha = smem_u32(hs) + wg * 64 * 128;
  unsigned n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const long r0 = (long)tile * PA_ROWS + lr, r1 = r0 + 8;
    const long s0 = r0 < p.R ? r0 : -1, s1 = r1 < p.R ? r1 : -1;
    prefetch_rows(p.src, 2, s0, s1, t);
    if (p.nxt) prefetch_rows(p.pos, 2, s0 < 0 ? -1 : s0 % p.n_tok, s1 < 0 ? -1 : s1 % p.n_tok, t);
    float x[2][64];
    acc_zero(x[0]);
    acc_zero(x[1]);
    reg_fence(x[0]);
    reg_fence(x[1]);
    mbar_wait(in_full, n & 1);
    // a = att . Wo^T: slot i holds k slab i / 2 of column half i % 2
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned b = ring.next();
      if (i & 1) mma_n128(x[1], xa + (i >> 1) * PA_SLAB, b);
      else mma_n128(x[0], xa + (i >> 1) * PA_SLAB, b);
      ring.issued(lane, i == 0);
    }
    ring.drain(lane);
    reg_fence(x[0]);
    reg_fence(x[1]);
    // x = LN1(src + a + bo); rows past R read row R - 1 and are not stored
    rows_add_cols(x, p.bo, t);
    rows_add(x, p.src, s0 < 0 ? p.R - 1 : r0, s1 < 0 ? p.R - 1 : r1, t);
    rows_layernorm(x, p.g1, p.be1, p.eps, t);
    bar_wg(wg);
    rows_to_slabs(x, xs, lr, t);      // over this warpgroup's att rows
    fence_view_async();
    bar_wg(wg);
    for (int j = 0; j < chunks; ++j) {
      float f[64];
      acc_zero(f);
      reg_fence(f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned b = ring.next();
        mma_n128(f, xa + i * PA_SLAB, b);
        ring.issued(lane, i == 0);
      }
      ring.drain(lane);
      reg_fence(f);
      if (j == chunks - 1 && lane == 0) mbar_arrive(in_empty);   // xs may take the next tile
      bar_wg(wg);
      acc_to_slabs(f, p.b1 + 128 * j, true, hs, lr, t);
      fence_view_async();
      bar_wg(wg);
      reg_fence(x[0]);
      reg_fence(x[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {     // k slab i / 2 of the chunk, column half i % 2
        const unsigned b = ring.next();
        if (i & 1) mma_n128(x[1], ha + (i >> 1) * PA_SLAB, b);
        else mma_n128(x[0], ha + (i >> 1) * PA_SLAB, b);
        ring.issued(lane, i == 0);
      }
      ring.drain(lane);
      reg_fence(x[0]);
      reg_fence(x[1]);
    }
    rows_add_cols(x, p.b2, t);
    rows_layernorm(x, p.g2, p.be2, p.eps, t);
    if (p.out) rows_store(x, p.out, p.out_dt, PA_C, s0, s1, t);
    if (p.nxt) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const long r = rh ? s1 : s0;
        if (r < 0) continue;
        const bf16* pr = p.pos + (r % p.n_tok) * PA_C + 2 * t;
        bf16* o = p.nxt + r * PA_C + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const unsigned u = __ldg(reinterpret_cast<const unsigned*>(pr + 128 * h + 8 * j));
            const float a = __bfloat162float(__float2bfloat16(x[h][4 * j + 2 * rh]));
            const float b = __bfloat162float(__float2bfloat16(x[h][4 * j + 2 * rh + 1]));
            *reinterpret_cast<unsigned*>(o + 128 * h + 8 * j) =
                pack_bf16(a + __uint_as_float(u << 16), b + __uint_as_float(u & 0xffff0000u));
          }
      }
    }
  }
}

// ---- decoder, after the self-attention: x1 = LN1(xb + att . Wso^T +
// bso), written in fp32; q2 = bf16(bf16(x1) . Wcq_x^T + qpos . Wcq_p^T +
// bcq) for the cross-attention, its 512 columns in two halves.
struct DecSelfArgs {
  const bf16* xb;
  const float *bso, *g1, *be1, *bcq;
  float* x1;
  bf16* q2;
  int R;
  float eps;
};

__global__ void __launch_bounds__(PA_THREADS, 1)
    dec_post_self_kernel(const __grid_constant__ CUtensorMap map_att,
                         const __grid_constant__ CUtensorMap map_qp,
                         const __grid_constant__ CUtensorMap map_wso,
                         const __grid_constant__ CUtensorMap map_wcqx,
                         const __grid_constant__ CUtensorMap map_wcqp, DecSelfArgs p) {
  extern __shared__ unsigned char pa_raw[];
  PaRing<DS_STAGES> ring;
  uint64_t *in_full, *in_empty;
  unsigned char* xs = pa_init(pa_raw, 8, ring, in_full, in_empty);  // att, then bf16(x1)
  unsigned char* qs = xs + 4 * PA_SLAB;                               // qpos
  const int tiles = (p.R + PA_ROWS - 1) / PA_ROWS;

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      unsigned n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        if (n) mbar_wait(in_empty, (n - 1) & 1);
        mbar_expect_tx(in_full, 8 * PA_SLAB);
        for (int ks = 0; ks < 4; ++ks) {
          tma_load_3d(xs + ks * PA_SLAB, &map_att, in_full, 64 * ks, tile * PA_ROWS, 0);
          tma_load_3d(qs + ks * PA_SLAB, &map_qp, in_full, 64 * ks, tile * PA_ROWS, 0);
        }
        for (int ks = 0; ks < 4; ++ks)
          for (int h = 0; h < 2; ++h) ring.load(&map_wso, 64 * ks, 128 * h);
        for (int q = 0; q < 2; ++q) {
          for (int ks = 0; ks < 4; ++ks)
            for (int h = 0; h < 2; ++h) ring.load(&map_wcqx, 64 * ks, 256 * q + 128 * h);
          for (int ks = 0; ks < 4; ++ks)
            for (int h = 0; h < 2; ++h) ring.load(&map_wcqp, 64 * ks, 256 * q + 128 * h);
        }
      }
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const unsigned xa = smem_u32(xs) + wg * 64 * 128, qa = smem_u32(qs) + wg * 64 * 128;
  unsigned n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const long r0 = (long)tile * PA_ROWS + lr, r1 = r0 + 8;
    const long s0 = r0 < p.R ? r0 : -1, s1 = r1 < p.R ? r1 : -1;
    prefetch_rows(p.xb, 2, s0, s1, t);
    float x[2][64];
    acc_zero(x[0]);
    acc_zero(x[1]);
    reg_fence(x[0]);
    reg_fence(x[1]);
    mbar_wait(in_full, n & 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {       // k slab i / 2, column half i % 2
      const unsigned b = ring.next();
      if (i & 1) mma_n128(x[1], xa + (i >> 1) * PA_SLAB, b);
      else mma_n128(x[0], xa + (i >> 1) * PA_SLAB, b);
      ring.issued(lane, i == 0);
    }
    ring.drain(lane);
    reg_fence(x[0]);
    reg_fence(x[1]);
    rows_add_cols(x, p.bso, t);
    rows_add(x, p.xb, s0 < 0 ? p.R - 1 : r0, s1 < 0 ? p.R - 1 : r1, t);
    rows_layernorm(x, p.g1, p.be1, p.eps, t);
    rows_store(x, p.x1, DT_F32, PA_C, s0, s1, t);
    bar_wg(wg);
    rows_to_slabs(x, xs, lr, t);
    fence_view_async();
    bar_wg(wg);
    for (int q = 0; q < 2; ++q) {
      acc_zero(x[0]);
      acc_zero(x[1]);
      reg_fence(x[0]);
      reg_fence(x[1]);
      // bf16(x1) . Wcq_x^T, then qpos . Wcq_p^T: slot i holds k slab
      // (i / 2) % 4 of column half i % 2
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const unsigned b = ring.next();
        const unsigned a = (i < 8 ? xa : qa) + ((i >> 1) & 3) * PA_SLAB;
        if (i & 1) mma_n128(x[1], a, b);
        else mma_n128(x[0], a, b);
        ring.issued(lane, i == 0);
      }
      ring.drain(lane);
      reg_fence(x[0]);
      reg_fence(x[1]);
      if (q == 1 && lane == 0) mbar_arrive(in_empty);
      rows_add_cols(x, p.bcq + 256 * q, t);
      rows_store(x, p.q2 + 256 * q, DT_BF16, 2 * PA_C, s0, s1, t);
    }
  }
}

// ---- decoder, after the cross-attention, one batch row of K <= 128
// keypoints a tile (rows past K: zero att2 rows from the TMA, zero
// adjacency rows and columns): o2 = bf16(att2 . Wco^T + bco) in 64-column
// pieces, each multiplied into the choker at once; x2 = LN2(x1 + a2 +
// bch); per F chunk of 64: y_s = bf16(bf16(x2) . Wg_s^T + bg_s) for the
// two slices s, m = adj0 . y0 + adj1 . y1, f2 += bf16(relu(m)) . Wf^T;
// out = LN3(x2 + f2 + bf).
struct DecCrossArgs {
  const float *bco, *bch, *g2, *be2, *bg, *bf, *g3, *be3;
  const float* x1;
  const void* adj; int adj_dt;
  void* out; int out_dt;
  int B, K, F;
  float eps;
};

__global__ void __launch_bounds__(PA_THREADS, 1)
    dec_post_cross_kernel(const __grid_constant__ CUtensorMap map_att2,
                          const __grid_constant__ CUtensorMap map_wco,
                          const __grid_constant__ CUtensorMap map_wch,
                          const __grid_constant__ CUtensorMap map_wg,
                          const __grid_constant__ CUtensorMap map_wf, DecCrossArgs p) {
  extern __shared__ unsigned char pa_raw[];
  PaRing<DC_STAGES> ring;
  uint64_t *in_full, *in_empty;
  // 8 slabs of att2; then bf16(x2) over the first four, the adjacency's two
  // slices over the last four
  unsigned char* as = pa_init(pa_raw, 10, ring, in_full, in_empty);
  unsigned char* adjs = as + 4 * PA_SLAB;
  // y0 | y1 of one F chunk (rows = keypoints, the B operand); the y0 slab
  // also holds a warpgroup's own rows of an o2 piece and of the hidden
  // chunk (A operands), which only its own y0 rows ever overlay
  unsigned char* ys = as + 8 * PA_SLAB;
  const int chunks = p.F / 64;

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      unsigned n = 0;
      for (int b = blockIdx.x; b < p.B; b += gridDim.x, ++n) {
        if (n) mbar_wait(in_empty, (n - 1) & 1);
        mbar_expect_tx(in_full, 8 * PA_SLAB);
        for (int ks = 0; ks < 8; ++ks)
          tma_load_3d(as + ks * PA_SLAB, &map_att2, in_full, 64 * ks, 0, b);
        for (int pc = 0; pc < 8; ++pc) {
          for (int u = 0; u < 4; ++u) ring.load2(&map_wco, 128 * u, 64 * pc);
          for (int h = 0; h < 2; ++h) ring.load(&map_wch, 64 * pc, 128 * h);
        }
        for (int j = 0; j < chunks; ++j) {
          for (int s = 0; s < 2; ++s)
            for (int u = 0; u < 2; ++u) ring.load2(&map_wg, 128 * u, s * p.F + 64 * j);
          for (int h = 0; h < 2; ++h) ring.load(&map_wf, 64 * j, 128 * h);
        }
      }
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const unsigned aa = smem_u32(as) + wg * 64 * 128, oa = smem_u32(ys) + wg * 64 * 128;
  const unsigned adja = smem_u32(adjs) + wg * 64 * 128, ya = smem_u32(ys);
  unsigned n = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x, ++n) {
    const long r0 = lr < p.K ? (long)b * p.K + lr : -1;
    const long r1 = lr + 8 < p.K ? (long)b * p.K + lr + 8 : -1;
    prefetch_rows(p.x1, 4, r0, r1, t);
    float x[2][64];
    acc_zero(x[0]);
    acc_zero(x[1]);
    mbar_wait(in_full, n & 1);
    for (int pc = 0; pc < 8; ++pc) {
      float o[32];
      acc_zero(o);
      reg_fence(o);
#pragma unroll
      for (int u = 0; u < 4; ++u) {     // k slabs 2 u and 2 u + 1 of att2
        const unsigned w = ring.next();
        mma_n64(o, aa + 2 * u * PA_SLAB, w);
        mma_n64(o, aa + (2 * u + 1) * PA_SLAB, w + PA_UNIT / 2);
        ring.issued(lane, u == 0);
      }
      ring.drain(lane);
      reg_fence(o);
      bar_wg(wg);
      acc_to_slabs(o, p.bco + 64 * pc, false, ys, lr, t);
      fence_view_async();
      bar_wg(wg);
      reg_fence(x[0]);
      reg_fence(x[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned w = ring.next();
        if (h) mma_n128(x[1], oa, w);
        else mma_n128(x[0], oa, w);
        ring.issued(lane, h == 0);
      }
      ring.drain(lane);
      reg_fence(x[0]);
      reg_fence(x[1]);
    }
    // x2 = LN2(x1 + a2 + bch); rows past K add no x1
    rows_add_cols(x, p.bch, t);
    rows_add(x, p.x1, r0, r1, t);
    rows_layernorm(x, p.g2, p.be2, p.eps, t);
    bar_wg(wg);
    rows_to_slabs(x, as, lr, t);
    {
      // this warpgroup's 64 rows of both adjacency slices, bf16, zero past K
      const int tw = threadIdx.x & 127;
      const long base = (long)b * 2 * p.K * p.K;
      for (int i = tw; i < 2 * 64 * 64; i += 128) {
        const int s = i >> 12, r = 64 * wg + ((i >> 6) & 63), c = 2 * (i & 63);
        float v0 = 0.0f, v1 = 0.0f;
        if (r < p.K) {
          const long off = base + ((long)s * p.K + r) * p.K + c;
          if (c < p.K) v0 = ld_val(p.adj, p.adj_dt, off);
          if (c + 1 < p.K) v1 = ld_val(p.adj, p.adj_dt, off + 1);
        }
        *reinterpret_cast<unsigned*>(adjs + s * 2 * PA_SLAB + sw_off(r, c)) = pack_bf16(v0, v1);
      }
    }
    fence_view_async();
    bar_wg(wg);
    for (int j = 0; j < chunks; ++j) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float y[32];
        acc_zero(y);
        reg_fence(y);
#pragma unroll
        for (int u = 0; u < 2; ++u) {   // k slabs 2 u and 2 u + 1 of bf16(x2)
          const unsigned w = ring.next();
          mma_n64(y, aa + 2 * u * PA_SLAB, w);
          mma_n64(y, aa + (2 * u + 1) * PA_SLAB, w + PA_UNIT / 2);
          ring.issued(lane, u == 0);
        }
        ring.drain(lane);
        reg_fence(y);
        // own keypoint rows of y_s: this warpgroup's hidden rows of the last
        // chunk in the y0 slab are read (its own products waited for)
        bar_wg(wg);
        acc_to_slabs(y, p.bg + s * p.F + 64 * j, false, ys + s * PA_SLAB, lr, t);
      }
      fence_view_async();
      bar_consumers();                  // y0 and y1 whole
      float m[32];
      acc_zero(m);
      reg_fence(m);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_m64n64k16<1>(m,
                             wg_desc(adja + s * 2 * PA_SLAB + (kk >> 2) * PA_SLAB + (kk & 3) * 32, 16),
                             wg_desc(ya + s * PA_SLAB + kk * 2048, PA_SLAB));
      wg_commit();
      wg_wait<0>();
      reg_fence(m);
      if (j == chunks - 1 && lane == 0) mbar_arrive(in_empty);   // att2 slabs free
      bar_consumers();                  // both warpgroups are done with y0, y1
      acc_to_slabs(m, nullptr, true, ys, lr, t);
      fence_view_async();
      bar_wg(wg);
      reg_fence(x[0]);
      reg_fence(x[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned w = ring.next();
        if (h) mma_n128(x[1], oa, w);
        else mma_n128(x[0], oa, w);
        ring.issued(lane, h == 0);
      }
      ring.drain(lane);
      reg_fence(x[0]);
      reg_fence(x[1]);
    }
    rows_add_cols(x, p.bf, t);
    rows_layernorm(x, p.g3, p.be3, p.eps, t);
    rows_store(x, p.out, p.out_dt, PA_C, r0, r1, t);
  }
}

// ---- decoder stack, a layer's keypoint head: the final norm, both
// kpt_branch passes and the coordinate update of the TPU kernel
// edgecape_tpu/ops/fused_decoder.py _stack_kernel (:456-475) as one
// kernel. Per tile of 64 keypoint rows of the layer's bf16 output x,
// warpgroup 0 takes the rows as they are (the TMA's, slab rows 0-63) and
// warpgroup 1 the same rows under the final norm (LayerNorm in fp32,
// rounded to bf16 into slab rows 64-127); each runs h = bf16(gelu(h .
// W_i^T + b_i)) for the three 256 x 256 products (W_i streamed through the
// ring, h in shared memory between them), then dd = h . Wo^T + bo (N = 2)
// on the CUDA cores from its accumulators (a row's 256 values lie over a
// quad: one shuffle sum) and writes sigmoid(inverse_sigmoid(ct) + dd):
// warpgroup 0 the trajectory `pts`, warpgroup 1 the head recompute
// `outs`. Nothing of the 2 x 256-wide hidden reaches device memory.
// Bound at [51000 rows]: 40 GFLOP (0.04 ms); each tile streams the 384 KB
// of W_0..W_2 from L2.
#define KH_ROWS 64
#define KH_STAGES 6
#define KH_SMEM PA_SMEM(8, KH_STAGES)
static_assert(KH_SMEM <= 232448, "the keypoint head exceeds the shared memory of a block");

struct KptHeadArgs {
  const bf16* x;
  const float *g, *be, *b0, *b1, *b2, *bo;
  const bf16* wo;              // [2, 256]
  const float* ct;             // [R, 2]
  float *pts, *outs;           // [R, 2]
  int R;
  float eps, ieps;
};

__global__ void __launch_bounds__(PA_THREADS, 1)
    kpt_head_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w0,
                    const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_w2, KptHeadArgs p) {
  extern __shared__ unsigned char pa_raw[];
  PaRing<KH_STAGES> ring;
  uint64_t *in_full, *in_empty;
  // four slabs of the tile's input rows (raw, then normed), four of the
  // hidden, each warpgroup its own 64 rows
  unsigned char* xs = pa_init(pa_raw, 8, ring, in_full, in_empty);
  unsigned char* hs = xs + 4 * PA_SLAB;
  const int tiles = (p.R + KH_ROWS - 1) / KH_ROWS;

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      const CUtensorMap* maps[3] = {&map_w0, &map_w1, &map_w2};
      unsigned n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        if (n) mbar_wait(in_empty, (n - 1) & 1);
        mbar_expect_tx(in_full, 4 * KH_ROWS * 128);
        for (int ks = 0; ks < 4; ++ks)
          tma_load_3d(xs + ks * PA_SLAB, &map_x, in_full, 64 * ks, tile * KH_ROWS, 0);
        for (int i = 0; i < 3; ++i)
          for (int ks = 0; ks < 4; ++ks)
            for (int h = 0; h < 2; ++h) ring.load(maps[i], 64 * ks, 128 * h);
      }
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int kr = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);   // row in the tile
  const int lr = wg * 64 + kr;                                   // row in the slabs
  const unsigned xa = smem_u32(xs) + wg * 64 * 128, ha = smem_u32(hs) + wg * 64 * 128;
  const float* bias[3] = {p.b0, p.b1, p.b2};
  float* dst = wg ? p.outs : p.pts;
  unsigned n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const long r0 = (long)tile * KH_ROWS + kr, r1 = r0 + 8;
    const long s0 = r0 < p.R ? r0 : -1, s1 = r1 < p.R ? r1 : -1;
    float x[2][64];
    if (wg == 1) {
      // the final norm of the tile's rows (rows past R: LayerNorm of 0)
      acc_zero(x[0]);
      acc_zero(x[1]);
      rows_add(x, p.x, s0, s1, t);
      rows_layernorm(x, p.g, p.be, p.eps, t);
      rows_to_slabs(x, xs, lr, t);
      fence_view_async();
      bar_wg(wg);
    }
    mbar_wait(in_full, n & 1);
    for (int i = 0; i < 3; ++i) {
      acc_zero(x[0]);
      acc_zero(x[1]);
      reg_fence(x[0]);
      reg_fence(x[1]);
      const unsigned a = i == 0 ? xa : ha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {     // k slab j / 2, column half j % 2
        const unsigned b = ring.next();
        if (j & 1) mma_n128(x[1], a + (j >> 1) * PA_SLAB, b);
        else mma_n128(x[0], a + (j >> 1) * PA_SLAB, b);
        ring.issued(lane, j == 0);
      }
      ring.drain(lane);
      reg_fence(x[0]);
      reg_fence(x[1]);
      if (i == 0 && lane == 0) mbar_arrive(in_empty);     // xs may take the next tile
      rows_add_cols(x, bias[i], t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 64; ++e)
          x[hh][e] = gelu_as(x[hh][e]);
      if (i < 2) {
        bar_wg(wg);
        rows_to_slabs(x, hs, lr, t);
        fence_view_async();
        bar_wg(wg);
      }
    }
    // dd = bf16(h) . Wo^T + bo: this thread's 64 columns of rows r0, r1,
    // summed over the quad
    float dd[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 128 * hh + 8 * j + 2 * t;
        float wv[2][2];
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p.wo + o * PA_C + c));
          wv[o][0] = __uint_as_float(u << 16);
          wv[o][1] = __uint_as_float(u & 0xffff0000u);
        }
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const float v0 = __bfloat162float(__float2bfloat16(x[hh][4 * j + 2 * rh]));
          const float v1 = __bfloat162float(__float2bfloat16(x[hh][4 * j + 2 * rh + 1]));
#pragma unroll
          for (int o = 0; o < 2; ++o)
            dd[rh][o] = fmaf(v1, wv[o][1], fmaf(v0, wv[o][0], dd[rh][o]));
        }
      }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int o = 0; o < 2; ++o) dd[rh][o] = quad_sum(dd[rh][o]);
    if (t == 0) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const long r = rh ? s1 : s0;
        if (r < 0) continue;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const float c = fminf(fmaxf(p.ct[2 * r + o], 0.0f), 1.0f);
          const float inv = logf(fmaxf(c, p.ieps) / fmaxf(1.0f - c, p.ieps));
          dst[2 * r + o] = 1.0f / (1.0f + expf(-(inv + (dd[rh][o] + p.bo[o]))));
        }
      }
    }
  }
}

// ---- the ViT block's MLP half (ops/fused_mlp.py fused_ln_mlp, #9, and
// the second half of ops/fused_vit_block.py, #1 / #2) as one kernel:
// y = x + ls * (bf16(gelu(bf16(LN(x)) . W1 + b1)) . W2 + b2) with the
// rounding points of the TPU kernels edgecape_tpu/ops/fused_mlp.py
// _kernel and fused_vit_block.py _block_body (fp32 LayerNorm statistics
// of x as given, h rounded to bf16, the hidden rounded to bf16 after the
// exact-erf GELU, the residual from x unrounded), y stored as out_dt; and
// optionally h_next = bf16(LN'(bf16(y))), the next block's LN1.
//
// Bound at [131070 rows, 384], F 1536: 309 GFLOP, 0.31 ms at the bf16
// peak, against 0.2-0.3 GB of rows in and out. The chain it replaces
// (LayerNorm, fc1 with GELU, fc2 with the residual) wrote the [R, 1536]
// bf16 hidden (403 MB) and read it back, and made LN2 a launch of its
// own. Design:
//   * 256 threads: two consumer warpgroups of 64 rows of a 128-row tile
//     each, and no producer warps, so that a thread may hold 255
//     registers (with a producer warpgroup, setmaxnreg leaves 240, and
//     ptxas spilled the loop's state around the 192 output registers);
//   * W1 and W2 stream by TMA through a ring of 8 slots of 16 KB in the
//     order the warpgroups use them, chunk 0 first, the same for every
//     tile of every block (so from L2): fc2 sums the hidden chunks into
//     fp32 registers in that order, so a row's bits do not depend on the
//     block, the tile or the call it lands in. Where the blocks walk more
//     than one tile each, they start in four groups about a chunk's time
//     apart (5 us), so that they do not all ask L2 for the same lines at
//     once (on an H100 the query pass took 1.070 ms in lockstep, 1.030
//     so staggered, 0.998 when each block started at its own chunk and
//     summed in its own order); each of the 8
//     warps counts its release of a slot in shared memory, and the warp
//     whose release is the eighth issues the slot's next load at once:
//     nobody waits for a slot to be freed;
//   * the LayerNorm prologue: a warp takes 16 rows from device memory
//     (fp32 or bf16), a lane the columns 64 k + 2 l + e, and writes bf16 h
//     into 6 swizzled [128 x 64] slabs (96 KB); an fp32 tile (192 KB)
//     would not fit beside the ring;
//   * a warpgroup's 64 x 384 fp32 output stays in registers (3 x m64n128,
//     192 a thread); the hidden goes in chunks of 64 columns: fc1 as
//     wgmma m64n64 from shared memory into 32 registers, bias and GELU
//     (gelu_as) on them, packed to bf16 as the A fragments of fc2, whose
//     wgmma takes A from registers (the layout of an m64n64 accumulator is
//     that of four k16 A fragments). No hidden value reaches shared or
//     device memory;
//   * each warpgroup's GELU and epilogue run under the other's products
//     as far as the shared ring lets them drift apart (8 slots);
//   * W1 and W2 are read as torch Linear weights (K-major: [F, C], [C, F])
//     or as the JAX function takes them (MN-major: [C, F], [F, C]), by the
//     transpose bit of wgmma: no transposed copy;
//   * the epilogue re-reads x (L2-hot since the prologue) and, with the
//     next LayerNorm, sums bf16(y) in layernorm_kernel's order.
// The grid is persistent, one block an SM (225 KB of shared memory).
#define VM_C 384              // channels
#define VM_ROWS 128           // rows of a tile
#define VM_CHUNK 64           // hidden columns of a chunk
#define VM_THREADS 256        // two consumer warpgroups
#define VM_STAGES 8
// the slabs and the slots (aligned to 1024 bytes in the kernel), then a
// full barrier and a release counter per slot
#define VM_SMEM (1024 + (6 + VM_STAGES) * PA_SLAB + VM_STAGES * (8 + 4))
static_assert(VM_SMEM <= 232448, "vit_mlp_kernel exceeds the shared memory of a block");

// fc1 of a chunk from one slot: the warpgroup's 64 rows (h slabs 2 s and
// 2 s + 1, descriptor hd of the first slab's first byte) times the
// chunk's 64 hidden columns (the slot w). An A descriptor is hd plus the
// offset >> 4 (shared addresses stay below 2^18, so the 14-bit address
// field does not carry).
template <bool KMAJ>
__device__ __forceinline__ void vm_fc1_slot(float (&f)[32], uint64_t hd, unsigned w, int s) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hd + (((2 * s + ks) * PA_SLAB + kk * 32) >> 4);
      // K-major: a [64 n x 64 k] box; MN-major: a [64 k x 64 n] box
      if (KMAJ)
        wgmma_m64n64k16<0>(f, da, wg_desc(w + ks * (PA_UNIT / 2) + kk * 32, 16));
      else
        wgmma_m64n64k16<1>(f, da, wg_desc(w + ks * (PA_UNIT / 2) + kk * 2048, PA_UNIT / 2));
    }
}

struct VitMlpArgs {
  const void* x; int x_dt;       // [R, 384]
  const float *g, *be, *b1, *b2, *ls;
  void* out; int out_dt;         // [R, 384]
  const float *gn, *ben;         // the next LayerNorm, with hn
  bf16* hn;                      // [R, 384] or null
  int R, F;
  float eps;
};

// The rows a LayerNorm prologue reads: x [R, 384] fp32 or bf16 and the
// norm's scale and shift.
struct LnRows {
  const void* x; int x_dt;
  const float *g, *be;
  int R;
  float eps;
};

// The prologue: LayerNorm of tile rows lrow0 .. lrow0 + 15 by one warp,
// BATCH rows' loads in flight at a time, lane l the columns 64 k + 2 l + e
// (layernorm_kernel's order), bf16 into the swizzled slabs; rows past R
// are zeros. ROUND: fp32 x is rounded to bf16 before the statistics.
template <bool ROUND, int BATCH>
__device__ __forceinline__ void vm_prologue(const LnRows& p, unsigned char* hs, long row0,
                                            int lrow0, int lane) {
  float2 g[6], b[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    g[k] = __ldg(reinterpret_cast<const float2*>(p.g + 64 * k + 2 * lane));
    b[k] = __ldg(reinterpret_cast<const float2*>(p.be + 64 * k + 2 * lane));
  }
#pragma unroll 1
  for (int i0 = 0; i0 < 16; i0 += BATCH) {
    float v[BATCH][12];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const long r = row0 + lrow0 + i0 + i;
#pragma unroll
      for (int e = 0; e < 12; ++e) v[i][e] = 0.0f;
      if (r >= p.R) continue;
      if (p.x_dt == DT_F32) {
        const float* xr = static_cast<const float*>(p.x) + r * VM_C + 2 * lane;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float2 u = __ldg(reinterpret_cast<const float2*>(xr + 64 * k));
          v[i][2 * k] = ROUND ? round_bf16(u.x) : u.x;
          v[i][2 * k + 1] = ROUND ? round_bf16(u.y) : u.y;
        }
      } else {
        const bf16* xr = static_cast<const bf16*>(p.x) + r * VM_C + 2 * lane;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const unsigned u = __ldg(reinterpret_cast<const unsigned*>(xr + 64 * k));
          v[i][2 * k] = __uint_as_float(u << 16);
          v[i][2 * k + 1] = __uint_as_float(u & 0xffff0000u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int lrow = lrow0 + i0 + i;
      unsigned hv[6];
      if (row0 + lrow < p.R) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < 12; ++e) s = __fadd_rn(s, v[i][e]);
        const float mean = ln_mean(warp_sum(s), VM_C);
        float q = 0.0f;
#pragma unroll
        for (int e = 0; e < 12; ++e) q = ln_sq(q, v[i][e], mean);
        const float inv = ln_inv(warp_sum(q), VM_C, p.eps);
#pragma unroll
        for (int k = 0; k < 6; ++k)
          hv[k] = pack_bf16(ln_apply(v[i][2 * k], mean, inv, g[k].x, b[k].x),
                            ln_apply(v[i][2 * k + 1], mean, inv, g[k].y, b[k].y));
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) hv[k] = 0u;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k)
        *reinterpret_cast<unsigned*>(hs + sw_off(lrow, 64 * k + 2 * lane)) = hv[k];
    }
  }
}

// The sum over a row of a warpgroup's 64 x 384 tile in accumulator layout
// (a[h][4 j + 2 rh + e]: column 128 h + 8 j + 2 t + e of row half rh), in
// layernorm_kernel's order: this thread t of the quad holds the columns of
// the lanes 4 v + t, v < 8 (v = j % 8, k = 2 h + j / 8); it sums each
// v's in that lane's order, forms the butterfly's steps 16, 8 and 4 apart
// in registers and then 2 and 1 apart by shuffles. SQ: the sum of squared
// deviations from `mean` instead.
template <bool SQ>
__device__ __forceinline__ float vm_row_sum(const float (&a)[3][64], int rh, float mean) {
  float pv[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = a[k >> 1][4 * (8 * (k & 1) + v) + 2 * rh + e];
        s = SQ ? ln_sq(s, x, mean) : __fadd_rn(s, x);
      }
    pv[v] = s;
  }
  const float q0 = __fadd_rn(pv[0], pv[4]), q1 = __fadd_rn(pv[1], pv[5]);
  const float q2 = __fadd_rn(pv[2], pv[6]), q3 = __fadd_rn(pv[3], pv[7]);
  float s = __fadd_rn(__fadd_rn(q0, q2), __fadd_rn(q1, q3));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  return __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
}

// Starts the warpgroup's 64 rows of the tile at row0 (rows lrow0 ..) on
// their way into L2, a 128-byte line a thread at a time, so that the
// prologue's loads of them wait on L2 and not on device memory.
__device__ __forceinline__ void vm_prefetch(const void* x, int x_dt, int R, long row0,
                                            int lrow0, int tid) {
  const int row_bytes = VM_C * (x_dt == DT_F32 ? 4 : 2), lines = row_bytes / 128;
  for (int i = tid; i < 64 * lines; i += 128) {
    const long r = row0 + lrow0 + i / lines;
    if (r < R)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(static_cast<const char*>(x) +
                                                      r * row_bytes + (i % lines) * 128));
  }
}

// The loads of vit_mlp_kernel's ring: a tile's chunks 0, 1, .. in turn,
// each the three fc1 slots then the three fc2 slots, the same for every
// tile of every block. fc2 reduces over the chunks in this order, so no
// block may start at another chunk: a row's sum order would then follow
// the block its tile lands on. fc1 slot r < 3 holds the k slabs 2 r,
// 2 r + 1 of the chunk's 64 columns, fc2 slot r - 3 the output columns
// 128 (r - 3) .. + 127.
template <bool KMAJ>
struct VmLoader {
  static constexpr unsigned kBytes = PA_UNIT;
  const CUtensorMap *w1, *w2;
  int chunks;

  __device__ __forceinline__ void operator()(unsigned i, unsigned char* dst,
                                             uint64_t* bar) const {
    const int r = (int)(i % 6), f0 = VM_CHUNK * (int)(i / 6 % chunks);
    mbar_expect_tx(bar, PA_UNIT);
    if (r < 3) {
      if (KMAJ) {
        tma_load_3d(dst, w1, bar, 128 * r, f0, 0);
        tma_load_3d(dst + PA_UNIT / 2, w1, bar, 128 * r + 64, f0, 0);
      } else {
        tma_load_3d(dst, w1, bar, f0, 128 * r, 0);
        tma_load_3d(dst + PA_UNIT / 2, w1, bar, f0, 128 * r + 64, 0);
      }
    } else if (KMAJ) {
      tma_load_3d(dst, w2, bar, f0, 128 * (r - 3), 0);
    } else {
      tma_load_3d(dst, w2, bar, 128 * (r - 3), f0, 0);
      tma_load_3d(dst + PA_UNIT / 2, w2, bar, 128 * (r - 3) + 64, f0, 0);
    }
  }
};

// KMAJ: w1 [F, 384] and w2 [384, F] (torch Linear weights); else w1
// [384, F] and w2 [F, 384].
template <bool KMAJ>
__global__ void __launch_bounds__(VM_THREADS, 1)
    vit_mlp_kernel(const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_w2, VitMlpArgs p) {
  extern __shared__ unsigned char pa_raw[];
  unsigned char* hs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pa_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tiles = (p.R + VM_ROWS - 1) / VM_ROWS, chunks = p.F / VM_CHUNK;
  constexpr int TB = KMAJ ? 0 : 1;
  CountRing<VM_STAGES, VmLoader<KMAJ>> ring;
  ring.place(hs + 6 * PA_SLAB, hs + (6 + VM_STAGES) * PA_SLAB,
             (unsigned)((tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) *
                 chunks * 6);
  ring.ld.w1 = &map_w1;
  ring.ld.w2 = &map_w2;
  ring.ld.chunks = chunks;
  if (threadIdx.x == 0) {
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (tiles > (int)gridDim.x) __nanosleep((blockIdx.x % 4u) * 5000u);   // the stagger
    ring.prime();
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = wg * 64 + warp * 16 + (lane >> 2);    // the thread's first row in the tile
  const unsigned ha = smem_u32(hs) + wg * 64 * 128;
  const LnRows ln = {p.x, p.x_dt, p.g, p.be, p.R, p.eps};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * VM_ROWS;
    bar_wg(wg);                           // the last tile's products have read the slabs
    vm_prologue<false, 4>(ln, hs, row0, wg * 64 + warp * 16, lane);
    fence_view_async();
    bar_wg(wg);
    if (tile + (int)gridDim.x < tiles)
      vm_prefetch(p.x, p.x_dt, p.R, row0 + (long)gridDim.x * VM_ROWS, wg * 64,
                  threadIdx.x & 127);
    float acc[3][64];
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      acc_zero(acc[h]);
      reg_fence(acc[h]);
    }
    for (int j = 0; j < chunks; ++j) {
      // fc1 into an m64n64 accumulator, bias, GELU, bf16: its registers
      // become the four k16 A fragments of fc2
      float f[32];
      acc_zero(f);
      reg_fence(f);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        vm_fc1_slot<KMAJ>(f, wg_desc(ha, 16), ring.next(), s);
        ring.issued(lane, s == 0);
      }
      ring.drain(lane);
      reg_fence(f);
      unsigned a[4][4];
      const float* b1 = p.b1 + VM_CHUNK * j + 2 * t;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + 8 * n8));
        const float y0 = gelu_as(f[4 * n8] + bb.x), y1 = gelu_as(f[4 * n8 + 1] + bb.y);
        const float y2 = gelu_as(f[4 * n8 + 2] + bb.x);
        const float y3 = gelu_as(f[4 * n8 + 3] + bb.y);
        a[n8 >> 1][2 * (n8 & 1)] = pack_bf16(y0, y1);        // row g
        a[n8 >> 1][2 * (n8 & 1) + 1] = pack_bf16(y2, y3);    // row g + 8
      }
#pragma unroll
      for (int h = 0; h < 3; ++h) reg_fence(acc[h]);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const unsigned b = ring.next();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_m64n128k16<TB>(acc[s], a[kk],
                                  KMAJ ? wg_desc(b + kk * 32, 16)
                                       : wg_desc(b + kk * 2048, PA_UNIT / 2));
        ring.issued(lane, s == 0);
      }
      ring.drain(lane);
#pragma unroll
      for (int h = 0; h < 3; ++h) reg_fence(acc[h]);
    }

    // a batch's residual values are loaded before its arithmetic (one
    // wait on L2 a batch); rows past R read row R - 1 and are not stored
    const long r0 = row0 + lr, r1 = r0 + 8;
    const bool ok0 = r0 < p.R, ok1 = r1 < p.R;
    const long o0 = (ok0 ? r0 : p.R - 1) * VM_C, o1 = (ok1 ? r1 : p.R - 1) * VM_C;
#pragma unroll
    for (int h = 0; h < 3; ++h)
#pragma unroll
      for (int jb = 0; jb < 16; jb += 8) {
        const int c0 = 128 * h + 8 * jb + 2 * t;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const long o = rh ? o1 : o0;
          float2 xv[8];
          if (p.x_dt == DT_F32) {
            const float* xr = static_cast<const float*>(p.x) + o + c0;
#pragma unroll
            for (int j = 0; j < 8; ++j) xv[j] = __ldg(reinterpret_cast<const float2*>(xr + 8 * j));
          } else {
            const bf16* xr = static_cast<const bf16*>(p.x) + o + c0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const unsigned u = __ldg(reinterpret_cast<const unsigned*>(xr + 8 * j));
              xv[j] = make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + 8 * j, i = 4 * (jb + j) + 2 * rh;
            const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b2 + c));
            const float2 l = __ldg(reinterpret_cast<const float2*>(p.ls + c));
            const float y0 = __fmaf_rn(l.x, __fadd_rn(acc[h][i], bb.x), xv[j].x);
            const float y1 = __fmaf_rn(l.y, __fadd_rn(acc[h][i + 1], bb.y), xv[j].y);
            if (rh ? ok1 : ok0) {
              const long off = (rh ? r1 : r0) * VM_C + c;
              if (p.out_dt == DT_BF16)
                *reinterpret_cast<unsigned*>(static_cast<bf16*>(p.out) + off) = pack_bf16(y0, y1);
              else
                *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(y0, y1);
            }
            acc[h][i] = __bfloat162float(__float2bfloat16(y0));
            acc[h][i + 1] = __bfloat162float(__float2bfloat16(y1));
          }
        }
      }
    if (p.hn) {
      float mean[2], inv[2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        mean[rh] = ln_mean(vm_row_sum<false>(acc, rh, 0.0f), VM_C);
        inv[rh] = ln_inv(vm_row_sum<true>(acc, rh, mean[rh]), VM_C, p.eps);
      }
#pragma unroll
      for (int h = 0; h < 3; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 128 * h + 8 * j + 2 * t;
          const float2 gg = __ldg(reinterpret_cast<const float2*>(p.gn + c));
          const float2 bb = __ldg(reinterpret_cast<const float2*>(p.ben + c));
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const long r = rh ? r1 : r0;
            if (r >= p.R) continue;
            const int i = 4 * j + 2 * rh;
            *reinterpret_cast<unsigned*>(p.hn + r * VM_C + c) =
                pack_bf16(ln_apply(acc[h][i], mean[rh], inv[rh], gg.x, bb.x),
                          ln_apply(acc[h][i + 1], mean[rh], inv[rh], gg.y, bb.y));
          }
        }
    }
  }
}

// ---- the ViT block's attention half (ops/fused_attn_block.py
// fused_attn_block, #10, and the first half of ops/fused_vit_block.py,
// #1 / #2) as two kernels: y = x + ls * (att . Wp^T + bp), att the
// multi-head attention over q | k | v = bf16(bf16(LN(bf16(x))) . Wqkv^T +
// bqkv), with the rounding points of the TPU kernels
// edgecape_tpu/ops/fused_attn_block.py _kernel and fused_vit_block.py
// _block_body: x rounded to bf16 on entry, fp32 LayerNorm statistics, h,
// q, k and v rounded to bf16, fp32 scores with the keys at or beyond N
// masked, p = bf16(e / sum e) (normalised before the rounding), o_h =
// bf16(p . v_h) per head, the projection accumulated in fp32 and the
// residual taken from bf16(x); y stored as out_dt.
//
// Bound at [510 images, 257 tokens, 384], 6 heads of 64: 155 GFLOP of
// projections and 52 GFLOP of attention products, 0.21 ms at the bf16
// peak. The chain it replaces (LayerNorm, the qkv GEMM, attention in two
// register passes, the proj GEMM) wrote h and att (100.7 MB each) to
// device memory and read them back; here only q, k and v cross it. Both
// kernels are latency-bound per SM (one block of 8 warps an SM): every
// operand and result moves by TMA, so that no thread waits on a global
// load or spends instructions on a scattered store.
//   * vit_qkv_kernel (A) is vit_mlp_kernel's prologue and weight ring
//     without the MLP: the LayerNorm of a 128-row tile into six swizzled
//     bf16 slabs, Wqkv [1152, 384] streamed by TMA through a ring of 6
//     slots of [128 x 64], 9 chunks of 128 output columns on wgmma
//     m64n128 (64 accumulator registers a thread: the 16 KB slot and the
//     product of the GEMM and vit_mlp_kernel, whose shared-memory operand
//     rate, 96 bytes a clock at the tensor cores' peak, is within the
//     SM's 128); the bias and the bf16 rounding on the accumulators, then
//     each warpgroup's [64 x 128] chunk through a staging tile in shared
//     memory to qkv [R, 1152] by TMA stores (stored by the threads, 4
//     bytes at a time, they were the kernel's largest cost);
//   * vit_attn_kernel (B): a block takes items of 128 query rows of one
//     image (an image of N tokens has ceil(N / 128) of them), a warpgroup
//     64 of them. For each head, K_h and V_h ([272 keys x 64] bf16 in two
//     TMA boxes of 136 rows, since a box holds at most 256) land in shared
//     memory once for both warpgroups, and each warpgroup's Q_h has landed
//     in slab h of its att tile. One wgmma pass forms the whole score row
//     (two m64n136 halves, 136 registers a thread); the row max and sum go
//     over the quad; p, normalised, is packed to bf16 as the A fragments of
//     P . V, whose B operand V is read MN-major through the descriptor's
//     transpose bit; o_h, rounded to bf16, overwrites Q_h in slab h.
//     K_{h+1} is loaded as soon as both warpgroups have formed their
//     scores, V_{h+1} as soon as both have multiplied by V_h, so each load
//     runs under the other half of a head's work. After the sixth head the
//     att tile (64 x 384 bf16 a warpgroup) is the A operand of the
//     projection: Wproj streams through a ring of 3 slots of [128 x 64],
//     and each chunk of 128 output columns is summed in 64 fp32 registers
//     (a whole 64 x 384 accumulator, 192 registers beside the kernel's
//     state, spilled and serialised the products) before its epilogue adds
//     bp and ls (from shared memory) and bf16(x). The residual tiles come
//     by TMA through the V buffer, free after the last head (its load
//     sequence is an item's six heads, then x of the three chunks), while
//     the K buffer already takes the next item's K_0. Read by the threads
//     as global loads, x was the kernel's largest cost.
// B's shared memory: two att tiles 96 KB, K and V 68 KB, the ring 48 KB
// (a fourth slot would not fit), bp and ls 3 KB; one block an SM, 256
// threads and no producer warps, so that a thread may hold 255 registers:
// every copy is issued by the warp whose release frees its buffer
// (CountRing), so the loaders divide by no run-time value (the residual's
// type is a template parameter, va_div). A warpgroup whose 64 rows lie
// past N (the last item of a 257-token image holds one row, in warpgroup
// 0) waits and releases with the other and multiplies nothing; its own
// branch, since products and their registers in branches of their own
// are serialised by ptxas. Tried and dropped: one ring of seven 18 KB
// buffers for the K_h / V_h halves, the Wproj slots and the residual
// (loads further ahead, but more of them, each on a warp's release path:
// slower).
#define VA_HEADS 6
#define VA_D 64
#define VA_HALF 136                 // keys of a score half (wgmma m64n136)
#define VA_KEYS (2 * VA_HALF)       // keys a score row holds in registers
#define VA_SLAB 8192                // a swizzled [64 rows x 64] bf16 slab
#define VA_KV_BYTES (VA_KEYS * 128)
#define VA_STAGES 3                 // Wproj ring slots
#define VA_WP_LOADS 18              // [128 x 64] slots of Wproj
#define VQ_STAGES 6                 // Wqkv ring slots
#define VQ_CHUNKS 9                 // 128-column chunks of the 1152 outputs
// A: the h slabs, the slots and a staging tile per warpgroup (aligned to
// 1024 bytes in the kernel), then a full barrier and a release counter per
// slot. B: the att tiles, K, V and the slots, then the barriers and
// counters, bp and ls.
#define VQ_SMEM (1024 + (6 + VQ_STAGES + 2) * PA_SLAB + VQ_STAGES * 12)
#define VB_SMEM (1024 + 12 * VA_SLAB + 2 * VA_KV_BYTES + VA_STAGES * PA_UNIT + 128 + 8 * VM_C)
static_assert(VQ_SMEM <= 232448 && VB_SMEM <= 232448,
              "a ViT attention kernel exceeds the shared memory of a block");

// d (+)= a . b for one m64n136k16 tile into d[OFF .. OFF + 67], a and b in
// shared memory, b K-major.
template <int OFF>
__device__ __forceinline__ void wgmma_m64n136k16(float (&d)[2 * 68], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67},"
      " %68, %69, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]),
        "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]),
        "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]),
        "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]),
        "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]),
        "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]),
        "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]),
        "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]),
        "+f"(d[OFF + 46]), "+f"(d[OFF + 47]), "+f"(d[OFF + 48]), "+f"(d[OFF + 49]),
        "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]),
        "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]),
        "+f"(d[OFF + 62]), "+f"(d[OFF + 63]), "+f"(d[OFF + 64]), "+f"(d[OFF + 65]),
        "+f"(d[OFF + 66]), "+f"(d[OFF + 67])
      : "l"(da), "l"(db), "r"(1));
}

struct VitQkvArgs {
  LnRows ln;            // x [R, 384] and LN1
  const float* bias;    // [1152]
};

// The loads of vit_qkv_kernel's ring: a tile's 9 chunks of 128 output
// columns in turn, each its 6 k slabs of 64, the same for every tile of
// the block; block b starts at chunk b % 9, so that the blocks do not all
// ask L2 for the same lines at the same time. The chunks are output
// columns, each summed over its k slabs 0 .. 5 in turn, so the rotation
// leaves every element's sum order as it is.
struct VqLoader {
  static constexpr unsigned kBytes = PA_UNIT;
  const CUtensorMap* w;
  int rot;

  __device__ __forceinline__ void operator()(unsigned i, unsigned char* dst,
                                             uint64_t* bar) const {
    const int r = (int)(i % (6 * VQ_CHUNKS));
    mbar_expect_tx(bar, PA_UNIT);
    tma_load_3d(dst, w, bar, 64 * (r % 6), 128 * ((r / 6 + rot) % VQ_CHUNKS), 0);
  }
};

// map_w: Wqkv [1152, 384] bf16 (torch Linear layout, K-major); map_qkv:
// the output [R, 1152] bf16 in boxes of [64 rows x 64].
__global__ void __launch_bounds__(VM_THREADS, 1)
    vit_qkv_kernel(const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_qkv, VitQkvArgs p) {
  extern __shared__ unsigned char pa_raw[];
  unsigned char* hs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pa_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int R = p.ln.R, tiles = (R + VM_ROWS - 1) / VM_ROWS;
  CountRing<VQ_STAGES, VqLoader> ring;
  ring.place(hs + 6 * PA_SLAB, hs + (6 + VQ_STAGES + 2) * PA_SLAB,
             (unsigned)((tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * 6 *
                 VQ_CHUNKS);
  ring.ld.w = &map_w;
  ring.ld.rot = (int)(blockIdx.x % VQ_CHUNKS);
  if (threadIdx.x == 0) {
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) ring.prime();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = warp * 16 + (lane >> 2);    // the thread's first row of the warpgroup's 64
  const unsigned ha = smem_u32(hs) + wg * 64 * 128;
  // the warpgroup's staging tile: a chunk's [64 x 128] bf16 outputs in two
  // swizzled [64 x 64] boxes, written to device memory by TMA
  unsigned char* stage = hs + (6 + VQ_STAGES + wg) * PA_SLAB;
  const bool storer = (threadIdx.x & 127) == 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * VM_ROWS;
    bar_wg(wg);                           // the last tile's products have read the slabs
    vm_prologue<true, 8>(p.ln, hs, row0, wg * 64 + warp * 16, lane);
    fence_view_async();
    bar_wg(wg);
#pragma unroll 1
    for (int cc = 0; cc < VQ_CHUNKS; ++cc) {
      // the next tile's rows on their way into L2, late enough to be
      // there, and not evicted, when its prologue reads them
      if (cc == VQ_CHUNKS - 3 && tile + (int)gridDim.x < tiles)
        vm_prefetch(p.ln.x, p.ln.x_dt, R, row0 + (long)gridDim.x * VM_ROWS, wg * 64,
                    threadIdx.x & 127);
      float acc[64];
      acc_zero(acc);
      reg_fence(acc);
#pragma unroll
      for (int ks = 0; ks < 6; ++ks) {
        mma_n128(acc, ha + ks * PA_SLAB, ring.next());
        ring.issued(lane, ks == 0);
      }
      ring.drain(lane);
      reg_fence(acc);
      const int c0 = 128 * ((cc + ring.ld.rot) % VQ_CHUNKS);
      if (storer) tma_store_wait();       // the last chunk's stores have read the stage
      bar_wg(wg);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.bias + c0 + 8 * j + 2 * t));
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = lr + 8 * rh;
          *reinterpret_cast<unsigned*>(stage + (j >> 3) * VA_SLAB + r * 128 +
                                       (((j & 7) ^ (r & 7)) << 4) + 4 * t) =
              pack_bf16(acc[4 * j + 2 * rh] + bb.x, acc[4 * j + 2 * rh + 1] + bb.y);
        }
      }
      fence_view_async();
      bar_wg(wg);
      if (storer) {                       // rows past R are not written
        tma_store_3d(&map_qkv, stage, c0, (int)row0 + 64 * wg, 0);
        tma_store_3d(&map_qkv, stage + VA_SLAB, c0 + 64, (int)row0 + 64 * wg, 0);
      }
    }
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// item / ipi for the 1, 2 or 3 items of an image, without a division by a
// run-time value (the loaders run on the path of a buffer's release).
__device__ __forceinline__ int va_div(int item, int ipi) {
  return ipi == 3 ? item / 3 : ipi == 2 ? item >> 1 : item;
}

struct VitAttnArgs {
  void* out; int out_dt;      // [B N, 384]
  const float *bp, *ls;       // [384]
  int N;                      // tokens an image
  int ipi;                    // items an image: ceil(N / 128)
  int items;                  // B * ipi
  float sl2;                  // the score scale times log2(e)
};

// The loads of vit_attn_kernel's K and V buffers. K: an item's K_h of the
// heads 0 .. 5. V: its V_h, then the residual x of the projection chunks
// 0, 1, 2 (both warpgroups' 64 rows of the chunk's 128 columns: one load
// of 32 KB for bf16 x, two of 32 KB for fp32 x, warpgroup 0's first), so
// that the K buffer takes the next item's K_0 while the projection runs.
// K_h and V_h: [272 keys x 64] from the [B, N, 1152] map in two boxes of
// 136 rows; where N <= 136 the second box repeats rows 0 .. 135 (rows
// past N only meet masked scores and zero probabilities, and must hold
// finite values). x: boxes of 64 rows of 128 bytes (64 bf16 or 32 fp32
// columns), a warpgroup's 16 KB (bf16) or 32 KB (fp32) apart; none for a
// warpgroup whose rows all lie past N.
// PER: loads an item; X_F32: x is fp32 (else bf16).
template <int PER, bool X_F32>
struct VaKvLoader {
  static constexpr unsigned kBytes = VA_KV_BYTES;
  const CUtensorMap *m, *mx;
  int col0;       // 384: the keys, 768: the values
  int N, ipi, rot;

  __device__ __forceinline__ void operator()(unsigned i, unsigned char* dst,
                                             uint64_t* bar) const {
    constexpr bool x_f32 = X_F32;
    const int item = (int)blockIdx.x + (int)(i / PER) * (int)gridDim.x;
    const int r = (int)(i % PER), b = va_div(item, ipi);
    if (r < VA_HEADS) {
      const int c = col0 + VA_D * r;
      mbar_expect_tx(bar, VA_KV_BYTES);
      tma_load_3d(dst, m, bar, c, 0, b);
      tma_load_3d(dst + VA_HALF * 128, m, bar, c, N > VA_HALF ? VA_HALF : 0, b);
      return;
    }
    // bf16: chunk r - 6 for both warpgroups; fp32: chunk (r - 6) / 2 for
    // warpgroup (r - 6) % 2
    const int j = r - VA_HEADS, chunk = x_f32 ? j / 2 : j, cols = x_f32 ? 32 : 64;
    const int c = 128 * ((chunk + rot) % 3), q = (item - b * ipi) * VM_ROWS;
    int bytes = 0;
    for (int w = x_f32 ? j % 2 : 0; w < (x_f32 ? j % 2 + 1 : 2); ++w)
      if (q + 64 * w < N) bytes += 128 / cols * VA_SLAB;
    mbar_expect_tx(bar, bytes);
    for (int w = x_f32 ? j % 2 : 0; w < (x_f32 ? j % 2 + 1 : 2); ++w) {
      if (q + 64 * w >= N) continue;
      unsigned char* to = dst + (x_f32 ? 0 : w * 2 * VA_SLAB);
      for (int k = 0; k < 128 / cols; ++k)
        tma_load_3d(to + k * VA_SLAB, mx, bar, c + k * cols, q + 64 * w, b);
    }
  }
};

// Wproj [384 out, 384 in] in slots of [128 x 64]: load i holds the output
// columns 128 ((i % 18 / 6 + rot) % 3) .. + 127 of the k slab i % 6, the
// same 18 loads for every item; block b starts at column chunk b % 3
// (output columns: each element still sums the k slabs 0 .. 5 in turn,
// whatever the block).
struct VaWpLoader {
  static constexpr unsigned kBytes = PA_UNIT;
  const CUtensorMap* w;
  int rot;

  __device__ __forceinline__ void operator()(unsigned i, unsigned char* dst,
                                             uint64_t* bar) const {
    const int r = (int)(i % VA_WP_LOADS);
    mbar_expect_tx(bar, PA_UNIT);
    tma_load_3d(dst, w, bar, 64 * (r % 6), 128 * ((r / 6 + rot) % 3), 0);
  }
};

// One thread: the Q_h tiles of all heads of rows q0 .. q0 + 63 of image b
// into a warpgroup's six att slabs.
__device__ __forceinline__ void va_load_q(const CUtensorMap* m, unsigned char* slabs,
                                          uint64_t* bar, int b, int q0) {
  mbar_expect_tx(bar, VA_HEADS * VA_SLAB);
#pragma unroll
  for (int h = 0; h < VA_HEADS; ++h) tma_load_3d(slabs + h * VA_SLAB, m, bar, VA_D * h, q0, b);
}

// The softmax of a warpgroup's score tile, in place of the scores: s holds
// the thread's rows g and g + 8 of its warp's 16 against VA_KEYS keys (key
// 8 J + 2 t + e % 2 at s[4 J + e], row g for e < 2, else g + 8). Keys at
// or beyond n are masked, the rest scaled by sl2 = scale * log2(e) and
// exponentiated in base 2 against the row max (over the quad); each row is
// normalised by its sum, then rounded to bf16 into the A fragments of
// P . V (pf[kk]: keys 16 kk .. 16 kk + 15).
__device__ __forceinline__ void va_softmax(float (&s)[2 * 68], unsigned (&pf)[VA_KEYS / 16][4],
                                           int n, float sl2, int t) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int J = 0; J < VA_KEYS / 8; ++J)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = 8 * J + 2 * t + (e & 1) < n ? s[4 * J + e] * sl2 : -INFINITY;
      s[4 * J + e] = v;
      if (e < 2)
        m0 = fmaxf(m0, v);
      else
        m1 = fmaxf(m1, v);
    }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int J = 0; J < VA_KEYS / 8; ++J)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = ex2(s[4 * J + e] - (e < 2 ? m0 : m1));
      s[4 * J + e] = v;
      if (e < 2)
        l0 += v;
      else
        l1 += v;
    }
  const float i0 = 1.0f / quad_sum(l0), i1 = 1.0f / quad_sum(l1);
#pragma unroll
  for (int J = 0; J < VA_KEYS / 8; ++J) {
    pf[J >> 1][2 * (J & 1)] = pack_bf16(s[4 * J] * i0, s[4 * J + 1] * i0);
    pf[J >> 1][2 * (J & 1) + 1] = pack_bf16(s[4 * J + 2] * i1, s[4 * J + 3] * i1);
  }
}

// bf16(x) at row r of a warpgroup's residual tile xs (its 64 rows of a
// projection chunk, VaKvLoader's boxes), columns 8 j + 2 t and + 1 of the
// chunk's 128.
__device__ __forceinline__ float2 va_x_pair(const unsigned char* xs, bool f32, int j, int r,
                                            int t) {
  if (f32) {
    const float2 u = *reinterpret_cast<const float2*>(
        xs + (j >> 2) * VA_SLAB + r * 128 + (((2 * (j & 3) + (t >> 1)) ^ (r & 7)) << 4) +
        8 * (t & 1));
    return make_float2(round_bf16(u.x), round_bf16(u.y));
  }
  const unsigned u = *reinterpret_cast<const unsigned*>(
      xs + (j >> 3) * VA_SLAB + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * t);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// map_q, map_kv: qkv [B, N, 1152] bf16 in boxes of [64 rows x 64] and
// [136 rows x 64]; map_x: x [B, N, 384] (fp32 or bf16) in boxes of [64
// rows x 128 bytes]; map_wp: Wproj [384, 384] bf16 (torch Linear layout).
template <bool X_F32>
__global__ void __launch_bounds__(VM_THREADS, 1)
    vit_attn_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_kv,
                    const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_wp, VitAttnArgs p) {
  extern __shared__ unsigned char pa_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pa_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nitems = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  unsigned char* kv = base + 2 * VA_HEADS * VA_SLAB;
  unsigned char* bars = kv + 2 * VA_KV_BYTES + VA_STAGES * PA_UNIT;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bars);     // one a warpgroup
  float* vec_s = reinterpret_cast<float*>(bars + 128);     // bp, then ls
  // the V buffer's loads an item: the heads, then x (VaKvLoader)
  constexpr int v_loads = VA_HEADS + (X_F32 ? 6 : 3);
  CountRing<1, VaKvLoader<VA_HEADS, X_F32>> kr;
  CountRing<1, VaKvLoader<v_loads, X_F32>> vr;
  CountRing<VA_STAGES, VaWpLoader> wr;
  unsigned char* nb = kr.place(kv, bars + 16, (unsigned)nitems * VA_HEADS);
  nb = vr.place(kv + VA_KV_BYTES, nb, (unsigned)nitems * v_loads);
  wr.place(kv + 2 * VA_KV_BYTES, nb, (unsigned)nitems * VA_WP_LOADS);
  wr.ld.w = &map_wp;
  wr.ld.rot = (int)(blockIdx.x % 3);
  kr.ld.m = vr.ld.m = &map_kv;
  kr.ld.mx = vr.ld.mx = &map_x;
  kr.ld.col0 = VM_C;
  vr.ld.col0 = 2 * VM_C;
  kr.ld.N = vr.ld.N = p.N;
  kr.ld.ipi = vr.ld.ipi = p.ipi;
  kr.ld.rot = vr.ld.rot = wr.ld.rot;
  for (int i = threadIdx.x; i < 2 * VM_C; i += blockDim.x)
    vec_s[i] = i < VM_C ? p.bp[i] : p.ls[i - VM_C];
  if (threadIdx.x == 0) {
    mbar_init(&q_full[0], 1);
    mbar_init(&q_full[1], 1);
    kr.init();
    vr.init();
    wr.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    kr.prime();
    vr.prime();
    wr.prime();
    for (int w = 0; w < 2; ++w) {         // the first item's query tiles
      const int b0 = va_div((int)blockIdx.x, p.ipi);
      const int q0 = ((int)blockIdx.x - b0 * p.ipi) * VM_ROWS + 64 * w;
      if (q0 < p.N) va_load_q(&map_q, base + w * VA_HEADS * VA_SLAB, &q_full[w], b0, q0);
    }
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = warp * 16 + (lane >> 2);   // the thread's first row of the warpgroup's 64
  unsigned char* att = base + wg * VA_HEADS * VA_SLAB;
  const unsigned att_u = smem_u32(att);
  unsigned qpar = 0;
#pragma unroll 1
  for (int n = 0; n < nitems; ++n) {
    const int item = (int)blockIdx.x + n * (int)gridDim.x;
    const int b = va_div(item, p.ipi), q0 = (item - b * p.ipi) * VM_ROWS + 64 * wg;
    // once every warp's products have read the att tile: the next item's
    // query tiles into it
    auto next_q = [&]() {
      bar_wg(wg);
      if ((threadIdx.x & 127) == 0 && n + 1 < nitems) {
        const int nx = item + (int)gridDim.x, nb = va_div(nx, p.ipi);
        const int nq0 = (nx - nb * p.ipi) * VM_ROWS + 64 * wg;
        if (nq0 < p.N) va_load_q(&map_q, att, &q_full[wg], nb, nq0);
      }
    };
    if (q0 >= p.N) {
      // a warpgroup past N: its share of the waits and releases only
      for (int h = 0; h < VA_HEADS; ++h) {
        kr.wait();
        kr.give(lane);
        vr.wait();
        vr.give(lane);
      }
      for (int c = 0; c < 3; ++c) {
        for (int i = 0; i < 6; ++i) {
          wr.wait();
          wr.give(lane);
        }
        if (c == 2) next_q();
        for (int k = 0; k < (X_F32 ? 2 : 1); ++k) {
          vr.wait();
          vr.give(lane);
        }
      }
      continue;
    }
    mbar_wait(&q_full[wg], qpar);
    qpar ^= 1;
#pragma unroll 1
    for (int h = 0; h < VA_HEADS; ++h) {
      float s[2 * 68];
      const unsigned qa = att_u + h * VA_SLAB;
      const unsigned kb = kr.wait();
      acc_zero(s);
      reg_fence(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n136k16<0>(s, wg_desc(qa + kk * 32, 16), wg_desc(kb + kk * 32, 16));
        wgmma_m64n136k16<68>(s, wg_desc(qa + kk * 32, 16),
                             wg_desc(kb + VA_HALF * 128 + kk * 32, 16));
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      kr.give(lane);
      unsigned pf[VA_KEYS / 16][4];
      va_softmax(s, pf, p.N, p.sl2, t);
      float o[32];
      acc_zero(o);
      const unsigned vb = vr.wait();
      reg_fence(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < VA_KEYS / 16; ++kk)
        wgmma_rs_m64n64k16<1>(o, pf[kk], wg_desc(vb + kk * 2048, VA_SLAB));
      wg_commit();
      wg_wait<0>();
      reg_fence(o);
      vr.give(lane);
      // o_h, rounded to bf16, over Q_h in slab h
      unsigned char* slab = att + h * VA_SLAB;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = lr + 8 * rh;
          *reinterpret_cast<unsigned*>(slab + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
              pack_bf16(o[4 * j + 2 * rh], o[4 * j + 2 * rh + 1]);
        }
    }
    fence_view_async();
    bar_wg(wg);                           // the warpgroup's att tile is whole

    // the projection in three chunks of 128 output columns (chunk nci:
    // 128 ((nci + rot) % 3) .. + 127), each summed over the k slabs (the
    // heads) 0 .. 5 in turn into 64 registers, then its epilogue: y =
    // bf16(x) + ls * (acc + bp), the residual tile from the K or V buffer
    // (VaKvLoader), bp and ls from shared memory; rows past N are not
    // stored
    const long row0 = (long)b * p.N + q0;     // the warpgroup's first row
    const bool ok0 = q0 + lr < p.N, ok1 = q0 + lr + 8 < p.N;
    const long e0 = (row0 + lr) * VM_C, e1 = e0 + 8 * VM_C;
#pragma unroll 1
    for (int nci = 0; nci < 3; ++nci) {
      const int cb = 128 * ((nci + wr.ld.rot) % 3) + 2 * t;
      float acc[64];
      acc_zero(acc);
      reg_fence(acc);
#pragma unroll
      for (int ks = 0; ks < 6; ++ks) {
        mma_n128(acc, att_u + ks * VA_SLAB, wr.next());
        wr.issued(lane, ks == 0);
      }
      wr.drain(lane);
      reg_fence(acc);
      if (nci == 2) next_q();
      // the chunk's residual tile in the V buffer: both warpgroups' in one
      // load (bf16), or warpgroup 0's, then 1's (fp32; the other one's is
      // handed back at once)
      if (X_F32 && wg) {
        vr.wait();
        vr.give(lane);
      }
      vr.wait();
      const unsigned char* xs = vr.slots + (X_F32 ? 0 : wg * 2 * VA_SLAB);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = cb + 8 * j;
        const float2 bb = *reinterpret_cast<const float2*>(vec_s + c);
        const float2 l = *reinterpret_cast<const float2*>(vec_s + VM_C + c);
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          if (!(rh ? ok1 : ok0)) continue;
          const long off = (rh ? e1 : e0) + c;
          const float2 xv = va_x_pair(xs, X_F32, j, lr + 8 * rh, t);
          const float y0 = __fmaf_rn(l.x, __fadd_rn(acc[4 * j + 2 * rh], bb.x), xv.x);
          const float y1 = __fmaf_rn(l.y, __fadd_rn(acc[4 * j + 2 * rh + 1], bb.y), xv.y);
          if (p.out_dt == DT_BF16)
            *reinterpret_cast<unsigned*>(static_cast<bf16*>(p.out) + off) = pack_bf16(y0, y1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(y0, y1);
        }
      }
      vr.give(lane);
      if (X_F32 && !wg) {
        vr.wait();
        vr.give(lane);
      }
    }
  }
}

// The persistent grid for `work` tiles: one block an SM at most.
static int pa_grid(long work, int& grid) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  grid = (int)(work < sms ? work : sms);
  return 0;
}

template <typename Kern>
static int pa_configure(Kern kern, bool& done, int bytes) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

static bool pa_aligned(const void* p) { return p && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Contiguous bf16 operands: att, src [R, 256]; wo [256, 256]; w1 [F, 256];
// w2 [256, F]; pos [n_tok, 256]. fp32 vectors; out [R, 256] (out_dt) and
// nxt [R, 256] bf16, either may be null.
extern "C" int ec_enc_post(const void* att, const void* src, const void* wo, const void* bo,
                           const void* g1, const void* be1, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* g2, const void* be2,
                           const void* pos, int n_tok, void* out, int out_dt, void* nxt, int R,
                           int F, float eps, void* stream) {
  static bool configured = false;
  if (R <= 0 || F <= 0 || F % 128 || (!out && !nxt) || (nxt && (!pos || n_tok <= 0)) ||
      !pa_aligned(att) || !pa_aligned(wo) || !pa_aligned(w1) || !pa_aligned(w2))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_att, m_wo, m_w1, m_w2;
  if (!encode_map(&m_att, att, PA_C, R, PA_C, 0, 1, 128) ||
      !encode_map(&m_wo, wo, PA_C, PA_C, PA_C, 0, 1, 128) ||
      !encode_map(&m_w1, w1, PA_C, F, PA_C, 0, 1, 128) ||
      !encode_map(&m_w2, w2, F, PA_C, F, 0, 1, 128))
    return (int)cudaErrorInvalidValue;
  int e = pa_configure(enc_post_kernel, configured, EP_SMEM);
  if (e) return e;
  int grid = 0;
  if ((e = pa_grid((R + PA_ROWS - 1) / PA_ROWS, grid))) return e;
  EncPostArgs p;
  p.src = static_cast<const bf16*>(src);
  p.bo = static_cast<const float*>(bo); p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1); p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2); p.g2 = static_cast<const float*>(g2);
  p.be2 = static_cast<const float*>(be2);
  p.pos = static_cast<const bf16*>(pos);
  p.out = out; p.out_dt = out_dt;
  p.nxt = static_cast<bf16*>(nxt);
  p.R = R; p.F = F; p.n_tok = n_tok; p.eps = eps;
  enc_post_kernel<<<grid, PA_THREADS, EP_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m_att, m_wo, m_w1, m_w2, p);
  return (int)cudaGetLastError();
}

// Contiguous bf16 operands: att, xb, qpos [R, 256]; wso [256, 256]; wcqx,
// wcqp [512, 256] (the x and qpos halves of the cross-attention's query
// weight). fp32 vectors; x1 fp32 [R, 256] and q2 bf16 [R, 512] written.
extern "C" int ec_dec_post_self(const void* att, const void* xb, const void* qpos,
                                const void* wso, const void* bso, const void* g1, const void* be1,
                                const void* wcqx, const void* wcqp, const void* bcq, void* x1,
                                void* q2, int R, float eps, void* stream) {
  static bool configured = false;
  if (R <= 0 || !pa_aligned(att) || !pa_aligned(qpos) || !pa_aligned(wso) ||
      !pa_aligned(wcqx) || !pa_aligned(wcqp))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_att, m_qp, m_wso, m_wcqx, m_wcqp;
  if (!encode_map(&m_att, att, PA_C, R, PA_C, 0, 1, 128) ||
      !encode_map(&m_qp, qpos, PA_C, R, PA_C, 0, 1, 128) ||
      !encode_map(&m_wso, wso, PA_C, PA_C, PA_C, 0, 1, 128) ||
      !encode_map(&m_wcqx, wcqx, PA_C, 2 * PA_C, PA_C, 0, 1, 128) ||
      !encode_map(&m_wcqp, wcqp, PA_C, 2 * PA_C, PA_C, 0, 1, 128))
    return (int)cudaErrorInvalidValue;
  int e = pa_configure(dec_post_self_kernel, configured, DS_SMEM);
  if (e) return e;
  int grid = 0;
  if ((e = pa_grid((R + PA_ROWS - 1) / PA_ROWS, grid))) return e;
  DecSelfArgs p;
  p.xb = static_cast<const bf16*>(xb);
  p.bso = static_cast<const float*>(bso); p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1); p.bcq = static_cast<const float*>(bcq);
  p.x1 = static_cast<float*>(x1); p.q2 = static_cast<bf16*>(q2);
  p.R = R; p.eps = eps;
  dec_post_self_kernel<<<grid, PA_THREADS, DS_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m_att, m_qp, m_wso, m_wcqx, m_wcqp, p);
  return (int)cudaGetLastError();
}

// Contiguous operands: att2 bf16 [B, K, 512]; wco [512, 512], wch [256,
// 512], wg [2F, 256], wf [256, F] bf16; x1 fp32 [B K, 256]; adj [B, 2, K,
// K] fp32 or bf16 (adj_dt); fp32 vectors; out [B K, 256] (out_dt).
extern "C" int ec_dec_post_cross(const void* att2, const void* wco, const void* bco,
                                 const void* wch, const void* bch, const void* x1,
                                 const void* g2, const void* be2, const void* wg, const void* bg,
                                 const void* adj, int adj_dt, const void* wf, const void* bf,
                                 const void* g3, const void* be3, void* out, int out_dt, int B,
                                 int K, int F, float eps, void* stream) {
  static bool configured = false;
  if (B <= 0 || K <= 0 || K > PA_ROWS || F <= 0 || F % 64 || !pa_aligned(att2) ||
      !pa_aligned(wco) || !pa_aligned(wch) || !pa_aligned(wg) || !pa_aligned(wf))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_att2, m_wco, m_wch, m_wg, m_wf;
  if (!encode_map(&m_att2, att2, 2 * PA_C, K, 2 * PA_C, (long)K * 2 * PA_C, B, 128) ||
      !encode_map(&m_wco, wco, 2 * PA_C, 2 * PA_C, 2 * PA_C, 0, 1, 64) ||
      !encode_map(&m_wch, wch, 2 * PA_C, PA_C, 2 * PA_C, 0, 1, 128) ||
      !encode_map(&m_wg, wg, PA_C, 2 * F, PA_C, 0, 1, 64) ||
      !encode_map(&m_wf, wf, F, PA_C, F, 0, 1, 128))
    return (int)cudaErrorInvalidValue;
  int e = pa_configure(dec_post_cross_kernel, configured, DC_SMEM);
  if (e) return e;
  int grid = 0;
  if ((e = pa_grid(B, grid))) return e;
  DecCrossArgs p;
  p.bco = static_cast<const float*>(bco); p.bch = static_cast<const float*>(bch);
  p.g2 = static_cast<const float*>(g2); p.be2 = static_cast<const float*>(be2);
  p.bg = static_cast<const float*>(bg); p.bf = static_cast<const float*>(bf);
  p.g3 = static_cast<const float*>(g3); p.be3 = static_cast<const float*>(be3);
  p.x1 = static_cast<const float*>(x1);
  p.adj = adj; p.adj_dt = adj_dt;
  p.out = out; p.out_dt = out_dt;
  p.B = B; p.K = K; p.F = F; p.eps = eps;
  dec_post_cross_kernel<<<grid, PA_THREADS, DC_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m_att2, m_wco, m_wch, m_wg, m_wf, p);
  return (int)cudaGetLastError();
}

// Contiguous operands: x bf16 [R, 256]; w0, w1, w2 bf16 [256, 256]
// (torch Linear weights), wo bf16 [2, 256]; ct, pts, outs fp32 [R, 2];
// fp32 vectors g, be, b0, b1, b2 [256], bo [2].
extern "C" int ec_kpt_head(const void* x, const void* g, const void* be, const void* w0,
                           const void* b0, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* wo, const void* bo, const void* ct,
                           void* pts, void* outs, int R, float eps, float ieps, void* stream) {
  static bool configured = false;
  if (R <= 0 || !pa_aligned(x) || !pa_aligned(w0) || !pa_aligned(w1) || !pa_aligned(w2) ||
      !pa_aligned(wo) || !g || !be || !b0 || !b1 || !b2 || !bo || !ct || !pts || !outs)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_x, m_w0, m_w1, m_w2;
  if (!encode_map(&m_x, x, PA_C, R, PA_C, 0, 1, KH_ROWS) ||
      !encode_map(&m_w0, w0, PA_C, PA_C, PA_C, 0, 1, 128) ||
      !encode_map(&m_w1, w1, PA_C, PA_C, PA_C, 0, 1, 128) ||
      !encode_map(&m_w2, w2, PA_C, PA_C, PA_C, 0, 1, 128))
    return (int)cudaErrorInvalidValue;
  int e = pa_configure(kpt_head_kernel, configured, KH_SMEM);
  if (e) return e;
  int grid = 0;
  if ((e = pa_grid((R + KH_ROWS - 1) / KH_ROWS, grid))) return e;
  KptHeadArgs p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const float*>(g); p.be = static_cast<const float*>(be);
  p.b0 = static_cast<const float*>(b0); p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2); p.bo = static_cast<const float*>(bo);
  p.wo = static_cast<const bf16*>(wo);
  p.ct = static_cast<const float*>(ct);
  p.pts = static_cast<float*>(pts); p.outs = static_cast<float*>(outs);
  p.R = R; p.eps = eps; p.ieps = ieps;
  kpt_head_kernel<<<grid, PA_THREADS, KH_SMEM, static_cast<cudaStream_t>(stream)>>>(
      m_x, m_w0, m_w1, m_w2, p);
  return (int)cudaGetLastError();
}

// Contiguous operands: x [R, 384] (x_dt), out [R, 384] (out_dt); w1, w2
// bf16, [F, 384] and [384, F] when kmajor, else [384, F] and [F, 384];
// fp32 vectors g, be, b2, ls [384], b1 [F]; with hn (bf16 [R, 384]) the
// next LayerNorm's gn, ben [384].
template <bool KMAJ>
static int launch_vit_mlp(const VitMlpArgs& p, const void* w1, const void* w2, cudaStream_t s) {
  static bool configured = false;
  CUtensorMap m_w1, m_w2;
  const bool ok = KMAJ ? encode_map(&m_w1, w1, VM_C, p.F, VM_C, 0, 1, 64) &&
                             encode_map(&m_w2, w2, p.F, VM_C, p.F, 0, 1, 128)
                       : encode_map(&m_w1, w1, p.F, VM_C, p.F, 0, 1, 64) &&
                             encode_map(&m_w2, w2, VM_C, p.F, VM_C, 0, 1, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  int e = pa_configure(vit_mlp_kernel<KMAJ>, configured, VM_SMEM);
  if (e) return e;
  int grid = 0;
  if ((e = pa_grid((p.R + VM_ROWS - 1) / VM_ROWS, grid))) return e;
  vit_mlp_kernel<KMAJ><<<grid, VM_THREADS, VM_SMEM, s>>>(m_w1, m_w2, p);
  return (int)cudaGetLastError();
}

extern "C" int ec_vit_mlp(const void* x, int x_dt, const void* g, const void* be,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* ls, int kmajor, void* out, int out_dt, const void* gn,
                          const void* ben, void* hn, int R, int F, float eps, void* stream) {
  if (R <= 0 || F <= 0 || F % VM_CHUNK || !pa_aligned(x) || !pa_aligned(out) ||
      !pa_aligned(w1) || !pa_aligned(w2) || !g || !be || !b1 || !b2 || !ls ||
      (hn && (!pa_aligned(hn) || !gn || !ben)))
    return (int)cudaErrorInvalidValue;
  VitMlpArgs p;
  p.x = x; p.x_dt = x_dt;
  p.g = static_cast<const float*>(g); p.be = static_cast<const float*>(be);
  p.b1 = static_cast<const float*>(b1); p.b2 = static_cast<const float*>(b2);
  p.ls = static_cast<const float*>(ls);
  p.out = out; p.out_dt = out_dt;
  p.gn = static_cast<const float*>(gn); p.ben = static_cast<const float*>(ben);
  p.hn = static_cast<bf16*>(hn);
  p.R = R; p.F = F; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kmajor ? launch_vit_mlp<true>(p, w1, w2, s) : launch_vit_mlp<false>(p, w1, w2, s);
}

// Contiguous operands: x [R, 384] (x_dt), w bf16 [1152, 384] (torch Linear
// layout), fp32 g, be [384] and bias [1152]; qkv bf16 [R, 1152] written.
extern "C" int ec_vit_qkv(const void* x, int x_dt, const void* g, const void* be, const void* w,
                          const void* bias, void* qkv, int R, float eps, void* stream) {
  static bool configured = false;
  if (R <= 0 || !pa_aligned(x) || !pa_aligned(w) || !pa_aligned(qkv) || !g || !be || !bias)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_w, m_qkv;
  if (!encode_map(&m_w, w, VM_C, 3 * VM_C, VM_C, 0, 1, 128) ||
      !encode_map(&m_qkv, qkv, 3 * VM_C, R, 3 * VM_C, 0, 1, 64))
    return (int)cudaErrorInvalidValue;
  int e = pa_configure(vit_qkv_kernel, configured, VQ_SMEM);
  if (e) return e;
  int grid = 0;
  if ((e = pa_grid((R + VM_ROWS - 1) / VM_ROWS, grid))) return e;
  VitQkvArgs p;
  p.ln.x = x; p.ln.x_dt = x_dt;
  p.ln.g = static_cast<const float*>(g); p.ln.be = static_cast<const float*>(be);
  p.ln.R = R; p.ln.eps = eps;
  p.bias = static_cast<const float*>(bias);
  vit_qkv_kernel<<<grid, VM_THREADS, VQ_SMEM, static_cast<cudaStream_t>(stream)>>>(m_w, m_qkv,
                                                                                    p);
  return (int)cudaGetLastError();
}

// Contiguous operands: qkv bf16 [B, N, 1152] (q | k | v, each 6 heads of
// 64), x [B, N, 384] (x_dt), wp bf16 [384, 384] (torch Linear layout), fp32
// bp, ls [384]; out [B, N, 384] (out_dt) written. smem: the shared memory
// of ops/kernels.py vit_attn_plan, which must be the kernel's.
extern "C" int ec_vit_attn(const void* qkv, const void* x, int x_dt, const void* wp,
                           const void* bp, const void* ls, void* out, int out_dt, int B, int N,
                           float scale, long smem, void* stream) {
  static bool configured[2] = {false, false};
  if (B <= 0 || N <= 0 || N > VA_KEYS || smem != VB_SMEM || !pa_aligned(qkv) ||
      !pa_aligned(x) || !pa_aligned(wp) || !pa_aligned(out) || !bp || !ls)
    return (int)cudaErrorInvalidValue;
  const long ld = 3 * VM_C;
  CUtensorMap m_q, m_kv, m_x, m_wp;
  if (!encode_map(&m_q, qkv, ld, N, ld, N * ld, B, 64) ||
      !encode_map(&m_kv, qkv, ld, N, ld, N * ld, B, VA_HALF) ||
      !encode_map(&m_x, x, VM_C, N, VM_C, (long)N * VM_C, B, 64, x_dt == DT_F32) ||
      !encode_map(&m_wp, wp, VM_C, VM_C, VM_C, 0, 1, 128))
    return (int)cudaErrorInvalidValue;
  const bool x_f32 = x_dt == DT_F32;
  int e = x_f32 ? pa_configure(vit_attn_kernel<true>, configured[1], VB_SMEM)
                : pa_configure(vit_attn_kernel<false>, configured[0], VB_SMEM);
  if (e) return e;
  VitAttnArgs p;
  p.bp = static_cast<const float*>(bp); p.ls = static_cast<const float*>(ls);
  p.out = out; p.out_dt = out_dt;
  p.N = N;
  p.ipi = (N + VM_ROWS - 1) / VM_ROWS;
  p.items = B * p.ipi;
  p.sl2 = scale * LOG2E_F;
  int grid = 0;
  if ((e = pa_grid(p.items, grid))) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    vit_attn_kernel<true><<<grid, VM_THREADS, VB_SMEM, st>>>(m_q, m_kv, m_x, m_wp, p);
  else
    vit_attn_kernel<false><<<grid, VM_THREADS, VB_SMEM, st>>>(m_q, m_kv, m_x, m_wp, p);
  return (int)cudaGetLastError();
}

extern "C" const char* ec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
