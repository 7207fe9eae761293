// The ViT block at trunk widths other than 384 channels in 6 heads (the
// resident kernels of kernels.cu, vit_qkv_kernel, vit_attn_kernel and
// vit_mlp_kernel, hold a warpgroup's 64 x 384 output in registers and the
// LayerNorm of 128 rows in shared memory: at 768 and 1024 channels neither
// fits). One kernel, vit_ln_gemm_kernel:
//
//   out = bf16(act(bf16(LN(x)) . W + bias)),   act: none or GELU,
//
// LayerNorm with fp32 statistics over the C channels of a row (x fp32 or
// bf16, optionally rounded to bf16 first), W taken as [N, C] torch Linear
// weights or as [C, N], N output columns stored as bf16. It replaces no
// TPU kernel alone: with ops/kernels.py attention (attn_kernel, or
// attn_long_kernel above 512 tokens) and gemm (its epilogue adds the bias,
// LayerScale and the residual) it is the wide route of the TPU kernels
// edgecape_tpu/ops/fused_vit_block.py fused_vit_block (#1) and
// fused_vit_block2 (#2), fused_mlp.py fused_ln_mlp (#9) and
// fused_attn_block.py fused_attn_block (#10): a block is LN1 + qkv (this
// kernel), attention, the projection GEMM, LN2 + fc1 + GELU (this kernel),
// the fc2 GEMM. The rounding points are those of the resident kernels and
// of the plain version (ops/fused_vit_block.py fused_vit_block_plain):
// x rounded to bf16 before LN1, h rounded to bf16, q | k | v and the GELU
// hidden stored as bf16; GELU is gelu_as (hopper.cuh), vit_mlp_kernel's.
//
// Bound: a product of 2 R C N operations against R C (x) + C N (W) + R N
// (out) elements; at the query pass (R = 510 x 257) every width is above
// the card's 295 operations a byte, so the tensor cores bound it (qkv at
// 768 channels: 0.93 TFLOP, 0.94 ms at 989 TFLOP/s). In practice L2 does:
// every 64-row tile reads all of W, about 3 TB/s of weight traffic at the
// query pass on an H100, 4-5x the time of torch.matmul of the product
// (PERF.md); clusters multicasting W are the next step.
//
// Design (simple and right first; a faster form is later work):
//   * a block owns a tile of 64 rows, so the LayerNorm output of all C
//     channels fits in shared memory beside the weight ring: C / 64
//     swizzled [64 x 64] bf16 slabs, 128 KB at 1024 channels. A warp
//     normalises 8 rows, lane l the columns 64 k + 2 l + e, summed in
//     layernorm_kernel's order with its steps (hopper.cuh ln_mean ..);
//   * W streams by TMA through a ring of S slots of [256 columns x 64 k]
//     (32 KB: S = 3 at C above 768, 4 above 512, else 5, so a block keeps
//     to 227 KB), in the same order for every tile: 256-column groups (the
//     block's first group rotated by its index, so that the blocks do not
//     ask L2 for the same lines at once), each its C / 64 k slabs in turn.
//     Both warpgroups wait on every slot, warpgroup w multiplies the 64
//     rows by the slot's columns 128 w .. 128 w + 127 (wgmma m64n128k16,
//     64 accumulator registers a thread); the eighth warp to release a slot
//     issues its next load (CountRing, hopper.cuh): no producer warp;
//   * an element sums its k slabs in order 0, 1, .. whatever the block,
//     the tile or the rotation, so a row's bits do not depend on its place
//     in the batch;
//   * the epilogue adds the bias, applies GELU, rounds to bf16 and stores
//     from the accumulator registers (4 bytes a thread at a time: no room
//     for a staging tile beside the slabs at 1024 channels); columns past
//     N (the last group's, N a multiple of 64) and rows past R are not
//     stored, and boxes wholly past N are not loaded (their products read
//     the slot's stale half and are dropped).
// The grid is persistent, at most one block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

enum { VW_F32 = 0, VW_BF16 = 1 };
enum { VW_ACT_NONE = 0, VW_ACT_GELU = 1 };

#define LG_ROWS 64            // rows of a tile
#define LG_THREADS 256        // two consumer warpgroups
#define LG_MAX_C 1024         // channels whose slabs fit beside a ring of 3
#define LG_SLAB 8192          // a swizzled [64 rows x 64] bf16 slab
#define LG_HALF 16384         // a warpgroup's [128 columns x 64 k] of a slot
#define LG_UNIT (2 * LG_HALF) // a ring slot: 256 output columns x 64 k
#define LG_GROUP 256          // output columns of a slot
#define LG_SMEM_LIMIT 232448
// alignment slack, the slabs, the slots, then a full barrier and a release
// counter a slot (CountRing::place)
#define LG_SMEM(C, S) (1024 + ((C) / 64) * LG_SLAB + (S) * LG_UNIT + (((S) * 12 + 7) & ~7))

static constexpr int lg_stages(int c) { return c > 768 ? 3 : c > 512 ? 4 : 5; }
static_assert(LG_SMEM(1024, 3) <= LG_SMEM_LIMIT && LG_SMEM(768, 4) <= LG_SMEM_LIMIT &&
                  LG_SMEM(512, 5) <= LG_SMEM_LIMIT,
              "vit_ln_gemm_kernel exceeds the shared memory of a block");

// Byte offset of element (r, c) of the LayerNorm output in its [64 x 64]
// slabs (column c in slab c / 64), the 128-byte swizzle of TMA and wgmma.
__device__ __forceinline__ unsigned lg_off(int r, int c) {
  return (unsigned)((c >> 6) * LG_SLAB + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                    ((c & 7) << 1));
}

struct LnGemmArgs {
  const void* x; int x_dt; int round_in;   // [R, C]
  const float *g, *be;                     // the LayerNorm, [C]
  const float* bias;                       // [N]
  bf16* out;                               // [R, N]
  int R, C, N, act;
  float eps;
};

// The loads of the ring: for every tile the groups of LG_GROUP output
// columns, starting at the block's `rot`, each its k slabs 0, 1, .. in
// turn. K-major W [N, C]: a [128 n x 64 k] box a warpgroup; W [C, N]: four
// [64 k x 64 n] boxes, two a warpgroup. Boxes wholly past N are not loaded.
template <bool KMAJ>
struct LgLoader {
  static constexpr unsigned kBytes = LG_UNIT;
  const CUtensorMap* w;
  int kslabs, groups, rot, N;

  __device__ __forceinline__ void operator()(unsigned i, unsigned char* dst,
                                             uint64_t* bar) const {
    const int ks = (int)(i % (unsigned)kslabs);
    const int g = ((int)(i / (unsigned)kslabs % (unsigned)groups) + rot) % groups;
    const int n0 = LG_GROUP * g;
    const int pieces = min(4, (N - n0) / 64);      // 64-column pieces inside N
    if (KMAJ) {
      const int halves = (pieces + 1) / 2;
      mbar_expect_tx(bar, halves * LG_HALF);
      for (int h = 0; h < halves; ++h) tma_load_3d(dst + h * LG_HALF, w, bar, 64 * ks, n0 + 128 * h, 0);
    } else {
      mbar_expect_tx(bar, pieces * LG_SLAB);
      for (int q = 0; q < pieces; ++q) tma_load_3d(dst + q * LG_SLAB, w, bar, n0 + 64 * q, 64 * ks, 0);
    }
  }
};

// The LayerNorm of tile rows lrow0 .. lrow0 + 7 by one warp, two rows'
// loads in flight at a time, into the slabs as bf16; rows past R are zeros.
__device__ __forceinline__ void lg_prologue(const LnGemmArgs& p, unsigned char* hs, long row0,
                                            int lrow0, int lane) {
  const int kc = p.C / 64;
#pragma unroll 1
  for (int i0 = 0; i0 < 8; i0 += 2) {
    float v[2][32];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long r = row0 + lrow0 + i0 + i;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        v[i][2 * k] = v[i][2 * k + 1] = 0.0f;
        if (k >= kc || r >= p.R) continue;
        const long off = r * p.C + 64 * k + 2 * lane;
        if (p.x_dt == VW_F32) {
          const float2 u = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p.x) + off));
          v[i][2 * k] = p.round_in ? round_bf16(u.x) : u.x;
          v[i][2 * k + 1] = p.round_in ? round_bf16(u.y) : u.y;
        } else {
          const unsigned u = __ldg(reinterpret_cast<const unsigned*>(static_cast<const bf16*>(p.x) + off));
          v[i][2 * k] = __uint_as_float(u << 16);
          v[i][2 * k + 1] = __uint_as_float(u & 0xffff0000u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lrow = lrow0 + i0 + i;
      const bool ok = row0 + lrow < p.R;     // the same for the whole warp
      float mean = 0.0f, inv = 0.0f;
      if (ok) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < kc) {
            s = __fadd_rn(s, v[i][2 * k]);
            s = __fadd_rn(s, v[i][2 * k + 1]);
          }
        mean = ln_mean(warp_sum(s), p.C);
        float q = 0.0f;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < kc) {
            q = ln_sq(q, v[i][2 * k], mean);
            q = ln_sq(q, v[i][2 * k + 1], mean);
          }
        inv = ln_inv(warp_sum(q), p.C, p.eps);
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k >= kc) continue;
        const int c = 64 * k + 2 * lane;
        unsigned h = 0u;
        if (ok) {
          const float2 gg = __ldg(reinterpret_cast<const float2*>(p.g + c));
          const float2 bb = __ldg(reinterpret_cast<const float2*>(p.be + c));
          h = pack_bf16(ln_apply(v[i][2 * k], mean, inv, gg.x, bb.x),
                        ln_apply(v[i][2 * k + 1], mean, inv, gg.y, bb.y));
        }
        *reinterpret_cast<unsigned*>(hs + lg_off(lrow, c)) = h;
      }
    }
  }
}

// A warpgroup's [64 x 128] accumulator (acc[4 j + 2 rh + e]: row r0 + 8 rh,
// column n0 + 8 j + 2 t + e) plus the bias, optional GELU, bf16 out.
__device__ __forceinline__ void lg_epilogue(const float (&acc)[64], const LnGemmArgs& p, long r0,
                                            int n0, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    if (c >= p.N) continue;
    const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + c));
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const long r = r0 + 8 * rh;
      if (r >= p.R) continue;
      float y0 = acc[4 * j + 2 * rh] + b.x, y1 = acc[4 * j + 2 * rh + 1] + b.y;
      if (p.act == VW_ACT_GELU) {
        y0 = gelu_as(y0);
        y1 = gelu_as(y1);
      }
      *reinterpret_cast<unsigned*>(p.out + r * p.N + c) = pack_bf16(y0, y1);
    }
  }
}

// map_w: W [N, C] (KMAJ, boxes [128 x 64]) or [C, N] (boxes [64 x 64]).
template <bool KMAJ, int S>
__global__ void __launch_bounds__(LG_THREADS, 1)
    vit_ln_gemm_kernel(const __grid_constant__ CUtensorMap map_w, LnGemmArgs p) {
  extern __shared__ unsigned char lg_raw[];
  unsigned char* hs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(lg_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int kslabs = p.C / 64, groups = (p.N + LG_GROUP - 1) / LG_GROUP;
  const int tiles = (p.R + LG_ROWS - 1) / LG_ROWS;
  CountRing<S, LgLoader<KMAJ>> ring;
  ring.place(hs + kslabs * LG_SLAB, hs + kslabs * LG_SLAB + S * LG_UNIT,
             (unsigned)((tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) *
                 (unsigned)(groups * kslabs));
  ring.ld.w = &map_w;
  ring.ld.kslabs = kslabs;
  ring.ld.groups = groups;
  ring.ld.rot = (int)(blockIdx.x % (unsigned)groups);
  ring.ld.N = p.N;
  if (threadIdx.x == 0) {
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) ring.prime();

  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = (warp & 3) * 16 + (lane >> 2);   // the thread's first row of the tile
  const unsigned ha = smem_u32(hs);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * LG_ROWS;
    __syncthreads();                      // the last tile's products have read the slabs
    lg_prologue(p, hs, row0, warp * 8, lane);
    fence_view_async();
    __syncthreads();
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) {
      const int n0 = LG_GROUP * ((gi + ring.ld.rot) % groups) + 128 * wg;
      float acc[64];
      acc_zero(acc);
      reg_fence(acc);
#pragma unroll 1
      for (int ks = 0; ks < kslabs; ++ks) {
        const unsigned b = ring.next() + wg * LG_HALF;
        const unsigned a = ha + ks * LG_SLAB;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (KMAJ)
            wgmma_m64n128k16<0>(acc, wg_desc(a + kk * 32, 16), wg_desc(b + kk * 32, 16), 1);
          else
            wgmma_m64n128k16<1>(acc, wg_desc(a + kk * 32, 16), wg_desc(b + kk * 2048, LG_SLAB),
                                1);
        }
        ring.issued(lane, ks == 0);
      }
      ring.drain(lane);
      reg_fence(acc);
      lg_epilogue(acc, p, row0 + lr, n0, t);
    }
  }
}

static int lg_sms(int& sms) {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      cached = 0;
      return (int)e;
    }
  }
  sms = cached;
  return 0;
}

template <bool KMAJ, int S>
static int launch_ln_gemm(const LnGemmArgs& p, const void* w, cudaStream_t s) {
  static bool configured = false;
  CUtensorMap m;
  const bool ok = KMAJ ? encode_map(&m, w, p.C, p.N, p.C, 0, 1, 128)
                       : encode_map(&m, w, p.N, p.C, p.N, 0, 1, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        vit_ln_gemm_kernel<KMAJ, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, LG_SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int sms = 0;
  const int e = lg_sms(sms);
  if (e) return e;
  const int tiles = (p.R + LG_ROWS - 1) / LG_ROWS, grid = tiles < sms ? tiles : sms;
  vit_ln_gemm_kernel<KMAJ, S><<<grid, LG_THREADS, LG_SMEM(p.C, S), s>>>(m, p);
  return (int)cudaGetLastError();
}

static bool lg_aligned(const void* p) { return p && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Contiguous operands: x [R, C] (x_dt, fp32 or bf16; round_in: rounded to
// bf16 before the LayerNorm), fp32 g, be [C] and bias [N], W bf16 [N, C]
// (kmajor) or [C, N], out bf16 [R, N]; act 0 (none) or 1 (GELU). C a
// multiple of 64 up to LG_MAX_C, N a multiple of 64. smem: the shared
// memory of ops/kernels.py vit_ln_gemm_plan, which must be the kernel's.
extern "C" int ec_vit_ln_gemm(const void* x, int x_dt, int round_in, const void* g,
                              const void* be, const void* w, int kmajor, const void* bias,
                              int act, void* out, int R, int C, int N, float eps, long smem,
                              void* stream) {
  if (R <= 0 || C < 64 || C > LG_MAX_C || C % 64 || N <= 0 || N % 64 ||
      (x_dt != VW_F32 && x_dt != VW_BF16) || (act != VW_ACT_NONE && act != VW_ACT_GELU) ||
      smem != LG_SMEM(C, lg_stages(C)) || !lg_aligned(x) || !lg_aligned(w) || !lg_aligned(out) ||
      !g || !be || !bias)
    return (int)cudaErrorInvalidValue;
  LnGemmArgs p;
  p.x = x; p.x_dt = x_dt; p.round_in = round_in;
  p.g = static_cast<const float*>(g); p.be = static_cast<const float*>(be);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.R = R; p.C = C; p.N = N; p.act = act; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lg_stages(C)) {
    case 3: return kmajor ? launch_ln_gemm<true, 3>(p, w, s) : launch_ln_gemm<false, 3>(p, w, s);
    case 4: return kmajor ? launch_ln_gemm<true, 4>(p, w, s) : launch_ln_gemm<false, 4>(p, w, s);
    default: return kmajor ? launch_ln_gemm<true, 5>(p, w, s) : launch_ln_gemm<false, 5>(p, w, s);
  }
}
