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
// of the plain version (ops/fused_vit_block.py vit_ln_gemm_plain): x
// rounded to bf16 before LN1, h rounded to bf16, q | k | v and the GELU
// hidden stored as bf16; GELU is gelu_as (hopper.cuh), vit_mlp_kernel's.
//
// Bound: a product of 2 R C N operations against R C (x) + C N (W) + R N
// (out) elements; at the query pass (R = 510 x 257) every width is above
// the card's 295 operations a byte, so the tensor cores bound it (qkv at
// 768 channels: 0.46 TFLOP, 0.47 ms at 989 TFLOP/s). What stands between
// a kernel and that bound is feeding the products: the kernel's first
// form kept a 64-row tile's LayerNorm of all C channels in shared memory,
// so two or three 32 KB slots of W were in flight at 64 operations a byte,
// and L2's latency held it to 4-5x torch.matmul. Here the LayerNorm is a
// pass of its own (inside the kernel, so no second launch) and the whole
// shared memory is a ring of the product's operands.
//
// Design:
//   * the LayerNorm pass: every warp of the grid normalises four rows at
//     a time, the rows split evenly over the grid's warps (every load
//     issued before the arithmetic; lane l the columns 64 k + 2 l + e,
//     summed in layernorm_kernel's order with its steps: hopper.cuh
//     ln_mean ..), and writes bf16(LN(x)) to h, a scratch [R, C] the
//     wrapper allocates: one pass at the card's bandwidth, each row
//     normalised once and written by one warp. The rounding point is the
//     plain version's: h is the bf16 product operand. A barrier of the
//     whole grid (a counter after h, zeroed before the launch; the launch
//     is cooperative, so every CTA is resident) then hands h to the
//     products;
//   * a work unit is a 128-row tile times a part of its output columns,
//     the groups of 256 columns g0 .. g0 + ng - 1. h and W stream by TMA
//     through a ring of four stages of [128 rows x 64 k] of h and [256
//     output columns x 64 k] of W (48 KB each), for each group its C / 64
//     k slabs in turn; both consumer warpgroups multiply their 64 rows of
//     the stage by its 256 columns (wgmma m64n256k16, 128 accumulators a
//     thread): 87 operations a byte a stage;
//   * a producer warp (a third warpgroup, setmaxnreg 40; the consumers
//     232) issues every load, each stage as soon as it is empty, across
//     the boundaries of groups and units;
//   * the epilogue adds the bias (kept in shared memory up to
//     LG_MAX_BIAS columns), applies GELU, rounds to bf16 and stores 16
//     bytes a thread (the quad's four 8-column pieces transposed by
//     shuffles) while the producer refills the ring for the next group;
//     columns past N (the last group's, N a multiple of 64) and rows past
//     R are not stored, W boxes wholly past N are not loaded (their
//     products read the stage's stale columns and are dropped);
//   * an element sums its k slabs in order 0, 1, .. whatever the CTA, the
//     groups' rotation or the column part, so a row's bits do not depend
//     on its place in the batch;
//   * where whole tiles leave the last round of CTAs mostly empty (the
//     support pass and the training step), ops/kernels.py
//     vit_ln_gemm_plan splits a tile's groups into `parts`, each a unit of
//     its own; a part costs no LayerNorm, which the pass did once.
// The grid is persistent: as many CTAs as the card holds at once (one an
// SM), CTA b taking units b, b + grid, ... Clusters of 2 CTAs that share
// each W box by TMA multicast were built and measured slower on an H100
// (a refill then waits for the releases of both CTAs, one of them across
// the cluster; PERF.md), and are not kept.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

enum { VW_F32 = 0, VW_BF16 = 1 };
enum { VW_ACT_NONE = 0, VW_ACT_GELU = 1 };

#define LG_ROWS 128           // rows of a tile
#define LG_CONSUMERS 256      // two consumer warpgroups, 64 rows each
#define LG_THREADS 384        // and a producer warpgroup (one warp issues)
#define LG_WARPS (LG_THREADS / 32)
#define LG_MAX_C 1024         // channels a warp's LayerNorm holds in registers
#define LG_BOX 8192           // a swizzled [64 x 64] bf16 box
#define LG_A 16384            // a stage's rows: [128 rows x 64 k]
#define LG_B 32768            // a stage's W: [256 output columns x 64 k], four boxes
#define LG_STAGE (LG_A + LG_B)
#define LG_GROUP 256          // output columns of a stage
#define LG_STAGES 4           // the ring's stages
#define LG_MAX_BIAS 8192      // output columns whose bias the epilogue reads from shared memory
#define LG_SMEM_LIMIT 232448
// alignment slack, the stages, the bias, a full and an empty barrier a stage
#define LG_SMEM (1024 + LG_STAGES * (LG_STAGE + 16) + 4 * LG_MAX_BIAS)
static_assert(LG_SMEM <= LG_SMEM_LIMIT && LG_SMEM + LG_STAGE + 16 > LG_SMEM_LIMIT,
              "the ring has as many stages as fit beside the bias");

struct LnGemmArgs {
  const void* x; int x_dt; int round_in;   // [R, C]
  const float *g, *be;                     // the LayerNorm, [C]
  const float* bias;                       // [N]
  bf16* h;                                 // [R, C]: bf16(LN(x)), the product's A
  unsigned* arrived;                       // the grid barrier's counter, 0 at the launch
  bf16* out;                               // [R, N]
  int R, C, N, act;
  float eps;
  int parts;                               // column parts of a tile
};

// Every CTA of the grid has come here (each once a launch), the writes of
// every CTA before it visible to the reads of every CTA after it.
__device__ __forceinline__ void lg_grid_sync(unsigned* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(arrived) : "memory");
    unsigned n;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(n) : "l"(arrived) : "memory");
    } while (n < gridDim.x);
  }
  __syncthreads();
}

// d (+)= a . b for one m64n256k16 tile, a and b in shared memory. TB: b
// is MN-major. `accumulate` 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// ------------------------------------------------------------ schedule
// A work unit: the 128-row tile `tile` and one of `parts` column parts,
// the groups g0 .. g0 + ng - 1 of LG_GROUP columns. Unit u: tile
// u / parts, part u % parts.
struct LgUnit {
  int tile, g0, ng;
};

__device__ __forceinline__ LgUnit lg_unit(const LnGemmArgs& p, int u, int groups) {
  const int part = u % p.parts;
  LgUnit w;
  w.tile = u / p.parts;
  w.g0 = part * groups / p.parts;
  w.ng = (part + 1) * groups / p.parts - w.g0;
  return w;
}

// ------------------------------------------------------------ producer
// Every load of the CTA's units in order: for each unit its groups from
// the CTA's rotation, each its k slabs 0, 1, ..: the tile's [128 x 64]
// box of h and the group's W; a stage is refilled once its empty barrier
// has the releases of the eight consumer warps. K-major W [N, C]: boxes
// [64 n x 64 k]; W [C, N]: boxes [64 k x 64 n]. W boxes wholly past N
// are not loaded; rows past R arrive as zeros.
template <bool KMAJ>
__device__ __forceinline__ void lg_producer(const CUtensorMap* map_h, const CUtensorMap* map_w,
                                            const LnGemmArgs& p, unsigned char* ring,
                                            uint64_t* full, uint64_t* empty, int units,
                                            int groups, int kslabs) {
  // h was written through the generic proxy; the copies read it through the async one
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  unsigned it = 0;
  for (int u = (int)blockIdx.x; u < units; u += (int)gridDim.x) {
    const LgUnit w = lg_unit(p, u, groups);
    const int rot = (int)(blockIdx.x % (unsigned)w.ng);
    for (int j = 0; j < w.ng; ++j) {
      const int n0 = LG_GROUP * (w.g0 + (j + rot) % w.ng);
      const int pieces = min(4, (p.N - n0) / 64);   // 64-column boxes inside N
      for (int ks = 0; ks < kslabs; ++ks, ++it) {
        const unsigned s = it % LG_STAGES;
        if (it >= LG_STAGES) mbar_wait(&empty[s], ((it / LG_STAGES) - 1) & 1);
        unsigned char* dst = ring + s * LG_STAGE;
        mbar_expect_tx(&full[s], LG_A + pieces * LG_BOX);
        tma_load_3d(dst, map_h, &full[s], 64 * ks, w.tile * LG_ROWS, 0);
        for (int b = 0; b < pieces; ++b) {
          const int c0 = KMAJ ? 64 * ks : n0 + 64 * b, c1 = KMAJ ? n0 + 64 * b : 64 * ks;
          tma_load_3d(dst + LG_A + b * LG_BOX, map_w, &full[s], c0, c1, 0);
        }
      }
    }
  }
}

// ------------------------------------------------------------ LayerNorm
// The LayerNorm of rows r[0..3] by one warp, into h as bf16 (rows past R
// read as zeros and are not written); lane l takes the columns 64 k + 2 l
// + e. Every load of the four rows is issued before any arithmetic (F32:
// x fp32, else bf16), and the four rows' sums run side by side: each row's
// arithmetic is layernorm_kernel's, in its order.
template <bool F32>
__device__ __forceinline__ void lg_layernorm4(const LnGemmArgs& p, const long (&r)[4], int lane) {
  const int kc = p.C / 64;
  float v[4][32];
  if (F32) {
    float2 raw[4][16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2* src =
          reinterpret_cast<const float2*>(static_cast<const float*>(p.x) + r[i] * p.C + 2 * lane);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        raw[i][k] = k < kc && r[i] < p.R ? __ldg(src + 32 * k) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        v[i][2 * k] = p.round_in ? round_bf16(raw[i][k].x) : raw[i][k].x;
        v[i][2 * k + 1] = p.round_in ? round_bf16(raw[i][k].y) : raw[i][k].y;
      }
  } else {
    unsigned raw[4][16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned* src =
          reinterpret_cast<const unsigned*>(static_cast<const bf16*>(p.x) + r[i] * p.C + 2 * lane);
#pragma unroll
      for (int k = 0; k < 16; ++k) raw[i][k] = k < kc && r[i] < p.R ? __ldg(src + 32 * k) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        v[i][2 * k] = __uint_as_float(raw[i][k] << 16);
        v[i][2 * k + 1] = __uint_as_float(raw[i][k] & 0xffff0000u);
      }
  }
  float mean[4], inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < kc) {
        s = __fadd_rn(s, v[i][2 * k]);
        s = __fadd_rn(s, v[i][2 * k + 1]);
      }
    mean[i] = s;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) mean[i] = ln_mean(warp_sum(mean[i]), p.C);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < kc) {
        q = ln_sq(q, v[i][2 * k], mean[i]);
        q = ln_sq(q, v[i][2 * k + 1], mean[i]);
      }
    inv[i] = q;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = ln_inv(warp_sum(inv[i]), p.C, p.eps);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k >= kc) continue;
    const int c = 64 * k + 2 * lane;
    const float2 gg = __ldg(reinterpret_cast<const float2*>(p.g + c));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(p.be + c));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r[i] < p.R)
        *reinterpret_cast<unsigned*>(p.h + r[i] * p.C + c) =
            pack_bf16(ln_apply(v[i][2 * k], mean[i], inv[i], gg.x, bb.x),
                      ln_apply(v[i][2 * k + 1], mean[i], inv[i], gg.y, bb.y));
  }
}

// The LayerNorm pass: the grid's warps take the rows four at a time (warp
// w of CTA b the rows 4 q .. 4 q + 3 for q = LG_WARPS b + w, then every
// LG_WARPS gridDim.x quads on) and write them to h, each row once; then
// every thread makes its writes visible to the copies of the async proxy.
__device__ __forceinline__ void lg_ln_phase(const LnGemmArgs& p) {
  const int lane = threadIdx.x & 31;
  const long quads = (p.R + 3) / 4, step = (long)LG_WARPS * gridDim.x;
#pragma unroll 1
  for (long q = (long)LG_WARPS * blockIdx.x + (threadIdx.x >> 5); q < quads; q += step) {
    const long r[4] = {4 * q, 4 * q + 1, 4 * q + 2, 4 * q + 3};
    if (p.x_dt == VW_F32)
      lg_layernorm4<true>(p, r, lane);
    else
      lg_layernorm4<false>(p, r, lane);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ------------------------------------------------------------ consumers
// The quad's four 8-column pieces of one row, v[i] this thread's columns
// 2 t, 2 t + 1 of piece i (two bf16), transposed by two exchanges (lane ^
// 1, lane ^ 2) so that thread t holds piece t whole: word s of the result
// is thread s's pair of it.
__device__ __forceinline__ uint4 lg_quad_transpose(const unsigned (&v)[4], int t) {
  const bool odd = t & 1, hi = t & 2;
  // pieces of this thread's parity kept, the others swapped with lane ^ 1
  const unsigned k0 = odd ? v[1] : v[0], k1 = odd ? v[3] : v[2];
  const unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  const unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  // piece t kept (from this thread and lane ^ 1), piece t ^ 2 swapped with lane ^ 2
  const unsigned m0 = hi ? k1 : k0, m1 = hi ? r1 : r0;
  const unsigned q0 = __shfl_xor_sync(0xffffffffu, hi ? k0 : k1, 2);
  const unsigned q1 = __shfl_xor_sync(0xffffffffu, hi ? r0 : r1, 2);
  // m0, m1, q0, q1 came from threads t, t ^ 1, t ^ 2, t ^ 3
  const unsigned ae = odd ? m1 : m0, ao = odd ? m0 : m1;
  const unsigned be = odd ? q1 : q0, bo = odd ? q0 : q1;
  return make_uint4(hi ? be : ae, hi ? bo : ao, hi ? ae : be, hi ? ao : bo);
}

// A warpgroup's [64 x 256] accumulator (acc[4 j + 2 rh + e]: row r0 + 8 rh,
// column n0 + 8 j + 2 t + e) plus the bias (from `bias`: shared memory,
// or p.bias where N is too wide for it), optional GELU, bf16 out, 16
// bytes a thread; every lane of the warp takes part (the shuffles).
__device__ __forceinline__ void lg_epilogue(const float (&acc)[128], const LnGemmArgs& p,
                                            const float* bias, long r0, int n0, int t) {
#pragma unroll
  for (int jq = 0; jq < 8; ++jq) {
    const int c0 = n0 + 32 * jq;
    if (c0 >= p.N) break;                 // the same for the whole warp
    float2 b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = *reinterpret_cast<const float2*>(bias + c0 + 8 * i + 2 * t);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      unsigned v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * jq + i;
        float y0 = acc[4 * j + 2 * rh] + b[i].x, y1 = acc[4 * j + 2 * rh + 1] + b[i].y;
        if (p.act == VW_ACT_GELU) {
          y0 = gelu_as(y0);
          y1 = gelu_as(y1);
        }
        v[i] = pack_bf16(y0, y1);
      }
      const uint4 o = lg_quad_transpose(v, t);
      const long r = r0 + 8 * rh;
      if (r < p.R) *reinterpret_cast<uint4*>(p.out + r * p.N + c0 + 8 * t) = o;
    }
  }
}

// The consumers: for each of the unit's groups warpgroup wg multiplies
// rows 64 wg .. 64 wg + 63 of the tile by the group's 256 columns, stage
// by stage (lane 0 of each warp releasing a stage once its products have
// read it), and stores them.
template <bool KMAJ>
__device__ __forceinline__ void lg_consumer(const LnGemmArgs& p, unsigned char* ring,
                                            float* bias_s, uint64_t* full, uint64_t* empty,
                                            int units, int groups, int kslabs) {
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lr = 64 * wg + (warp & 3) * 16 + (lane >> 2);   // the thread's first row
  const unsigned ra = smem_u32(ring);
  // the bias in shared memory where it fits
  const bool bias_here = p.N <= LG_MAX_BIAS;
  if (bias_here)
    for (int c = threadIdx.x; c < p.N; c += LG_CONSUMERS) bias_s[c] = __ldg(p.bias + c);
  bar_consumers();
  const float* bias = bias_here ? bias_s : p.bias;
  unsigned it = 0;
  for (int u = (int)blockIdx.x; u < units; u += (int)gridDim.x) {
    const LgUnit w = lg_unit(p, u, groups);
    const long row0 = (long)w.tile * LG_ROWS;
    const int rot = (int)(blockIdx.x % (unsigned)w.ng);
#pragma unroll 1
    for (int j = 0; j < w.ng; ++j) {
      const int n0 = LG_GROUP * (w.g0 + (j + rot) % w.ng);
      float acc[128];
      acc_zero(acc);
      reg_fence(acc);
#pragma unroll 1
      for (int ks = 0; ks < kslabs; ++ks, ++it) {
        const unsigned s = it % LG_STAGES;
        mbar_wait(&full[s], (it / LG_STAGES) & 1);
        wg_fence();
        const unsigned a = ra + s * LG_STAGE + wg * LG_BOX, b = ra + s * LG_STAGE + LG_A;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (KMAJ)
            wgmma_m64n256k16<0>(acc, wg_desc(a + kk * 32, 16), wg_desc(b + kk * 32, 16), 1);
          else
            wgmma_m64n256k16<1>(acc, wg_desc(a + kk * 32, 16), wg_desc(b + kk * 2048, LG_BOX),
                                1);
        }
        wg_commit();
        if (ks > 0) {
          wg_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % LG_STAGES]);
        }
      }
      wg_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % LG_STAGES]);
      reg_fence(acc);
      lg_epilogue(acc, p, bias, row0 + lr, n0, t);
    }
  }
}

// map_h: h [R, C] in boxes [128 rows x 64]; map_w: W [N, C] (KMAJ) or
// [C, N], boxes [64 x 64]. A cooperative launch of at most the CTAs the
// card holds at once (lg_grid_sync waits for all of them).
template <bool KMAJ>
__global__ void __launch_bounds__(LG_THREADS, 1)
    vit_ln_gemm_kernel(const __grid_constant__ CUtensorMap map_h,
                       const __grid_constant__ CUtensorMap map_w, LnGemmArgs p) {
  extern __shared__ unsigned char lg_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(lg_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int kslabs = p.C / 64, groups = (p.N + LG_GROUP - 1) / LG_GROUP;
  const int units = (p.R + LG_ROWS - 1) / LG_ROWS * p.parts;
  float* bias_s = reinterpret_cast<float*>(ring + LG_STAGES * LG_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + LG_MAX_BIAS);
  uint64_t* empty = full + LG_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < LG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);             // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  lg_ln_phase(p);
  lg_grid_sync(p.arrived);                 // every row is in h, every barrier is ready

  if (threadIdx.x >= LG_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == LG_CONSUMERS)
      lg_producer<KMAJ>(&map_h, &map_w, p, ring, full, empty, units, groups, kslabs);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    lg_consumer<KMAJ>(p, ring, bias_s, full, empty, units, groups, kslabs);
  }
}

// The CTAs of vit_ln_gemm_kernel<KMAJ> the card runs at once (one an SM:
// occupancy times the SMs; cached per instantiation).
template <bool KMAJ>
static int lg_ctas(int& ctas) {
  static int cached = 0;
  if (!cached) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(vit_ln_gemm_kernel<KMAJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LG_SMEM_LIMIT);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vit_ln_gemm_kernel<KMAJ>,
                                                        LG_THREADS, (size_t)LG_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
    cached = per_sm * sms;
  }
  ctas = cached;
  return 0;
}

template <bool KMAJ>
static int launch_ln_gemm(const LnGemmArgs& p, const void* w, cudaStream_t s) {
  CUtensorMap mh, mw;
  const bool ok = encode_map(&mh, p.h, p.C, p.R, p.C, 0, 1, LG_ROWS) &&
                  (KMAJ ? encode_map(&mw, w, p.C, p.N, p.C, 0, 1, 64)
                        : encode_map(&mw, w, p.N, p.C, p.N, 0, 1, 64));
  if (!ok) return (int)cudaErrorInvalidValue;
  int ctas = 0;
  const int e = lg_ctas<KMAJ>(ctas);
  if (e) return e;
  cudaError_t le = cudaMemsetAsync(p.arrived, 0, sizeof(unsigned), s);
  if (le != cudaSuccess) return (int)le;
  const int units = (p.R + LG_ROWS - 1) / LG_ROWS * p.parts;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(units < ctas ? units : ctas));
  cfg.blockDim = dim3(LG_THREADS);
  cfg.dynamicSmemBytes = (size_t)LG_SMEM;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  le = cudaLaunchKernelEx(&cfg, vit_ln_gemm_kernel<KMAJ>, mh, mw, p);
  return le != cudaSuccess ? (int)le : (int)cudaGetLastError();
}

static bool lg_aligned(const void* p) { return p && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Contiguous operands: x [R, C] (x_dt, fp32 or bf16; round_in: rounded to
// bf16 before the LayerNorm), fp32 g, be [C] and bias [N], W bf16 [N, C]
// (kmajor) or [C, N], the scratch h (bf16 [R, C], the LayerNorm's output,
// then 16 bytes for the grid's barrier), out bf16 [R, N]; act 0 (none) or
// 1 (GELU). C a multiple of 64 up to LG_MAX_C, N a multiple of 64. smem
// and parts (1 .. the 256-column groups): ops/kernels.py
// vit_ln_gemm_plan's, whose shared memory must be the kernel's.
extern "C" int ec_vit_ln_gemm(const void* x, int x_dt, int round_in, const void* g,
                              const void* be, const void* w, int kmajor, const void* bias,
                              int act, void* h, void* out, int R, int C, int N, float eps,
                              long smem, int parts, void* stream) {
  if (R <= 0 || C < 64 || C > LG_MAX_C || C % 64 || N <= 0 || N % 64 ||
      (x_dt != VW_F32 && x_dt != VW_BF16) || (act != VW_ACT_NONE && act != VW_ACT_GELU) ||
      smem != LG_SMEM || parts < 1 || parts > (N + LG_GROUP - 1) / LG_GROUP ||
      !lg_aligned(x) || !lg_aligned(w) || !lg_aligned(h) || !lg_aligned(out) || !g || !be ||
      !bias)
    return (int)cudaErrorInvalidValue;
  LnGemmArgs p;
  p.x = x; p.x_dt = x_dt; p.round_in = round_in;
  p.g = static_cast<const float*>(g); p.be = static_cast<const float*>(be);
  p.bias = static_cast<const float*>(bias);
  p.h = static_cast<bf16*>(h);
  p.arrived = reinterpret_cast<unsigned*>(p.h + (long)R * C);
  p.out = static_cast<bf16*>(out);
  p.R = R; p.C = C; p.N = N; p.act = act; p.eps = eps;
  p.parts = parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kmajor ? launch_ln_gemm<true>(p, w, s) : launch_ln_gemm<false>(p, w, s);
}

// The CTAs of vit_ln_gemm_kernel the card runs at once, into *out
// (vit_ln_gemm_plan's `ctas` on this card).
extern "C" int ec_vit_ln_gemm_ctas(int* out) {
  if (!out) return (int)cudaErrorInvalidValue;
  int a = 0, b = 0;
  const int e = lg_ctas<true>(a);
  if (e) return e;
  const int f = lg_ctas<false>(b);
  if (f) return f;
  *out = a < b ? a : b;
  return 0;
}
