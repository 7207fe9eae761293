// The decoder layer's post-attention kernels at every width but the 256
// channels of kernels.cu's dec_post_self_kernel / dec_post_cross_kernel,
// and the cross layer's at 256 channels too above the 128 keypoints that
// dec_post_cross_kernel's tile holds: C from 1 to 512, any GCN width F,
// any K keypoints a batch row. They replace the TPU kernel edgecape_tpu/ops/fused_decoder.py
// _kernel (:111-121 and :142-166; through pallas_call at :262 and inside
// _stack_kernel at :531), with the rounding points of the plain versions
// (ops/fused_decoder.py fused_decoder_layer_plain): bf16 operands, fp32
// accumulation, fp32 LayerNorm statistics over the true C.
//
//   dec_post_self_wide_kernel:  x1 = LN1(xb + (att . Wso^T + bso)), fp32;
//                               q2 = bf16(bf16(x1) . Wcq_x^T + qpos .
//                               Wcq_p^T + bcq), 2C columns;
//   dec_post_cross_wide_kernel: o2 = bf16(att2 . Wco^T + bco); x2 =
//                               LN2(x1 + (o2 . Wch^T + bch)), fp32; y =
//                               bf16(bf16(x2) . Wg^T + bg), 2 Fp columns
//                               (y0 | y1), rows flattened over the batch;
//   dec_post_gcn_wide_kernel:   per batch row m = bf16(adj0) . y0 +
//                               bf16(adj1) . y1; out = LN3(x2 + (bf16(
//                               relu(m)) . Wf^T + bf)).
//
// Bound. At 60 query rows (6000 keypoint rows, K 100) and C 512, F 1024:
// the self kernel 15.7 GFLOP of products (0.016 ms at 989 TFLOP/s)
// against 46 MB of operands (0.014 ms at 3.35 TB/s); the cross pair 40.2
// GFLOP (0.041 ms) against 54 MB (fp32 out). Every 64-row tile multiplies by all of
// its op's weights (the self kernel 2.5 MB, the cross kernel 5 MB, the gcn
// kernel 1 MB at that width), 32 multiply-adds a weight byte, so what
// feeds the tensor cores is L2, as in enc_post_wide_kernel.
//
// Design: enc_post_wide_kernel's (head_wide.cu), from the parts it shares
// in head_wide.cuh:
//   * a persistent grid (one block an SM) of tiles of 64 rows, 384
//     threads: a producer warpgroup (one thread issues every TMA copy,
//     setmaxnreg 40) and two consumer warpgroups (232), each holding the
//     tile's 64 rows times its half NH of the channels (C / 2 rounded up to
//     64: an instance each of 64, 128, 192, 256) in an m64 x NH fp32
//     wgmma accumulator;
//   * the weights stream by TMA through one ring a consumer warpgroup, in
//     the same order for every tile, in load units of one [64 x 64] bf16
//     box (8 KB): an m64n64 product of a 64-deep k slab, into a 64-column
//     chunk or into one 64-column part of the NH-wide accumulator. The
//     weights are padded by zero rows and columns (ops/kernels.py
//     post_plan: C to 2 NH, 2C to 4 NH, F to whole 128-column chunks), so
//     every box lies inside them and the padding adds exact zeros; the
//     activations' columns past C load as zeros, and LayerNorm, biases and
//     stores run over the true C alone;
//   * the tile's activation rows arrive by cp.async into 128-byte-swizzled
//     boxes, each warpgroup its columns, and are the A operand of both
//     warpgroups; a chunk of 128 output columns (64 a warpgroup) is an m64n64
//     accumulator that goes to device memory (q2, y) or, rounded to bf16,
//     into one of two buffers of two boxes that both warpgroups multiply
//     at once (o2 by Wch, relu(m) by Wf), as the encoder's FFN hidden;
//   * the cross kernel's GCN needs a whole batch row's y, so the layer
//     after the cross-attention is two launches: dec_post_cross_wide_kernel
//     over the flattened rows (x2 and y through scratch buffers), then
//     dec_post_gcn_wide_kernel over tiles of 64 rows of one batch row (one
//     tile at K <= 64, two at K <= 128, ceil(K / 64) in all), which loads
//     the tile's adjacency rows as bf16 boxes [64 x 64] (zero past K), a
//     box for each slice s and each 64 keys q (the unit s kt + q, kt =
//     ceil(K / 64)), and takes each chunk's y0 and y1 by TMA as MN-major
//     boxes of 64 keys in the same unit order (the rows past K fill with
//     zeros), m = adj0 . y0 + adj1 . y1 on wgmma, every unit in that order
//     into one accumulator. The boxes of a tile stay resident while its
//     2 kt units fit the adjacency window (DW_ADJ_SHORT boxes up to K 128,
//     DW_ADJ_LONG above: K <= 320), loaded once a tile; past that each
//     chunk of F loads them again, a window at a time, its products
//     complete before the next window's rows overwrite it;
//   * a row's LayerNorm: head_wide.cuh ew_layernorm. Every element sums its
//     k slabs in one order, the same for every tile, so a row's bits do not
//     depend on its place in the batch, nor on which block ran its tile.
//   No summation point moves: a residual adds (product + bias) as the plain
//   versions do, and q2's two products share one accumulator.
//
// Shared memory (227 KB a block; ring slots 8 KB + two 8-byte barriers):
//   self:  1 KB alignment + x1 boxes [64 x 2 NH] + qpos boxes [64 x 2 NH]
//          + 1 KB LayerNorm sums = 130 KB at NH 256, 6 slots a warpgroup;
//   cross: 1 KB + att2 boxes [64 x 4 NH] (128 KB at NH 256: the A operand of
//          every o2 chunk, then bf16(x2) over its first half) + two o2
//          buffers (32 KB) + 1 KB = 162 KB, 4 slots a warpgroup;
//   gcn:   1 KB + the adjacency window, DW_ADJ_SHORT boxes (32 KB) up to
//          K 128 or DW_ADJ_LONG (80 KB) above, + two relu(m) buffers (32
//          KB) + 1 KB = 66 KB, 8 slots a warpgroup, or 114 KB, 7 slots;
//   8 slots a warpgroup at most (ops/kernels.py dec_wide_rings).
//
// This header holds what the three share (kpt_wide.cu's keypoint head
// takes its ring units, parts and launch helpers too); dec_self_wide.cu
// has the self kernel and dec_wide.cu the cross layer's two, each source a
// library of its own so that nvcc builds them side by side.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attention.cuh"
#include "head_wide.cuh"

#define DW_SLOT EW_BOX                  // a load unit: one [64 x 64] bf16 box
#define DW_RED (4 * 2 * 2 * EW_ROWS)    // the LayerNorm's partial sums

__host__ __device__ constexpr int dw_self_fixed(int nh) { return 1024 + 2 * nh * 256 + DW_RED; }
__host__ __device__ constexpr int dw_cross_fixed(int nh) {
  return 1024 + nh * 512 + 4 * EW_BOX + DW_RED;
}
// The gcn kernel's adjacency window: DW_ADJ_SHORT boxes up to two key
// boxes a batch row (K <= 128), DW_ADJ_LONG above.
#define DW_ADJ_SHORT 4
#define DW_ADJ_LONG 10
__host__ __device__ constexpr int dw_gcn_fixed(int w) { return 1024 + (w + 4) * EW_BOX + DW_RED; }
__host__ __device__ constexpr int dw_adj_window(int k) {
  return (k + 63) / 64 <= 2 ? DW_ADJ_SHORT : DW_ADJ_LONG;
}
__host__ __device__ constexpr int dw_slots(int fixed) {
  return (HW_SMEM_LIMIT - fixed) / (2 * (DW_SLOT + 16)) < EW_MAX_SLOTS
             ? (HW_SMEM_LIMIT - fixed) / (2 * (DW_SLOT + 16))
             : EW_MAX_SLOTS;
}
__host__ __device__ constexpr int dw_smem(int fixed) {
  return fixed + 2 * dw_slots(fixed) * (DW_SLOT + 16);
}
static_assert(dw_slots(dw_cross_fixed(256)) >= 2 && dw_smem(dw_cross_fixed(256)) <= HW_SMEM_LIMIT &&
                  dw_smem(dw_self_fixed(256)) <= HW_SMEM_LIMIT &&
                  dw_smem(dw_gcn_fixed(DW_ADJ_LONG)) <= HW_SMEM_LIMIT &&
                  dw_slots(dw_gcn_fixed(DW_ADJ_LONG)) >= 4,
              "a decoder kernel's rings do not fit a block");

// Columns [64 q, 64 q + 64) of a warpgroup's m64 x NH accumulator x: the
// m64n64 accumulator of those columns (wgmma's layout: column 8 j + 2 t +
// e of the thread's rows in x[4 j + 2 rh + e]).
__device__ __forceinline__ float (&dw_part(float* x, int q))[32] {
  return *reinterpret_cast<float(*)[32]>(x + 32 * q);
}

// The block's shared memory: `boxes` bytes of boxes from a 1024-byte
// boundary, the LayerNorm's sums, the two warpgroups' rings of S slots and
// their barriers (a full one a slot, armed by the producer, and an empty
// one the warpgroup's 4 warps release), initialised.
struct DwSmem {
  unsigned char* boxes;
  float* red;
  unsigned char* ring;
  uint64_t* bars;
};

template <int S>
__device__ __forceinline__ DwSmem dw_smem_init(unsigned char* raw, int boxes) {
  DwSmem m;
  m.boxes = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  m.red = reinterpret_cast<float*>(m.boxes + boxes);
  m.ring = reinterpret_cast<unsigned char*>(m.red + 4 * EW_ROWS);
  m.bars = reinterpret_cast<uint64_t*>(m.ring + 2 * S * DW_SLOT);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * S; ++s) {
      mbar_init(&m.bars[2 * S * (s / S) + s % S], 1);        // full
      mbar_init(&m.bars[2 * S * (s / S) + S + s % S], 4);    // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return m;
}

// The producer: the next load unit of warpgroup ring r, box (c0, c1, c2)
// of a map.
template <int S>
__device__ __forceinline__ void dw_unit(EwRing<S, DW_SLOT>& r, const CUtensorMap* map, int c0,
                                        int c1, int c2 = 0) {
  uint64_t* bar;
  unsigned char* d = r.arm(DW_SLOT, bar);
  tma_load_3d(d, map, bar, c0, c1, c2);
}

// x = res + (x + bias) over the true C, zero past it; res: rows s0, s1 of
// a [*, C] bf16 or fp32 matrix.
template <int NH, class T>
__device__ __forceinline__ void dw_residual(float (&x)[NH / 2], const T* res, long s0, long s1,
                                            const float* bias, int C, int wg, int t) {
#pragma unroll
  for (int j = 0; j < NH / 8; ++j) {
    const int c = wg * NH + 8 * j + 2 * t;
    const float2 bo = ew_ld2(bias, c, C);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float2 sv = ew_ld2(res + (rh ? s1 : s0) * C, c, C);
      float& v0 = x[4 * j + 2 * rh];
      float& v1 = x[4 * j + 2 * rh + 1];
      v0 = c < C ? sv.x + (v0 + bo.x) : 0.0f;
      v1 = c + 1 < C ? sv.y + (v1 + bo.y) : 0.0f;
    }
  }
}

// bf16(x) over the warpgroup's columns of the boxes xs (the next
// products' A operand).
template <int NH>
__device__ __forceinline__ void dw_to_boxes(const float (&x)[NH / 2], unsigned char* xs, int wg,
                                            int row, int t) {
#pragma unroll
  for (int j = 0; j < NH / 8; ++j)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      *reinterpret_cast<unsigned*>(xs + ew_off(row + 8 * rh, wg * NH + 8 * j + 2 * t)) =
          pack_bf16(x[4 * j + 2 * rh], x[4 * j + 2 * rh + 1]);
}

// A warpgroup's 64-column chunk v (columns c0 + 8 jj + 2 t of the tile's
// rows row, row + 8) plus bias (0 at or past n; none when null), ReLU
// where asked, rounded to bf16 into its [64 x 64] box.
__device__ __forceinline__ void dw_chunk_to_box(const float (&v)[32], unsigned char* box,
                                                const float* bias, int c0, int n, bool relu,
                                                int row, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 bb = bias ? ew_ld2(bias, c0 + 8 * jj + 2 * t, n) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float a = v[4 * jj + 2 * rh] + bb.x, b = v[4 * jj + 2 * rh + 1] + bb.y;
      if (relu) {
        a = fmaxf(a, 0.0f);
        b = fmaxf(b, 0.0f);
      }
      *reinterpret_cast<unsigned*>(box + ew_off(row + 8 * rh, 8 * jj + 2 * t)) = pack_bf16(a, b);
    }
  }
}

// The warpgroup's columns below C of the rows r0, r1 (skipped when < 0)
// into a [*, C] matrix of type dt.
template <int NH>
__device__ __forceinline__ void dw_store(const float (&x)[NH / 2], void* m, int dt, long r0,
                                         long r1, int C, int wg, int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const long r = rh ? r1 : r0;
    if (r < 0) continue;
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
      const int c = wg * NH + 8 * j + 2 * t;
      if (c < C) ew_st2(m, dt, r * C + c, x[4 * j + 2 * rh], x[4 * j + 2 * rh + 1], c, C);
    }
  }
}

// bf16(v + bias) of a warpgroup's 64-column chunk (columns c0 + 8 jj + 2 t)
// into the rows r0, r1 (those below R) of a [*, n] bf16 matrix, columns
// below n (n even).
__device__ __forceinline__ void dw_store_chunk(const float (&v)[32], bf16* m, const float* bias,
                                               long r0, long r1, long R, int n, int c0, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = c0 + 8 * jj + 2 * t;
    if (c >= n) continue;
    const float2 bb = ew_ld2(bias, c, n);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const long r = rh ? r1 : r0;
      if (r < R)
        *reinterpret_cast<unsigned*>(m + r * n + c) =
            pack_bf16(v[4 * jj + 2 * rh] + bb.x, v[4 * jj + 2 * rh + 1] + bb.y);
    }
  }
}

// The launches' dynamic shared memory, set once a kernel.
static int dw_configure(const void* f, int smem, bool& configured) {
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  configured = true;
  return 0;
}

// the persistent grid: a block an SM, at most one a tile
static int dw_grid(long tiles, unsigned& grid) {
  int sms = 0;
  const int rc = ew_sms(sms);
  grid = (unsigned)(tiles < sms ? tiles : sms);
  return rc;
}
