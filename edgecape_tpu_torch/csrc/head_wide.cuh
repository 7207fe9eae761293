// The parts of a persistent Hopper kernel that the head_wide.cu,
// dec_self_wide.cu, dec_wide.cu and kpt_wide.cu kernels share
// (enc_post_wide_kernel, the design of the head_wide.cu header;
// dec_post_self_wide_kernel, dec_post_cross_wide_kernel and
// dec_post_gcn_wide_kernel, dec_wide.cuh's; kpt_head_wide_kernel,
// kpt_wide.cu's):
// tiles of 64 rows, a producer warpgroup whose one thread issues every TMA
// copy of the weights, two consumer warpgroups holding the tile's rows
// times half the channels each (NH = C / 2 rounded up to 64) in wgmma
// accumulators, the weight ring of a warpgroup, the LayerNorm over both
// warpgroups' halves, the tile's rows into 128-byte-swizzled boxes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attention.cuh"

#define HW_MAX_C 512       // channels
#define HW_MAX_K 128       // keypoints of a batch row (bias_attn_wide_kernel)
#define HW_SMEM_LIMIT (227 * 1024)

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16(v)); }

static bool hw_aligned(const void* p) {
  return p && (reinterpret_cast<uintptr_t>(p) & 31) == 0;
}

// The producer warpgroup's registers to the consumers: 128 (168 - 40) =
// 256 (232 - 168) from the launch's 168 a thread.
__device__ __forceinline__ void regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

#define EW_ROWS 64            // rows of a tile
#define EW_THREADS 384        // the producer warpgroup + two consumer warpgroups
#define EW_CHUNK 128          // hidden columns a chunk, 64 a consumer warpgroup
#define EW_BOX 8192           // a swizzled [64 rows x 64] bf16 box
#define EW_MAX_SLOTS 8        // slots of a warpgroup's ring at most

// The half width of C channels: C / 2 in steps of 64.
__host__ __device__ constexpr int ew_half(int c) { return ((c + 1) / 2 + 63) / 64 * 64; }

// Byte offset of element (r, c) in consecutive swizzled boxes of [64 rows x
// 64] bf16 (column c in box c / 64): the layout of the TMA's and wgmma's
// 128-byte swizzle, as hopper.cuh sw_off for boxes of 64 rows.
__device__ __forceinline__ unsigned ew_off(int r, int c) {
  return (unsigned)((c >> 6) * EW_BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                    ((c & 7) << 1));
}

// d (+)= a . b for one m64n192k16 tile, a and b K-major in shared memory;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n192k16_ss(float (&d)[96], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
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
      " %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 0;\n"
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
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= a . b for one m64n256k16 tile, a and b K-major in shared memory;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
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
      " %128, %129, p, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// x += A . B^T over one 64-deep k slab for a warpgroup's accumulator x
// [64 rows x NH] (wgmma's layout: columns 8 j + 2 t + e of rows r, r + 8
// in x[4 j + 2 rh + e]): A the tile's rows at shared address xa, B NH
// rows of the weight (K-major) at bb, one product per 16 of k.
template <int NH>
__device__ __forceinline__ void ew_mma(float (&x)[NH / 2], unsigned xa, unsigned bb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = wg_desc(xa + kk * 32, 16), db = wg_desc(bb + kk * 32, 16);
    if constexpr (NH == 64) wgmma_m64n64k16<0>(x, da, db, 1);
    else if constexpr (NH == 128) wgmma_m64n128k16<0>(x, da, db, 1);
    else if constexpr (NH == 192) wgmma_m64n192k16_ss(x, da, db, 1);
    else wgmma_m64n256k16_ss(x, da, db, 1);
  }
}

// A consumer warpgroup's ring: slot i % S holds load unit i of the
// warpgroup (SLOT bytes by TMA, one or several boxes, arming the slot's
// full barrier with their bytes), released by the warpgroup's 4 warps
// (the empty barrier) once its products are complete.
template <int S, int SLOT>
struct EwRing {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  unsigned it;     // the next slot to fill (producer) or to take (consumers)
  unsigned done;   // consumers: the next slot to hand back

  __device__ __forceinline__ void place(unsigned char* at, uint64_t* bars) {
    slots = at;
    full = bars;
    empty = bars + S;
    it = done = 0;
  }
  // producer: the next slot once it is free, armed for `bytes`
  __device__ __forceinline__ unsigned char* arm(unsigned bytes, uint64_t*& bar) {
    const unsigned s = it % S;
    if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
    bar = &full[s];
    mbar_expect_tx(bar, bytes);
    ++it;
    return slots + s * SLOT;
  }
  // consumers: the next slot's shared address once it has arrived, ready
  // for products
  __device__ __forceinline__ unsigned next() {
    const unsigned s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    ++it;
    wg_fence();
    return smem_u32(slots + s * SLOT);
  }
  // consumers, after issuing a slot's products: commit them and hand back
  // the slot before it (`first`: there is none in this run of slots)
  __device__ __forceinline__ void issued(int lane, bool first) {
    wg_commit();
    if (!first) {
      wg_wait<1>();
      give(lane);
    }
  }
  __device__ __forceinline__ void drain(int lane) {
    wg_wait<0>();
    give(lane);
  }
  __device__ __forceinline__ void give(int lane) {
    if (lane == 0) mbar_arrive(&empty[done % S]);
    ++done;
  }
};

// Columns c, c + 1 of a row of n values, 0 at or past n: one load where n
// is even (c is even, so c + 1 < n with c < n).
__device__ __forceinline__ float2 ew_ld2(const bf16* row, int c, int n) {
  if (!(n & 1)) {
    if (c >= n) return make_float2(0.0f, 0.0f);
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(row + c));
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  return make_float2(c < n ? __bfloat162float(row[c]) : 0.0f,
                     c + 1 < n ? __bfloat162float(row[c + 1]) : 0.0f);
}
__device__ __forceinline__ float2 ew_ld2(const float* row, int c, int n) {
  if (!(n & 1)) return c < n ? __ldg(reinterpret_cast<const float2*>(row + c))
                             : make_float2(0.0f, 0.0f);
  return make_float2(c < n ? row[c] : 0.0f, c + 1 < n ? row[c + 1] : 0.0f);
}

// a, b into columns c, c + 1 (those below n) of element offset `off` of a
// bf16 or fp32 matrix with rows of n values
__device__ __forceinline__ void ew_st2(void* m, int dt, long off, float a, float b, int c,
                                       int n) {
  if (!(n & 1)) {
    if (dt == DT_BF16)
      *reinterpret_cast<unsigned*>(static_cast<bf16*>(m) + off) = pack_bf16(a, b);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(m) + off) = make_float2(a, b);
    return;
  }
  st_val(m, dt, off, a);
  if (c + 1 < n) st_val(m, dt, off + 1, b);
}

// LayerNorm of the tile's rows `row`, `row + 8` held by the two consumer
// warpgroups (each its NH columns of v in wgmma's accumulator layout,
// columns at or past C zero and kept zero), fp32 statistics over the true
// C and the two-pass variance, as ops/plain.py layer_norm: (v - mean) *
// rsqrt(var + eps) * g + be. A row's sums: over the thread's columns in
// order, over the quad by shuffles, then warpgroup 0's part plus
// warpgroup 1's through `red` (shared memory), the same for every row.
template <int NH>
__device__ __forceinline__ void ew_layernorm(float (&v)[NH / 2], float* red, const float* g,
                                             const float* be, int C, float eps, int wg,
                                             int row, int t) {
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NH / 8; ++j)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) s[rh] += v[4 * j + 2 * rh] + v[4 * j + 2 * rh + 1];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    s[rh] = quad_sum(s[rh]);
    if (t == 0) red[wg * EW_ROWS + row + 8 * rh] = s[rh];
  }
  bar_consumers();
  float mean[2], q[2] = {0.0f, 0.0f};
#pragma unroll
  for (int rh = 0; rh < 2; ++rh)
    mean[rh] = (red[row + 8 * rh] + red[EW_ROWS + row + 8 * rh]) / (float)C;
#pragma unroll
  for (int j = 0; j < NH / 8; ++j) {
    const int c = wg * NH + 8 * j + 2 * t;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = c + e < C ? v[4 * j + 2 * rh + e] - mean[rh] : 0.0f;
        q[rh] += d * d;
      }
  }
  float* rq = red + 2 * EW_ROWS;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    q[rh] = quad_sum(q[rh]);
    if (t == 0) rq[wg * EW_ROWS + row + 8 * rh] = q[rh];
  }
  bar_consumers();
  float inv[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh)
    inv[rh] = rsqrtf((rq[row + 8 * rh] + rq[EW_ROWS + row + 8 * rh]) / (float)C + eps);
#pragma unroll
  for (int j = 0; j < NH / 8; ++j) {
    const int c = wg * NH + 8 * j + 2 * t;
    const float2 gg = ew_ld2(g, c, C), bb = ew_ld2(be, c, C);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float& v0 = v[4 * j + 2 * rh];
      float& v1 = v[4 * j + 2 * rh + 1];
      v0 = c < C ? (v0 - mean[rh]) * inv[rh] * gg.x + bb.x : 0.0f;
      v1 = c + 1 < C ? (v1 - mean[rh]) * inv[rh] * gg.y + bb.y : 0.0f;
    }
  }
}

// The att rows [row0, row0 + 64) of warpgroup wg's columns [wg NH, wg NH +
// NH) into the x boxes: 16-byte cp.async where C is a multiple of 8 (the
// rows are then 16-byte aligned), else element loads; zeros past R and C.
template <int NH>
__device__ __forceinline__ void ew_load_att(unsigned char* xs, const bf16* att, long row0,
                                            long R, int C, int wg, int ct) {
  const bool vec = !(C & 7);
  for (int i = ct; i < EW_ROWS * NH / 8; i += 128) {
    const int r = i / (NH / 8), c = wg * NH + (i % (NH / 8)) * 8;
    unsigned char* dst = xs + ew_off(r, c);
    const long row = row0 + r;
    const bf16* src = att + row * C + c;
    if (vec && row < R && c + 8 <= C) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
    } else {
      unsigned u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = row < R && c + 2 * e < C ? __bfloat162float(src[2 * e]) : 0.0f;
        const float b = row < R && c + 2 * e + 1 < C ? __bfloat162float(src[2 * e + 1]) : 0.0f;
        u[e] = pack_bf16(a, b);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

// Starts the row r (skipped when < 0) of a [*, C] bf16 matrix, columns
// [c0, c0 + NH) below C, on its way into L2: the quad's threads take every
// fourth 128-byte line.
template <int NH>
__device__ __forceinline__ void ew_prefetch(const bf16* m, long r, int C, int c0, int t) {
  if (r < 0 || c0 >= C) return;
  const char* row = reinterpret_cast<const char*>(m + r * C + c0);
  const int bytes = 2 * (C - c0 < NH ? C - c0 : NH);
  for (int off = 128 * t; off < bytes; off += 512)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + off));
}

static int ew_sms(int& sms) {
  static int count = 0;
  if (!count) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      count = 0;
      return (int)e;
    }
  }
  sms = count;
  return 0;
}
