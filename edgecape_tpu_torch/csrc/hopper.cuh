// Hopper building blocks shared by the kernels of edgecape_tpu_torch
// (kernels.cu, mm_chain.cu, attn_long.cu, head_wide.cu, dec_self_wide.cu,
// dec_wide.cu, kpt_wide.cu, bias_long.cu, vit_wide.cu):
// the row arithmetic of the LayerNorm and GELU epilogues, mbarriers, TMA
// copies in and out of 128-byte swizzled shared memory, wgmma descriptors
// and products (from shared memory, or with A in registers), the weight
// ring of the kernels without producer warps (CountRing), and the host's
// tensor-map encoder. Each source that includes this header is its own
// library (ops/kernels.py builds one per source), so every definition
// here is inline or static.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// a swizzled [128 rows x 64] bf16 slab: 128 rows of 128 bytes
#define SW_SLAB 16384

// Two floats rounded to bf16 in one register, `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// v rounded to bf16, in fp32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The steps of the LayerNorm that layernorm_kernel, vit_mlp_kernel,
// vit_qkv_kernel (kernels.cu) and vit_ln_gemm_kernel (vit_wide.cu) share,
// each rounded on its own (the _rn intrinsics) so that the compiler
// contracts nothing differently in them: the mean, 1 / sqrt(var + eps),
// q + (v - mean)^2 and (v - mean) * inv * g + b.
__device__ __forceinline__ float ln_mean(float sum, int C) { return __fdiv_rn(sum, (float)C); }
__device__ __forceinline__ float ln_inv(float sq, int C, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(sq, (float)C), eps));
}
__device__ __forceinline__ float ln_sq(float q, float v, float mean) {
  const float d = __fsub_rn(v, mean);
  return __fmaf_rn(d, d, q);
}
__device__ __forceinline__ float ln_apply(float v, float mean, float inv, float g, float b) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(v, mean), inv), g, b);
}

// Exact-erf GELU of vit_mlp_kernel and vit_ln_gemm_kernel, with the TPU
// kernel's own erf (Abramowitz & Stegun 7.1.26,
// edgecape_tpu/ops/fused_decoder.py _erf: within 1.5e-7 of erf): an
// approximate reciprocal, five multiply-adds and an approximate
// exponential, written out (__fdividef and __expf add range checks):
// about 16 instructions and two MUFU operations a value, under half the
// instructions of erff.
__device__ __forceinline__ float gelu_as(float x) {
  float t, e;
  const float az = fabsf(x) * 0.70710678118654752f;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(0.3275911f, az, 1.0f)));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f), 0.254829592f);
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(az * az * -1.4426950408889634f));
  const float hx = 0.5f * x;
  return fmaf(hx, copysignf(fmaf(-poly, e, 1.0f), x), hx);
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a three-dimensional tensor map into shared memory; the copy
// completes `bar` with the box's bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory to a three-dimensional tensor map (rows and
// columns past the tensor's edges are not written), as a bulk group of
// the issuing thread; tma_store_wait: that thread's groups have read
// their shared memory.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Matrix descriptors of wgmma for 128-byte-swizzled tiles whose rows are
// 128 bytes (64 bf16) and whose 8-row groups are 1024 bytes apart.
// K-major (rows are m or n, k runs along a row): the leading offset is
// unused, the stride offset is the 8-row group. MN-major (rows are k, n
// runs along a row, 64 columns a box): the stride offset is the group of
// 8 k, the leading offset the distance to the next 64 columns (one box).
__device__ __forceinline__ uint64_t wg_desc(unsigned addr, unsigned lead_bytes) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lead_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= a . b for one m64n64k16 tile, a and b in shared memory. TB: b is
// MN-major. `accumulate` 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d += a . b for one m64n128k16 tile, a in registers (four bf16 pairs a
// thread, the m16n8k16 A fragment of the thread's warp), b in shared
// memory. TB: b is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const unsigned (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// d (+)= a . b for one m64n128k16 tile, a and b in shared memory. TB: b
// is MN-major. `accumulate` 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d += a . b for one m64n64k16 tile, a in registers (the m16n8k16 A
// fragment of the thread's warp), b in shared memory. TB: b is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const unsigned (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// d += a . b for one m64n32k16 tile, a in registers, b in shared memory.
// TB: b is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const unsigned (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that use it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void reg_fence(unsigned (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void acc_zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.0f;
}

__device__ __forceinline__ void fence_view_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of the 128 threads of consumer warpgroup wg, or of both (256).
__device__ __forceinline__ void bar_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Byte offset of element (r, c) in consecutive swizzled slabs of
// [128 rows x 64] bf16 (column c in slab c / 64): rows of 128 bytes whose
// 16-byte chunks are XORed with the row's three low bits, the layout of
// the TMA's and wgmma's 128-byte swizzle. A K-major operand has its rows
// as m or n; an MN-major one (the decoder's y) its rows as k.
__device__ __forceinline__ unsigned sw_off(int r, int c) {
  return (unsigned)((c >> 6) * SW_SLAB + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                    ((c & 7) << 1));
}

// A ring of S slots of Loader::kBytes each in shared memory, filled by TMA
// in the block's load order: slot i % S holds load i (issued by the
// Loader, which arms the slot's full barrier with its bytes), and a
// release counter per slot that each of the block's 8 warps raises once
// the products that read the slot are complete; the warp whose release is
// the eighth issues the slot's next load at once, so nobody waits for a
// slot to be freed.
template <int S, class Loader>
struct CountRing {
  unsigned char* slots;
  uint64_t* full;
  unsigned* used;
  Loader ld;
  unsigned it;      // the next slot to take
  unsigned done;    // the next slot to hand back
  unsigned total;   // loads of this block

  // the slots at `at`, the full barriers and the counters at `bars`, for
  // `n` loads; returns the next 8-byte-aligned byte after the counters
  __device__ __forceinline__ unsigned char* place(unsigned char* at, unsigned char* bars,
                                                  unsigned n) {
    slots = at;
    full = reinterpret_cast<uint64_t*>(bars);
    used = reinterpret_cast<unsigned*>(full + S);
    it = done = 0;
    total = n;
    return bars + ((S * 12 + 7) & ~7);
  }
  // one thread, before the block's first barrier: the barriers' state
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      used[s] = 0;
    }
  }
  // one thread, after it: the first S loads
  __device__ __forceinline__ void prime() {
    for (unsigned i = 0; i < S && i < total; ++i) load(i);
  }
  __device__ __forceinline__ void load(unsigned i) {
    ld(i, slots + (i % S) * Loader::kBytes, &full[i % S]);
  }
  // wait for the next slot; its shared address
  __device__ __forceinline__ unsigned wait() {
    const unsigned s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    ++it;
    return smem_u32(slots + s * Loader::kBytes);
  }
  // the same, ready for products
  __device__ __forceinline__ unsigned next() {
    const unsigned a = wait();
    wg_fence();
    return a;
  }
  // after a slot's products: commit them and hand back the slot before
  // (`first`: there is none in this run)
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
  // this warp is done with the slot; the eighth warp to say so refills it
  __device__ __forceinline__ void give(int lane) {
    if (lane == 0) {
      unsigned old;
      asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                   : "=r"(old) : "r"(smem_u32(&used[done % S])) : "memory");
      if (old % 8 == 7 && done + S < total) load(done + S);
    }
    ++done;
  }
};

typedef CUresult (*TensorMapEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                      const cuuint32_t*, CUtensorMapInterleave,
                                      CUtensorMapSwizzle, CUtensorMapL2promotion,
                                      CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the installed libcuda, through the runtime.
static TensorMapEncodeFn tensor_map_encoder() {
  static TensorMapEncodeFn fn = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeFn>(sym);
  }
  return fn;
}

// A [rows, inner] bf16 matrix with row stride ld, repeated `batch` times
// sz elements apart (0: shared), as a map of boxes [1, box_rows, 64]; f32:
// an fp32 matrix in boxes [1, box_rows, 32]. A box row is 128 bytes.
static bool encode_map(CUtensorMap* map, const void* ptr, long inner, long rows, long ld,
                       long sz, int batch, unsigned box_rows, bool f32 = false) {
  TensorMapEncodeFn encode = tensor_map_encoder();
  if (!encode) return false;
  const bool shared = batch == 1 || sz == 0;
  const int el = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)(shared ? 1 : batch)};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * el,
                                 (cuuint64_t)(shared ? rows * ld : sz) * el};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / el), box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
