// kpt_coord_kernel: the last step of a decoder layer's keypoint head on the
// split route (ops/kernels.py kpt_head_plan above 512 channels). It
// replaces the delta head and coordinate update of the TPU kernel
// edgecape_tpu/ops/fused_decoder.py _stack_kernel (:456-475, through
// pallas_call at :531), with the rounding points of the plain version
// (ops/fused_decoder.py kpt_head_plain): after the three kpt_branch layers
// (GEMMs with the GELU epilogue, run before it), for the stacked rows h =
// [h(x); h(LN(x))] bf16 [2R, C],
//   dd = h . Wo^T + bo                       (N = 2, fp32 sums)
//   pts  = sigmoid(inverse_sigmoid(ct) + dd of row r)
//   outs = sigmoid(inverse_sigmoid(ct) + dd of row R + r)
// with the log-odds clipped at ieps (pos_enc.inverse_sigmoid's 1e-3).
//
// Bound: bytes. Four dot products of C a source row against 2 C bf16 of h
// (a 2 x 2 R x C product: 0.4 GFLOP at 51000 rows of 1024, nothing for the
// tensor cores), so the kernel is the read of h once: 209 MB there, 0.062
// ms at 3.35 TB/s. An N = 2 GEMM would waste 126 of every 128 columns of
// a tile; here a warp takes one source row (its raw and its normed row)
// on the CUDA cores, both rows of Wo staying in L1.
//
// Sum order (held on the CPU by tests/test_torch_split_heads.py): lane l
// takes the columns 64 k + 2 l + e (k ascending, then e < 2), one fused
// multiply-add each (a product of two bf16 values is exact in fp32, so
// each step is one rounded sum); the 32 partial sums meet in the butterfly
// of lanes 16, 8, 4, 2 and 1 apart, then bo is added.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float kc_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void kpt_coord_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wo,
                                 const float* __restrict__ bo, const float* __restrict__ ct,
                                 float* __restrict__ pts, float* __restrict__ outs, long R,
                                 int C, float ieps) {
  const long r = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const bf16* raw = h + r * C;
  const bf16* nrm = h + (R + r) * C;
  // sums of (raw, normed) x (Wo row 0, Wo row 1)
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if ((C & 1) == 0) {          // a bf16 pair a load: rows start on 4 bytes
    for (int c = 2 * lane; c < C; c += 64) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(raw + c));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(nrm + c));
      const float2 w0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wo + c));
      const float2 w1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wo + C + c));
      s[0][0] = __fmaf_rn(a.y, w0.y, __fmaf_rn(a.x, w0.x, s[0][0]));
      s[0][1] = __fmaf_rn(a.y, w1.y, __fmaf_rn(a.x, w1.x, s[0][1]));
      s[1][0] = __fmaf_rn(b.y, w0.y, __fmaf_rn(b.x, w0.x, s[1][0]));
      s[1][1] = __fmaf_rn(b.y, w1.y, __fmaf_rn(b.x, w1.x, s[1][1]));
    }
  } else {
    for (int c0 = 2 * lane; c0 < C; c0 += 64) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + e;
        if (c >= C) break;
        const float a = __bfloat162float(raw[c]), b = __bfloat162float(nrm[c]);
        const float w0 = __bfloat162float(wo[c]), w1 = __bfloat162float(wo[C + c]);
        s[0][0] = __fmaf_rn(a, w0, s[0][0]);
        s[0][1] = __fmaf_rn(a, w1, s[0][1]);
        s[1][0] = __fmaf_rn(b, w0, s[1][0]);
        s[1][1] = __fmaf_rn(b, w1, s[1][1]);
      }
    }
  }
  float dd[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int o = 0; o < 2; ++o) dd[p][o] = __fadd_rn(kc_warp_sum(s[p][o]), bo[o]);
  if (lane < 4) {              // lane 2 p + o writes coordinate o of pass p
    const int p = lane >> 1, o = lane & 1;
    const float c = fminf(fmaxf(ct[2 * r + o], 0.0f), 1.0f);
    const float inv = logf(fmaxf(c, ieps) / fmaxf(1.0f - c, ieps));
    (p ? outs : pts)[2 * r + o] = 1.0f / (1.0f + expf(-__fadd_rn(inv, dd[p][o])));
  }
}

// h [2R, C] bf16, 4-byte aligned (rows 0..R-1 from x, R..2R-1 from the
// normed x); wo [2, C] bf16, 4-byte aligned; bo fp32 [2]; ct, pts, outs
// fp32 [R, 2]. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what it does not take.
extern "C" int ec_kpt_coord(const void* h, const void* wo, const void* bo, const void* ct,
                            void* pts, void* outs, long R, int C, float ieps, void* stream) {
  if (R <= 0 || C <= 0 || !h || !wo || !bo || !ct || !pts || !outs ||
      (reinterpret_cast<uintptr_t>(h) & 3) || (reinterpret_cast<uintptr_t>(wo) & 3))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long blocks = (R * 32 + threads - 1) / threads;
  kpt_coord_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wo), static_cast<const float*>(bo),
      static_cast<const float*>(ct), static_cast<float*>(pts), static_cast<float*>(outs), R, C,
      ieps);
  return (int)cudaGetLastError();
}
