// Width-generic companions of the head's kernels in kernels.cu, for every
// head the JAX package takes other than the 256 channels (8 heads of 32)
// those are written for: enc_post_wide_kernel, dec_post_self_wide_kernel,
// dec_post_cross_wide_kernel, kpt_head_wide_kernel (C up to 512 channels,
// any hidden width) and bias_attn_wide_kernel (1..16 heads of 1..128).
// They replace the same TPU kernels as their 256-channel forms
// (edgecape_tpu/ops/fused_encoder.py _layer_body, fused_decoder.py _kernel
// and _stack_kernel) with the same rounding points as the plain versions
// (ops/fused_encoder.py, ops/fused_decoder.py): bf16 operands, fp32
// accumulation, fp32 LayerNorm statistics over the true C and softmax.
//
// Why a second form: the 256-channel kernels keep a warpgroup's 64 rows of
// whole channels in wgmma accumulators (128 registers a thread at C = 256);
// at C = 512 that is 256 registers, more than a thread has, and below 256
// channels their four 64-column slabs, the TMA boxes and the LayerNorm all
// assume the width. This form is simple and right at every width, not fast:
//   * a block owns a tile of 16 rows (a batch row of K <= 128 keypoints for
//     the decoder's cross kernel, walked 16 rows at a time), 256 threads;
//   * products are WMMA m16n16k16 (bf16 in, fp32 out): A from shared memory,
//     B straight from the weights in device memory (L2 holds them: every
//     tile reads the same ones), outputs into fp32 rows in shared memory;
//   * K and N are padded to multiples of 16 (hidden widths to 64) with zero
//     rows and columns in the weights, laid out once by the fused ops'
//     `_prepare` (ops/kernels.py pad_cols / pad_ffn / pad_gcn); rows and
//     channels past the true ones are zero in the A tiles, so the padding
//     adds exact zeros, and every LayerNorm, bias and store runs over the
//     true C alone;
//   * row work (bias, residual, LayerNorm, activations, stores) takes a
//     half-warp a row, its sums by shuffles.
// What bounds them: each 16-row tile reads every weight of its op from L2
// (at C = 512, F = 1024: 2.5 MB a tile for the encoder), so they run at
// L2's rate, far above the bytes and operations the work needs. Their
// times are in PERF.md; making them fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attention.cuh"

using namespace nvcuda;

#define HW_ROWS 16         // rows of a tile
#define HW_THREADS 256     // 8 warps
#define HW_CHUNK 64        // hidden columns a chunk
#define HW_MAX_C 512       // channels
#define HW_MAX_K 128       // keypoints of a batch row (the cross kernel)
#define HW_SMEM_LIMIT (227 * 1024)

// out[16, n] (fp32 shared memory, row stride ldo) = (acc ? out : 0) +
// a[16, k] (bf16 shared, stride lda) . B, with B [k, n] the transpose of a
// [n, k] weight of row stride ldb (B_NK), or a [k, n] matrix of row stride
// ldb; n and k multiples of 16, every base 32-byte aligned. Warps take the
// 16-column tiles in turn; the caller synchronises the block around it.
template <bool B_NK>
__device__ __forceinline__ void tile_mm(float* out, int ldo, const bf16* a, int lda,
                                        const bf16* b, long ldb, int n, int k, bool acc) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int n0 = warp * 16; n0 < n; n0 += nw * 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc)
      wmma::load_matrix_sync(c, out + n0, ldo, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.0f);
    for (int k0 = 0; k0 < k; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + k0, lda);
      if constexpr (B_NK) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, b + (long)n0 * ldb + k0, (unsigned)ldb);
        wmma::mma_sync(c, fa, fb, c);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b + (long)k0 * ldb + n0, (unsigned)ldb);
        wmma::mma_sync(c, fa, fb, c);
      }
    }
    wmma::store_matrix_sync(out + n0, c, ldo, wmma::mem_row_major);
  }
}

__device__ __forceinline__ float hsum16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16(v)); }

// The half-warp of a row: rows 2 warp and 2 warp + 1 of the tile.
struct RowLane {
  int r, l;   // tile row, lane in the row's half-warp (0..15)
};
__device__ __forceinline__ RowLane row_lane() {
  const int lane = threadIdx.x & 31;
  return {2 * (threadIdx.x >> 5) + (lane >> 4), lane & 15};
}

// LayerNorm of v[0 .. c) (a tile row in shared memory) in place, fp32
// statistics and the two-pass variance over the true c, as
// ops/plain.py layer_norm: (v - mean) * rsqrt(var + eps) * g + be.
__device__ __forceinline__ void row_layernorm(float* v, int c, const float* g, const float* be,
                                              float eps, int l) {
  float s = 0.0f;
  for (int i = l; i < c; i += 16) s += v[i];
  const float mean = hsum16(s) / (float)c;
  float q = 0.0f;
  for (int i = l; i < c; i += 16) {
    const float d = v[i] - mean;
    q += d * d;
  }
  const float inv = rsqrtf(hsum16(q) / (float)c + eps);
  for (int i = l; i < c; i += 16) v[i] = (v[i] - mean) * inv * g[i] + be[i];
}

// Rows [row0, row0 + 16) of a bf16 matrix [rows, c] (row stride ld) into
// the bf16 tile a [16, cp] (stride lda): zeros past `rows` and past c.
__device__ __forceinline__ void load_rows(bf16* a, int lda, const bf16* m, long ld, long row0,
                                          long rows, int c, int cp) {
  for (int i = threadIdx.x; i < HW_ROWS * cp; i += blockDim.x) {
    const int r = i / cp, cc = i % cp;
    const long row = row0 + r;
    a[r * lda + cc] = row < rows && cc < c ? m[row * ld + cc] : __float2bfloat16(0.0f);
  }
}

// Shared memory: bf16 and fp32 tiles of 16 rows, strides padded (bf16 by
// 8, fp32 by 4 elements) and each tile rounded up to 128 bytes.
__host__ __device__ constexpr int hw_bld(int cols) { return cols + 8; }
__host__ __device__ constexpr int hw_fld(int cols) { return cols + 4; }
__host__ __device__ constexpr long hw_bytes(long b) { return (b + 127) / 128 * 128; }
__host__ __device__ constexpr long hw_btile(int cols) { return hw_bytes(2L * HW_ROWS * hw_bld(cols)); }
__host__ __device__ constexpr long hw_ftile(int cols) { return hw_bytes(4L * HW_ROWS * hw_fld(cols)); }

static int hw_launch_check(const void* f, long smem, bool& configured) {
  if (smem > HW_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, HW_SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  return 0;
}

static bool hw_aligned(const void* p) {
  return p && (reinterpret_cast<uintptr_t>(p) & 31) == 0;
}

// ---- joint encoder: x = LN1(src + (att . Wo^T + bo)); y = LN2(x +
// (relu(bf16(x) . W1^T + b1) . W2^T + b2)), the hidden in chunks of 64;
// y in the tokens' type and / or the next layer's src = bf16(bf16(y) +
// pos[row % n_tok]).
struct EncWideArgs {
  const bf16 *att, *src, *wo, *w1, *w2, *pos;
  const float *bo, *g1, *be1, *b1, *b2, *g2, *be2;
  void* out; int out_dt;
  bf16* nxt;
  long R;
  int C, Cp, Fp, n_tok;
  float eps;
};

__host__ __device__ constexpr long enc_wide_smem(int cp) {
  return hw_btile(cp) + 2 * hw_ftile(cp) + hw_ftile(HW_CHUNK) + hw_btile(HW_CHUNK);
}

__global__ void __launch_bounds__(HW_THREADS) enc_post_wide_kernel(EncWideArgs p) {
  extern __shared__ __align__(128) unsigned char hw_raw[];
  const int cp = p.Cp, lda = hw_bld(cp), ldx = hw_fld(cp);
  bf16* A = reinterpret_cast<bf16*>(hw_raw);
  float* X = reinterpret_cast<float*>(hw_raw + hw_btile(cp));
  float* Y = reinterpret_cast<float*>(hw_raw + hw_btile(cp) + hw_ftile(cp));
  float* H = reinterpret_cast<float*>(hw_raw + hw_btile(cp) + 2 * hw_ftile(cp));
  bf16* HB = reinterpret_cast<bf16*>(hw_raw + hw_btile(cp) + 2 * hw_ftile(cp) +
                                     hw_ftile(HW_CHUNK));
  const long row0 = (long)blockIdx.x * HW_ROWS;
  const RowLane rl = row_lane();
  const long row = row0 + rl.r;

  load_rows(A, lda, p.att, p.C, row0, p.R, p.C, cp);
  __syncthreads();
  tile_mm<true>(X, ldx, A, lda, p.wo, cp, cp, cp, false);
  __syncthreads();
  {
    float* v = X + rl.r * ldx;
    for (int i = rl.l; i < p.C; i += 16) {
      const float s = row < p.R ? __bfloat162float(p.src[row * p.C + i]) : 0.0f;
      v[i] = s + (v[i] + p.bo[i]);
    }
    row_layernorm(v, p.C, p.g1, p.be1, p.eps, rl.l);
    for (int i = rl.l; i < p.C; i += 16) A[rl.r * lda + i] = __float2bfloat16(v[i]);
  }
  __syncthreads();
  for (int j = 0; j < p.Fp / HW_CHUNK; ++j) {
    tile_mm<true>(H, hw_fld(HW_CHUNK), A, lda, p.w1 + (long)j * HW_CHUNK * cp, cp, HW_CHUNK,
                  cp, false);
    __syncthreads();
    for (int i = threadIdx.x; i < HW_ROWS * HW_CHUNK; i += blockDim.x) {
      const int r = i / HW_CHUNK, cc = i % HW_CHUNK;
      HB[r * hw_bld(HW_CHUNK) + cc] = __float2bfloat16(
          fmaxf(H[r * hw_fld(HW_CHUNK) + cc] + p.b1[j * HW_CHUNK + cc], 0.0f));
    }
    __syncthreads();
    tile_mm<true>(Y, ldx, HB, hw_bld(HW_CHUNK), p.w2 + j * HW_CHUNK, p.Fp, cp, HW_CHUNK, j > 0);
    __syncthreads();
  }
  float* v = X + rl.r * ldx;
  const float* y = Y + rl.r * ldx;
  for (int i = rl.l; i < p.C; i += 16) v[i] = v[i] + (y[i] + p.b2[i]);
  row_layernorm(v, p.C, p.g2, p.be2, p.eps, rl.l);
  if (row >= p.R) return;
  for (int i = rl.l; i < p.C; i += 16) {
    if (p.out) st_val(p.out, p.out_dt, row * p.C + i, v[i]);
    if (p.nxt)
      p.nxt[row * p.C + i] = __float2bfloat16(
          bfr(v[i]) + __bfloat162float(p.pos[(row % p.n_tok) * p.C + i]));
  }
}

// ---- decoder, after the self-attention: x1 = LN1(xb + (att . Wso^T +
// bso)), written in fp32; q2 = bf16(bf16(x1) . Wcq_x^T + qpos . Wcq_p^T +
// bcq) for the cross-attention (2C columns).
struct DecSelfWideArgs {
  const bf16 *att, *xb, *qpos, *wso, *wcqx, *wcqp;
  const float *bso, *g1, *be1, *bcq;
  float* x1;
  bf16* q2;
  long R;
  int C, Cp, C2p;
  float eps;
};

__host__ __device__ constexpr long dec_self_wide_smem(int cp, int c2p) {
  return 2 * hw_btile(cp) + hw_ftile(cp) + hw_ftile(c2p);
}

__global__ void __launch_bounds__(HW_THREADS) dec_post_self_wide_kernel(DecSelfWideArgs p) {
  extern __shared__ __align__(128) unsigned char hw_raw[];
  const int cp = p.Cp, lda = hw_bld(cp), ldx = hw_fld(cp), ldz = hw_fld(p.C2p);
  bf16* A = reinterpret_cast<bf16*>(hw_raw);
  bf16* Q = reinterpret_cast<bf16*>(hw_raw + hw_btile(cp));
  float* X = reinterpret_cast<float*>(hw_raw + 2 * hw_btile(cp));
  float* Z = reinterpret_cast<float*>(hw_raw + 2 * hw_btile(cp) + hw_ftile(cp));
  const long row0 = (long)blockIdx.x * HW_ROWS;
  const RowLane rl = row_lane();
  const long row = row0 + rl.r;

  load_rows(A, lda, p.att, p.C, row0, p.R, p.C, cp);
  load_rows(Q, lda, p.qpos, p.C, row0, p.R, p.C, cp);
  __syncthreads();
  tile_mm<true>(X, ldx, A, lda, p.wso, cp, cp, cp, false);
  __syncthreads();
  {
    float* v = X + rl.r * ldx;
    for (int i = rl.l; i < p.C; i += 16) {
      const float s = row < p.R ? __bfloat162float(p.xb[row * p.C + i]) : 0.0f;
      v[i] = s + (v[i] + p.bso[i]);
    }
    row_layernorm(v, p.C, p.g1, p.be1, p.eps, rl.l);
    for (int i = rl.l; i < p.C; i += 16) {
      A[rl.r * lda + i] = __float2bfloat16(v[i]);
      if (row < p.R) p.x1[row * p.C + i] = v[i];
    }
  }
  __syncthreads();
  tile_mm<true>(Z, ldz, A, lda, p.wcqx, cp, p.C2p, cp, false);
  __syncthreads();
  tile_mm<true>(Z, ldz, Q, lda, p.wcqp, cp, p.C2p, cp, true);
  __syncthreads();
  if (row >= p.R) return;
  for (int i = rl.l; i < 2 * p.C; i += 16)
    p.q2[row * 2 * p.C + i] = __float2bfloat16(Z[rl.r * ldz + i] + p.bcq[i]);
}

// ---- decoder, after the cross-attention, one block a batch row of K <=
// 128 keypoints, 16 rows at a time: phase A per tile o2 = bf16(att2 .
// Wco^T + bco); x2 = LN2(x1 + (o2 . Wch^T + bch)) into the x2 scratch;
// y = bf16(bf16(x2) . Wg^T + bg) into the y scratch [B, K16, 2 Fp] (its
// rows past K zero). Phase B per tile, the block's
// own y written and synchronised: per hidden chunk of 64, m = bf16(adj0) .
// y0 + bf16(adj1) . y1, f += bf16(relu(m)) . Wf^T; out = LN3(x2 + (f +
// bf)).
struct DecCrossWideArgs {
  const bf16 *att2, *wco, *wch, *wg, *wf;
  const float *bco, *bch, *g2, *be2, *bg, *bf, *g3, *be3;
  const float* x1;
  const void* adj; int adj_dt;
  float* x2;       // scratch [B K, C]
  bf16* y;         // scratch [B, K16, 2 Fp]
  void* out; int out_dt;
  int B, K, K16, C, Cp, C2p, Fp;
  float eps;
};

__host__ __device__ constexpr long dec_cross_wide_smem(int cp, int c2p, int k16) {
  return hw_btile(c2p) + hw_ftile(c2p) + hw_ftile(cp > HW_CHUNK ? cp : HW_CHUNK) +
         hw_btile(cp) + hw_ftile(128) + 2 * hw_btile(k16) + hw_btile(HW_CHUNK);
}

__global__ void __launch_bounds__(HW_THREADS) dec_post_cross_wide_kernel(DecCrossWideArgs p) {
  extern __shared__ __align__(128) unsigned char hw_raw[];
  const int cp = p.Cp, c2p = p.C2p;
  const int lda2 = hw_bld(c2p), ldz = hw_fld(c2p), ldx = hw_fld(cp), lda = hw_bld(cp);
  const int ldj = hw_bld(p.K16), ldy = 2 * p.Fp;
  unsigned char* at = hw_raw;
  bf16* A2 = reinterpret_cast<bf16*>(at);
  at += hw_btile(c2p);
  float* Z = reinterpret_cast<float*>(at);        // o2; phase B: f
  at += hw_ftile(c2p);
  float* X = reinterpret_cast<float*>(at);        // a2, x2; phase B: m
  at += hw_ftile(cp > HW_CHUNK ? cp : HW_CHUNK);
  bf16* A = reinterpret_cast<bf16*>(at);          // bf16(x2)
  at += hw_btile(cp);
  float* H = reinterpret_cast<float*>(at);        // a 128-column piece of y
  at += hw_ftile(128);
  bf16* ADJ = reinterpret_cast<bf16*>(at);        // [2][16, K16]
  at += 2 * hw_btile(p.K16);
  bf16* HB = reinterpret_cast<bf16*>(at);         // bf16(relu(m))
  const int b = blockIdx.x;
  const long base = (long)b * p.K;
  const RowLane rl = row_lane();
  bf16* yb = p.y + (long)b * p.K16 * ldy;

  for (int i0 = 0; i0 < p.K; i0 += HW_ROWS) {
    const int i = i0 + rl.r;
    const long row = base + i;
    load_rows(A2, lda2, p.att2, 2 * p.C, base + i0, base + p.K, 2 * p.C, c2p);
    __syncthreads();
    tile_mm<true>(Z, ldz, A2, lda2, p.wco, c2p, c2p, c2p, false);
    __syncthreads();
    for (int e = rl.l; e < 2 * p.C; e += 16)
      A2[rl.r * lda2 + e] = __float2bfloat16(Z[rl.r * ldz + e] + p.bco[e]);
    __syncthreads();
    tile_mm<true>(X, ldx, A2, lda2, p.wch, c2p, cp, c2p, false);
    __syncthreads();
    {
      float* v = X + rl.r * ldx;
      for (int e = rl.l; e < p.C; e += 16) {
        const float s = i < p.K ? p.x1[row * p.C + e] : 0.0f;
        v[e] = s + (v[e] + p.bch[e]);
      }
      row_layernorm(v, p.C, p.g2, p.be2, p.eps, rl.l);
      for (int e = rl.l; e < cp; e += 16) {
        A[rl.r * lda + e] = __float2bfloat16(e < p.C ? v[e] : 0.0f);
        if (e < p.C && i < p.K) p.x2[row * p.C + e] = v[e];
      }
    }
    __syncthreads();
    for (int n0 = 0; n0 < 2 * p.Fp; n0 += 128) {
      const int n = 2 * p.Fp - n0 < 128 ? 2 * p.Fp - n0 : 128;
      tile_mm<true>(H, hw_fld(128), A, lda, p.wg + (long)n0 * cp, cp, n, cp, false);
      __syncthreads();
      for (int e = rl.l; e < n; e += 16)      // rows past K: zeros for phase B
        yb[(long)i * ldy + n0 + e] =
            __float2bfloat16(i < p.K ? H[rl.r * hw_fld(128) + e] + p.bg[n0 + e] : 0.0f);
      __syncthreads();
    }
  }
  __syncthreads();   // the block's y and x2 rows are written: phase B reads them

  const long adj_base = (long)b * 2 * p.K * p.K;
  for (int i0 = 0; i0 < p.K; i0 += HW_ROWS) {
    const int i = i0 + rl.r;
    const long row = base + i;
    for (int e = threadIdx.x; e < 2 * HW_ROWS * p.K16; e += blockDim.x) {
      const int s = e / (HW_ROWS * p.K16), r = (e / p.K16) % HW_ROWS, j = e % p.K16;
      float a = 0.0f;
      if (i0 + r < p.K && j < p.K)
        a = ld_val(p.adj, p.adj_dt, adj_base + ((long)s * p.K + i0 + r) * p.K + j);
      ADJ[s * HW_ROWS * ldj + r * ldj + j] = __float2bfloat16(a);
    }
    __syncthreads();
    for (int j = 0; j < p.Fp / HW_CHUNK; ++j) {
      tile_mm<false>(X, hw_fld(HW_CHUNK), ADJ, ldj, yb + j * HW_CHUNK, ldy, HW_CHUNK, p.K16,
                     false);
      tile_mm<false>(X, hw_fld(HW_CHUNK), ADJ + HW_ROWS * ldj, ldj, yb + p.Fp + j * HW_CHUNK,
                     ldy, HW_CHUNK, p.K16, true);
      __syncthreads();
      for (int e = threadIdx.x; e < HW_ROWS * HW_CHUNK; e += blockDim.x) {
        const int r = e / HW_CHUNK, cc = e % HW_CHUNK;
        HB[r * hw_bld(HW_CHUNK) + cc] = __float2bfloat16(fmaxf(X[r * hw_fld(HW_CHUNK) + cc], 0.0f));
      }
      __syncthreads();
      tile_mm<true>(Z, ldx, HB, hw_bld(HW_CHUNK), p.wf + j * HW_CHUNK, p.Fp, cp, HW_CHUNK, j > 0);
      __syncthreads();
    }
    float* v = Z + rl.r * ldx;
    for (int e = rl.l; e < p.C; e += 16) {
      const float s = i < p.K ? p.x2[row * p.C + e] : 0.0f;
      v[e] = s + (v[e] + p.bf[e]);
    }
    row_layernorm(v, p.C, p.g3, p.be3, p.eps, rl.l);
    if (i < p.K)
      for (int e = rl.l; e < p.C; e += 16) st_val(p.out, p.out_dt, row * p.C + e, v[e]);
    __syncthreads();
  }
}

// ---- decoder stack, a layer's keypoint head: for h = x and h = bf16(LN(x))
// (the final norm), h = bf16(gelu(h . W_i^T + b_i)) for the three kpt_branch
// layers, dd = h . Wo^T + bo, and sigmoid(inverse_sigmoid(ct) + dd) into
// pts (from x) and outs (from the normed x), as ops/fused_decoder.py
// kpt_head_plain (exact-erf GELU, log-odds clipped at ieps).
struct KptWideArgs {
  const bf16 *x, *w0, *w1, *w2, *wo;
  const float *g, *be, *b0, *b1, *b2, *bo;
  const float* ct;
  float *pts, *outs;
  long R;
  int C, Cp;
  float eps, ieps;
};

__host__ __device__ constexpr long kpt_wide_smem(int cp) { return hw_btile(cp) + hw_ftile(cp); }

__global__ void __launch_bounds__(HW_THREADS) kpt_head_wide_kernel(KptWideArgs p) {
  extern __shared__ __align__(128) unsigned char hw_raw[];
  const int cp = p.Cp, lda = hw_bld(cp), ldz = hw_fld(cp);
  bf16* A = reinterpret_cast<bf16*>(hw_raw);
  float* Z = reinterpret_cast<float*>(hw_raw + hw_btile(cp));
  const long row0 = (long)blockIdx.x * HW_ROWS;
  const RowLane rl = row_lane();
  const long row = row0 + rl.r;
  const bf16* ws[3] = {p.w0, p.w1, p.w2};
  const float* bs[3] = {p.b0, p.b1, p.b2};

  for (int pass = 0; pass < 2; ++pass) {
    load_rows(A, lda, p.x, p.C, row0, p.R, p.C, cp);
    __syncthreads();
    if (pass) {
      float* v = Z + rl.r * ldz;
      for (int e = rl.l; e < p.C; e += 16) v[e] = __bfloat162float(A[rl.r * lda + e]);
      row_layernorm(v, p.C, p.g, p.be, p.eps, rl.l);
      for (int e = rl.l; e < p.C; e += 16) A[rl.r * lda + e] = __float2bfloat16(v[e]);
      __syncthreads();
    }
    for (int layer = 0; layer < 3; ++layer) {
      tile_mm<true>(Z, ldz, A, lda, ws[layer], cp, cp, cp, false);
      __syncthreads();
      for (int e = rl.l; e < p.C; e += 16) {
        const float z = Z[rl.r * ldz + e] + bs[layer][e];
        A[rl.r * lda + e] = __float2bfloat16(0.5f * z * (1.0f + erff(z * 0.7071067811865476f)));
      }
      __syncthreads();
    }
    float dd[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      float s = 0.0f;
      for (int e = rl.l; e < p.C; e += 16)
        s += __bfloat162float(A[rl.r * lda + e]) * __bfloat162float(p.wo[o * p.C + e]);
      dd[o] = hsum16(s) + p.bo[o];
    }
    if (row < p.R && rl.l < 2) {
      const float c = fminf(fmaxf(p.ct[2 * row + rl.l], 0.0f), 1.0f);
      const float inv = logf(fmaxf(c, p.ieps) / fmaxf(1.0f - c, p.ieps));
      const float z = inv + dd[rl.l];
      (pass ? p.outs : p.pts)[2 * row + rl.l] = 1.0f / (1.0f + expf(-z));
    }
    __syncthreads();
  }
}

// ---- decoder stack, the self-attention with its Markov bias at any head
// count H <= 16 and head dim D <= 128 (bias_attn_kernel takes 8 heads of
// 32): a warp a query row i of batch row b, lanes over keys (K <= 128, four
// a lane). The MLP's hidden units of (i, j) are formed once and give all H
// biases, kept in the warp's shared memory [H][128]; then per head the
// scores q.k^T * scale + key mask + bias, the fp32 softmax, p rounded to
// bf16 ([128] in shared memory), and out = bf16(p . v), lanes over the
// head's columns. As ops/fused_decoder.py bias_attention_plain.
struct BiasWideArgs {
  const bf16* qkv;
  const unsigned char* kvalid; long skvb;
  const bf16* hops;
  const float *w1, *b1, *w2, *b2;
  bf16* out;
  int B, N, H, D, nhop, hid;
  float scale;
};

#define BW_WARPS 8
#define BW_HOP_MAX 8
#define BW_HID_MAX 32
#define BW_HEADS_MAX 16
// per warp: the biases [H][128], the probabilities [128], the query [128]
__host__ __device__ constexpr long bias_wide_smem(int heads) {
  return 4L * (BW_HOP_MAX * BW_HID_MAX + BW_HID_MAX + BW_HID_MAX * BW_HEADS_MAX + BW_HEADS_MAX) +
         4L * BW_WARPS * (heads * HW_MAX_K + 2 * HW_MAX_K);
}

__global__ void __launch_bounds__(BW_WARPS * 32) bias_attn_wide_kernel(BiasWideArgs p) {
  extern __shared__ __align__(128) unsigned char hw_raw[];
  float* w1 = reinterpret_cast<float*>(hw_raw);
  float* b1 = w1 + BW_HOP_MAX * BW_HID_MAX;
  float* w2 = b1 + BW_HID_MAX;
  float* b2 = w2 + BW_HID_MAX * BW_HEADS_MAX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* bias = b2 + BW_HEADS_MAX + warp * (p.H * HW_MAX_K + 2 * HW_MAX_K);
  float* prob = bias + p.H * HW_MAX_K;
  float* qrow = prob + HW_MAX_K;
  for (int e = threadIdx.x; e < p.nhop * p.hid; e += blockDim.x) w1[e] = p.w1[e];
  for (int e = threadIdx.x; e < p.hid; e += blockDim.x) b1[e] = p.b1[e];
  for (int e = threadIdx.x; e < p.hid * p.H; e += blockDim.x) w2[e] = p.w2[e];
  for (int e = threadIdx.x; e < p.H; e += blockDim.x) b2[e] = p.b2[e];
  __syncthreads();
  const int b = blockIdx.x, i = blockIdx.y * BW_WARPS + warp;
  if (i >= p.N) return;
  const int C = p.H * p.D;
  const long C3 = 3L * C;
  const bf16* qkv_b = p.qkv + (long)b * p.N * C3;

  float kb[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = lane + 32 * u;
    kb[u] = -INFINITY;
    if (j < p.N) {
      kb[u] = p.kvalid == nullptr || p.kvalid[(long)b * p.skvb + j] ? 0.0f : -INFINITY;
      const bf16* hp = p.hops + (((long)b * p.N + i) * p.N + j) * p.nhop;
      float hv[BW_HOP_MAX];
#pragma unroll
      for (int n = 0; n < BW_HOP_MAX; ++n) hv[n] = n < p.nhop ? __bfloat162float(hp[n]) : 0.0f;
      float hid[BW_HID_MAX];
#pragma unroll
      for (int m = 0; m < BW_HID_MAX; ++m) {
        float s = 0.0f;
        if (m < p.hid) {
          s = b1[m];
#pragma unroll
          for (int n = 0; n < BW_HOP_MAX; ++n)
            if (n < p.nhop) s = fmaf(hv[n], w1[n * p.hid + m], s);
        }
        hid[m] = fmaxf(s, 0.0f);
      }
      for (int h = 0; h < p.H; ++h) {
        float s = b2[h];
#pragma unroll
        for (int m = 0; m < BW_HID_MAX; ++m)
          if (m < p.hid) s = fmaf(hid[m], w2[m * p.H + h], s);
        bias[h * HW_MAX_K + j] = s;
      }
    }
  }
  __syncwarp();

  for (int h = 0; h < p.H; ++h) {
    for (int d = lane; d < p.D; d += 32)
      qrow[d] = __bfloat162float(qkv_b[(long)i * C3 + h * p.D + d]);
    __syncwarp();
    float s[4];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = lane + 32 * u;
      s[u] = -INFINITY;
      if (j < p.N) {
        const bf16* kr = qkv_b + (long)j * C3 + C + h * p.D;
        float dot = 0.0f;
        for (int d = 0; d < p.D; ++d) dot = fmaf(qrow[d], __bfloat162float(kr[d]), dot);
        s[u] = (dot * p.scale + kb[u]) + bias[h * HW_MAX_K + j];
      }
      mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s[u] = mx == -INFINITY ? 0.0f : expf(s[u] - mx);
      sum += s[u];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float rs = sum > 0.0f ? 1.0f / sum : 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = lane + 32 * u;
      if (j < p.N) prob[j] = bfr(s[u] * rs);
    }
    __syncwarp();
    for (int d = lane; d < p.D; d += 32) {
      const bf16* vc = qkv_b + 2 * C + h * p.D + d;
      float o = 0.0f;
      for (int j = 0; j < p.N; ++j) o = fmaf(prob[j], __bfloat162float(vc[(long)j * C3]), o);
      p.out[((long)b * p.N + i) * C + h * p.D + d] = __float2bfloat16(o);
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------ entry points
// Each returns cudaGetLastError() after its launch, or cudaErrorInvalidValue
// for a shape it does not take.

extern "C" int ec_enc_post_wide(const void* att, const void* src, const void* wo,
                                const void* bo, const void* g1, const void* be1,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* g2, const void* be2, const void* pos, int n_tok,
                                void* out, int out_dt, void* nxt, long R, int C, int Cp, int Fp,
                                float eps, void* stream) {
  static bool configured = false;
  if (R <= 0 || C <= 0 || C > HW_MAX_C || Cp % 16 || Cp < C || Fp <= 0 || Fp % HW_CHUNK ||
      (!out && !nxt) || (nxt && (!pos || n_tok <= 0)) || !hw_aligned(wo) || !hw_aligned(w1) ||
      !hw_aligned(w2))
    return (int)cudaErrorInvalidValue;
  const long smem = enc_wide_smem(Cp);
  const int rc = hw_launch_check((const void*)enc_post_wide_kernel, smem, configured);
  if (rc) return rc;
  EncWideArgs p;
  p.att = static_cast<const bf16*>(att); p.src = static_cast<const bf16*>(src);
  p.wo = static_cast<const bf16*>(wo); p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2); p.pos = static_cast<const bf16*>(pos);
  p.bo = static_cast<const float*>(bo); p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1); p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2); p.g2 = static_cast<const float*>(g2);
  p.be2 = static_cast<const float*>(be2);
  p.out = out; p.out_dt = out_dt; p.nxt = static_cast<bf16*>(nxt);
  p.R = R; p.C = C; p.Cp = Cp; p.Fp = Fp; p.n_tok = n_tok; p.eps = eps;
  enc_post_wide_kernel<<<(unsigned)((R + HW_ROWS - 1) / HW_ROWS), HW_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ec_dec_post_self_wide(const void* att, const void* xb, const void* qpos,
                                     const void* wso, const void* bso, const void* g1,
                                     const void* be1, const void* wcqx, const void* wcqp,
                                     const void* bcq, void* x1, void* q2, long R, int C,
                                     int Cp, int C2p, float eps, void* stream) {
  static bool configured = false;
  if (R <= 0 || C <= 0 || C > HW_MAX_C || Cp % 16 || Cp < C || C2p % 16 || C2p < 2 * C ||
      !hw_aligned(wso) || !hw_aligned(wcqx) || !hw_aligned(wcqp))
    return (int)cudaErrorInvalidValue;
  const long smem = dec_self_wide_smem(Cp, C2p);
  const int rc = hw_launch_check((const void*)dec_post_self_wide_kernel, smem, configured);
  if (rc) return rc;
  DecSelfWideArgs p;
  p.att = static_cast<const bf16*>(att); p.xb = static_cast<const bf16*>(xb);
  p.qpos = static_cast<const bf16*>(qpos); p.wso = static_cast<const bf16*>(wso);
  p.wcqx = static_cast<const bf16*>(wcqx); p.wcqp = static_cast<const bf16*>(wcqp);
  p.bso = static_cast<const float*>(bso); p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1); p.bcq = static_cast<const float*>(bcq);
  p.x1 = static_cast<float*>(x1); p.q2 = static_cast<bf16*>(q2);
  p.R = R; p.C = C; p.Cp = Cp; p.C2p = C2p; p.eps = eps;
  dec_post_self_wide_kernel<<<(unsigned)((R + HW_ROWS - 1) / HW_ROWS), HW_THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ec_dec_post_cross_wide(const void* att2, const void* wco, const void* bco,
                                      const void* wch, const void* bch, const void* x1,
                                      const void* g2, const void* be2, const void* wg,
                                      const void* bg, const void* adj, int adj_dt,
                                      const void* wf, const void* bf, const void* g3,
                                      const void* be3, void* x2, void* y, void* out,
                                      int out_dt, int B, int K, int C, int Cp, int C2p, int Fp,
                                      float eps, void* stream) {
  static bool configured = false;
  const int k16 = (K + 15) / 16 * 16;
  if (B <= 0 || K <= 0 || K > HW_MAX_K || C <= 0 || C > HW_MAX_C || Cp % 16 || Cp < C ||
      C2p % 16 || C2p < 2 * C || Fp <= 0 || Fp % HW_CHUNK || !hw_aligned(wco) ||
      !hw_aligned(wch) || !hw_aligned(wg) || !hw_aligned(wf) || !hw_aligned(y))
    return (int)cudaErrorInvalidValue;
  const long smem = dec_cross_wide_smem(Cp, C2p, k16);
  const int rc = hw_launch_check((const void*)dec_post_cross_wide_kernel, smem, configured);
  if (rc) return rc;
  DecCrossWideArgs p;
  p.att2 = static_cast<const bf16*>(att2); p.wco = static_cast<const bf16*>(wco);
  p.wch = static_cast<const bf16*>(wch); p.wg = static_cast<const bf16*>(wg);
  p.wf = static_cast<const bf16*>(wf);
  p.bco = static_cast<const float*>(bco); p.bch = static_cast<const float*>(bch);
  p.g2 = static_cast<const float*>(g2); p.be2 = static_cast<const float*>(be2);
  p.bg = static_cast<const float*>(bg); p.bf = static_cast<const float*>(bf);
  p.g3 = static_cast<const float*>(g3); p.be3 = static_cast<const float*>(be3);
  p.x1 = static_cast<const float*>(x1);
  p.adj = adj; p.adj_dt = adj_dt;
  p.x2 = static_cast<float*>(x2); p.y = static_cast<bf16*>(y);
  p.out = out; p.out_dt = out_dt;
  p.B = B; p.K = K; p.K16 = k16; p.C = C; p.Cp = Cp; p.C2p = C2p; p.Fp = Fp; p.eps = eps;
  dec_post_cross_wide_kernel<<<(unsigned)B, HW_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ec_kpt_head_wide(const void* x, const void* g, const void* be, const void* w0,
                                const void* b0, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* wo, const void* bo, const void* ct,
                                void* pts, void* outs, long R, int C, int Cp, float eps,
                                float ieps, void* stream) {
  static bool configured = false;
  if (R <= 0 || C <= 0 || C > HW_MAX_C || Cp % 16 || Cp < C || !hw_aligned(w0) ||
      !hw_aligned(w1) || !hw_aligned(w2))
    return (int)cudaErrorInvalidValue;
  const long smem = kpt_wide_smem(Cp);
  const int rc = hw_launch_check((const void*)kpt_head_wide_kernel, smem, configured);
  if (rc) return rc;
  KptWideArgs p;
  p.x = static_cast<const bf16*>(x);
  p.w0 = static_cast<const bf16*>(w0); p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2); p.wo = static_cast<const bf16*>(wo);
  p.g = static_cast<const float*>(g); p.be = static_cast<const float*>(be);
  p.b0 = static_cast<const float*>(b0); p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2); p.bo = static_cast<const float*>(bo);
  p.ct = static_cast<const float*>(ct);
  p.pts = static_cast<float*>(pts); p.outs = static_cast<float*>(outs);
  p.R = R; p.C = C; p.Cp = Cp; p.eps = eps; p.ieps = ieps;
  kpt_head_wide_kernel<<<(unsigned)((R + HW_ROWS - 1) / HW_ROWS), HW_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ec_bias_attention_wide(const void* qkv, int B, int N, int H, int D,
                                      const void* kvalid, long skvb, const void* hops, int nhop,
                                      int hid, const void* w1, const void* b1, const void* w2,
                                      const void* b2, float scale, void* out, void* stream) {
  static bool configured = false;
  if (B <= 0 || N <= 0 || N > HW_MAX_K || H <= 0 || H > BW_HEADS_MAX || D <= 0 || D > 128 ||
      nhop <= 0 || nhop > BW_HOP_MAX || hid <= 0 || hid > BW_HID_MAX || B > 2147483647)
    return (int)cudaErrorInvalidValue;
  const long smem = bias_wide_smem(H);
  const int rc = hw_launch_check((const void*)bias_attn_wide_kernel, smem, configured);
  if (rc) return rc;
  BiasWideArgs p;
  p.qkv = static_cast<const bf16*>(qkv);
  p.kvalid = static_cast<const unsigned char*>(kvalid); p.skvb = skvb;
  p.hops = static_cast<const bf16*>(hops);
  p.w1 = static_cast<const float*>(w1); p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2); p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.N = N; p.H = H; p.D = D; p.nhop = nhop; p.hid = hid; p.scale = scale;
  bias_attn_wide_kernel<<<dim3((unsigned)B, (unsigned)((N + BW_WARPS - 1) / BW_WARPS)),
                          BW_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
