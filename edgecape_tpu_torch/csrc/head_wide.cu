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
// assume the width.
//
// enc_post_wide_kernel (the joint encoder after its attention). Bound: at
// [21360 rows, C 512], F 1024 a layer is 56 GFLOP of products (0.057 ms
// at 989 TFLOP/s) against 66-88 MB of activations; each row tile reads
// all of Wo, W1 and W2 (2.6 MB at that width), so what feeds the tensor
// cores is L2. Design, enc_post_kernel's (kernels.cu) split by columns:
//   * a persistent grid (one block an SM) of tiles of 64 rows; 384
//     threads: a producer warpgroup (one thread issues every TMA copy,
//     setmaxnreg 40) and two consumer warpgroups (232), each holding the
//     tile's 64 rows times its half of the channels, NH = C / 2 rounded up
//     to 64 (64, 128, 192 or 256 columns: one instance each), in an m64 x
//     NH fp32 wgmma accumulator, 128 registers a thread at C = 512;
//   * the tile's att rows arrive by cp.async, each warpgroup its columns,
//     in 128-byte-swizzled boxes of [64 rows x 64] bf16 (the next tile's
//     under this tile's last products); both warpgroups multiply all of
//     them, each by its NH rows of Wo;
//   * Wo, W1 and W2 stream by TMA through one ring a warpgroup of slots
//     of NH x 128 bytes (as many as fit: 2 at C = 512, 5 at 200, 8 below
//     129), a load unit a slot, in the same order for every tile (so L2
//     serves them): a k slab of Wo [NH x 64], NH / 64 k slabs of the
//     warpgroup's 64 rows of a W1 chunk, a hidden slab of W2 [NH x 64];
//     every unit carries 64 x NH x 64 multiply-adds. The weights are
//     padded with zero rows and columns to 2 NH channels and the hidden to
//     whole chunks (ops/kernels.py post_plan enc_c_pad / enc_f_pad), so
//     every box lies inside them and the padding adds exact zeros; att's
//     columns past C load as zeros, and LayerNorm, biases and stores run
//     over the true C alone;
//   * a row's LayerNorm sums: the thread's columns in order, the quad by
//     shuffles, then warpgroup 0's part plus warpgroup 1's through shared
//     memory, the same order for every row; bf16(x) is written whole into
//     the x boxes and each 128-column hidden chunk (64 columns a
//     warpgroup, bias and ReLU applied) into two boxes of one of two
//     buffers, each followed by a proxy fence and a barrier of both
//     warpgroups, whose products read them as their A operand (with two
//     buffers, one barrier a chunk);
//   * the FFN's second product accumulates onto the LayerNorm output x
//     that its residual adds, as enc_post_kernel does: y = LN2((x + sum_j
//     h_j . W2_j^T) + b2), where the plain version forms x + (h . W2^T +
//     b2) (one fp32 summation point moved; 128 registers saved).
// A row's bits do not depend on its place in the batch: every element sums
// its k slabs in one order.
//
// bias_attn_wide_kernel (the decoder stack's Markov-biased
// self-attention). Bound: at [60, K 100, 8 heads of 64] a call moves 30
// MB (0.009 ms) and does 1.2 GFLOP of products and 0.2 GFLOP of fp32 MLP;
// its time is latency: the bias MLP, the K / V copy and the products.
// Design, bias_attn_kernel's (kernels.cu) for any head count and dim:
//   * a block (256 threads) takes a batch row and a run of 16-query
//     tiles; per tile a thread takes (query, 4 keys), forms the MLP's
//     hidden units once (b1, the hop terms ascending, ReLU, then b2 and
//     the hidden terms ascending, fp32 multiply-adds) and writes every
//     head's bias into shared memory [H][16][nkp];
//   * K, V and the tile's queries of a head lie in a slot of shared
//     memory, the head dim padded to 32, 64 or 128 with zeros
//     (ops/kernels.py attention_head_dim), loaded by cp.async (element
//     loads where a head's columns are not 16-byte aligned) under the
//     bias MLP. Where every head's slot fits beside the bias (`resident`)
//     K and V arrive once a block, which takes a run of tiles, only the
//     queries following a tile, and the 8 warps take the heads in turn.
//     Otherwise a block takes one tile and the heads run in passes of up
//     to 8 (one a warp), each pass's slot holding K, then V: every warp
//     forms its head's scores and softmax, the probabilities stay in its
//     registers while V is copied over K, then P.V; so K and V are read
//     once a block either way, and all 8 warps work at 8 heads;
//   * a warp's head: q.k^T and P.V on mma.sync m16n8k16 from ldmatrix
//     fragments (attention.cuh attn_scores / attn_pv), the scores, softmax
//     (2^x) and P (rounded to bf16) in registers, the output staged
//     through the head's query rows.
//
// dec_post_self_wide_kernel, dec_post_cross_wide_kernel and
// kpt_head_wide_kernel are simple and right at every width, not fast:
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
// What bounds them: each 16-row tile reads every weight of its op from L2,
// so they run at L2's rate, far above the bytes and operations the work
// needs. Their times are in PERF.md.

#include <cuda.h>
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

// The producer warpgroup's registers to the consumers: 128 (168 - 40) =
// 256 (232 - 168) from the launch's 168 a thread.
__device__ __forceinline__ void regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// ---- joint encoder: enc_post_wide_kernel (the design: this file's
// header). x = LN1(src + (att . Wo^T + bo)); y = LN2((x + sum_j h_j .
// W2_j^T) + b2), h_j = bf16(relu(bf16(x) . W1_j^T + b1_j)) over the hidden
// chunks j of EW_CHUNK columns; y in the tokens' type and / or the next
// layer's src = bf16(bf16(y) + pos[row % n_tok]).
struct EncWideArgs {
  const bf16 *att, *src, *pos;
  const float *bo, *g1, *be1, *b1, *b2, *g2, *be2;
  void* out; int out_dt;
  bf16* nxt;
  long R;
  int C, Fp, n_tok;
  float eps;
};

#define EW_ROWS 64            // rows of a tile
#define EW_THREADS 384        // the producer warpgroup + two consumer warpgroups
#define EW_CHUNK 128          // hidden columns a chunk, 64 a consumer warpgroup
#define EW_BOX 8192           // a swizzled [64 rows x 64] bf16 box
#define EW_MAX_SLOTS 8        // slots of a warpgroup's ring at most

// Shared memory at half width nh (the channels a consumer warpgroup holds,
// 64, 128, 192 or 256): alignment slack, the x tile ([64 rows x 2 nh] bf16
// in nh / 32 boxes), two buffers of a hidden chunk (two boxes each: chunk
// j in buffer j % 2), the LayerNorm's partial
// row sums ([sum, squares][warpgroup][64 rows] fp32), then each
// warpgroup's ring of slots of nh x 128 bytes (as many as fit, at most
// EW_MAX_SLOTS) and a full and an empty barrier a slot.
__host__ __device__ constexpr int ew_fixed(int nh) {
  return 1024 + nh * 256 + 4 * EW_BOX + 4 * 2 * 2 * EW_ROWS;
}
__host__ __device__ constexpr int ew_slots(int nh) {
  return (HW_SMEM_LIMIT - ew_fixed(nh)) / (2 * (nh * 128 + 16)) < EW_MAX_SLOTS
             ? (HW_SMEM_LIMIT - ew_fixed(nh)) / (2 * (nh * 128 + 16))
             : EW_MAX_SLOTS;
}
__host__ __device__ constexpr int ew_smem(int nh) {
  return ew_fixed(nh) + 2 * ew_slots(nh) * (nh * 128 + 16);
}
static_assert(ew_slots(256) >= 2 && ew_smem(256) <= HW_SMEM_LIMIT && ew_smem(64) <= HW_SMEM_LIMIT,
              "enc_post_wide_kernel's ring does not fit a block");

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

template <int NH>
__global__ void __launch_bounds__(EW_THREADS, 1)
    enc_post_wide_kernel(const __grid_constant__ CUtensorMap map_wo,
                         const __grid_constant__ CUtensorMap map_w1,
                         const __grid_constant__ CUtensorMap map_w2, EncWideArgs p) {
  constexpr int S = ew_slots(NH), SLOT = NH * 128;
  constexpr int KS = NH / 32;        // 64-column k slabs of the tile's 2 NH channels
  constexpr int KU = NH / 64;        // k slabs of W1 a load unit
  extern __shared__ unsigned char hw_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(hw_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* hs = xs + NH * 256;
  float* red = reinterpret_cast<float*>(hs + 4 * EW_BOX);
  unsigned char* ring_at = reinterpret_cast<unsigned char*>(red + 4 * EW_ROWS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_at + 2 * S * SLOT);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * S; ++s) {
      mbar_init(&bars[2 * S * (s / S) + s % S], 1);        // full
      mbar_init(&bars[2 * S * (s / S) + S + s % S], 4);    // empty: a warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (int)((p.R + EW_ROWS - 1) / EW_ROWS);
  const int chunks = p.Fp / EW_CHUNK;

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      // every tile's load units in the order the warpgroups take them, the
      // two warpgroups' units of a step in turn
      EwRing<S, SLOT> ring[2];
      ring[0].place(ring_at, bars);
      ring[1].place(ring_at + S * SLOT, bars + 2 * S);
      uint64_t* bar;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int ks = 0; ks < KS; ++ks)
          for (int w = 0; w < 2; ++w) {
            unsigned char* d = ring[w].arm(SLOT, bar);
            tma_load_3d(d, &map_wo, bar, 64 * ks, w * NH, 0);
          }
        for (int j = 0; j < chunks; ++j) {
          for (int u = 0; u < 2; ++u)
            for (int w = 0; w < 2; ++w) {
              unsigned char* d = ring[w].arm(SLOT, bar);
              for (int i = 0; i < KU; ++i)
                tma_load_3d(d + i * EW_BOX, &map_w1, bar, 64 * (u * KU + i),
                            EW_CHUNK * j + 64 * w, 0);
            }
          for (int kh = 0; kh < 2; ++kh)
            for (int w = 0; w < 2; ++w) {
              unsigned char* d = ring[w].arm(SLOT, bar);
              tma_load_3d(d, &map_w2, bar, EW_CHUNK * j + 64 * kh, w * NH, 0);
            }
        }
      }
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1, ct = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = (ct >> 5) * 16 + (lane >> 2);      // tile rows row, row + 8
  const int C = p.C;
  EwRing<S, SLOT> ring;
  ring.place(ring_at + wg * S * SLOT, bars + wg * 2 * S);
  const unsigned xa = smem_u32(xs), ha = smem_u32(hs);
  ew_load_att<NH>(xs, p.att, (long)blockIdx.x * EW_ROWS, p.R, C, wg, ct);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long r0 = (long)tile * EW_ROWS + row, r1 = r0 + 8;
    const long s0 = r0 < p.R ? r0 : p.R - 1, s1 = r1 < p.R ? r1 : p.R - 1;
    ew_prefetch<NH>(p.src, s0, C, wg * NH, t);
    ew_prefetch<NH>(p.src, s1, C, wg * NH, t);
    if (p.nxt) {
      ew_prefetch<NH>(p.pos, s0 % p.n_tok, C, wg * NH, t);
      ew_prefetch<NH>(p.pos, s1 % p.n_tok, C, wg * NH, t);
    }
    cp_async_wait<0>();
    fence_view_async();
    bar_consumers();                 // the tile's att rows are in the x boxes

    // a = att . Wo^T: unit ks holds k slab ks of this warpgroup's NH rows of Wo
    float x[NH / 2];
    acc_zero(x);
    reg_fence(x);
    for (int ks = 0; ks < KS; ++ks) {
      const unsigned b = ring.next();
      ew_mma<NH>(x, xa + ks * EW_BOX, b);
      ring.issued(lane, ks == 0);
    }
    ring.drain(lane);
    reg_fence(x);

    // x = LN1(src + (a + bo)); rows past R read row R - 1 and are not stored
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
      const int c = wg * NH + 8 * j + 2 * t;
      const float2 bo = ew_ld2(p.bo, c, C);
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const float2 sv = ew_ld2(p.src + (rh ? s1 : s0) * C, c, C);
        float& v0 = x[4 * j + 2 * rh];
        float& v1 = x[4 * j + 2 * rh + 1];
        v0 = c < C ? sv.x + (v0 + bo.x) : 0.0f;
        v1 = c + 1 < C ? sv.y + (v1 + bo.y) : 0.0f;
      }
    }
    ew_layernorm<NH>(x, red, p.g1, p.be1, C, p.eps, wg, row, t);
    // bf16(x) over this warpgroup's columns of the x boxes: both
    // warpgroups' products of att are complete (the LayerNorm's barriers)
#pragma unroll
    for (int j = 0; j < NH / 8; ++j)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        *reinterpret_cast<unsigned*>(xs + ew_off(row + 8 * rh, wg * NH + 8 * j + 2 * t)) =
            pack_bf16(x[4 * j + 2 * rh], x[4 * j + 2 * rh + 1]);
    fence_view_async();
    bar_consumers();

    for (int j = 0; j < chunks; ++j) {
      // this warpgroup's 64 columns of the chunk: bf16(x) . W1^T, two units
      // of KU k slabs each
      float f[32];
      acc_zero(f);
      reg_fence(f);
      for (int u = 0; u < 2; ++u) {
        const unsigned b = ring.next();
#pragma unroll
        for (int i = 0; i < KU; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16<0>(f, wg_desc(xa + (u * KU + i) * EW_BOX + kk * 32, 16),
                               wg_desc(b + i * EW_BOX + kk * 32, 16));
        ring.issued(lane, u == 0);
      }
      ring.drain(lane);
      reg_fence(f);
      if (j == chunks - 1) {
        bar_consumers();             // both warpgroups' products of the x boxes are done
        if (tile + (int)gridDim.x < tiles) {
          ew_load_att<NH>(xs, p.att, (long)(tile + gridDim.x) * EW_ROWS, p.R, C, wg, ct);
          cp_async_commit();         // the next tile's att, under this one's end
        }
      }
      // chunk j's hidden into buffer j % 2: the other warpgroup read that
      // buffer (chunk j - 2) before the barrier of chunk j - 1 below
      unsigned char* hb = hs + (j & 1) * 2 * EW_BOX;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int hc = EW_CHUNK * j + 64 * wg + 8 * jj + 2 * t;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b1 + hc));
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          *reinterpret_cast<unsigned*>(hb + wg * EW_BOX + ew_off(row + 8 * rh, 8 * jj + 2 * t)) =
              pack_bf16(fmaxf(f[4 * jj + 2 * rh] + bb.x, 0.0f),
                        fmaxf(f[4 * jj + 2 * rh + 1] + bb.y, 0.0f));
      }
      fence_view_async();
      bar_consumers();               // the chunk's hidden is whole
      reg_fence(x);
      // x += h . W2^T: unit kh holds hidden k slab kh of this warpgroup's NH rows of W2
      for (int kh = 0; kh < 2; ++kh) {
        const unsigned b = ring.next();
        ew_mma<NH>(x, ha + (j & 1) * 2 * EW_BOX + kh * EW_BOX, b);
        ring.issued(lane, kh == 0);
      }
      ring.drain(lane);
      reg_fence(x);
    }

    // y = LN2(x + b2)
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
      const float2 b2 = ew_ld2(p.b2, wg * NH + 8 * j + 2 * t, C);
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        x[4 * j + 2 * rh] += b2.x;
        x[4 * j + 2 * rh + 1] += b2.y;
      }
    }
    ew_layernorm<NH>(x, red, p.g2, p.be2, C, p.eps, wg, row, t);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const long r = rh ? r1 : r0;
      if (r >= p.R) continue;
      const bf16* pr = p.nxt ? p.pos + (r % p.n_tok) * C : nullptr;
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const int c = wg * NH + 8 * j + 2 * t;
        if (c >= C) continue;
        const float a = x[4 * j + 2 * rh], b = x[4 * j + 2 * rh + 1];
        if (p.out) ew_st2(p.out, p.out_dt, r * C + c, a, b, c, C);
        if (p.nxt) {
          const float2 pv = ew_ld2(pr, c, C);
          ew_st2(p.nxt, DT_BF16, r * C + c, bfr(a) + pv.x, bfr(b) + pv.y, c, C);
        }
      }
    }
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

// ---- decoder stack: bias_attn_wide_kernel (the design: this file's
// header), the self-attention with its Markov bias at H <= 16 heads of
// head dim D <= 128 (run at DP = 32, 64 or 128), K <= 128 keypoints:
//   bias[h, i, j] = b2[h] + sum_m relu(b1[m] + sum_n hops[b, i, j, n]
//                   w1[n, m]) w2[m, h],
//   out[b, i, D h:D h + D] = bf16(bf16(softmax(q.k^T * scale + key mask
//                   + bias)) . v), as ops/fused_decoder.py
//                   bias_attention_plain.
struct BiasWideArgs {
  const bf16* qkv;
  const unsigned char* kvalid; long skvb;
  const bf16* hops;
  const float *w1, *b1, *w2, *b2;
  bf16* out;
  int N, H, D, NK16, nhop, hid;
  int tiles_per_block, per_pass, resident;
  float scale;
};

#define BW_THREADS 256        // 8 warps
#define BW_WARPS 8
#define BW_HOP_MAX 8
#define BW_HID_MAX 32
#define BW_HEADS_MAX 16
// w1 [hid][8] | w2 [hid][16] | b1 [hid] | b2 [16], zero past nhop, hid, H
#define BW_MLP_FLOATS (BW_HID_MAX * 8 + BW_HID_MAX * BW_HEADS_MAX + BW_HID_MAX + BW_HEADS_MAX)

// A head's slot, bf16 rows of dp + 8 (padded by 16 bytes against
// ldmatrix's bank conflicts): resident, K [nkp] | V [nkp] | the tile's
// queries [16]; in passes, K then (over it) V [nkp] | the queries [16].
__host__ __device__ constexpr long bw_slot(int nkp, int dp, int resident) {
  return ((resident ? 2L : 1L) * nkp + 16) * (dp + 8) * 2;
}
// per_pass slots, the bias of a 16-query tile for every head [heads][16]
// [nkp] fp32, the additive key mask, the MLP.
__host__ __device__ constexpr long bw_smem(int heads, int nkp, int dp, int per_pass,
                                           int resident) {
  return per_pass * bw_slot(nkp, dp, resident) + 4L * heads * 16 * nkp + 4L * nkp +
         4L * BW_MLP_FLOATS;
}

// The hop values of keys k0 .. k0 + 3 of one query row (src: the first of
// them, nhop planes a key), as hv[plane][key]; 0 past n keys or nhop
// planes. vec: NHOP == nhop and the run of 8 x NHOP bytes is aligned.
template <int NHOP>
__device__ __forceinline__ void bw_load_hops(const bf16* src, int k0, int n, int nhop, bool vec,
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

// The bias of the 16-query tile from q0 for every head (HB: the heads
// rounded up to 8 or 16) into bs [H][16][nkp], the MLP's hidden layer
// once per (query, key), summed as bias_attn_kernel does: a thread takes
// (query, 4 keys).
template <int NHOP, int HB>
__device__ __forceinline__ void bw_bias(float* bs, const float* w1s, const float* w2s,
                                        const float* b1s, const float* b2s,
                                        const BiasWideArgs& p, long b, int q0, bool hvec) {
  const int NKP = p.NK16 * 16, nq4 = NKP / 4;
  for (int i = threadIdx.x; i < 16 * nq4; i += BW_THREADS) {
    const int rr = i / nq4, k0 = 4 * (i % nq4), q = q0 + rr;
    float acc[HB][4];
#pragma unroll
    for (int h = 0; h < HB; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] = b2s[h];
    if (q < p.N && k0 < p.N) {
      float hv[NHOP][4];
      bw_load_hops<NHOP>(p.hops + ((b * p.N + q) * (long)p.N + k0) * p.nhop, k0, p.N, p.nhop,
                         hvec, hv);
      for (int m = 0; m < p.hid; ++m) {
        float w1m[8], w2m[HB];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float4 w = *reinterpret_cast<const float4*>(w1s + 8 * m + 4 * v);
          w1m[4 * v] = w.x; w1m[4 * v + 1] = w.y; w1m[4 * v + 2] = w.z; w1m[4 * v + 3] = w.w;
        }
#pragma unroll
        for (int v = 0; v < HB / 4; ++v) {
          const float4 w = *reinterpret_cast<const float4*>(w2s + BW_HEADS_MAX * m + 4 * v);
          w2m[4 * v] = w.x; w2m[4 * v + 1] = w.y; w2m[4 * v + 2] = w.z; w2m[4 * v + 3] = w.w;
        }
        const float b1m = b1s[m];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float hsum = b1m;
#pragma unroll
          for (int j = 0; j < NHOP; ++j) hsum = fmaf(hv[j][e], w1m[j], hsum);
          hsum = fmaxf(hsum, 0.0f);
#pragma unroll
          for (int h = 0; h < HB; ++h) acc[h][e] = fmaf(hsum, w2m[h], acc[h][e]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HB; ++h)
      if (h < p.H)
        *reinterpret_cast<float4*>(bs + ((size_t)h * 16 + rr) * NKP + k0) =
            make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
}

// Token rows [src0, src0 + n) of the q (off 0), k (C) or v (2 C) columns of
// heads [h0, h0 + gn) into rows [dst, dst + n) of their consecutive slots
// from `at`: 16-byte cp.async where a row's 8 values are whole and
// aligned (D a multiple of 8), else element loads; zeros past D and N.
template <int DP>
__device__ __forceinline__ void bw_rows(unsigned char* at, long slot, const bf16* qkv,
                                        const BiasWideArgs& p, int h0, int gn, int dst, int n,
                                        int src0, int off) {
  constexpr int KLD = DP + 8, D8 = DP / 8;
  const long C3 = 3L * p.H * p.D;
  for (int i = threadIdx.x; i < gn * n * D8; i += BW_THREADS) {
    const int hl = i / (n * D8), r = (i / D8) % n, d8 = (i % D8) * 8, row = src0 + r;
    const int valid = row < p.N ? (p.D - d8 >= 8 ? 8 : p.D - d8 > 0 ? p.D - d8 : 0) : 0;
    copy8(reinterpret_cast<bf16*>(at + hl * slot) + (dst + r) * KLD + d8,
          qkv + (long)row * C3 + off + (long)(h0 + hl) * p.D + d8, valid);
  }
}

// One warp, one head of the 16-query tile from q0: the finished scores
// on mma.sync from ldmatrix fragments of the queries Qs and keys Ks
// (shared memory), with the key mask and the bias rows `brows` [16][nkp];
// the softmax in registers, s left holding the probabilities.
template <int DP>
__device__ __forceinline__ void bw_scores(float (&s)[2 * ATT_ROW16][4], const bf16* Qs,
                                          const bf16* Ks, const float* brows, const float* kbs,
                                          const BiasWideArgs& p, const AttnArgs& a, int q0,
                                          int lane) {
  constexpr int KLD = DP + 8, NT = 2 * ATT_ROW16;
  const int NKP = p.NK16 * 16, g = lane >> 2;
  unsigned qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldsm_x4(Qs + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * KLD + kk * 16 + (lane >> 4) * 8,
            qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
  AttnRows rw;
  rw.brow[0] = q0 + g < p.N ? brows + (size_t)g * NKP : nullptr;
  rw.brow[1] = q0 + g + 8 < p.N ? brows + (size_t)(g + 8) * NKP : nullptr;
  rw.bias_vec = true;             // every bias row holds nkp values
  attn_scores<DP, NT>(s, qa, Ks, kbs, 0, NKP, a, rw, lane);
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
}

// The same warp: out = P . V (P rounded to bf16, V from shared memory by
// ldmatrix), rounded to bf16, staged through the head's query rows Qs and
// stored to columns [D h, D h + D) of the tile's rows of out_b [N, C].
template <int DP>
__device__ __forceinline__ void bw_pv(const float (&s)[2 * ATT_ROW16][4], const bf16* Vs,
                                      bf16* Qs, const BiasWideArgs& p, bf16* out_b, int h,
                                      int q0, int lane) {
  constexpr int KLD = DP + 8, NT = 2 * ATT_ROW16;
  const int C = p.H * p.D, g = lane >> 2, t = lane & 3;
  float o[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  attn_pv<DP, NT>(o, s, Vs, 0, p.NK16, lane);
  __syncwarp();                   // every lane has read its queries
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    *reinterpret_cast<unsigned*>(&Qs[g * KLD + dt * 8 + 2 * t]) = pack_bf16(o[dt][0], o[dt][1]);
    *reinterpret_cast<unsigned*>(&Qs[(g + 8) * KLD + dt * 8 + 2 * t]) =
        pack_bf16(o[dt][2], o[dt][3]);
  }
  __syncwarp();
  bf16* out = out_b + (long)h * p.D;
  if (!(p.D & 7) && !(reinterpret_cast<uintptr_t>(out_b) & 15)) {   // C is then a multiple of 8
    const int d8n = p.D / 8;
    for (int c = lane; c < 16 * d8n; c += 32) {
      const int rr = c / d8n, d8 = (c % d8n) * 8;
      if (q0 + rr < p.N)
        *reinterpret_cast<uint4*>(out + (long)(q0 + rr) * C + d8) =
            *reinterpret_cast<const uint4*>(&Qs[rr * KLD + d8]);
    }
  } else {
    for (int c = lane; c < 16 * p.D; c += 32) {
      const int rr = c / p.D, d = c % p.D;
      if (q0 + rr < p.N) out[(long)(q0 + rr) * C + d] = Qs[rr * KLD + d];
    }
  }
  __syncwarp();
}

template <int DP, int NHOP>
__global__ void __launch_bounds__(BW_THREADS, 1) bias_attn_wide_kernel(BiasWideArgs p) {
  constexpr int KLD = DP + 8;
  extern __shared__ __align__(128) unsigned char hw_raw[];
  const int NKP = p.NK16 * 16, H = p.H, G = p.per_pass, C = H * p.D;
  const bool res = p.resident != 0;
  const long slot = bw_slot(NKP, DP, p.resident);
  const int vrow = res ? NKP : 0, qrow = res ? 2 * NKP : NKP;
  unsigned char* slots = hw_raw;
  float* bs = reinterpret_cast<float*>(hw_raw + G * slot);
  float* kbs = bs + (size_t)H * 16 * NKP;
  float* w1s = kbs + NKP;
  float* w2s = w1s + BW_HID_MAX * 8;
  float* b1s = w2s + BW_HID_MAX * BW_HEADS_MAX;
  float* b2s = b1s + BW_HID_MAX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long b = blockIdx.x;
  const bf16* qkv = p.qkv + b * p.N * 3L * C;
  bf16* out_b = p.out + b * p.N * (long)C;

  for (int i = threadIdx.x; i < BW_HID_MAX * 8; i += BW_THREADS) {
    const int m = i >> 3, j = i & 7;
    w1s[i] = m < p.hid && j < p.nhop ? p.w1[j * p.hid + m] : 0.0f;
  }
  for (int i = threadIdx.x; i < BW_HID_MAX * BW_HEADS_MAX; i += BW_THREADS) {
    const int m = i >> 4, h = i & 15;
    w2s[i] = m < p.hid && h < H ? p.w2[m * H + h] : 0.0f;
  }
  for (int i = threadIdx.x; i < BW_HID_MAX; i += BW_THREADS) b1s[i] = i < p.hid ? p.b1[i] : 0.0f;
  if (threadIdx.x < BW_HEADS_MAX) b2s[threadIdx.x] = threadIdx.x < H ? p.b2[threadIdx.x] : 0.0f;
  for (int j = threadIdx.x; j < NKP; j += BW_THREADS) {
    const bool on = j < p.N && (p.kvalid == nullptr || p.kvalid[b * p.skvb + j] != 0);
    kbs[j] = on ? 0.0f : -INFINITY;
  }
  __syncthreads();

  AttnArgs a = {};
  a.scale = p.scale;
  a.Nk = p.N;
  const int tiles = (p.N + 15) / 16, passes = (H + G - 1) / G;
  const int t0 = blockIdx.y * p.tiles_per_block;
  const int t_end = min(tiles, t0 + p.tiles_per_block);
  const bool hvec = p.nhop == NHOP && p.N % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(p.hops) & 7) == 0;
  for (int tile = t0; tile < t_end; ++tile) {
    const int q0 = tile * 16;
    if (res && tile == t0) {         // every head's K and V, once a block
      bw_rows<DP>(slots, slot, qkv, p, 0, H, 0, NKP, 0, C);
      bw_rows<DP>(slots, slot, qkv, p, 0, H, vrow, NKP, 0, 2 * C);
    } else if (!res) {               // the first pass's K
      bw_rows<DP>(slots, slot, qkv, p, 0, min(G, H), 0, NKP, 0, C);
    }
    bw_rows<DP>(slots, slot, qkv, p, 0, min(G, H), qrow, 16, q0, 0);
    cp_async_commit();

    if (H <= 8) bw_bias<NHOP, 8>(bs, w1s, w2s, b1s, b2s, p, b, q0, hvec);
    else bw_bias<NHOP, BW_HEADS_MAX>(bs, w1s, w2s, b1s, b2s, p, b, q0, hvec);

    for (int gi = 0; gi < passes; ++gi) {
      const int h0 = gi * G, gn = min(G, H - h0);
      cp_async_wait<0>();
      __syncthreads();               // the pass's keys and queries, the tile's bias
      // a warp a head of the pass (resident: several in turn); in passes
      // each head's V is copied over its K once every warp has its scores
      for (int r = 0; r < (gn + BW_WARPS - 1) / BW_WARPS; ++r) {
        const int hl = warp + BW_WARPS * r;
        bf16* sl = reinterpret_cast<bf16*>(slots + hl * slot);
        float s[2 * ATT_ROW16][4];
        if (hl < gn)
          bw_scores<DP>(s, sl + qrow * KLD, sl, bs + (size_t)(h0 + hl) * 16 * NKP, kbs, p, a,
                        q0, lane);
        if (!res) {
          __syncthreads();
          bw_rows<DP>(slots, slot, qkv, p, h0, gn, 0, NKP, 0, 2 * C);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        if (hl < gn) bw_pv<DP>(s, sl + vrow * KLD, sl + qrow * KLD, p, out_b, h0 + hl, q0, lane);
      }
      __syncthreads();               // the slots are free for the next pass
      if (gi + 1 < passes) {
        const int hn = h0 + G, gm = min(G, H - hn);
        bw_rows<DP>(slots, slot, qkv, p, hn, gm, 0, NKP, 0, C);
        bw_rows<DP>(slots, slot, qkv, p, hn, gm, qrow, 16, q0, 0);
        cp_async_commit();
      }
    }
    __syncthreads();                 // the tile's queries and bias are read
  }
}

// ------------------------------------------------------------ entry points
// Each returns cudaGetLastError() after its launch, or cudaErrorInvalidValue
// for a shape it does not take.

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

template <int NH>
static int launch_enc_wide(const CUtensorMap (&m)[3], const EncWideArgs& p, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        enc_post_wide_kernel<NH>, cudaFuncAttributeMaxDynamicSharedMemorySize, ew_smem(NH));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int sms = 0;
  const int rc = ew_sms(sms);
  if (rc) return rc;
  const long tiles = (p.R + EW_ROWS - 1) / EW_ROWS;
  enc_post_wide_kernel<NH><<<(unsigned)(tiles < sms ? tiles : sms), EW_THREADS, ew_smem(NH), s>>>(
      m[0], m[1], m[2], p);
  return (int)cudaGetLastError();
}

// att, src [R, C] bf16, att 16-byte aligned; wo [Cp, Cp], w1 [Fp, Cp], w2
// [Cp, Fp] bf16, zero past C and F (ops/kernels.py pad_cols, pad_ffn),
// 16-byte aligned, with Cp = 2 ew_half(C) and Fp a multiple of EW_CHUNK,
// so that every box the tensor maps read lies inside them; fp32 vectors
// of C values (b1: Fp); pos [n_tok, C]; out [R, C] (out_dt) and nxt [R, C]
// bf16, either may be null.
extern "C" int ec_enc_post_wide(const void* att, const void* src, const void* wo,
                                const void* bo, const void* g1, const void* be1,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* g2, const void* be2, const void* pos, int n_tok,
                                void* out, int out_dt, void* nxt, long R, int C, int Cp, int Fp,
                                float eps, void* stream) {
  const int nh = ew_half(C);
  if (R <= 0 || R > 2147483647L * EW_ROWS || C <= 0 || C > HW_MAX_C || Cp != 2 * nh ||
      Fp <= 0 || Fp % EW_CHUNK || (!out && !nxt) || (nxt && (!pos || n_tok <= 0)) || !src ||
      !att || (reinterpret_cast<uintptr_t>(att) & 15) || !hw_aligned(wo) || !hw_aligned(w1) ||
      !hw_aligned(w2))
    return (int)cudaErrorInvalidValue;
  // Wo and W2 in boxes of [nh rows x 64], W1 of [64 x 64]
  CUtensorMap m[3];
  if (!encode_map(&m[0], wo, Cp, Cp, Cp, 0, 1, nh) ||
      !encode_map(&m[1], w1, Cp, Fp, Cp, 0, 1, 64) ||
      !encode_map(&m[2], w2, Fp, Cp, Fp, 0, 1, nh))
    return (int)cudaErrorInvalidValue;
  EncWideArgs p;
  p.att = static_cast<const bf16*>(att); p.src = static_cast<const bf16*>(src);
  p.pos = static_cast<const bf16*>(pos);
  p.bo = static_cast<const float*>(bo); p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1); p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2); p.g2 = static_cast<const float*>(g2);
  p.be2 = static_cast<const float*>(be2);
  p.out = out; p.out_dt = out_dt; p.nxt = static_cast<bf16*>(nxt);
  p.R = R; p.C = C; p.Fp = Fp; p.n_tok = n_tok; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nh) {
    case 64: return launch_enc_wide<64>(m, p, s);
    case 128: return launch_enc_wide<128>(m, p, s);
    case 192: return launch_enc_wide<192>(m, p, s);
    default: return launch_enc_wide<256>(m, p, s);
  }
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
template <int DP, int NHOP>
static int launch_bias_wide(const BiasWideArgs& p, int B, int qsplit, long smem,
                            cudaStream_t s) {
  static bool configured = false;
  const int rc = hw_launch_check((const void*)bias_attn_wide_kernel<DP, NHOP>, smem, configured);
  if (rc) return rc;
  bias_attn_wide_kernel<DP, NHOP><<<dim3((unsigned)B, (unsigned)qsplit), BW_THREADS, smem, s>>>(
      p);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_bias_wide_dp(const BiasWideArgs& p, int B, int qsplit, long smem,
                               cudaStream_t s) {
  return p.nhop == 5 ? launch_bias_wide<DP, 5>(p, B, qsplit, smem, s)
                     : launch_bias_wide<DP, BW_HOP_MAX>(p, B, qsplit, smem, s);
}

// qkv: contiguous bf16 [B, N, 3 H D], 16-byte aligned; kvalid: bool [B,
// N] (row stride skvb) or null; hops: contiguous bf16 [B, N, N, nhop]; w1
// [nhop, hid], b1 [hid], w2 [hid, H], b2 [H] fp32; out: contiguous bf16
// [B, N, H D]. The plan (ops/kernels.py bias_attention_plan): qsplit
// blocks a batch row of tiles_per_block 16-query tiles each, per_pass
// heads a pass (resident: every head, its K and V kept a block), smem
// bytes.
extern "C" int ec_bias_attention_wide(const void* qkv, int B, int N, int H, int D,
                                      const void* kvalid, long skvb, const void* hops, int nhop,
                                      int hid, const void* w1, const void* b1, const void* w2,
                                      const void* b2, float scale, void* out, int qsplit,
                                      int tiles_per_block, int per_pass, int resident, long smem,
                                      void* stream) {
  const int nk16 = (N + 15) / 16;
  const int dp = D <= 32 ? 32 : D <= 64 ? 64 : 128;
  if (B <= 0 || N <= 0 || N > HW_MAX_K || H <= 0 || H > BW_HEADS_MAX || D <= 0 || D > 128 ||
      nhop <= 0 || nhop > BW_HOP_MAX || hid <= 0 || hid > BW_HID_MAX || !qkv || !hops || !w1 ||
      !b1 || !w2 || !b2 || !out || (reinterpret_cast<uintptr_t>(qkv) & 15) || qsplit < 1 ||
      qsplit > 65535 || tiles_per_block < 1 || (long)qsplit * tiles_per_block * 16 < N ||
      per_pass < 1 || per_pass > H || (resident ? per_pass != H : per_pass > BW_WARPS) ||
      smem < bw_smem(H, nk16 * 16, dp, per_pass, resident) || smem > HW_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  BiasWideArgs p;
  p.qkv = static_cast<const bf16*>(qkv);
  p.kvalid = static_cast<const unsigned char*>(kvalid); p.skvb = skvb;
  p.hops = static_cast<const bf16*>(hops);
  p.w1 = static_cast<const float*>(w1); p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2); p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.N = N; p.H = H; p.D = D; p.NK16 = nk16; p.nhop = nhop; p.hid = hid;
  p.tiles_per_block = tiles_per_block; p.per_pass = per_pass; p.resident = resident != 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dp == 32 ? launch_bias_wide_dp<32>(p, B, qsplit, smem, s)
         : dp == 64 ? launch_bias_wide_dp<64>(p, B, qsplit, smem, s)
                    : launch_bias_wide_dp<128>(p, B, qsplit, smem, s);
}
