// Width-generic companions of the head's kernels in kernels.cu, for every
// head the JAX package takes other than the 256 channels (8 heads of 32)
// those are written for: enc_post_wide_kernel and bias_attn_wide_kernel
// (1..16 heads of 1..128); the decoder layer's post-attention kernels at
// those widths are dec_self_wide.cu's and dec_wide.cu's
// (dec_post_self_wide_kernel, dec_post_cross_wide_kernel,
// dec_post_gcn_wide_kernel) and the keypoint head kpt_wide.cu's
// (kpt_head_wide_kernel), all built from the parts enc_post_wide_kernel
// shares in head_wide.cuh, libraries of their own so that nvcc builds them
// beside this file.
// They replace the same TPU kernels as their 256-channel forms
// (edgecape_tpu/ops/fused_encoder.py _layer_body, fused_decoder.py
// _stack_kernel) with the same rounding points as the plain versions
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attention.cuh"
#include "head_wide.cuh"

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
