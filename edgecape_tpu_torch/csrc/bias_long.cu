// bias_attn_long_kernel: the decoder stack's self-attention with its
// Markov bias at more than 128 keypoints a batch row (any K), 1..16 heads
// of head dim 1..128 (run at DP = 32, 64 or 128):
//   bias[h, i, j] = b2[h] + sum_m relu(b1[m] + sum_n hops[b, i, j, n]
//                   w1[n, m]) w2[m, h],
//   out[b, i, D h:D h + D] = bf16(bf16(softmax(q.k^T * scale + key mask
//                   + bias)) . v),
// as ops/fused_decoder.py bias_attention_plain. It replaces, above 128
// keypoints, the TPU kernel edgecape_tpu/ops/fused_decoder.py
// fused_decoder_stack's self-attention with the in-kernel Markov bias
// (_stack_kernel, through pallas_call at :531), which pads K to a multiple
// of 128 and keeps a whole batch row in VMEM. kernels.cu bias_attn_kernel
// and head_wide.cu bias_attn_wide_kernel keep every key of a row and the
// bias of a 16-query tile for every head, [H, 16, K] fp32, in shared
// memory, so they stop at 128 keys; here the keys stream.
//
// Bound. At the eval chunk's shape with K 133 (510 batch rows, 8 heads of
// 32, 5 hop planes, 12 hidden units) the call must read q, k, v (104 MB)
// and the hop stack (90 MB) and write its output (35 MB): 0.068 ms at
// 3.35 TB/s. Its operations take less: the bias MLP, 2 x (5 x 12 + 12 x
// 8) fp32 operations a (query, key), 2.8 GFLOP (0.042 ms at 67 TFLOP/s);
// the two products, 9.2 GFLOP on tensor cores (0.009 ms); one
// exponential a score, 72 M (0.019 ms on the special-function units). So
// bytes bound it, the MLP next.
//
// Design:
//   * a persistent grid of 256-thread blocks (8 warps) walks the items,
//     one 16-query tile of one batch row each, batch row by batch row so
//     that neighbouring blocks share a row's keys, values and hops in L2;
//     the tile's queries of every head stay in shared memory;
//   * two passes over the row's keys in tiles of KT (64; 32 or 16 where 16
//     heads of head dim 64 or 128 leave no room), the two-pass form of
//     kernels.cu attn_kernel (attention.cuh attn_stats_chunk, attn_exp,
//     attn_probs, attn_pv): pass 1 loads a tile's keys of every head and
//     forms the tile's bias for every head in shared memory, the MLP's
//     hidden layer once per (query, key) for all heads, in
//     bias_attn_kernel's term order (b1, the hop terms ascending, ReLU; b2,
//     the hidden terms ascending); a warp a head (two above 8 heads) makes
//     the finished scores on mma.sync from shared memory (attn_scores),
//     keeps its rows' running max and exp-sum, and writes the scores to
//     its block's slot of a scratch buffer in its own lane layout (one
//     row of 16 keys a lane, 32 bytes), which the same lane reads back in
//     pass 2; pass 2 loads a tile's values and forms p = 2^(s - max) /
//     sum, rounded to bf16 for P.V on mma.sync as the plain version
//     rounds the normalised probabilities. A one-pass online softmax would
//     round the unnormalised p instead: emulated on the CPU against the
//     plain version its outputs differ by 2-3e-4 on the mean, past the
//     1e-4 the port holds its emulations to, where this form differs by
//     fp32 noise only;
//   * the scratch of a block is H x 16 x K fp32 (78 KB at K 133, 8
//     heads), so the grid's (20 MB at 264 blocks) stays in L2.
// A row's bits do not depend on its place in the batch nor on the block
// that ran its tile: every sum runs over the same keys in the same order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attention.cuh"

#define BL_THREADS 256        // 8 warps
#define BL_WARPS 8
#define BL_HOP_MAX 8
#define BL_HID_MAX 32
#define BL_HEADS_MAX 16
#define BL_SMEM_LIMIT (227 * 1024)
// w1 [hid][8] | w2 [hid][16] | b1 [hid] | b2 [16], zero past nhop, hid, H
#define BL_MLP_FLOATS (BL_HID_MAX * 8 + BL_HID_MAX * BL_HEADS_MAX + BL_HID_MAX + BL_HEADS_MAX)

// Keys of a streamed tile: 64, or as many as fit beside 16 heads of head
// dim 64 (32) or 128 (16). HPW: heads a warp takes (1 up to 8, 2 above).
__host__ __device__ constexpr int bl_key_tile(int dp, int hpw) {
  return hpw == 1 || dp == 32 ? 64 : dp == 64 ? 32 : 16;
}
// Blocks an SM holds: two of the head dims up to 64 at up to 8 heads
// (registers capped at 128 a thread), else one.
__host__ __device__ constexpr int bl_min_blocks(int dp, int hpw) {
  return hpw == 1 && dp <= 64 ? 2 : 1;
}
// Shared memory: the queries [H][16][dp + 8] bf16, a key (pass 1) or value
// (pass 2) tile [H][kt][dp + 8] bf16 (rows padded by 16 bytes against
// ldmatrix's bank conflicts), the tile's bias [H][16][kt] fp32, its key
// mask [kt] and the MLP.
__host__ __device__ constexpr long bl_smem(int heads, int dp, int kt) {
  return 32L * heads * (dp + 8) + 2L * heads * kt * (dp + 8) + 64L * heads * kt + 4L * kt +
         4L * BL_MLP_FLOATS;
}
static_assert(bl_smem(8, 128, bl_key_tile(128, 1)) <= BL_SMEM_LIMIT &&
                  bl_smem(16, 32, bl_key_tile(32, 2)) <= BL_SMEM_LIMIT &&
                  bl_smem(16, 64, bl_key_tile(64, 2)) <= BL_SMEM_LIMIT &&
                  bl_smem(16, 128, bl_key_tile(128, 2)) <= BL_SMEM_LIMIT,
              "a bias_attn_long_kernel instance does not fit a block");

struct BiasLongArgs {
  const bf16* qkv;                     // [B, N, 3 H D]
  const unsigned char* kvalid; long skvb;
  const bf16* hops;                    // [B, N, N, nhop]
  const float *w1, *b1, *w2, *b2;
  bf16* out;                           // [B, N, H D]
  float* scores;                       // [grid][H][NKP / 16][32 lanes][8]
  long items;                          // B x qtiles
  int N, H, D, NKP, nhop, hid, qtiles;
  float scale;
};

// Rows [src0, src0 + n) of the q (off 0), k (C) or v (2 C) columns of heads
// [h0, h0 + gn) of one batch row into rows [0, n) of consecutive slots of
// `rows` rows from `at`: 16-byte cp.async where a row's 8 values are
// whole and aligned, else element loads; zeros past D and N.
template <int DP>
__device__ __forceinline__ void bl_rows(bf16* at, int rows, const bf16* qkv,
                                        const BiasLongArgs& p, int h0, int gn, int n, int src0,
                                        int off) {
  constexpr int KLD = DP + 8, D8 = DP / 8;
  const long C3 = 3L * p.H * p.D;
  for (int i = threadIdx.x; i < gn * n * D8; i += BL_THREADS) {
    const int hl = i / (n * D8), r = (i / D8) % n, d8 = (i % D8) * 8, row = src0 + r;
    const int valid = row < p.N ? (p.D - d8 >= 8 ? 8 : p.D - d8 > 0 ? p.D - d8 : 0) : 0;
    copy8(at + ((size_t)hl * rows + r) * KLD + d8,
          qkv + (long)row * C3 + off + (long)(h0 + hl) * p.D + d8, valid);
  }
}

// The hop values of keys k0 .. k0 + 3 of one query row (src: the first of
// them, nhop planes a key), as hv[plane][key]; 0 past n keys or nhop
// planes. vec: NHOP == nhop and the run of 4 x NHOP values is 8-byte
// aligned.
template <int NHOP>
__device__ __forceinline__ void bl_load_hops(const bf16* src, int k0, int n, int nhop, bool vec,
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

// The bias of the 16-query tile from q0 against the KT keys from kt0, for
// every head (HB: the heads rounded up to 8 or 16), into bs [H][16][KT]:
// the MLP's hidden layer once per (query, key), summed as
// bias_attn_kernel sums it. A thread takes (query, 4 keys).
template <int NHOP, int HB, int KT>
__device__ __forceinline__ void bl_bias(float* bs, const float* w1s, const float* w2s,
                                        const float* b1s, const float* b2s,
                                        const BiasLongArgs& p, long b, int q0, int kt0,
                                        bool hvec) {
  constexpr int NQ4 = KT / 4;
  for (int i = threadIdx.x; i < 16 * NQ4; i += BL_THREADS) {
    const int rr = i / NQ4, kl = 4 * (i % NQ4), k0 = kt0 + kl, q = q0 + rr;
    float acc[HB][4];
#pragma unroll
    for (int h = 0; h < HB; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] = b2s[h];
    if (q < p.N && k0 < p.N) {
      float hv[NHOP][4];
      bl_load_hops<NHOP>(p.hops + ((b * p.N + q) * (long)p.N + k0) * p.nhop, k0, p.N, p.nhop,
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
          const float4 w = *reinterpret_cast<const float4*>(w2s + BL_HEADS_MAX * m + 4 * v);
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
        *reinterpret_cast<float4*>(bs + ((size_t)h * 16 + rr) * KT + kl) =
            make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
}

template <int DP, int HPW, int NHOP>
__global__ void __launch_bounds__(BL_THREADS, bl_min_blocks(DP, HPW))
    bias_attn_long_kernel(BiasLongArgs p) {
  constexpr int KLD = DP + 8, KT = bl_key_tile(DP, HPW), NT = KT / 8, KB = KT / 16;
  extern __shared__ __align__(128) unsigned char bl_raw[];
  const int H = p.H, C = H * p.D, NKP = p.NKP, NB = NKP / 16;
  bf16* Qs = reinterpret_cast<bf16*>(bl_raw);                           // [H][16][KLD]
  bf16* KVs = Qs + (size_t)H * 16 * KLD;                                // [H][KT][KLD]
  float* bs = reinterpret_cast<float*>(KVs + (size_t)H * KT * KLD);    // [H][16][KT]
  float* kbs = bs + (size_t)H * 16 * KT;                                // [KT]
  float* w1s = kbs + KT;
  float* w2s = w1s + BL_HID_MAX * 8;
  float* b1s = w2s + BL_HID_MAX * BL_HEADS_MAX;
  float* b2s = b1s + BL_HID_MAX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* slot = p.scores + (size_t)blockIdx.x * H * NKP * 16;

  for (int i = threadIdx.x; i < BL_HID_MAX * 8; i += BL_THREADS) {
    const int m = i >> 3, j = i & 7;
    w1s[i] = m < p.hid && j < p.nhop ? p.w1[j * p.hid + m] : 0.0f;
  }
  for (int i = threadIdx.x; i < BL_HID_MAX * BL_HEADS_MAX; i += BL_THREADS) {
    const int m = i >> 4, h = i & 15;
    w2s[i] = m < p.hid && h < H ? p.w2[m * H + h] : 0.0f;
  }
  for (int i = threadIdx.x; i < BL_HID_MAX; i += BL_THREADS) b1s[i] = i < p.hid ? p.b1[i] : 0.0f;
  if (threadIdx.x < BL_HEADS_MAX) b2s[threadIdx.x] = threadIdx.x < H ? p.b2[threadIdx.x] : 0.0f;

  AttnArgs a = {};
  a.scale = p.scale;
  a.Nk = p.N;
  const bool hvec = p.nhop == NHOP && p.N % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(p.hops) & 7) == 0;

  for (long item = blockIdx.x; item < p.items; item += gridDim.x) {
    const long b = item / p.qtiles;
    const int q0 = (int)(item % p.qtiles) * 16;
    const bf16* qkv = p.qkv + b * p.N * 3L * C;
    __syncthreads();               // the last item's tiles and output rows are done with
    bl_rows<DP>(Qs, 16, qkv, p, 0, H, 16, q0, 0);

    // pass 1: the finished scores into the block's slot, each row's max
    // and exp-sum
    float m0[HPW], m1[HPW], l0[HPW], l1[HPW];
#pragma unroll
    for (int r = 0; r < HPW; ++r) {
      m0[r] = m1[r] = -INFINITY;
      l0[r] = l1[r] = 0.0f;
    }
    for (int kt0 = 0; kt0 < NKP; kt0 += KT) {
      if (kt0) __syncthreads();    // every warp is done with the last tile's keys and bias
      bl_rows<DP>(KVs, KT, qkv, p, 0, H, KT, kt0, C);
      cp_async_commit();
      for (int j = threadIdx.x; j < KT; j += BL_THREADS) {
        const int key = kt0 + j;
        const bool on = key < p.N && (p.kvalid == nullptr || p.kvalid[b * p.skvb + key] != 0);
        kbs[j] = on ? 0.0f : -INFINITY;
      }
      if (H <= 8) bl_bias<NHOP, 8, KT>(bs, w1s, w2s, b1s, b2s, p, b, q0, kt0, hvec);
      else bl_bias<NHOP, BL_HEADS_MAX, KT>(bs, w1s, w2s, b1s, b2s, p, b, q0, kt0, hvec);
      cp_async_wait<0>();
      __syncthreads();             // the queries, the tile's keys, mask and bias
#pragma unroll
      for (int r = 0; r < HPW; ++r) {
        const int h = warp + BL_WARPS * r;
        if (h >= H) continue;
        const bf16* Qh = Qs + (size_t)h * 16 * KLD;
        unsigned qa[DP / 16][4];
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ldsm_x4(Qh + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * KLD + kk * 16 +
                      (lane >> 4) * 8,
                  qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
        // bias rows of the tile, indexed by key (attn_scores reads key k0
        // of a row at brow[k0])
        const float* brows = bs + (size_t)h * 16 * KT - kt0;
        AttnRows rw;
        rw.brow[0] = q0 + g < p.N ? brows + (size_t)g * KT : nullptr;
        rw.brow[1] = q0 + g + 8 < p.N ? brows + (size_t)(g + 8) * KT : nullptr;
        rw.bias_vec = true;        // a tile's bias rows take 16-byte loads
        float s[NT][4];
        attn_scores<DP, NT>(s, qa, KVs + (size_t)h * KT * KLD, kbs, kt0, NKP, a, rw, lane, kt0);
        attn_stats_chunk<NT>(s, m0[r], m1[r], l0[r], l1[r]);
        float* dst = slot + (((size_t)h * NB + kt0 / 16) * 32 + lane) * 8;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
          if (kt0 + 16 * kb < NKP) {
            float4* d4 = reinterpret_cast<float4*>(dst + kb * 256);
            d4[0] = make_float4(s[2 * kb][0], s[2 * kb][1], s[2 * kb][2], s[2 * kb][3]);
            d4[1] = make_float4(s[2 * kb + 1][0], s[2 * kb + 1][1], s[2 * kb + 1][2],
                                s[2 * kb + 1][3]);
          }
      }
    }
    float z0[HPW], z1[HPW], inv0[HPW], inv1[HPW];
#pragma unroll
    for (int r = 0; r < HPW; ++r) {
      attn_stats_join(m0[r], m1[r], l0[r], l1[r]);
      z0[r] = m0[r] == -INFINITY ? 0.0f : m0[r];
      z1[r] = m1[r] == -INFINITY ? 0.0f : m1[r];
      inv0[r] = l0[r] > 0.0f ? 1.0f / l0[r] : 0.0f;
      inv1[r] = l1[r] > 0.0f ? 1.0f / l1[r] : 0.0f;
    }

    // pass 2: per group of 8 heads, the values tile by tile and P.V
#pragma unroll
    for (int r = 0; r < HPW; ++r) {
      const int h0 = BL_WARPS * r, gn = H - h0 < BL_WARPS ? H - h0 : BL_WARPS;
      if (gn <= 0) continue;       // the same for every warp
      const int h = h0 + warp;
      float o[DP / 8][4];
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
      for (int kt0 = 0; kt0 < NKP; kt0 += KT) {
        __syncthreads();           // the keys, or the last tile's values, are read
        bl_rows<DP>(KVs, KT, qkv, p, h0, gn, KT, kt0, 2 * C);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (warp >= gn) continue;
        float s[NT][4];
        const float* src = slot + (((size_t)h * NB + kt0 / 16) * 32 + lane) * 8;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          float4 v0 = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY), v1 = v0;
          if (kt0 + 16 * kb < NKP) {
            v0 = reinterpret_cast<const float4*>(src + kb * 256)[0];
            v1 = reinterpret_cast<const float4*>(src + kb * 256)[1];
          }
          s[2 * kb][0] = v0.x; s[2 * kb][1] = v0.y; s[2 * kb][2] = v0.z; s[2 * kb][3] = v0.w;
          s[2 * kb + 1][0] = v1.x; s[2 * kb + 1][1] = v1.y;
          s[2 * kb + 1][2] = v1.z; s[2 * kb + 1][3] = v1.w;
        }
        attn_exp<NT>(s, z0[r], z1[r]);
        attn_probs<false, NT>(s, kt0, NKP, inv0[r], inv1[r], a, 0ull, 0u, 0, 0, t);
        const int nblk = (NKP - kt0) / 16;
        attn_pv<DP, NT>(o, s, KVs + (size_t)warp * KT * KLD, 0, nblk < KB ? nblk : KB, lane);
      }
      if (warp >= gn) continue;
      // the output rounded to bf16, staged through the head's query rows
      // (no warp reads them in pass 2), 16-byte stores where D allows
      bf16* Qh = Qs + (size_t)h * 16 * KLD;
      __syncwarp();
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        *reinterpret_cast<unsigned*>(&Qh[g * KLD + dt * 8 + 2 * t]) =
            pack_bf16(o[dt][0], o[dt][1]);
        *reinterpret_cast<unsigned*>(&Qh[(g + 8) * KLD + dt * 8 + 2 * t]) =
            pack_bf16(o[dt][2], o[dt][3]);
      }
      __syncwarp();
      bf16* out = p.out + b * p.N * (long)C + (long)h * p.D;
      if (!(p.D & 7) && !(reinterpret_cast<uintptr_t>(p.out) & 15)) {   // C a multiple of 8
        const int d8n = p.D / 8;
        for (int c = lane; c < 16 * d8n; c += 32) {
          const int rr = c / d8n, d8 = (c % d8n) * 8;
          if (q0 + rr < p.N)
            *reinterpret_cast<uint4*>(out + (long)(q0 + rr) * C + d8) =
                *reinterpret_cast<const uint4*>(&Qh[rr * KLD + d8]);
        }
      } else {
        for (int c = lane; c < 16 * p.D; c += 32) {
          const int rr = c / p.D, d = c % p.D;
          if (q0 + rr < p.N) out[(long)(q0 + rr) * C + d] = Qh[rr * KLD + d];
        }
      }
    }
  }
}

// ------------------------------------------------------------ entry point
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape it does not take.

template <int DP, int HPW, int NHOP>
static int launch_bias_long(const BiasLongArgs& p, int grid, long smem, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(bias_attn_long_kernel<DP, HPW, NHOP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               BL_SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  bias_attn_long_kernel<DP, HPW, NHOP><<<(unsigned)grid, BL_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int HPW>
static int launch_bias_long_hops(const BiasLongArgs& p, int grid, long smem, cudaStream_t s) {
  return p.nhop == 5 ? launch_bias_long<DP, HPW, 5>(p, grid, smem, s)
                     : launch_bias_long<DP, HPW, BL_HOP_MAX>(p, grid, smem, s);
}

template <int DP>
static int launch_bias_long_dp(const BiasLongArgs& p, int grid, long smem, cudaStream_t s) {
  return p.H > BL_WARPS ? launch_bias_long_hops<DP, 2>(p, grid, smem, s)
                        : launch_bias_long_hops<DP, 1>(p, grid, smem, s);
}

// qkv: contiguous bf16 [B, N, 3 H D], 16-byte aligned; kvalid: bool [B,
// N] (row stride skvb) or null; hops: contiguous bf16 [B, N, N, nhop]; w1
// [nhop, hid], b1 [hid], w2 [hid, H], b2 [H] fp32; out: contiguous bf16
// [B, N, H D]; scores: fp32 scratch of grid x H x 16 x NKP values (NKP =
// N rounded up to 16), 16-byte aligned. The plan (ops/kernels.py
// bias_attention_plan): grid blocks, key_tile keys a streamed tile (which
// must be bl_key_tile's), smem bytes.
extern "C" int ec_bias_attention_long(const void* qkv, int B, int N, int H, int D,
                                      const void* kvalid, long skvb, const void* hops, int nhop,
                                      int hid, const void* w1, const void* b1, const void* w2,
                                      const void* b2, float scale, void* out, void* scores,
                                      int grid, int key_tile, long smem, void* stream) {
  const int dp = D <= 32 ? 32 : D <= 64 ? 64 : 128;
  const int hpw = H > BL_WARPS ? 2 : 1;
  if (B <= 0 || N <= 0 || H <= 0 || H > BL_HEADS_MAX || D <= 0 || D > 128 || nhop <= 0 ||
      nhop > BL_HOP_MAX || hid <= 0 || hid > BL_HID_MAX || !qkv || !hops || !w1 || !b1 || !w2 ||
      !b2 || !out || !scores || (reinterpret_cast<uintptr_t>(qkv) & 15) ||
      (reinterpret_cast<uintptr_t>(scores) & 15) || grid < 1 ||
      key_tile != bl_key_tile(dp, hpw) || smem < bl_smem(H, dp, key_tile) ||
      smem > BL_SMEM_LIMIT || (long)N * N > 2147483647L)
    return (int)cudaErrorInvalidValue;
  BiasLongArgs p;
  p.qkv = static_cast<const bf16*>(qkv);
  p.kvalid = static_cast<const unsigned char*>(kvalid); p.skvb = skvb;
  p.hops = static_cast<const bf16*>(hops);
  p.w1 = static_cast<const float*>(w1); p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2); p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.scores = static_cast<float*>(scores);
  p.N = N; p.H = H; p.D = D; p.NKP = (N + 15) / 16 * 16; p.nhop = nhop; p.hid = hid;
  p.qtiles = (N + 15) / 16;
  p.items = (long)B * p.qtiles;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dp == 32 ? launch_bias_long_dp<32>(p, grid, smem, s)
         : dp == 64 ? launch_bias_long_dp<64>(p, grid, smem, s)
                    : launch_bias_long_dp<128>(p, grid, smem, s);
}
