// Attention over any number of keys (and queries): the kernels of
// kernels.cu's attention with the keys, or in the key-major backward the
// queries, streamed through shared memory in tiles instead of held whole.
// They take what the TPU kernels take at any length
// (edgecape_tpu/ops/flash_attention.py flash_mha, which pads Nk up with no
// cap, and the training pair _flash_train_fwd / _flash_train_bwd; the
// attention inside fused_vit_block, fused_encoder, fused_decoder and
// fused_attn_block), where kernels.cu's hold a head's keys and values in
// 4 * Nk * (D + 8) bytes of shared memory and so stop at 512 keys
// (ATT_MAX_NK), and the ViT attention kernel keeps a 272-key score row in
// registers:
//   * attn_long_kernel: the eval forward, head dim 32 or 64, any Nq and
//     Nk >= 1, with the key mask and an fp32 [B, H, Nq, Nk] bias;
//   * train_fwd_long_kernel: the same with Philox dropout on the
//     probabilities, an fp32 output and each row's max and reciprocal
//     exp-sum saved in the layout the backward reads;
//   * train_bwd_q_long_kernel (delta, dbias, dq: keys and values streamed)
//     and train_bwd_k_long_kernel (dk, dv: queries, do and their statistics
//     streamed), launched in that order.
// Their plain twins, which CPU tensors take and which the card's checks
// hold them against: ops/plain.py attention (attn_long_kernel),
// ops/flash_attention.py flash_mha_train_plain fed dropout_mask(seed)
// (train_fwd_long_kernel) and autograd through it (the backward pair).
//
// The arithmetic is that of kernels.cu's two-pass form, chunk for chunk
// (the helpers of attention.cuh): the scores of a warp's 16-row query
// tile are formed in registers over 32-key chunks, pass 1 keeps a per-lane
// running max and exp-sum in fp32 and joins them over the quad, pass 2
// recomputes the scores, normalises by the final sum before the rounding
// to bf16 and accumulates P.V in fp32. The rounding points are
// flash_attention.py:132's, and a row's output does not depend on how the
// keys arrive: at a shape the resident kernels also take, these give the
// same bits as their two-pass form. No online rescale of the output (one
// pass) is used: it would round exp(s - running max) to bf16 where the TPU
// kernel rounds exp(s - row max) / sum. Dropout bits depend on (row,
// key / 4, batch * H + head) alone, so the mask is dropout_mask(seed)'s
// whatever the tiling.
//
// What bounds them on this card: at 518 px the ViT's [B, 1370, 6 x 64]
// and the joint encoder's [B, 1469, 8 x 32] make 4 * Nq * Nk * D
// operations a head against 8 * N * D bytes, some 340 operations a byte:
// the tensor cores bound them, not memory. The design is the first, simple
// one: a block of up to LONG_MAX_WARPS warps (a 16-row tile each) walks
// the keys in tiles of LONG_TILE through a ring of LONG_STAGES stages
// filled by cp.async, the next tile landing under the current one's
// products; every warp of the block reads the tile from shared memory, so
// a key is fetched from L2 once per block and pass. Pass 1 fetches K
// alone; the ring runs on from pass 1 into pass 2 without a pause. The
// products are mma.sync m16n8k16 tiles as in kernels.cu, not wgmma.
// Hazards: keys past Nk are zero K and V rows with a -inf mask; 16-key
// blocks past the padded length are skipped; a warp past Nq loads and
// waits with the block but multiplies nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attention.cuh"

#define LONG_TILE 64          // keys (or queries) of a streamed tile
#define LONG_STAGES 2         // tiles in the ring
#define LONG_MAX_WARPS 8      // 16-row tiles a block takes

// Bytes of a ring stage: K and V [LONG_TILE][D + 8] bf16 and the additive
// key mask; in the key-major backward q and do and each query's float4 of
// statistics.
template <int D>
__host__ __device__ constexpr int long_key_stage() {
  return 4 * LONG_TILE * (D + 8) + 4 * LONG_TILE;
}
template <int D>
__host__ __device__ constexpr int long_query_stage() {
  return 4 * LONG_TILE * (D + 8) + 16 * LONG_TILE;
}

// Keys [k0, k0 + LONG_TILE) of (batch b, head h) into a stage: K (and V
// with V_TOO) by cp.async, zero rows past Nk, and the additive mask (-inf
// past Nk or where the key mask is off).
template <int D, bool V_TOO>
__device__ __forceinline__ void long_load_keys(unsigned char* stage, const AttnArgs& p, long b,
                                               int h, int k0) {
  constexpr int KLD = D + 8;
  bf16* Ks = reinterpret_cast<bf16*>(stage);
  bf16* Vs = Ks + LONG_TILE * KLD;
  float* kbs = reinterpret_cast<float*>(Vs + LONG_TILE * KLD);
  for (int c = threadIdx.x; c < LONG_TILE * (D / 8); c += blockDim.x) {
    const int n = c / (D / 8), d8 = (c % (D / 8)) * 8, key = k0 + n;
    stage8(&Ks[n * KLD + d8], p.k, p.in_dt, b * p.skb + (long)key * p.skn + h * D + d8,
           key < p.Nk);
    if (V_TOO)
      stage8(&Vs[n * KLD + d8], p.v, p.in_dt, b * p.svb + (long)key * p.svn + h * D + d8,
             key < p.Nk);
  }
  for (int j = threadIdx.x; j < LONG_TILE; j += blockDim.x) {
    const int key = k0 + j;
    const bool on = key < p.Nk && (p.kvalid == nullptr || p.kvalid[b * p.skvb + key] != 0);
    kbs[j] = on ? 0.0f : -INFINITY;
  }
}

// The 16 rows from row r0 of a [.., N, H * D] operand into a warp's tile
// (zero rows past n).
template <int D>
__device__ __forceinline__ void long_load_rows(bf16* dst, const void* src, int dt, long sb,
                                               long sn, long b, int h, int r0, int n,
                                               int lane) {
  constexpr int KLD = D + 8;
  for (int c = lane; c < 16 * (D / 8); c += 32) {
    const int rr = c / (D / 8), d8 = (c % (D / 8)) * 8;
    stage8(&dst[rr * KLD + d8], src, dt, b * sb + (long)(r0 + rr) * sn + h * D + d8,
           r0 + rr < n);
  }
}

// A 16-row tile of shared memory as the A operand of mma16816.
template <int D>
__device__ __forceinline__ void long_a_operand(unsigned (&a)[D / 16][4], const bf16* tile,
                                               int lane) {
  constexpr int KLD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(tile + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * KLD + kk * 16
                + (lane >> 4) * 8,
            a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
}

template <int D, bool TRAIN>
__device__ __forceinline__ void attn_long_body(const AttnArgs& p) {
  constexpr int KLD = D + 8;
  constexpr int NT = 2 * ATT_CH16;            // 8-key score tiles of a 32-key chunk
  constexpr int STAGE = long_key_stage<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int NKP = p.NK16 * 16;
  const int tiles = (NKP + LONG_TILE - 1) / LONG_TILE;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the ring, then a query tile [16][KLD] per warp (reused to stage a bf16
  // output)
  bf16* Qs = reinterpret_cast<bf16*>(smem + LONG_STAGES * STAGE) + (size_t)warp * 16 * KLD;

  const long bh = blockIdx.x;
  const long b = bh / p.H;
  const int h = (int)(bh % p.H);
  const int q0 = (blockIdx.y * nwarps + warp) * 16;
  const bool active = q0 < p.Nq;
  const int r0 = q0 + g, r1 = q0 + g + 8;

  if (active) long_load_rows<D>(Qs, p.q, p.in_dt, p.sqb, p.sqn, b, h, q0, p.Nq, lane);
  long_load_keys<D, false>(smem, p, b, h, 0);
  cp_async_commit();

  unsigned qa[D / 16][4];
  AttnRows rw;
  rw.brow[0] = rw.brow[1] = nullptr;
  rw.bias_vec = p.Nk % 4 == 0 && (reinterpret_cast<uintptr_t>(p.bias) & 15) == 0;
  if (p.bias) {
    if (r0 < p.Nq) rw.brow[0] = p.bias + ((size_t)bh * p.Nq + r0) * p.Nk;
    if (r1 < p.Nq) rw.brow[1] = p.bias + ((size_t)bh * p.Nq + r1) * p.Nk;
  }
  float s[NT][4];
  // running max (base 2) and exp-sum of the lane's two rows, then the
  // rows' max (0 for a fully masked row) and reciprocal sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float z0 = 0.0f, z1 = 0.0f, inv0 = 0.0f, inv1 = 0.0f;
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  unsigned long long seed = 0ull;
  if constexpr (TRAIN) {
    if (p.thresh) seed = *p.seed;
  }

  // step i < tiles: pass 1 over key tile i; then pass 2 over tile i - tiles
  for (int i = 0; i < 2 * tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();              // step i's tile has landed; step i - 1's stage is free
    if (i + 1 < 2 * tiles) {
      unsigned char* next = smem + ((i + 1) % LONG_STAGES) * STAGE;
      if (i + 1 < tiles)
        long_load_keys<D, false>(next, p, b, h, (i + 1) * LONG_TILE);
      else
        long_load_keys<D, true>(next, p, b, h, (i + 1 - tiles) * LONG_TILE);
    }
    cp_async_commit();
    if (!active) continue;
    if (i == 0) long_a_operand<D>(qa, Qs, lane);
    const bf16* Ks = reinterpret_cast<const bf16*>(smem + (i % LONG_STAGES) * STAGE);
    const bf16* Vs = Ks + LONG_TILE * KLD;
    const float* kbs = reinterpret_cast<const float*>(Vs + LONG_TILE * KLD);
    const bool pass1 = i < tiles;
    const int k0 = (pass1 ? i : i - tiles) * LONG_TILE;
    for (int c = 0; c < LONG_TILE && k0 + c < NKP; c += NT * 8) {
      attn_scores<D, NT>(s, qa, Ks, kbs, k0 + c, NKP, p, rw, lane, k0);
      if (pass1) {
        attn_stats_chunk<NT>(s, m0, m1, l0, l1);
      } else {
        attn_exp<NT>(s, z0, z1);
        attn_probs<TRAIN, NT>(s, k0 + c, NKP, inv0, inv1, p, seed, (unsigned)bh, r0, r1, t);
        attn_pv<D, NT>(o, s, Vs, c / 16, p.NK16 - k0 / 16, lane);
      }
    }
    if (i == tiles - 1) {
      attn_stats_join(m0, m1, l0, l1);
      z0 = m0 == -INFINITY ? 0.0f : m0;
      z1 = m1 == -INFINITY ? 0.0f : m1;
      inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
      inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
      if constexpr (TRAIN) attn_save_stats(p, (size_t)bh, r0, r1, m0, m1, inv0, inv1, t);
    }
  }
  if (active) attn_store<D, TRAIN>(o, p, Qs, b, h, q0, r0, r1, lane);
}

// 256 threads and two blocks an SM: up to 128 registers a thread.
template <int D>
__global__ void __launch_bounds__(LONG_MAX_WARPS * 32, 2) attn_long_kernel(AttnArgs p) {
  attn_long_body<D, false>(p);
}

template <int D>
__global__ void __launch_bounds__(LONG_MAX_WARPS * 32, 2) train_fwd_long_kernel(AttnArgs p) {
  attn_long_body<D, true>(p);
}

// The query-major backward with the keys and values streamed: pass 1
// delta = rowsum(dp * p), pass 2 ds = p * (dp - delta), dbias and
// dq += bf16(ds) . k, chunk for chunk kernels.cu's train_bwd_q_kernel in
// its two-pass form.
template <int D>
__global__ void __launch_bounds__(LONG_MAX_WARPS * 32, 2)
    train_bwd_q_long_kernel(AttnArgs p, BwdArgs w) {
  constexpr int KLD = D + 8;
  constexpr int NT = 2 * ATT_CH16;
  constexpr int STAGE = long_key_stage<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int NKP = p.NK16 * 16;
  const int tiles = (NKP + LONG_TILE - 1) / LONG_TILE;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the ring, then a query tile and a do tile [16][KLD] per warp
  bf16* Qs = reinterpret_cast<bf16*>(smem + LONG_STAGES * STAGE) + (size_t)warp * 32 * KLD;
  bf16* Gs = Qs + 16 * KLD;

  const long bh = blockIdx.x;
  const long b = bh / p.H;
  const int h = (int)(bh % p.H);
  const int q0 = (blockIdx.y * nwarps + warp) * 16;
  const bool active = q0 < p.Nq;
  const int r0 = q0 + g, r1 = q0 + g + 8;

  if (active) {
    long_load_rows<D>(Qs, p.q, p.in_dt, p.sqb, p.sqn, b, h, q0, p.Nq, lane);
    long_load_rows<D>(Gs, w.dout, w.do_dt, w.sdb, w.sdn, b, h, q0, p.Nq, lane);
  }
  long_load_keys<D, true>(smem, p, b, h, 0);
  cp_async_commit();

  unsigned qa[D / 16][4], da[D / 16][4];
  AttnRows rw;
  float* dbrow[2];
  float z0, z1, inv0, inv1;
  bwd_q_rows(rw, dbrow, z0, z1, inv0, inv1, p, w, (size_t)bh, r0, r1);
  const unsigned long long seed = p.thresh ? *p.seed : 0ull;
  float s[NT][4], dpv[NT][4];
  float delta0 = 0.0f, delta1 = 0.0f;
  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.0f;

  for (int i = 0; i < 2 * tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < 2 * tiles)
      long_load_keys<D, true>(smem + ((i + 1) % LONG_STAGES) * STAGE, p, b, h,
                              ((i + 1) % tiles) * LONG_TILE);
    cp_async_commit();
    if (!active) continue;
    if (i == 0) {
      long_a_operand<D>(qa, Qs, lane);
      long_a_operand<D>(da, Gs, lane);
    }
    const bf16* Ks = reinterpret_cast<const bf16*>(smem + (i % LONG_STAGES) * STAGE);
    const bf16* Vs = Ks + LONG_TILE * KLD;
    const float* kbs = reinterpret_cast<const float*>(Vs + LONG_TILE * KLD);
    const bool pass1 = i < tiles;
    const int k0 = (i % tiles) * LONG_TILE;
    for (int c = 0; c < LONG_TILE && k0 + c < NKP; c += NT * 8) {
      bwd_q_chunk<D, NT>(s, dpv, qa, da, Ks, Vs, kbs, k0 + c, NKP, p, rw, lane, z0, z1, inv0,
                         inv1, seed, (unsigned)bh, r0, r1, k0);
      if (pass1) {
        bwd_q_delta<NT>(s, dpv, delta0, delta1);
      } else {
        bwd_q_ds<NT>(s, dpv, delta0, delta1, k0 + c, dbrow, p, w, t);
        attn_pv<D, NT>(dq, s, Ks, c / 16, p.NK16 - k0 / 16, lane);   // dq += bf16(ds) . k
      }
    }
    if (i == tiles - 1) {
      delta0 = quad_sum(delta0);
      delta1 = quad_sum(delta1);
    }
  }
  if (active) bwd_q_store<D>(dq, delta0, delta1, w, p, b, h, r0, r1, t);
}

// Each query's (max in base 2, 1 / sum, delta, 0) of queries [q0, q0 +
// LONG_TILE) into a stage, zeros past Nq.
__device__ __forceinline__ void long_load_stats(float4* sts, const AttnArgs& p,
                                                const BwdArgs& w, size_t bh, int q0) {
  for (int i = threadIdx.x; i < LONG_TILE; i += blockDim.x) {
    float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + i < p.Nq) {
      const size_t row = bh * p.Nq + q0 + i;
      const float m = p.stats[row * 2] * LOG2E_F;
      st.x = m == -INFINITY ? 0.0f : m;
      st.y = p.stats[row * 2 + 1];
      st.z = w.delta[row];
    }
    sts[i] = st;
  }
}

// The key-major backward with the queries, do and their statistics
// streamed: kernels.cu's train_bwd_k_kernel over query tiles.
template <int D>
__global__ void __launch_bounds__(LONG_MAX_WARPS * 32, 2)
    train_bwd_k_long_kernel(AttnArgs p, BwdArgs w) {
  constexpr int KLD = D + 8;
  constexpr int STAGE = long_query_stage<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int NQP = w.NQ16 * 16;
  const int tiles = (NQP + LONG_TILE - 1) / LONG_TILE;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  // the ring, then a key tile and a value tile [16][KLD] per warp
  bf16* Kt = reinterpret_cast<bf16*>(smem + LONG_STAGES * STAGE) + (size_t)warp * 32 * KLD;
  bf16* Vt = Kt + 16 * KLD;

  const long bh = blockIdx.x;
  const long b = bh / p.H;
  const int h = (int)(bh % p.H);
  const int k0 = (blockIdx.y * nwarps + warp) * 16;
  const bool active = k0 < p.Nk;

  // a stage: q and do [LONG_TILE][KLD], then the statistics
  auto load = [&](int i) {
    unsigned char* st = smem + (i % LONG_STAGES) * STAGE;
    bf16* Qs = reinterpret_cast<bf16*>(st);
    bf16* Gs = Qs + LONG_TILE * KLD;
    const int first = i * LONG_TILE;
    for (int c = threadIdx.x; c < LONG_TILE * (D / 8); c += blockDim.x) {
      const int n = c / (D / 8), d8 = (c % (D / 8)) * 8, q = first + n;
      stage8(&Qs[n * KLD + d8], p.q, p.in_dt, b * p.sqb + (long)q * p.sqn + h * D + d8,
             q < p.Nq);
      stage8(&Gs[n * KLD + d8], w.dout, w.do_dt, b * w.sdb + (long)q * w.sdn + h * D + d8,
             q < p.Nq);
    }
    long_load_stats(reinterpret_cast<float4*>(Gs + LONG_TILE * KLD), p, w, (size_t)bh, first);
  };

  if (active) {
    long_load_rows<D>(Kt, p.k, p.in_dt, p.skb, p.skn, b, h, k0, p.Nk, lane);
    long_load_rows<D>(Vt, p.v, p.in_dt, p.svb, p.svn, b, h, k0, p.Nk, lane);
  }
  load(0);
  cp_async_commit();

  unsigned ka[D / 16][4], va[D / 16][4], cg = 0;
  int key[2] = {0, 0};
  float kadd[2] = {0.0f, 0.0f};
  const float* bias = p.bias ? p.bias + (size_t)bh * p.Nq * p.Nk : nullptr;
  const unsigned long long seed = p.thresh ? *p.seed : 0ull;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.0f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.0f;
  }

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < tiles) load(i + 1);
    cp_async_commit();
    if (!active) continue;
    if (i == 0) bwd_k_tile<D>(ka, va, key, kadd, cg, Kt, Vt, p, b, k0, lane);
    const bf16* Qs = reinterpret_cast<const bf16*>(smem + (i % LONG_STAGES) * STAGE);
    const bf16* Gs = Qs + LONG_TILE * KLD;
    const float4* sts = reinterpret_cast<const float4*>(Gs + LONG_TILE * KLD);
    const int first = i * LONG_TILE;
    for (int c = 0; c < LONG_TILE && first + c < NQP; c += BWD_KCH * 8)
      bwd_k_chunk<D>(dk, dv, ka, va, Qs, Gs, sts, first + c, first, NQP, p, bias, key, kadd,
                     seed, (unsigned)bh, cg, lane);
  }
  if (active) bwd_k_store<D>(dk, dv, w, p, b, h, key, t);
}

// ------------------------------------------------------------------ launch
// The plan (ops/kernels.py attention_plan / attention_bwd_plan with
// "long"): query (or key) tiles split over gridDim.y, warps a block, and
// the shared memory a block gets, checked here against the shapes.
// Shared memory a block needs: the ring, and beside it `per_warp` 16-row
// tiles a warp (the forward's query tile; q and do, or k and v, in the
// backward).
static size_t long_smem_need(int D, int warps, int per_warp, bool query_stage) {
  const size_t kld = D + 8;
  const size_t stage = 4 * LONG_TILE * kld + (query_stage ? 16 : 4) * LONG_TILE;
  return LONG_STAGES * stage + 32 * (size_t)per_warp * warps * kld;
}

static bool long_plan_ok(int split, int warps, long smem, long rows, size_t need) {
  return warps >= 1 && warps <= LONG_MAX_WARPS && split >= 1 && split <= 65535 &&
         (long)split * warps * 16 >= rows && smem >= (long)need && smem <= ATT_SMEM_LIMIT;
}

template <typename Kern, typename... Args>
static int launch_long(Kern kern, bool& configured, long blocks, int split, int warps,
                       long smem, cudaStream_t s, Args... args) {
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ATT_SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<dim3((unsigned)blocks, (unsigned)split), warps * 32, (size_t)smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int D, bool TRAIN>
static int launch_attn_long(const AttnArgs& p, int B, int split, int warps, long smem,
                            cudaStream_t s) {
  static bool configured = false;
  if (!long_plan_ok(split, warps, smem, p.Nq, long_smem_need(D, warps, 1, false)))
    return (int)cudaErrorInvalidValue;
  if constexpr (TRAIN)
    return launch_long(train_fwd_long_kernel<D>, configured, (long)B * p.H, split, warps,
                       smem, s, p);
  return launch_long(attn_long_kernel<D>, configured, (long)B * p.H, split, warps, smem, s,
                     p);
}

template <int D>
static int launch_bwd_long(const AttnArgs& p, const BwdArgs& w, int B, int qsplit, int qwarps,
                           long qsmem, int ksplit, int kwarps, long ksmem, cudaStream_t s) {
  static bool configured[2] = {false, false};
  if (!long_plan_ok(qsplit, qwarps, qsmem, p.Nq, long_smem_need(D, qwarps, 2, false)) ||
      !long_plan_ok(ksplit, kwarps, ksmem, p.Nk, long_smem_need(D, kwarps, 2, true)))
    return (int)cudaErrorInvalidValue;
  const int rc = launch_long(train_bwd_q_long_kernel<D>, configured[0], (long)B * p.H, qsplit,
                             qwarps, qsmem, s, p, w);
  if (rc != 0) return rc;
  return launch_long(train_bwd_k_long_kernel<D>, configured[1], (long)B * p.H, ksplit, kwarps,
                     ksmem, s, p, w);
}

extern "C" int ec_attention_long(const void* q, const void* k, const void* v, int in_dt,
                                 long sqb, long sqn, long skb, long skn, long svb, long svn,
                                 int B, int H, int D, int Nq, int Nk,
                                 const void* kvalid, long skvb, const void* bias, float scale,
                                 void* out, int out_dt, long sob, long son,
                                 int qsplit, int warps, long smem, void* stream) {
  AttnArgs p;
  if (!attn_args(p, q, k, v, in_dt, sqb, sqn, skb, skn, svb, svn, B, H, Nq, Nk, kvalid,
                 skvb, bias, scale, 0))
    return (int)cudaErrorInvalidValue;
  p.out = out; p.out_dt = out_dt; p.sob = sob; p.son = son;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_attn_long<32, false>(p, B, qsplit, warps, smem, s);
  if (D == 64) return launch_attn_long<64, false>(p, B, qsplit, warps, smem, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ec_attn_train_fwd_long(const void* q, const void* k, const void* v, int in_dt,
                                      long sqb, long sqn, long skb, long skn, long svb,
                                      long svn, int B, int H, int D, int Nq, int Nk,
                                      const void* kvalid, long skvb, const void* bias,
                                      float scale, const void* seed, unsigned thresh,
                                      float inv_keep, void* out, long sob, long son,
                                      void* stats, int qsplit, int warps, long smem,
                                      void* stream) {
  AttnArgs p;
  if (!attn_args(p, q, k, v, in_dt, sqb, sqn, skb, skn, svb, svn, B, H, Nq, Nk, kvalid,
                 skvb, bias, scale, 0) || (thresh && !seed) || !stats)
    return (int)cudaErrorInvalidValue;
  p.seed = static_cast<const unsigned long long*>(seed);
  p.thresh = thresh; p.inv_keep = inv_keep;
  p.stats = static_cast<float*>(stats);
  p.out = out; p.out_dt = DT_F32; p.sob = sob; p.son = son;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_attn_long<32, true>(p, B, qsplit, warps, smem, s);
  if (D == 64) return launch_attn_long<64, true>(p, B, qsplit, warps, smem, s);
  return (int)cudaErrorInvalidValue;
}

// dq, dk, dv: fp32 [B, N, H * D], contiguous; dbias [B, H, Nq, Nk] or
// null; delta: fp32 scratch [B * H, Nq]; kvalid: the forward's bool mask.
extern "C" int ec_attn_train_bwd_long(const void* q, const void* k, const void* v, int in_dt,
                                      long sqb, long sqn, long skb, long skn, long svb,
                                      long svn, int B, int H, int D, int Nq, int Nk,
                                      const void* kvalid, long skvb, const void* bias,
                                      float scale, const void* seed, unsigned thresh,
                                      float inv_keep, const void* dout, int do_dt, long sdb,
                                      long sdn, const void* stats, void* dq, void* dk,
                                      void* dv, void* dbias, void* delta,
                                      int qsplit, int qwarps, long qsmem,
                                      int ksplit, int kwarps, long ksmem, void* stream) {
  AttnArgs p;
  if (!attn_args(p, q, k, v, in_dt, sqb, sqn, skb, skn, svb, svn, B, H, Nq, Nk, kvalid,
                 skvb, bias, scale, 0) || (thresh && !seed) || !stats || !dout || !dq ||
      !dk || !dv || !delta)
    return (int)cudaErrorInvalidValue;
  p.seed = static_cast<const unsigned long long*>(seed);
  p.thresh = thresh; p.inv_keep = inv_keep;
  p.stats = static_cast<float*>(const_cast<void*>(stats));
  BwdArgs w;
  w.dout = dout; w.do_dt = do_dt; w.sdb = sdb; w.sdn = sdn;
  w.dq = static_cast<float*>(dq); w.dk = static_cast<float*>(dk);
  w.dv = static_cast<float*>(dv); w.dbias = static_cast<float*>(dbias);
  w.delta = static_cast<float*>(delta);
  w.NQ16 = (Nq + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32)
    return launch_bwd_long<32>(p, w, B, qsplit, qwarps, qsmem, ksplit, kwarps, ksmem, s);
  if (D == 64)
    return launch_bwd_long<64>(p, w, B, qsplit, qwarps, qsmem, ksplit, kwarps, ksmem, s);
  return (int)cudaErrorInvalidValue;
}
