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
// The model trains rows above 512 tokens on its fp32 plain path, as the
// JAX module does, so the training kernels run on direct calls of
// flash_mha_train alone.
//
// What bounds them on this card: at 518 px the ViT's [B, 1370, 6 x 64]
// and the joint encoder's [B, 1469, 8 x 32] make 4 * Nq * Nk * D
// operations a head against 8 * N * D bytes, some 340 operations a byte,
// and one 2^x a score on the special-function unit (16 a clock an SM,
// against 4 * D tensor-core operations a score at 1024 a clock an SM):
// at D 64 the exponentials take as long as the products, at D 32 twice as
// long. Memory does not bound them.
//
// attn_long_kernel (the eval forward) is one pass over the keys, the
// FlashAttention-2/3 form: each row keeps a running max (base 2, log2(e)
// * scale folded into the scores) and a running sum in fp32; a key tile's
// p = 2^(s - running max) is rounded to bf16 as the A operand of P.V, the
// output accumulator is multiplied by 2^(old max - new max) when the max
// grows, and divided by the sum once at the end, before the single bf16
// rounding of the output. So each score is formed once and exponentiated
// once (the two-pass form did both twice). It gives up the TPU kernel's
// rounding point (flash_attention.py:50: the normalised p rounded to
// bf16): here the unnormalised p is rounded, and the sum is of the fp32
// p. A probability's rounding error is the same relative 2^-9 either way,
// but different probabilities round the other way, so the output differs
// from the plain version by about a bf16 ulp of its largest values (the
// card's check: 1e-2 + 2^-6 |ref|, the bound of every kernel op; the CPU
// tests hold an emulation of this order to one bf16 ulp of the largest
// output against the plain version and JAX). Design:
//   * a block is persistent (one an SM) and walks items of 128 query rows
//     of one (batch, head), block x taking items x, x + gridDim.x, ...: the
//     items in flight together are a few heads', whose K and V come from
//     L2; 384 threads: consumer warpgroups 0 and 1 (64 rows each), the
//     producer warpgroup 2, whose one working warp issues every TMA copy;
//     setmaxnreg gives the consumers 232 registers and the producer 40;
//   * Q (once an item, two slots so the next item's lands early) and the
//     K and V tiles of 128 keys (a ring of AL_STAGES stages with full and
//     empty mbarriers) arrive by TMA from maps over the [B, N, H * D] views
//     with their own strides (boxes of [1, 128 rows, D]), 128-byte
//     swizzled at D 64 and 64-byte swizzled at D 32, whose rows are 64
//     bytes; rows past N read as zeros. For a tile with a key mask, or
//     with keys past Nk, the producer warp writes the tile's additive mask
//     (0 or -inf) beside it;
//   * S = Q K^T is wgmma m64n128k16 from shared memory (K [keys][D] is
//     K-major, as B wants it); p, packed to bf16 in registers, is the A
//     operand of O += P V (wgmma m64nDk16, V MN-major through the
//     descriptor's transpose bit): the m64n128 accumulator's fragment is
//     the A fragment of the next product, so p never reaches shared
//     memory. 64 registers a thread for S, 32 (D 64) or 16 for O, 32 for P;
//   * the exponentials overlap the products within a warpgroup: S_j is
//     issued, then O += P_{j-1} V_{j-1} behind it, and the softmax of S_j
//     runs while the second product does; the first tile's S is issued
//     alone, outside the loop, since ptxas serialises products that sit
//     in branches of their own. The O rescale waits for that product. The
//     warp scheduler interleaves the two warpgroups besides: an explicit
//     ping-pong on named barriers (FlashAttention-3's) was tried and
//     dropped (measured on the H100: 3.562 against 3.599 ms at the ViT's
//     query pass, 6.438 against 6.301 at the joint encoder's). So was the
//     other overlap, S_{j+1} issued before the softmax of S_j into a
//     second score buffer: its 64 copies a tile and spills cost more than
//     it hid (4.160 against 3.632 ms, 6.456 against 6.301);
//   * the softmax is a branch-free run over a tile's 64 values a thread
//     in one of four forms, chosen once a tile (key mask or ragged tile,
//     bias, both, neither): with the key-mask and bias tests inside the
//     loop it cost twice the products (7.10 ms at the ViT's query pass,
//     3.59 branch-free). Unmasked tiles take the max on the raw products
//     and p = 2^(fma(s, log2(e) scale, -max)); the scale must be positive;
//   * a row's output depends on its own query, the keys and the mask
//     alone: the keys are met in one fixed order, each row keeps its own
//     max and sum (the quad's four lanes join them by shuffles), and a
//     row's products do not depend on where in a tile it sits, so neither
//     its batch position, the 128-row split nor Nq change its bits.
// ptxas gives it 168 registers (the cap of a 384-thread block, before
// setmaxnreg) and no spills; kernels.ptxas_usage("attn_long_kernel") reads
// them, chip_smoke.py's [long] phase prints them. A barrier wait that
// never completes traps (al_wait) rather than hang the card.
//
// The training kernels are the first, simple design: the two-pass form of
// kernels.cu, chunk for chunk (the helpers of attention.cuh): the scores
// of a warp's 16-row query tile are formed in registers over 32-key
// chunks, pass 1 keeps a per-lane running max and exp-sum in fp32 and
// joins them over the quad, pass 2 recomputes the scores, normalises by
// the final sum before the rounding to bf16 and accumulates P.V in fp32:
// flash_attention.py:132's rounding points, so at a shape the resident
// kernels also take these give the same bits. Dropout bits depend on
// (row, key / 4, batch * H + head) alone, so the mask is
// dropout_mask(seed)'s whatever the tiling. A block of up to
// LONG_MAX_WARPS warps (a 16-row tile each) walks the keys in tiles of
// LONG_TILE through a ring of LONG_STAGES stages filled by cp.async, the
// next tile landing under the current one's products; every warp of the
// block reads the tile from shared memory, so a key is fetched from L2
// once per block and pass. The products are mma.sync m16n8k16 tiles as in
// kernels.cu. Hazards: keys past Nk are zero K and V rows with a -inf
// mask; 16-key blocks past the padded length are skipped; a warp past Nq
// loads and waits with the block but multiplies nothing.

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
__global__ void __launch_bounds__(LONG_MAX_WARPS * 32, 2) train_fwd_long_kernel(AttnArgs p) {
  attn_long_body<D, true>(p);
}

// ------------------------------------------------------- the eval forward
// attn_long_kernel: one pass over the keys with the online softmax, TMA
// loads on mbarriers and wgmma for both products (the design note is at
// the top of this file).
#define AL_ROWS 128        // query rows of an item: two consumer warpgroups of 64
#define AL_KEYS 128        // keys of a streamed tile
#define AL_STAGES 4        // key / value tiles in the ring
#define AL_THREADS 384     // consumer warpgroups 0 and 1, the producer warpgroup 2

// Shared memory of a block: two query slots, the ring (K, V and the
// additive key mask of a tile), the barriers; rows of 2 * D bytes, 128-
// (D 64) or 64-byte (D 32) swizzled, every tile on 1024 bytes.
template <int D>
struct AlTile {
  static constexpr int ROW = 2 * D;
  static constexpr int Q = AL_ROWS * ROW;
  static constexpr int KV = AL_KEYS * ROW;
  static constexpr int STAGE = 2 * KV + 1024;
  static constexpr int SMEM = 1024 + 2 * Q + AL_STAGES * STAGE + 128;
};
static_assert(AlTile<64>::SMEM <= ATT_SMEM_LIMIT, "attn_long_kernel's tiles exceed a block");

struct AlArgs {
  const unsigned char* kvalid; long skvb;   // bool [B, Nk], or null
  const float* bias;                        // [B, H, Nq, Nk], or null
  float scale;
  void* out; int out_dt; long sob, son;
  int H, Nq, Nk, qtiles, ktiles, items;
  int bq, bk, bv;                           // 1: the operand's map has a batch axis
};

// A wgmma descriptor of a tile whose rows are 2 * D bytes (the 8-row
// groups 16 * D bytes apart) in the swizzle TMA wrote it with: 128 bytes
// (layout 1) for D 64, 64 bytes (layout 2) for D 32. K-major (Q, K): the
// leading offset is unused; MN-major (V, rows are keys): the leading
// offset would be the next D columns, which no product reaches.
template <int D>
__device__ __forceinline__ uint64_t al_desc(unsigned addr, unsigned lead) {
  constexpr uint64_t sbo = 16 * D, layout = D == 64 ? 1 : 2;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lead >> 4) << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}

// O += P . V_tile: the 8 16-key steps of a tile, P in registers.
template <int D>
__device__ __forceinline__ void al_pv(float (&o)[D / 2], const unsigned (&pf)[AL_KEYS / 16][4],
                                      unsigned vb) {
#pragma unroll
  for (int kk = 0; kk < AL_KEYS / 16; ++kk) {
    if constexpr (D == 64)
      wgmma_rs_m64n64k16<1>(o, pf[kk], al_desc<D>(vb + kk * 16 * 2 * D, AlTile<D>::KV));
    else
      wgmma_rs_m64n32k16<1>(o, pf[kk], al_desc<D>(vb + kk * 16 * 2 * D, AlTile<D>::KV));
  }
}

// S = Q . K_tile^T (m64n128, overwriting s): the D / 16 16-column steps.
template <int D>
__device__ __forceinline__ void al_scores(float (&s)[64], unsigned qa, unsigned kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16<0>(s, al_desc<D>(qa + kk * 32, 16), al_desc<D>(kb + kk * 32, 16), kk > 0);
}

// The bias of a row at keys k and k + 1 (0 past Nk).
__device__ __forceinline__ float2 al_bias2(const float* row, int k, int nk, bool vec) {
  if (vec && k + 1 < nk) return *reinterpret_cast<const float2*>(row + k);
  return make_float2(k < nk ? row[k] : 0.0f, k + 1 < nk ? row[k + 1] : 0.0f);
}

// One key tile's scores s (the wgmma accumulator of m64n128: s[4 J + 2 rh
// + e] is row g + 8 rh, key k0 + 8 J + 2 t + e) turned into 2^(score in
// base 2 - running max) in place: the running max m and sum l of the
// thread's two rows move on, and a[rh] is the factor that brings the
// output so far to the new max. MASK: the stage's additive key mask kbs
// applies (a key mask, or keys past Nk in the tile); BIAS: the rows' bias
// does. Each form is a branch-free run over the 64 values (a branch
// inside it cut the run into blocks the compiler could not interleave).
// With neither (every tile of an unmasked row but its last), the max is
// taken on the raw products (sc2 > 0) and each p is one fma and one 2^x.
template <bool MASK, bool BIAS>
__device__ __forceinline__ void al_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                           float (&a)[2], float sc2, const float* kbs,
                                           const float* const (&brow)[2], bool bvec, int k0,
                                           int nk, int t) {
  constexpr bool ADD = MASK || BIAS;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int J = 0; J < AL_KEYS / 8; ++J) {
    const int c = 8 * J + 2 * t;
    float2 add = make_float2(0.0f, 0.0f);
    if constexpr (MASK) add = *reinterpret_cast<const float2*>(kbs + c);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float v0 = s[4 * J + 2 * rh], v1 = s[4 * J + 2 * rh + 1];
      if constexpr (ADD) {
        float2 ad = add;
        if constexpr (BIAS) {
          if (brow[rh]) {
            const float2 bv = al_bias2(brow[rh], k0 + c, nk, bvec);
            ad.x = fmaf(bv.x, LOG2E_F, ad.x);
            ad.y = fmaf(bv.y, LOG2E_F, ad.y);
          }
        }
        v0 = fmaf(v0, sc2, ad.x);
        v1 = fmaf(v1, sc2, ad.y);
        s[4 * J + 2 * rh] = v0;
        s[4 * J + 2 * rh + 1] = v1;
      }
      mx[rh] = fmaxf(mx[rh], fmaxf(v0, v1));
    }
  }
  float z[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const float tm = ADD ? quad_max(mx[rh]) : quad_max(mx[rh]) * sc2;
    const float mn = fmaxf(m[rh], tm);
    z[rh] = mn == -INFINITY ? 0.0f : mn;      // a row masked so far: every 2^-inf is 0
    a[rh] = ex2(m[rh] - z[rh]);
    m[rh] = mn;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int J = 0; J < AL_KEYS / 8; ++J)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ADD ? s[4 * J + e] - z[e >> 1] : fmaf(s[4 * J + e], sc2, -z[e >> 1]);
      const float v = ex2(x);
      s[4 * J + e] = v;
      sum[e >> 1] += v;
    }
  l[0] = l[0] * a[0] + sum[0];
  l[1] = l[1] * a[1] + sum[1];
}

// mbar_wait that gives up: a block whose copies never land (a map the
// hardware refused at run time) traps, so the launch fails and does not
// hang the card.
__device__ __forceinline__ void al_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  for (unsigned i = 0;; ++i) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (i == (1u << 28)) __trap();
  }
}

// map_q / map_k / map_v: the [B, N, H * D] bf16 views in boxes of
// [1, 128 rows, D]. Items: (batch * H + head) * qtiles + query tile, block
// x taking items x, x + gridDim.x, ...
template <int D>
__global__ void __launch_bounds__(AL_THREADS, 1)
    attn_long_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, AlArgs p) {
  using T = AlTile<D>;
  extern __shared__ unsigned char al_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(al_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = base + 2 * T::Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + AL_STAGES * T::STAGE);
  uint64_t* empty = full + AL_STAGES;
  uint64_t* q_full = empty + AL_STAGES;
  uint64_t* q_empty = q_full + 2;
  const int nitems = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < AL_STAGES; ++s) {
      mbar_init(&full[s], 32);      // the producer warp's lanes (lane 0's with the bytes)
      mbar_init(&empty[s], 8);      // one arrive per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;

  if (wg == 2) {
    // the producer: one warp issues every copy and writes the key mask
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 0) return;
    unsigned it = 0;
    for (int n = 0; n < nitems; ++n) {
      const int item = (int)blockIdx.x + n * (int)gridDim.x;
      const int bh = item / p.qtiles, q0 = (item - bh * p.qtiles) * AL_ROWS;
      const int b = bh / p.H, h = bh - b * p.H;
      const int slot = n & 1;
      al_wait(&q_empty[slot], ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&q_full[slot], T::Q);
        tma_load_3d(base + slot * T::Q, &map_q, &q_full[slot], h * D, q0, b * p.bq);
      }
      for (int j = 0; j < p.ktiles; ++j, ++it) {
        const int s = it % AL_STAGES;
        al_wait(&empty[s], ((it / AL_STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * T::STAGE;
        if (p.kvalid || (j + 1) * AL_KEYS > p.Nk) {
          float* kbs = reinterpret_cast<float*>(st + 2 * T::KV);
#pragma unroll
          for (int e = 0; e < AL_KEYS / 32; ++e) {
            const int key = j * AL_KEYS + lane * (AL_KEYS / 32) + e;
            const bool on = key < p.Nk && (!p.kvalid || p.kvalid[b * p.skvb + key] != 0);
            kbs[lane * (AL_KEYS / 32) + e] = on ? 0.0f : -INFINITY;
          }
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * T::KV);
          tma_load_3d(st, &map_k, &full[s], h * D, j * AL_KEYS, b * p.bk);
          tma_load_3d(st + T::KV, &map_v, &full[s], h * D, j * AL_KEYS, b * p.bv);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of an item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = lane >> 2, t = lane & 3;
  const bool bvec = p.Nk % 2 == 0 && (reinterpret_cast<uintptr_t>(p.bias) & 7) == 0;
  const float sc2 = p.scale * LOG2E_F;
  const bool pair = p.out_dt == DT_BF16 &&
                    ((reinterpret_cast<uintptr_t>(p.out) | (uintptr_t)(p.sob * 2) |
                      (uintptr_t)(p.son * 2)) & 3) == 0;
  unsigned it = 0;
#pragma unroll 1
  for (int n = 0; n < nitems; ++n) {
    const int item = (int)blockIdx.x + n * (int)gridDim.x;
    const int bh = item / p.qtiles, q0 = (item - bh * p.qtiles) * AL_ROWS;
    const int b = bh / p.H, h = bh - b * p.H;
    const int slot = n & 1;
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const float* brow[2] = {nullptr, nullptr};
    if (p.bias) {
      if (r0 < p.Nq) brow[0] = p.bias + ((size_t)bh * p.Nq + r0) * p.Nk;
      if (r1 < p.Nq) brow[1] = p.bias + ((size_t)bh * p.Nq + r1) * p.Nk;
    }
    al_wait(&q_full[slot], (n >> 1) & 1);
    const unsigned qa = smem_u32(base + slot * T::Q + wg * 64 * T::ROW);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, a[2];
    float o[D / 2];
    unsigned pf[AL_KEYS / 16][4];
    // the next key tile of the ring: its stage, once it has landed
    auto take = [&]() {
      const int s_i = it % AL_STAGES;
      al_wait(&full[s_i], (it / AL_STAGES) & 1);
      ++it;
      return s_i;
    };
    // S_j's softmax and p packed as the A fragments of P . V
    auto soft = [&](float (&s)[64], int s_i, int j) {
      reg_fence(s);
      if (j == p.ktiles - 1 && lane == 0) mbar_arrive(&q_empty[slot]);   // Q read
      const float* kbs = reinterpret_cast<const float*>(ring + s_i * T::STAGE + 2 * T::KV);
      const int k0 = j * AL_KEYS;
      if (p.kvalid || k0 + AL_KEYS > p.Nk) {
        if (p.bias)
          al_softmax<true, true>(s, m, l, a, sc2, kbs, brow, bvec, k0, p.Nk, t);
        else
          al_softmax<true, false>(s, m, l, a, sc2, kbs, brow, bvec, k0, p.Nk, t);
      } else if (p.bias) {
        al_softmax<false, true>(s, m, l, a, sc2, kbs, brow, bvec, k0, p.Nk, t);
      } else {
        al_softmax<false, false>(s, m, l, a, sc2, kbs, brow, bvec, k0, p.Nk, t);
      }
    };
    auto pack = [&](const float (&s)[64]) {
#pragma unroll
      for (int kk = 0; kk < AL_KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };
    // tile 0: S_0 alone (no branch holds a product: ptxas serialises
    // products in branches of their own)
    int prev = take();
    {
      float s[64];
      wg_fence();
      al_scores<D>(s, qa, smem_u32(ring + prev * T::STAGE));
      wg_commit();
      wg_wait<0>();
      soft(s, prev, 0);
      acc_zero(o);
      pack(s);
    }
#pragma unroll 1
    for (int j = 1; j < p.ktiles; ++j) {
      const int s_i = take();
      float s[64];
      reg_fence(o);
      reg_fence(pf);
      wg_fence();
      // S_j = Q K_j^T, then O += P_{j-1} V_{j-1} behind it: the softmax of
      // S_j runs while the second product does
      al_scores<D>(s, qa, smem_u32(ring + s_i * T::STAGE));
      wg_commit();
      al_pv<D>(o, pf, smem_u32(ring + prev * T::STAGE + T::KV));
      wg_commit();
      wg_wait<1>();
      soft(s, s_i, j);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
      if (lane == 0) mbar_arrive(&empty[prev]);   // K_{j-1} and V_{j-1} read
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= a[(i >> 1) & 1];
      pack(s);
      prev = s_i;
    }
    reg_fence(o);
    reg_fence(pf);
    wg_fence();
    al_pv<D>(o, pf, smem_u32(ring + prev * T::STAGE + T::KV));
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // O / sum, rounded once to bf16 (0 for a fully masked row)
    float inv[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float tot = quad_sum(l[rh]);
      inv[rh] = tot > 0.0f ? 1.0f / tot : 0.0f;
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = rh ? r1 : r0;
      if (r >= p.Nq) continue;
      const long row = (long)b * p.sob + (long)r * p.son + h * D;
#pragma unroll
      for (int J = 0; J < D / 8; ++J) {
        const float y0 = o[4 * J + 2 * rh] * inv[rh], y1 = o[4 * J + 2 * rh + 1] * inv[rh];
        const long off = row + 8 * J + 2 * t;
        if (pair) {
          *reinterpret_cast<unsigned*>(static_cast<bf16*>(p.out) + off) = pack_bf16(y0, y1);
        } else {
          st_val(p.out, p.out_dt, off, __bfloat162float(__float2bfloat16(y0)));
          st_val(p.out, p.out_dt, off + 1, __bfloat162float(__float2bfloat16(y1)));
        }
      }
    }
  }
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

template <int D>
static int launch_train_fwd_long(const AttnArgs& p, int B, int split, int warps, long smem,
                                 cudaStream_t s) {
  static bool configured = false;
  if (!long_plan_ok(split, warps, smem, p.Nq, long_smem_need(D, warps, 1, false)))
    return (int)cudaErrorInvalidValue;
  return launch_long(train_fwd_long_kernel<D>, configured, (long)B * p.H, split, warps, smem,
                     s, p);
}

// A [B, N, H * D] bf16 view (row stride ld, batch stride sb; 0: one
// shared by the batch) as a map of boxes [1, AL_ROWS rows, D] in the
// swizzle of attn_long_kernel's tiles; rows past N read as zeros. `has_b`:
// the map has the batch axis (else the kernel asks for batch 0).
static bool al_map(CUtensorMap* map, const void* ptr, int D, long inner, long rows, long ld,
                   long sb, int batch, int& has_b) {
  TensorMapEncodeFn encode = tensor_map_encoder();
  has_b = batch > 1 && sb != 0;
  if (!encode || (reinterpret_cast<uintptr_t>(ptr) & 15) || ld % 8 || (has_b && sb % 8))
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)(has_b ? batch : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)(has_b ? sb : rows * ld) * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, AL_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The persistent grid: one block an SM at most, over the items.
static int al_grid(long items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms > 0 ? (int)(items < sms ? items : sms) : 0;
}

template <int D>
static int launch_attn_long(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                            const AlArgs& a, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attn_long_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         AlTile<D>::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int grid = al_grid(a.items);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  attn_long_kernel<D><<<grid, AL_THREADS, AlTile<D>::SMEM, s>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
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
  // the plan (ops/kernels.py attention_plan, eval): 128-row query tiles,
  // the block's warps and shared memory
  const int qtiles = (Nq + AL_ROWS - 1) / AL_ROWS;
  const long need = D == 64 ? AlTile<64>::SMEM : AlTile<32>::SMEM;
  if ((D != 32 && D != 64) || in_dt != DT_BF16 || B < 1 || H < 1 || Nq < 1 || Nk < 1 ||
      !q || !k || !v || !out || !(scale > 0.0f) || qsplit != qtiles ||
      warps * 32 != AL_THREADS || smem != need)
    return (int)cudaErrorInvalidValue;
  AlArgs a;
  a.kvalid = static_cast<const unsigned char*>(kvalid); a.skvb = skvb;
  a.bias = static_cast<const float*>(bias); a.scale = scale;
  a.out = out; a.out_dt = out_dt; a.sob = sob; a.son = son;
  a.H = H; a.Nq = Nq; a.Nk = Nk; a.qtiles = qtiles;
  a.ktiles = (Nk + AL_KEYS - 1) / AL_KEYS;
  const long items = (long)B * H * qtiles;
  if (items > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  CUtensorMap mq, mk, mv;
  const long c = (long)H * D;
  if (!al_map(&mq, q, D, c, Nq, sqn, sqb, B, a.bq) || !al_map(&mk, k, D, c, Nk, skn, skb, B, a.bk) ||
      !al_map(&mv, v, D, c, Nk, svn, svb, B, a.bv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_attn_long<64>(mq, mk, mv, a, s) : launch_attn_long<32>(mq, mk, mv, a, s);
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
  if (D == 32) return launch_train_fwd_long<32>(p, B, qsplit, warps, smem, s);
  if (D == 64) return launch_train_fwd_long<64>(p, B, qsplit, warps, smem, s);
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
