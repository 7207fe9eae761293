// Attention over any number of keys (and queries): the attention kernels
// with the keys, or in the key-major backward the queries, streamed
// through shared memory in tiles instead of held whole. They take what the
// TPU kernels take at any length (edgecape_tpu/ops/flash_attention.py
// flash_mha, which pads Nk up with no cap, and the training pair
// _flash_train_fwd / _flash_train_bwd; the attention inside
// fused_vit_block, fused_encoder, fused_decoder and fused_attn_block),
// where kernels.cu's hold a head's keys and values in 4 * Nk * (D + 8)
// bytes of shared memory and so stop at 512 keys (ATT_MAX_KEYS), and the
// ViT attention kernel keeps a 272-key score row in registers:
//   * attn_long_kernel: the eval forward, head dim 32, 64 or 128 (head
//     dims 1-128 run at the first of them at or above, zero-padded), any
//     Nq and Nk >= 1, with the key mask and an fp32 [B, H, Nq, Nk] bias;
//   * train_fwd_long_kernel: the same body with Philox dropout on the
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
// flash_mha_train alone. At head dim 128 the resident kernels of
// kernels.cu hold up to 416 keys (their backward fewer); every longer row
// at that head dim takes these kernels (ops/kernels.py attention_plan /
// attention_bwd_plan).
//
// Head dim 128 changes three things (AlOperand, AlTile, BwTile): a row of
// 256 bytes is wider than the 128-byte swizzle span, so each operand tile
// lies in two slabs of 64 columns (two TMA boxes, al_load), which wgmma
// reads as two atoms (al_kstep for K-major Q and K, the descriptor's
// leading offset for MN-major V, Q and do); the forward's ring holds two
// stages of 65 KB instead of four, and the backward keeps one item slot
// (64 KB) beside its four-stage ring; the key-major backward, whose dK
// and dV accumulators take 128 registers a thread, waits for its dK / dV
// products before it issues the next tile's S^T and dP^T.
//
// What bounds them on this card: at 518 px the ViT's [B, 1370, 6 x 64]
// and the joint encoder's [B, 1469, 8 x 32] make 4 * Nq * Nk * D
// operations a head against 8 * N * D bytes, some 340 operations a byte,
// and one 2^x a score on the special-function unit (16 a clock an SM,
// against 4 * D tensor-core operations a score at 1024 a clock an SM):
// at D 64 the exponentials take as long as the products, at D 32 twice as
// long. Memory does not bound them. The backward forms each score's
// probability once in each of its two kernels (2 exponentials, 7 tile
// products: S and dP in both, dq, dk, dv); dropout adds a Philox-4x32-10
// call (ten rounds of two 32-bit multiplies) for every 4 scores a kernel.
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
//     K and V tiles of 128 keys (a ring of AlTile::STAGES stages, 4 or 2
//     at D 128, with full and empty mbarriers) arrive by TMA from maps
//     over the [B, N, H * D] views with their own strides (boxes of [1,
//     128 rows, min(D, 64)]), 128-byte swizzled at D 64 and 128 and
//     64-byte swizzled at D 32, whose rows are 64 bytes; rows past N read
//     as zeros. For a tile with a key mask, or
//     with keys past Nk, the producer warp writes the tile's additive mask
//     (0 or -inf) beside it;
//   * S = Q K^T is wgmma m64n128k16 from shared memory (K [keys][D] is
//     K-major, as B wants it); p, packed to bf16 in registers, is the A
//     operand of O += P V (wgmma m64nDk16, V MN-major through the
//     descriptor's transpose bit): the m64n128 accumulator's fragment is
//     the A fragment of the next product, so p never reaches shared
//     memory. 64 registers a thread for S, 64 (D 128), 32 (D 64) or 16
//     for O, 32 for P;
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
// train_fwd_long_kernel is attn_long_kernel's body (attn_long_body with
// TRAIN) with three additions: dropout zeroes the dropped p of a tile
// after its softmax and before the pack, so the running sum stays over the
// undropped p and only P.V sees the mask; the output is stored in fp32,
// times 1 / sum and 1 / (1 - rate) (the keep factor applied once, at the
// end); and each row's final max (in base e) and 1 / sum go to `stats`.
// Its rounding points are the eval kernel's (the unnormalised p rounded
// to bf16 for P.V), not the resident two-pass kernels'.
//
// The backward is two deterministic kernels, each with the eval kernel's
// shape (persistent 384-thread blocks, one producer warp issuing every
// TMA copy through a full / empty mbarrier ring, two consumer warpgroups
// of 64 rows, wgmma for every product) and no atomics: FlashAttention-3's
// single kernel adds dq with fp32 atomics, whose order, and so whose
// bits, change from call to call, and the checks hold two calls to the
// same bits. Both recompute p = 2^(s log2(e) scale + mask + log2(e) bias
// - max) / sum from the forward's statistics, so neither keeps a running
// max, and neither walks its stream twice: delta = rowsum(dp * p) is
// formed up front as rowsum(bf16(do) * O), O the forward's fp32 output
// (FlashAttention-2/3's preprocessing; the two are equal in exact
// arithmetic with dropout too, since O = sum p * keep / (1 - rate) * v):
//   * train_bwd_q_long_kernel: items of 128 query rows; Q and do (bf16)
//     arrive once an item, K and V tiles of 64 keys stream through the
//     ring (with the additive key mask beside a masked or ragged tile). In
//     its prologue a consumer forms its rows' delta from O and do in
//     device memory and writes it to the scratch the key-major kernel
//     reads. Per tile, S = Q K^T and dP = do V^T (wgmma m64n64k16 from
//     shared memory), then ds = p (dp keep / (1 - rate) - delta), stored
//     as dbias straight from registers (each quad writes 8 neighbouring
//     keys of a row), and dq += bf16(ds) K with ds as the register A
//     operand and K MN-major through the transpose bit; dq is scaled and
//     stored once. The dq product of tile j runs behind the S and dP
//     products of tile j + 1;
//   * train_bwd_k_long_kernel: items of 128 keys; K and V arrive once an
//     item, Q and do tiles of 64 queries stream with each query's (max in
//     base 2, 1 / sum, delta), which the producer warp writes beside the
//     tile (zeros past Nq, so those queries' p is 0). Per tile, S^T = K
//     Q^T and dP^T = V do^T, then p^T and ds^T, and dV += bf16(keep p^T /
//     (1 - rate)) do, dK += bf16(ds^T) Q with the accumulator fragments as
//     the A operands (64-query tiles: S^T, dP^T, dK, dV and the two packed
//     operands take some 160 registers a thread, where 128-query tiles
//     would need 256); dK is multiplied by the scale once, at the store.
// Rounding points: q, k, v and do are bf16 operands (do rounded once by
// the wrapper, as the TPU kernel casts it), S, dP and the gradients fp32,
// p keep / (1 - rate) and ds rounded to bf16 only as the A operands of
// the dv, dk and dq products, as in the plain version. delta from O makes
// ds differ from the plain version's (which sums dp p over fp32 p) by p
// times the rounding of O's probabilities: where a row's probability sits
// on a few keys, and many rows share them, the differences add up in
// those keys' dk (measured, a CPU emulation at 1469 queries with 3 valid
// keys: up to 0.0087 past the bound 1e-2 + 2^-6 |dk| of the checks; with
// a quarter of the keys masked, 4e-4 of differences, far inside it). The
// probability formula is one branch-free form a tile (or an item, in the
// key-major kernel), as in the forward.
// Dropout bits depend on (row, key / 4, batch * H + head) alone
// (dropout_bits), so the mask is dropout_mask(seed)'s: in the wgmma
// accumulator layout a lane holds keys 8 J + 2 t and + 1 of rows g and g
// + 8, so lanes t and t ^ 1 need the same Philox call for a row; each
// makes it for one of the two rows and the halves are swapped by a
// shuffle (keep_rows: one call for 4 scores). In the key-major kernel a
// lane holds keys g and g + 8 (rows of the accumulator) of queries 8 J +
// 2 t and + 1, so the four lanes g = 4 a .. 4 a + 3 share each call; each
// makes a quarter and three shuffles deal out the bits (keep_cols).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attention.cuh"

// ------------------------------------------------------------ the forward
// attn_long_kernel and train_fwd_long_kernel: one pass over the keys with
// the online softmax, TMA loads on mbarriers and wgmma for both products.
#define AL_ROWS 128        // query rows of an item: two consumer warpgroups of 64
#define AL_KEYS 128        // keys of a streamed tile
#define AL_THREADS 384     // consumer warpgroups 0 and 1, the producer warpgroup 2

// How a [rows x D] bf16 operand lies in shared memory: in SLABS slabs of
// 64 columns (one at D 32 and 64), each slab rows of SW bytes swizzled
// over SW bytes (64 at D 32, 128 above), the slabs rows * SW bytes apart.
// A row of D 128 (256 bytes) is wider than the 128-byte swizzle span, so
// TMA writes its two halves as two boxes of 64 columns and wgmma reads
// them as two atoms: a K-major operand's 16-column steps 4-7 start in the
// second slab, an MN-major one's N columns reach it by the descriptor's
// leading offset.
template <int D>
struct AlOperand {
  static constexpr int SW = D < 64 ? 2 * D : 128;
  static constexpr int SLABS = D <= 64 ? 1 : D / 64;
};

// The forward's ring: stages of K, V and the additive key mask, two query
// slots. At D 128 a stage takes 65 KB, so the ring holds two (four take
// 332,928 bytes, three with one query slot 1,152 more than a block has).
template <int D>
struct AlTile {
  static constexpr int ROW = 2 * D;
  static constexpr int Q = AL_ROWS * ROW;
  static constexpr int KV = AL_KEYS * ROW;
  static constexpr int STAGE = 2 * KV + 1024;
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int SLOTS = 2;
  static constexpr int SMEM = 1024 + SLOTS * Q + STAGES * STAGE + 128;
};
static_assert(AlTile<64>::SMEM <= ATT_SMEM_LIMIT, "attn_long_kernel's tiles exceed a block");
static_assert(AlTile<128>::SMEM <= ATT_SMEM_LIMIT, "attn_long_kernel's tiles exceed a block");

// An item slot's index and the parity of its n-th use (n: the block's
// item count so far) in a ring of SLOTS slots (1 or 2).
template <int SLOTS>
__device__ __forceinline__ int al_slot(int n) { return SLOTS == 1 ? 0 : n & 1; }
template <int SLOTS>
__device__ __forceinline__ unsigned al_phase(int n) {
  return SLOTS == 1 ? (unsigned)n & 1u : (unsigned)(n >> 1) & 1u;
}

struct AlArgs {
  const unsigned char* kvalid; long skvb;   // bool [B, Nk], or null
  const float* bias;                        // [B, H, Nq, Nk], or null
  float scale;
  void* out; int out_dt; long sob, son;
  int H, Nq, Nk, qtiles, ktiles, items;
  int bq, bk, bv;                           // 1: the operand's map has a batch axis
  // training: dropout (thresh 0: none) and the rows' statistics
  const unsigned long long* seed; unsigned thresh; float inv_keep;
  float* stats;                             // [B * H, Nq, 2]: max (base e), 1 / sum
};

// A wgmma descriptor of a tile laid out as AlOperand<D> says: the 8-row
// groups 8 * SW bytes apart, the swizzle of 128 bytes (layout 1) or of 64
// (layout 2). K-major (Q, K): the leading offset is unused; MN-major (V,
// rows are keys): the leading offset is the distance to the next 64
// columns (the next slab), which only D 128's products reach.
template <int D>
__device__ __forceinline__ uint64_t al_desc(unsigned addr, unsigned lead) {
  constexpr uint64_t sbo = 8 * AlOperand<D>::SW, layout = AlOperand<D>::SW == 128 ? 1 : 2;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lead >> 4) << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}

// The byte offset of a K-major operand's 16-column step kk in a tile
// whose slabs are `slab` bytes apart (32 bytes a step, four steps a slab).
__device__ __forceinline__ unsigned al_kstep(int kk, unsigned slab) {
  return (unsigned)(kk >> 2) * slab + (unsigned)(kk & 3) * 32u;
}

// One box of a [rows x D] operand tile: SLABS TMA copies of 64 columns
// (one at D <= 64) from column col of the map, each into its slab.
template <int D>
__device__ __forceinline__ void al_load(unsigned char* dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int row, int batch, int rows) {
#pragma unroll
  for (int s = 0; s < AlOperand<D>::SLABS; ++s)
    tma_load_3d(dst + s * rows * AlOperand<D>::SW, map, bar, col + 64 * s, row, batch);
}

// d += A . B for the NK / 16 16-row steps of an MN-major B tile of NK rows
// in shared memory (from b), A in registers: O += P V, dq += ds K, dV +=
// p^T do, dK += ds^T Q.
template <int D, int NK>
__device__ __forceinline__ void al_rs(float (&d)[D / 2], const unsigned (&a)[NK / 16][4],
                                      unsigned b) {
  constexpr int SW = AlOperand<D>::SW;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint64_t db = al_desc<D>(b + kk * 16 * SW, NK * SW);
    if constexpr (D == 128)
      wgmma_rs_m64n128k16<1>(d, a[kk], db);
    else if constexpr (D == 64)
      wgmma_rs_m64n64k16<1>(d, a[kk], db);
    else
      wgmma_rs_m64n32k16<1>(d, a[kk], db);
  }
}

// S = Q . K_tile^T (m64n128, overwriting s): the D / 16 16-column steps;
// the A and B tiles' slabs aslab and bslab bytes apart.
template <int D>
__device__ __forceinline__ void al_scores(float (&s)[64], unsigned qa, unsigned kb,
                                          unsigned aslab, unsigned bslab) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16<0>(s, al_desc<D>(qa + al_kstep(kk, aslab), 16),
                        al_desc<D>(kb + al_kstep(kk, bslab), 16), kk > 0);
}

// The same for a 64-column tile (m64n64): S, dP, S^T, dP^T of the backward.
template <int D>
__device__ __forceinline__ void al_scores64(float (&s)[32], unsigned a, unsigned b,
                                            unsigned aslab, unsigned bslab) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16<0>(s, al_desc<D>(a + al_kstep(kk, aslab), 16),
                       al_desc<D>(b + al_kstep(kk, bslab), 16), kk > 0);
}

// The packed bf16 A fragments of an m64nN accumulator (its fragment is the
// A fragment of a product over its N columns).
template <int N>
__device__ __forceinline__ void al_pack(unsigned (&pf)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
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

// The 4 keep bits of one Philox call's 4 random words (bit e: word e >=
// the threshold).
__device__ __forceinline__ unsigned keep4(const unsigned (&bits)[4], unsigned thresh) {
  return (bits[0] >= thresh ? 1u : 0u) | (bits[1] >= thresh ? 2u : 0u) |
         (bits[2] >= thresh ? 4u : 0u) | (bits[3] >= thresh ? 8u : 0u);
}

// The dropout keep bits of the thread's two rows r0, r1 at the 64 keys
// from k0 (a multiple of 4) in the accumulator layout: bit 4 J + e of
// keep[rh] keeps key k0 + 8 J + 2 t + e of row rh (J < 8). Keys 8 J + 2 t
// and + 1 are half of the Philox group (k0 + 8 J) / 4 + t / 2, whose other
// half lane t ^ 1 holds: each of the two lanes makes the call for one of
// the rows and a shuffle swaps them.
__device__ __forceinline__ void keep_rows(unsigned (&keep)[2], unsigned long long seed,
                                          unsigned thresh, unsigned bh, int r0, int r1, int k0,
                                          int t) {
  const int u = t & 1;
  const unsigned row = (unsigned)(u ? r1 : r0);
  const unsigned cg0 = (unsigned)(k0 / 4 + (t >> 1));
  unsigned own = 0;
#pragma unroll
  for (int J = 0; J < 8; ++J) {
    unsigned bits[4];
    dropout_bits(seed, bh, row, cg0 + 2 * J, bits);
    own |= keep4(bits, thresh) << (4 * J);
  }
  const unsigned other = __shfl_xor_sync(0xffffffffu, own, 1);
  keep[0] = (u ? other : own) >> (2 * u);
  keep[1] = (u ? own : other) >> (2 * u);
}

// The dropout keep bits of the key-major backward: the thread's keys kw +
// g and kw + g + 8 (kw: its warp's first key, a multiple of 16; rows hf 0
// and 1 of the accumulator) at the queries q0 + 8 J + 2 t + c (J < 8, c <
// 2, the columns). Key kw + 8 hf + g is element g % 4 of the Philox group
// (kw + 8 hf) / 4 + g / 4, which the lanes g = 4 (g / 4) .. + 3 of the
// same t share: lane e = g % 4 makes the calls of the columns J = e and e
// + 4, and each lane takes its element of every call from the four lanes'
// words. Bit 4 ((J / 4 * 2 + hf) * 2 + c) of w[J % 4] keeps (hf, J, c).
__device__ __forceinline__ void keep_cols(unsigned (&w)[4], unsigned long long seed,
                                          unsigned thresh, unsigned bh, int kw, int q0,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3, e = g & 3;
  unsigned own = 0;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        unsigned bits[4];
        dropout_bits(seed, bh, (unsigned)(q0 + 8 * (e + 4 * jj) + 2 * t + c),
                     (unsigned)((kw + 8 * hf) / 4 + (g >> 2)), bits);
        own |= keep4(bits, thresh) << (4 * ((jj * 2 + hf) * 2 + c));
      }
#pragma unroll
  for (int e2 = 0; e2 < 4; ++e2)
    w[e2] = __shfl_sync(0xffffffffu, own, (lane & ~12) | (e2 << 2)) >> e;
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

// The start of a persistent block's shared memory, on 1024 bytes.
__device__ __forceinline__ unsigned char* al_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// The barriers of a ring of `stages` and two item slots: full (the
// producer warp's 32 lanes, lane 0's with the bytes) and empty (one arrive
// per consumer warp); thread 0, before the block's first barrier.
__device__ __forceinline__ void al_init(uint64_t* full, uint64_t* empty, uint64_t* i_full,
                                        uint64_t* i_empty, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 32);
    mbar_init(&empty[s], 8);
  }
  for (int s = 0; s < 2; ++s) {
    mbar_init(&i_full[s], 1);
    mbar_init(&i_empty[s], 8);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// map_q / map_k / map_v: the [B, N, H * D] bf16 views in boxes of
// [1, 128 rows, D]. Items: (batch * H + head) * qtiles + query tile, block
// x taking items x, x + gridDim.x, ... TRAIN: train_fwd_long_kernel's
// dropout, fp32 output and statistics.
template <int D, bool TRAIN>
__device__ __forceinline__ void attn_long_body(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                               const CUtensorMap& map_v, const AlArgs& p) {
  using T = AlTile<D>;
  using O = AlOperand<D>;
  extern __shared__ unsigned char al_raw[];
  unsigned char* base = al_base(al_raw);
  unsigned char* ring = base + T::SLOTS * T::Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  uint64_t* q_full = empty + T::STAGES;
  uint64_t* q_empty = q_full + 2;
  const int nitems = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (threadIdx.x == 0) al_init(full, empty, q_full, q_empty, T::STAGES);
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
      const int slot = al_slot<T::SLOTS>(n);
      al_wait(&q_empty[slot], al_phase<T::SLOTS>(n) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&q_full[slot], T::Q);
        al_load<D>(base + slot * T::Q, &map_q, &q_full[slot], h * D, q0, b * p.bq, AL_ROWS);
      }
      for (int j = 0; j < p.ktiles; ++j, ++it) {
        const int s = it % T::STAGES;
        al_wait(&empty[s], ((it / T::STAGES) & 1) ^ 1);
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
          al_load<D>(st, &map_k, &full[s], h * D, j * AL_KEYS, b * p.bk, AL_KEYS);
          al_load<D>(st + T::KV, &map_v, &full[s], h * D, j * AL_KEYS, b * p.bv, AL_KEYS);
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
  const bool pair = TRAIN ? ((reinterpret_cast<uintptr_t>(p.out) | (uintptr_t)(p.sob * 4) |
                              (uintptr_t)(p.son * 4)) & 7) == 0
                          : p.out_dt == DT_BF16 &&
                                ((reinterpret_cast<uintptr_t>(p.out) | (uintptr_t)(p.sob * 2) |
                                  (uintptr_t)(p.son * 2)) & 3) == 0;
  unsigned long long seed = 0ull;
  if constexpr (TRAIN) {
    if (p.thresh) seed = *p.seed;
  }
  unsigned it = 0;
#pragma unroll 1
  for (int n = 0; n < nitems; ++n) {
    const int item = (int)blockIdx.x + n * (int)gridDim.x;
    const int bh = item / p.qtiles, q0 = (item - bh * p.qtiles) * AL_ROWS;
    const int b = bh / p.H, h = bh - b * p.H;
    const int slot = al_slot<T::SLOTS>(n);
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const float* brow[2] = {nullptr, nullptr};
    if (p.bias) {
      if (r0 < p.Nq) brow[0] = p.bias + ((size_t)bh * p.Nq + r0) * p.Nk;
      if (r1 < p.Nq) brow[1] = p.bias + ((size_t)bh * p.Nq + r1) * p.Nk;
    }
    al_wait(&q_full[slot], al_phase<T::SLOTS>(n));
    const unsigned qa = smem_u32(base + slot * T::Q + wg * 64 * O::SW);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, a[2];
    float o[D / 2];
    unsigned pf[AL_KEYS / 16][4];
    // the next key tile of the ring: its stage, once it has landed
    auto take = [&]() {
      const int s_i = it % T::STAGES;
      al_wait(&full[s_i], (it / T::STAGES) & 1);
      ++it;
      return s_i;
    };
    // S_j's softmax (and, in training, its dropout: the sum keeps the
    // undropped p), p packed as the A fragments of P . V
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
      if constexpr (TRAIN) {
        if (p.thresh) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            unsigned keep[2];
            keep_rows(keep, seed, p.thresh, (unsigned)bh, r0, r1, k0 + 64 * hh, t);
#pragma unroll
            for (int J = 0; J < 8; ++J)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * (8 * hh + J) + e;
                s[i] = (keep[e >> 1] >> (4 * J + (e & 1))) & 1u ? s[i] : 0.0f;
              }
          }
        }
      }
    };
    // tile 0: S_0 alone (no branch holds a product: ptxas serialises
    // products in branches of their own)
    int prev = take();
    {
      float s[64];
      wg_fence();
      al_scores<D>(s, qa, smem_u32(ring + prev * T::STAGE), AL_ROWS * O::SW, AL_KEYS * O::SW);
      wg_commit();
      wg_wait<0>();
      soft(s, prev, 0);
      acc_zero(o);
      al_pack<AL_KEYS>(pf, s);
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
      al_scores<D>(s, qa, smem_u32(ring + s_i * T::STAGE), AL_ROWS * O::SW, AL_KEYS * O::SW);
      wg_commit();
      al_rs<D, AL_KEYS>(o, pf, smem_u32(ring + prev * T::STAGE + T::KV));
      wg_commit();
      wg_wait<1>();
      soft(s, s_i, j);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
      if (lane == 0) mbar_arrive(&empty[prev]);   // K_{j-1} and V_{j-1} read
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= a[(i >> 1) & 1];
      al_pack<AL_KEYS>(pf, s);
      prev = s_i;
    }
    reg_fence(o);
    reg_fence(pf);
    wg_fence();
    al_rs<D, AL_KEYS>(o, pf, smem_u32(ring + prev * T::STAGE + T::KV));
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // O / sum: rounded once to bf16 (0 for a fully masked row), or in
    // training fp32 times 1 / (1 - rate), with the rows' statistics
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
      if constexpr (TRAIN) {
        if (t == 0) {
          p.stats[((size_t)bh * p.Nq + r) * 2] = m[rh] * LN2_F;
          p.stats[((size_t)bh * p.Nq + r) * 2 + 1] = inv[rh];
        }
        const float f = inv[rh] * p.inv_keep;
        float* out = static_cast<float*>(p.out);
#pragma unroll
        for (int J = 0; J < D / 8; ++J) {
          const float y0 = o[4 * J + 2 * rh] * f, y1 = o[4 * J + 2 * rh + 1] * f;
          const long off = row + 8 * J + 2 * t;
          if (pair) {
            *reinterpret_cast<float2*>(out + off) = make_float2(y0, y1);
          } else {
            out[off] = y0;
            out[off + 1] = y1;
          }
        }
      } else {
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
}

template <int D>
__global__ void __launch_bounds__(AL_THREADS, 1)
    attn_long_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, AlArgs p) {
  attn_long_body<D, false>(map_q, map_k, map_v, p);
}

template <int D>
__global__ void __launch_bounds__(AL_THREADS, 1)
    train_fwd_long_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, AlArgs p) {
  attn_long_body<D, true>(map_q, map_k, map_v, p);
}

// ----------------------------------------------------------- the backward
#define BW_TILE 64         // keys (query-major) or queries (key-major) of a streamed tile

// Shared memory of a backward block: SLOTS item slots of two 128-row
// operands (Q and do, or K and V), the ring of STAGES stages (two 64-row
// operands and 1024 bytes of side data a stage: the key mask, or each
// query's max, 1 / sum and delta), the barriers; operands laid out as the
// forward's (AlOperand), every tile on 1024 bytes. At D 128 an item slot
// takes 64 KB: one slot keeps the four-stage ring (201,856 bytes; two
// slots and four stages take 267,392, two and three 1,152 more than a
// block has), so the next item's operands load once the last tile of the
// current one has been read.
template <int D>
struct BwTile {
  static constexpr int ROW = 2 * D;
  static constexpr int ITEM = AL_ROWS * ROW;
  static constexpr int SLOT = 2 * ITEM;
  static constexpr int TILE = BW_TILE * ROW;
  static constexpr int STAGE = 2 * TILE + 1024;
  static constexpr int STAGES = 4;
  static constexpr int SLOTS = D == 128 ? 1 : 2;
  static constexpr int SMEM = 1024 + SLOTS * SLOT + STAGES * STAGE + 128;
};
static_assert(BwTile<64>::SMEM <= ATT_SMEM_LIMIT, "the backward's tiles exceed a block");
static_assert(BwTile<128>::SMEM <= ATT_SMEM_LIMIT, "the backward's tiles exceed a block");

struct BwArgs {
  const unsigned char* kvalid; long skvb;   // bool [B, Nk], or null
  const float* bias;                        // [B, H, Nq, Nk], or null
  float scale;
  const unsigned long long* seed; unsigned thresh; float inv_keep;
  const float* stats;                       // [B * H, Nq, 2]: max (base e), 1 / sum
  const float* o; long sob, son;            // the forward's fp32 output
  const bf16* dout; long sdb, sdn;          // bf16 do
  float* dq; float* dk; float* dv;          // fp32 [B, N, H * D], contiguous
  float* dbias;                             // [B, H, Nq, Nk], or null
  float* delta;                             // [B * H, Nq]: rowsum(bf16(do) * O)
  int H, Nq, Nk;
  int itiles, stiles, items;   // this kernel's 128-row items a (batch, head), 64-row tiles, items
  int bi0, bi1, bs0, bs1;      // 1: the item's / the streamed operands' maps have a batch axis
};

// The producer warp of a backward block: the item's two 128-row operands
// (mi0, mi1) into its slot, then its 64-row tiles (ms0, ms1) through the
// ring with their side data. KEYS_STREAM: the query-major kernel (keys
// stream; the side data is a masked or ragged tile's additive key mask),
// else the key-major one (queries stream; each query's max in base 2 (0
// for a fully masked row), 1 / sum and delta, zeros past Nq).
template <int D, bool KEYS_STREAM>
__device__ __forceinline__ void bw_produce(const CUtensorMap* mi0, const CUtensorMap* mi1,
                                           const CUtensorMap* ms0, const CUtensorMap* ms1,
                                           const BwArgs& p, unsigned char* base,
                                           unsigned char* ring, uint64_t* full, uint64_t* empty,
                                           uint64_t* i_full, uint64_t* i_empty, int nitems,
                                           int lane) {
  using T = BwTile<D>;
  unsigned it = 0;
  for (int n = 0; n < nitems; ++n) {
    const int item = (int)blockIdx.x + n * (int)gridDim.x;
    const int bh = item / p.itiles, i0 = (item - bh * p.itiles) * AL_ROWS;
    const int b = bh / p.H, h = bh - b * p.H;
    const int slot = al_slot<T::SLOTS>(n);
    al_wait(&i_empty[slot], al_phase<T::SLOTS>(n) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&i_full[slot], T::SLOT);
      al_load<D>(base + slot * T::SLOT, mi0, &i_full[slot], h * D, i0, b * p.bi0, AL_ROWS);
      al_load<D>(base + slot * T::SLOT + T::ITEM, mi1, &i_full[slot], h * D, i0, b * p.bi1,
                 AL_ROWS);
    }
    for (int j = 0; j < p.stiles; ++j, ++it) {
      const int s = it % T::STAGES;
      al_wait(&empty[s], ((it / T::STAGES) & 1) ^ 1);
      unsigned char* st = ring + s * T::STAGE;
      float* side = reinterpret_cast<float*>(st + 2 * T::TILE);
      if constexpr (KEYS_STREAM) {
        if (p.kvalid || (j + 1) * BW_TILE > p.Nk) {
#pragma unroll
          for (int e = 0; e < BW_TILE / 32; ++e) {
            const int key = j * BW_TILE + lane * (BW_TILE / 32) + e;
            const bool on = key < p.Nk && (!p.kvalid || p.kvalid[b * p.skvb + key] != 0);
            side[lane * (BW_TILE / 32) + e] = on ? 0.0f : -INFINITY;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < BW_TILE / 32; ++e) {
          const int i = lane * (BW_TILE / 32) + e, q = j * BW_TILE + i;
          float z = 0.0f, inv = 0.0f, dl = 0.0f;
          if (q < p.Nq) {
            const size_t row = (size_t)bh * p.Nq + q;
            const float m = p.stats[row * 2] * LOG2E_F;
            z = m == -INFINITY ? 0.0f : m;
            inv = p.stats[row * 2 + 1];
            dl = p.delta[row];
          }
          side[i] = z;
          side[BW_TILE + i] = inv;
          side[2 * BW_TILE + i] = dl;
        }
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * T::TILE);
        al_load<D>(st, ms0, &full[s], h * D, j * BW_TILE, b * p.bs0, BW_TILE);
        al_load<D>(st + T::TILE, ms1, &full[s], h * D, j * BW_TILE, b * p.bs1, BW_TILE);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  }
}

// A key tile of the query-major kernel: s (S = Q K^T of rows g, g + 8 at
// keys k0 + 8 J + 2 t + e, as al_softmax's but m64n64) and dp (do V^T)
// turned into ds = p (dp keep / (1 - rate) - delta) in place of s, p =
// 2^(s log2(e) scale - z + mask + log2(e) bias) * inv from the forward's
// statistics (z: max in base 2, 0 for a fully masked row). MASK: the
// stage's additive key mask kbs applies; BIAS: the rows' bias; DROP:
// dropout, keep holding the rows' keep bits (keep_rows).
template <bool MASK, bool BIAS, bool DROP>
__device__ __forceinline__ void bw_ds_rows(float (&s)[32], const float (&dp)[32], float sc2,
                                           const float (&z)[2], const float (&inv)[2],
                                           const float (&dl)[2], const float* kbs,
                                           const float* const (&brow)[2], bool bvec, int k0,
                                           int nk, int t, const unsigned (&keep)[2],
                                           float inv_keep) {
#pragma unroll
  for (int J = 0; J < BW_TILE / 8; ++J) {
    const int c = 8 * J + 2 * t;
    float2 add = make_float2(0.0f, 0.0f);
    if constexpr (MASK) add = *reinterpret_cast<const float2*>(kbs + c);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float2 bv = make_float2(0.0f, 0.0f);
      if constexpr (BIAS) {
        if (brow[rh]) bv = al_bias2(brow[rh], k0 + c, nk, bvec);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * J + 2 * rh + e;
        float x = fmaf(s[i], sc2, -z[rh]);
        if constexpr (MASK) x += e ? add.y : add.x;
        if constexpr (BIAS) x = fmaf(e ? bv.y : bv.x, LOG2E_F, x);
        const float pr = ex2(x) * inv[rh];
        float dpm = dp[i];
        if constexpr (DROP) dpm = (keep[rh] >> (4 * J + e)) & 1u ? dpm * inv_keep : 0.0f;
        s[i] = pr * (dpm - dl[rh]);
      }
    }
  }
}

// bw_ds_rows in the form a tile takes: MASK for a key mask or a ragged
// tile, BIAS with a bias, DROP with dropout (its keep bits made here).
template <bool DROP>
__device__ __forceinline__ void bw_ds_rows_tile(float (&s)[32], const float (&dp)[32],
                                                const BwArgs& p, float sc2, const float (&z)[2],
                                                const float (&inv)[2], const float (&dl)[2],
                                                const float* kbs, const float* const (&brow)[2],
                                                bool bvec, unsigned long long seed, int bh,
                                                const int (&r)[2], int k0, int t) {
  unsigned keep[2] = {~0u, ~0u};
  if constexpr (DROP) keep_rows(keep, seed, p.thresh, (unsigned)bh, r[0], r[1], k0, t);
  if (p.kvalid || k0 + BW_TILE > p.Nk) {
    if (p.bias)
      bw_ds_rows<true, true, DROP>(s, dp, sc2, z, inv, dl, kbs, brow, bvec, k0, p.Nk, t, keep,
                                   p.inv_keep);
    else
      bw_ds_rows<true, false, DROP>(s, dp, sc2, z, inv, dl, kbs, brow, bvec, k0, p.Nk, t, keep,
                                    p.inv_keep);
  } else if (p.bias) {
    bw_ds_rows<false, true, DROP>(s, dp, sc2, z, inv, dl, kbs, brow, bvec, k0, p.Nk, t, keep,
                                  p.inv_keep);
  } else {
    bw_ds_rows<false, false, DROP>(s, dp, sc2, z, inv, dl, kbs, brow, bvec, k0, p.Nk, t, keep,
                                   p.inv_keep);
  }
}

// A query tile of the key-major kernel: sT (S^T = K Q^T of keys g, g + 8
// at queries q0 + 8 J + 2 t + c) and dpT (V do^T) turned into keep p^T /
// (1 - rate) (in place of sT) and ds^T (in place of dpT). side: the tile's queries' z,
// inv and delta (bw_produce); kadd: the keys' additive mask (MASK); bias:
// the (batch, head)'s [Nq, Nk] rows (BIAS); DROP: dropout, w holding
// keep_cols' words.
template <bool MASK, bool BIAS, bool DROP>
__device__ __forceinline__ void bw_ds_cols(float (&sT)[32], float (&dpT)[32], float sc2,
                                           const float* side, const float (&kadd)[2],
                                           const float* bias, const int (&key)[2], int q0,
                                           int nq, int nk, int t, const unsigned (&w)[4],
                                           float inv_keep) {
#pragma unroll
  for (int J = 0; J < BW_TILE / 8; ++J) {
    const int c = 8 * J + 2 * t;
    const float2 z = *reinterpret_cast<const float2*>(side + c);
    const float2 inv = *reinterpret_cast<const float2*>(side + BW_TILE + c);
    const float2 dl = *reinterpret_cast<const float2*>(side + 2 * BW_TILE + c);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * J + 2 * hf + e;
        float x = fmaf(sT[i], sc2, -(e ? z.y : z.x));
        if constexpr (MASK) x += kadd[hf];
        if constexpr (BIAS) {
          const int q = q0 + c + e;
          if (q < nq && key[hf] < nk) x = fmaf(bias[(size_t)q * nk + key[hf]], LOG2E_F, x);
        }
        const float pr = ex2(x) * (e ? inv.y : inv.x);
        if constexpr (DROP) {
          const bool kp = (w[J & 3] >> (4 * (((J >> 2) * 2 + hf) * 2 + e))) & 1u;
          const float dpm = kp ? dpT[i] * inv_keep : 0.0f;
          dpT[i] = pr * (dpm - (e ? dl.y : dl.x));
          sT[i] = kp ? pr * inv_keep : 0.0f;
        } else {
          dpT[i] = pr * (dpT[i] - (e ? dl.y : dl.x));
          sT[i] = pr;
        }
      }
  }
}

// bw_ds_cols in the form an item takes (masked: a key mask, or keys past
// Nk in the item) for a tile; DROP: its keep bits made here.
template <bool DROP>
__device__ __forceinline__ void bw_ds_cols_tile(float (&sT)[32], float (&dpT)[32],
                                                const BwArgs& p, float sc2, const float* side,
                                                const float (&kadd)[2], const float* bias,
                                                const int (&key)[2], bool masked,
                                                unsigned long long seed, int bh, int kw, int q0,
                                                int lane) {
  const int t = lane & 3;
  unsigned w[4] = {~0u, ~0u, ~0u, ~0u};
  if constexpr (DROP) keep_cols(w, seed, p.thresh, (unsigned)bh, kw, q0, lane);
  if (masked) {
    if (bias)
      bw_ds_cols<true, true, DROP>(sT, dpT, sc2, side, kadd, bias, key, q0, p.Nq, p.Nk, t, w,
                                   p.inv_keep);
    else
      bw_ds_cols<true, false, DROP>(sT, dpT, sc2, side, kadd, bias, key, q0, p.Nq, p.Nk, t, w,
                                    p.inv_keep);
  } else if (bias) {
    bw_ds_cols<false, true, DROP>(sT, dpT, sc2, side, kadd, bias, key, q0, p.Nq, p.Nk, t, w,
                                  p.inv_keep);
  } else {
    bw_ds_cols<false, false, DROP>(sT, dpT, sc2, side, kadd, bias, key, q0, p.Nq, p.Nk, t, w,
                                   p.inv_keep);
  }
}

// The query-major backward: items of 128 query rows of a (batch, head),
// keys and values streamed in 64-key tiles; delta, dbias and dq. map_q /
// map_do: boxes of [1, 128 rows, D]; map_k / map_v: [1, 64 rows, D].
template <int D>
__global__ void __launch_bounds__(AL_THREADS, 1)
    train_bwd_q_long_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_do,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, BwArgs p) {
  using T = BwTile<D>;
  using O = AlOperand<D>;
  extern __shared__ unsigned char bw_raw[];
  unsigned char* base = al_base(bw_raw);
  unsigned char* ring = base + T::SLOTS * T::SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  uint64_t* i_full = empty + T::STAGES;
  uint64_t* i_empty = i_full + 2;
  const int nitems = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (threadIdx.x == 0) al_init(full, empty, i_full, i_empty, T::STAGES);
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0)
      bw_produce<D, true>(&map_q, &map_do, &map_k, &map_v, p, base, ring, full, empty, i_full,
                          i_empty, nitems, lane);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = lane >> 2, t = lane & 3;
  const float sc2 = p.scale * LOG2E_F;
  const bool bvec = p.Nk % 2 == 0 && (reinterpret_cast<uintptr_t>(p.bias) & 7) == 0;
  const bool dbvec = p.Nk % 2 == 0 && (reinterpret_cast<uintptr_t>(p.dbias) & 7) == 0;
  const unsigned long long seed = p.thresh ? *p.seed : 0ull;
  const long HD = (long)p.H * D;
  unsigned it = 0;
#pragma unroll 1
  for (int n = 0; n < nitems; ++n) {
    const int item = (int)blockIdx.x + n * (int)gridDim.x;
    const int bh = item / p.itiles, q0 = (item - bh * p.itiles) * AL_ROWS;
    const int b = bh / p.H, h = bh - b * p.H;
    const int slot = al_slot<T::SLOTS>(n);
    const int r[2] = {q0 + 64 * wg + 16 * warp + g, q0 + 64 * wg + 16 * warp + g + 8};
    // the rows' statistics, bias and dbias rows, and delta = rowsum(bf16(do)
    // * O) from device memory (the quad's lanes hold D / 4 columns each)
    float z[2], inv[2], dl[2];
    const float* brow[2];
    float* dbrow[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      z[rh] = inv[rh] = 0.0f;
      brow[rh] = nullptr;
      dbrow[rh] = nullptr;
      float acc = 0.0f;
      if (r[rh] < p.Nq) {
        const size_t row = (size_t)bh * p.Nq + r[rh];
        const float m = p.stats[row * 2] * LOG2E_F;
        z[rh] = m == -INFINITY ? 0.0f : m;
        inv[rh] = p.stats[row * 2 + 1];
        if (p.bias) brow[rh] = p.bias + row * p.Nk;
        if (p.dbias) dbrow[rh] = p.dbias + row * p.Nk;
        const float* orow = p.o + (long)b * p.sob + (long)r[rh] * p.son + h * D;
        const bf16* drow = p.dout + (long)b * p.sdb + (long)r[rh] * p.sdn + h * D;
#pragma unroll
        for (int J = 0; J < D / 8; ++J) {
          const float2 ov = *reinterpret_cast<const float2*>(orow + 8 * J + 2 * t);
          const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(drow + 8 * J + 2 * t);
          acc = fmaf(__low2float(dv), ov.x, acc);
          acc = fmaf(__high2float(dv), ov.y, acc);
        }
      }
      dl[rh] = quad_sum(acc);
      if (t == 0 && r[rh] < p.Nq) p.delta[(size_t)bh * p.Nq + r[rh]] = dl[rh];
    }
    al_wait(&i_full[slot], al_phase<T::SLOTS>(n));
    const unsigned qa = smem_u32(base + slot * T::SLOT + wg * 64 * O::SW);
    const unsigned da = qa + T::ITEM;
    float dq[D / 2];
    acc_zero(dq);
    unsigned pf[BW_TILE / 16][4];
    int prev = 0;
#pragma unroll 1
    for (int j = 0; j < p.stiles; ++j) {
      const int s_i = it % T::STAGES;
      al_wait(&full[s_i], (it / T::STAGES) & 1);
      ++it;
      const unsigned kb = smem_u32(ring + s_i * T::STAGE), vb = kb + T::TILE;
      float s[32], dp[32];
      reg_fence(dq);
      reg_fence(pf);
      wg_fence();
      // S_j and dP_j behind dq += ds_{j-1} K_{j-1}
      al_scores64<D>(s, qa, kb, AL_ROWS * O::SW, BW_TILE * O::SW);
      al_scores64<D>(dp, da, vb, AL_ROWS * O::SW, BW_TILE * O::SW);
      wg_commit();
      wg_wait<0>();
      reg_fence(s);
      reg_fence(dp);
      reg_fence(dq);
      if (lane == 0) {
        if (j > 0) mbar_arrive(&empty[prev]);                  // K_{j-1} read
        if (j == p.stiles - 1) mbar_arrive(&i_empty[slot]);    // Q and do read
      }
      const int k0 = j * BW_TILE;
      const float* kbs = reinterpret_cast<const float*>(ring + s_i * T::STAGE + 2 * T::TILE);
      if (p.thresh)
        bw_ds_rows_tile<true>(s, dp, p, sc2, z, inv, dl, kbs, brow, bvec, seed, bh, r, k0, t);
      else
        bw_ds_rows_tile<false>(s, dp, p, sc2, z, inv, dl, kbs, brow, bvec, seed, bh, r, k0, t);
      if (p.dbias) {
#pragma unroll
        for (int J = 0; J < BW_TILE / 8; ++J) {
          const int k = k0 + 8 * J + 2 * t;
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            if (!dbrow[rh] || k >= p.Nk) continue;
            const float v0 = s[4 * J + 2 * rh], v1 = s[4 * J + 2 * rh + 1];
            if (dbvec) {                          // Nk even: k + 1 < Nk
              *reinterpret_cast<float2*>(dbrow[rh] + k) = make_float2(v0, v1);
            } else {
              dbrow[rh][k] = v0;
              if (k + 1 < p.Nk) dbrow[rh][k + 1] = v1;
            }
          }
        }
      }
      al_pack<BW_TILE>(pf, s);
      wg_fence();
      al_rs<D, BW_TILE>(dq, pf, kb);    // dq += bf16(ds) K_j (K MN-major)
      wg_commit();
      prev = s_i;
    }
    wg_wait<0>();
    reg_fence(dq);
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      if (r[rh] >= p.Nq) continue;
      float* out = p.dq + ((long)b * p.Nq + r[rh]) * HD + h * D;
#pragma unroll
      for (int J = 0; J < D / 8; ++J)
        *reinterpret_cast<float2*>(out + 8 * J + 2 * t) =
            make_float2(dq[4 * J + 2 * rh] * p.scale, dq[4 * J + 2 * rh + 1] * p.scale);
    }
  }
}

// The key-major backward: items of 128 keys of a (batch, head), queries,
// do and their statistics streamed in 64-query tiles; dk and dv. map_k /
// map_v: boxes of [1, 128 rows, D]; map_q / map_do: [1, 64 rows, D].
template <int D>
__global__ void __launch_bounds__(AL_THREADS, 1)
    train_bwd_k_long_kernel(const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_do, BwArgs p) {
  using T = BwTile<D>;
  using O = AlOperand<D>;
  extern __shared__ unsigned char bw_raw[];
  unsigned char* base = al_base(bw_raw);
  unsigned char* ring = base + T::SLOTS * T::SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  uint64_t* i_full = empty + T::STAGES;
  uint64_t* i_empty = i_full + 2;
  const int nitems = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (threadIdx.x == 0) al_init(full, empty, i_full, i_empty, T::STAGES);
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0)
      bw_produce<D, false>(&map_k, &map_v, &map_q, &map_do, p, base, ring, full, empty, i_full,
                           i_empty, nitems, lane);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = lane >> 2, t = lane & 3;
  const float sc2 = p.scale * LOG2E_F;
  const unsigned long long seed = p.thresh ? *p.seed : 0ull;
  const long HD = (long)p.H * D;
  unsigned it = 0;
#pragma unroll 1
  for (int n = 0; n < nitems; ++n) {
    const int item = (int)blockIdx.x + n * (int)gridDim.x;
    const int bh = item / p.itiles, k0 = (item - bh * p.itiles) * AL_ROWS;
    const int b = bh / p.H, h = bh - b * p.H;
    const int slot = al_slot<T::SLOTS>(n);
    const int kw = k0 + 64 * wg + 16 * warp;
    const int key[2] = {kw + g, kw + g + 8};
    float kadd[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const bool on = key[hf] < p.Nk && (!p.kvalid || p.kvalid[b * p.skvb + key[hf]] != 0);
      kadd[hf] = on ? 0.0f : -INFINITY;
    }
    const bool masked = p.kvalid || k0 + AL_ROWS > p.Nk;
    const float* bias = p.bias ? p.bias + (size_t)bh * p.Nq * p.Nk : nullptr;
    al_wait(&i_full[slot], al_phase<T::SLOTS>(n));
    const unsigned ka = smem_u32(base + slot * T::SLOT + wg * 64 * O::SW);
    const unsigned va = ka + T::ITEM;
    float dk[D / 2], dv[D / 2];
    acc_zero(dk);
    acc_zero(dv);
    unsigned pp[BW_TILE / 16][4], pd[BW_TILE / 16][4];
    int prev = 0;
#pragma unroll 1
    for (int i = 0; i < p.stiles; ++i) {
      const int s_i = it % T::STAGES;
      al_wait(&full[s_i], (it / T::STAGES) & 1);
      ++it;
      const unsigned qb = smem_u32(ring + s_i * T::STAGE), ob = qb + T::TILE;
      float sT[32], dpT[32];
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pp);
      reg_fence(pd);
      wg_fence();
      // S^T_i and dP^T_i behind dV, dK += tile i - 1's products
      al_scores64<D>(sT, ka, qb, AL_ROWS * O::SW, BW_TILE * O::SW);
      al_scores64<D>(dpT, va, ob, AL_ROWS * O::SW, BW_TILE * O::SW);
      wg_commit();
      wg_wait<0>();
      reg_fence(sT);
      reg_fence(dpT);
      reg_fence(dk);
      reg_fence(dv);
      if (lane == 0) {
        if (i > 0) mbar_arrive(&empty[prev]);                  // Q, do_{i-1} read
        if (i == p.stiles - 1) mbar_arrive(&i_empty[slot]);    // K and V read
      }
      const int q0 = i * BW_TILE;
      const float* side = reinterpret_cast<const float*>(ring + s_i * T::STAGE + 2 * T::TILE);
      if (p.thresh)
        bw_ds_cols_tile<true>(sT, dpT, p, sc2, side, kadd, bias, key, masked, seed, bh, kw, q0,
                              lane);
      else
        bw_ds_cols_tile<false>(sT, dpT, p, sc2, side, kadd, bias, key, masked, seed, bh, kw, q0,
                               lane);
      al_pack<BW_TILE>(pp, sT);
      al_pack<BW_TILE>(pd, dpT);
      wg_fence();
      al_rs<D, BW_TILE>(dv, pp, ob);    // dV += bf16(keep p^T / (1 - rate)) do_i
      al_rs<D, BW_TILE>(dk, pd, qb);    // dK += bf16(ds^T) Q_i
      wg_commit();
      if constexpr (D == 128) {
        // dK and dV take 128 registers a thread at D 128: these products
        // end before the next tile's S^T and dP^T are issued, so their
        // packed operands are not live beside the new scores
        wg_wait<0>();
        reg_fence(dk);
        reg_fence(dv);
        reg_fence(pp);
        reg_fence(pd);
      }
      prev = s_i;
    }
    wg_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (key[hf] >= p.Nk) continue;
      const long off = ((long)b * p.Nk + key[hf]) * HD + h * D + 2 * t;
#pragma unroll
      for (int J = 0; J < D / 8; ++J) {
        *reinterpret_cast<float2*>(p.dv + off + 8 * J) =
            make_float2(dv[4 * J + 2 * hf], dv[4 * J + 2 * hf + 1]);
        *reinterpret_cast<float2*>(p.dk + off + 8 * J) =
            make_float2(dk[4 * J + 2 * hf] * p.scale, dk[4 * J + 2 * hf + 1] * p.scale);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
// A [B, N, H * D] bf16 view (row stride ld, batch stride sb; 0: one
// shared by the batch) as a map of boxes [1, box_rows, min(D, 64)] in the
// swizzle of the kernels' tiles (a D 128 tile is two boxes, al_load);
// rows past N read as zeros. `has_b`: the map has the batch axis (else
// the kernel asks for batch 0).
static bool al_map(CUtensorMap* map, const void* ptr, int D, long inner, long rows, long ld,
                   long sb, int batch, int& has_b, unsigned box_rows = AL_ROWS) {
  TensorMapEncodeFn encode = tensor_map_encoder();
  has_b = batch > 1 && sb != 0;
  if (!encode || (reinterpret_cast<uintptr_t>(ptr) & 15) || ld % 8 || (has_b && sb % 8))
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)(has_b ? batch : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)(has_b ? sb : rows * ld) * 2};
  const cuuint32_t box[3] = {(cuuint32_t)(D < 64 ? D : 64), box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
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

// A persistent launch of `kern` over `items` (its shared memory allowed
// once, at its first launch).
template <typename Kern, typename... Args>
static int al_launch(Kern kern, bool& configured, long smem, long items, cudaStream_t s,
                     Args... args) {
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int grid = al_grid(items);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kern<<<grid, AL_THREADS, (size_t)smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_attn_long(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                            const AlArgs& a, bool train, cudaStream_t s) {
  static bool configured[2] = {false, false};
  if (train)
    return al_launch(train_fwd_long_kernel<D>, configured[1], AlTile<D>::SMEM, a.items, s, mq,
                     mk, mv, a);
  return al_launch(attn_long_kernel<D>, configured[0], AlTile<D>::SMEM, a.items, s, mq, mk, mv,
                   a);
}

// The forward's arguments, maps and launch (ops/kernels.py attention_plan
// with "long": 128-row query items, 12 warps, the block's shared memory).
static int al_forward(const void* q, const void* k, const void* v, int in_dt, long sqb, long sqn,
                      long skb, long skn, long svb, long svn, int B, int H, int D, int Nq,
                      int Nk, const void* kvalid, long skvb, const void* bias, float scale,
                      AlArgs& a, int qsplit, int warps, long smem, bool train, void* stream) {
  const int qtiles = (Nq + AL_ROWS - 1) / AL_ROWS;
  const long need = D == 128  ? AlTile<128>::SMEM
                    : D == 64 ? AlTile<64>::SMEM
                              : AlTile<32>::SMEM;
  if ((D != 32 && D != 64 && D != 128) || in_dt != DT_BF16 || B < 1 || H < 1 || Nq < 1 || Nk < 1 ||
      !q || !k || !v || !a.out || !(scale > 0.0f) || qsplit != qtiles ||
      warps * 32 != AL_THREADS || smem != need)
    return (int)cudaErrorInvalidValue;
  a.kvalid = static_cast<const unsigned char*>(kvalid); a.skvb = skvb;
  a.bias = static_cast<const float*>(bias); a.scale = scale;
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
  if (D == 128) return launch_attn_long<128>(mq, mk, mv, a, train, s);
  return D == 64 ? launch_attn_long<64>(mq, mk, mv, a, train, s)
                 : launch_attn_long<32>(mq, mk, mv, a, train, s);
}

extern "C" int ec_attention_long(const void* q, const void* k, const void* v, int in_dt,
                                 long sqb, long sqn, long skb, long skn, long svb, long svn,
                                 int B, int H, int D, int Nq, int Nk,
                                 const void* kvalid, long skvb, const void* bias, float scale,
                                 void* out, int out_dt, long sob, long son,
                                 int qsplit, int warps, long smem, void* stream) {
  AlArgs a = {};
  a.out = out; a.out_dt = out_dt; a.sob = sob; a.son = son;
  return al_forward(q, k, v, in_dt, sqb, sqn, skb, skn, svb, svn, B, H, D, Nq, Nk, kvalid, skvb,
                    bias, scale, a, qsplit, warps, smem, false, stream);
}

// out: fp32 [B, Nq, H * D] (row stride son, batch stride sob); stats: fp32
// [B * H, Nq, 2]; q, k, v bf16 views a tensor map can describe.
extern "C" int ec_attn_train_fwd_long(const void* q, const void* k, const void* v, int in_dt,
                                      long sqb, long sqn, long skb, long skn, long svb,
                                      long svn, int B, int H, int D, int Nq, int Nk,
                                      const void* kvalid, long skvb, const void* bias,
                                      float scale, const void* seed, unsigned thresh,
                                      float inv_keep, void* out, long sob, long son,
                                      void* stats, int qsplit, int warps, long smem,
                                      void* stream) {
  if ((thresh && !seed) || !stats) return (int)cudaErrorInvalidValue;
  AlArgs a = {};
  a.out = out; a.out_dt = DT_F32; a.sob = sob; a.son = son;
  a.seed = static_cast<const unsigned long long*>(seed);
  a.thresh = thresh; a.inv_keep = inv_keep;
  a.stats = static_cast<float*>(stats);
  return al_forward(q, k, v, in_dt, sqb, sqn, skb, skn, svb, svn, B, H, D, Nq, Nk, kvalid, skvb,
                    bias, scale, a, qsplit, warps, smem, true, stream);
}

template <int D>
static int launch_bwd_long(const CUtensorMap (&mq)[2], const CUtensorMap (&mk)[2],
                           const CUtensorMap (&mv)[2], const CUtensorMap (&md)[2],
                           const BwArgs& qa, const BwArgs& ka, cudaStream_t s) {
  static bool configured[2] = {false, false};
  const int rc = al_launch(train_bwd_q_long_kernel<D>, configured[0], BwTile<D>::SMEM, qa.items,
                           s, mq[0], md[0], mk[1], mv[1], qa);
  if (rc != 0) return rc;
  return al_launch(train_bwd_k_long_kernel<D>, configured[1], BwTile<D>::SMEM, ka.items, s,
                   mk[0], mv[0], mq[1], md[1], ka);
}

// q, k, v, dout: bf16 views a tensor map can describe; stats: the
// forward's [B * H, Nq, 2]; o: its fp32 output [B, Nq, H * D] (row stride
// son, batch stride sob, both even); dq, dk, dv: fp32 [B, N, H * D],
// contiguous; dbias [B, H, Nq, Nk] or null; delta: fp32 scratch [B * H,
// Nq]; kvalid: the forward's bool mask. The plan (ops/kernels.py
// attention_bwd_plan with "long"): each kernel's 128-row items a (batch,
// head), 12 warps, the block's shared memory.
extern "C" int ec_attn_train_bwd_long(const void* q, const void* k, const void* v, int in_dt,
                                      long sqb, long sqn, long skb, long skn, long svb,
                                      long svn, int B, int H, int D, int Nq, int Nk,
                                      const void* kvalid, long skvb, const void* bias,
                                      float scale, const void* seed, unsigned thresh,
                                      float inv_keep, const void* dout, int do_dt, long sdb,
                                      long sdn, const void* stats, const void* o, long sob,
                                      long son, void* dq, void* dk, void* dv, void* dbias,
                                      void* delta, int qsplit, int qwarps, long qsmem,
                                      int ksplit, int kwarps, long ksmem, void* stream) {
  const int qtiles = (Nq + AL_ROWS - 1) / AL_ROWS, ktiles = (Nk + AL_ROWS - 1) / AL_ROWS;
  const long need = D == 128  ? BwTile<128>::SMEM
                    : D == 64 ? BwTile<64>::SMEM
                              : BwTile<32>::SMEM;
  if ((D != 32 && D != 64 && D != 128) || in_dt != DT_BF16 || do_dt != DT_BF16 || B < 1 || H < 1 ||
      Nq < 1 || Nk < 1 || !q || !k || !v || !dout || !stats || !o || !dq || !dk || !dv ||
      !delta || (thresh && !seed) || !(scale > 0.0f) || qsplit != qtiles || ksplit != ktiles ||
      qwarps * 32 != AL_THREADS || kwarps * 32 != AL_THREADS || qsmem != need || ksmem != need ||
      ((reinterpret_cast<uintptr_t>(o) | (uintptr_t)(sob * 4) | (uintptr_t)(son * 4)) & 7))
    return (int)cudaErrorInvalidValue;
  const long qitems = (long)B * H * qtiles, kitems = (long)B * H * ktiles;
  if (qitems > 0x7fffffffL || kitems > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  BwArgs a = {};
  a.kvalid = static_cast<const unsigned char*>(kvalid); a.skvb = skvb;
  a.bias = static_cast<const float*>(bias); a.scale = scale;
  a.seed = static_cast<const unsigned long long*>(seed);
  a.thresh = thresh; a.inv_keep = inv_keep;
  a.stats = static_cast<const float*>(stats);
  a.o = static_cast<const float*>(o); a.sob = sob; a.son = son;
  a.dout = static_cast<const bf16*>(dout); a.sdb = sdb; a.sdn = sdn;
  a.dq = static_cast<float*>(dq); a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv); a.dbias = static_cast<float*>(dbias);
  a.delta = static_cast<float*>(delta);
  a.H = H; a.Nq = Nq; a.Nk = Nk;
  // each operand in 128-row boxes (as an item's) and 64-row ones (as a
  // streamed tile's)
  CUtensorMap mq[2], mk[2], mv[2], md[2];
  int bq = 0, bk = 0, bv = 0, bd = 0;
  const long c = (long)H * D;
  for (int i = 0; i < 2; ++i) {
    const unsigned rows = i ? BW_TILE : AL_ROWS;
    if (!al_map(&mq[i], q, D, c, Nq, sqn, sqb, B, bq, rows) ||
        !al_map(&mk[i], k, D, c, Nk, skn, skb, B, bk, rows) ||
        !al_map(&mv[i], v, D, c, Nk, svn, svb, B, bv, rows) ||
        !al_map(&md[i], dout, D, c, Nq, sdn, sdb, B, bd, rows))
      return (int)cudaErrorInvalidValue;
  }
  BwArgs qa = a, ka = a;
  qa.itiles = qtiles; qa.stiles = (Nk + BW_TILE - 1) / BW_TILE; qa.items = (int)qitems;
  qa.bi0 = bq; qa.bi1 = bd; qa.bs0 = bk; qa.bs1 = bv;
  ka.itiles = ktiles; ka.stiles = (Nq + BW_TILE - 1) / BW_TILE; ka.items = (int)kitems;
  ka.bi0 = bk; ka.bi1 = bv; ka.bs0 = bq; ka.bs1 = bd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_bwd_long<128>(mq, mk, mv, md, qa, ka, s);
  return D == 64 ? launch_bwd_long<64>(mq, mk, mv, md, qa, ka, s)
                 : launch_bwd_long<32>(mq, mk, mv, md, qa, ka, s);
}
