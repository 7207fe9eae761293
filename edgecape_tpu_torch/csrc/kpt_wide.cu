// kpt_head_wide_kernel: a decoder layer's keypoint head at every width but
// the 256 channels of kernels.cu's kpt_head_kernel, C from 1 to 512. It
// replaces the final norm, dual kpt_branch and coordinate update of the
// TPU kernel edgecape_tpu/ops/fused_decoder.py _stack_kernel (:456-475,
// through pallas_call at :531), with the rounding points of the plain
// version (ops/fused_decoder.py kpt_head_plain): for h = x (bf16 [R, C])
// and h = bf16(LN(x)) (fp32 statistics over the true C, two-pass
// variance), h = bf16(gelu(h . W_i^T + b_i)) for the three kpt_branch
// layers, dd = h . Wo^T + bo (N = 2), and sigmoid(inverse_sigmoid(ct) +
// dd) with the log-odds clipped at ieps: `pts` from x, `outs` from the
// normed x.
//
// Bound. At 60 query rows (6000 keypoint rows) and C 512 a call is 19
// GFLOP of products (0.019 ms at 989 TFLOP/s) against 6 MB of x; every
// tile multiplies by all three weights (1.5 MB at 512 channels), so what
// feeds the tensor cores is the weight bytes read from L2, and the lever
// is the rows each weight byte serves.
//
// Design: the parts enc_post_wide_kernel and the decoder's wide kernels
// share (head_wide.cuh, dec_wide.cuh):
//   * a persistent grid (one block an SM) of tiles, 384 threads: a
//     producer warpgroup (one thread issues every TMA copy, setmaxnreg 40)
//     and two consumer warpgroups (232) running wgmma;
//   * the raw pass and the normed pass multiply the same rows by the same
//     weights (the TPU kernel's stacked kin = [x; LN(x)]), so a warpgroup's
//     64 product rows are 32 source rows as they are (rows 0-31: warps 0
//     and 1) and the same 32 rows under the final norm (rows 32-63: warps 2
//     and 3), and every weight box serves both. Two instances:
//       - c_pad <= 256 (C 1..255 at 64, 128, 192 or 256): a tile is 64
//         source rows, 32 a warpgroup, each warpgroup all c_pad channels of
//         its rows with its own A boxes; both take every weight box of one
//         ring, which so serves 128 stacked rows;
//       - c_pad 384 or 512 (C 257..512): the two warpgroups split the
//         channels (NH = c_pad / 2 each, as enc_post_wide_kernel) over one
//         tile of 32 source rows (64 stacked) in shared A boxes that both
//         multiply; a warpgroup's ring carries its NH rows of the weights;
//   * the weights stream by TMA in [64 x 64] bf16 boxes (8 KB, one load
//     unit: a 64-deep k slab of 64 output columns), in the same order for
//     every tile (so L2 serves them), through up to KW_MAX_SLOTS slots a
//     ring. They are padded with zero rows and columns to c_pad
//     (ops/kernels.py kpt_head_plan, laid out once by
//     ops/fused_decoder.py _build_stack_weights), so every box lies inside
//     them and the padding adds exact zeros;
//   * a layer runs in passes of 128 output columns (64 where a warpgroup
//     holds 64 or 192): each 64-deep k slab of a 64-column part goes into
//     a fresh m64n64 wgmma accumulator, which, once its products are done
//     (under the next unit's), is added into the part's fp32 sum on the
//     CUDA cores. wgmma rounds every 16-deep step of its sum toward zero,
//     so one accumulator over 512 deep drifts by tens of ulps and flips
//     several times as many bf16 roundings of h as fp32 sums do, while a
//     slab at a time sums as accurately as fp32 (PERF.md). The
//     pass's h = bf16(gelu(sum + b)) goes into the other of two sets of A
//     boxes (the next layer's input), and 96-128 accumulator registers a
//     thread serve every width;
//   * x arrives by cp.async (16 bytes where C is a multiple of 8, else
//     element loads) into rows 0-31 of the boxes, with the rows'
//     coordinates, the next tile's under this one's last layer; the final
//     norm fills rows 32-63 from them, a warp a row. Columns past C load
//     as zeros; the biases, the final norm's gamma and beta and Wo lie in
//     shared memory, zero past C, so the padding stays zero through every
//     layer; the LayerNorm's statistics run over the true C;
//   * dd (N = 2) runs on the CUDA cores from the last layer's passes: a
//     thread's columns in order, the quad by shuffles, and where the
//     channels are split warpgroup 0's part plus warpgroup 1's through
//     shared memory. Every element sums its k slabs in one order, so a
//     row's bits do not depend on its place in the batch.

#include "dec_wide.cuh"

#define KW_MAX_SLOTS 16            // slots of a ring at most
#define KW_RED (4 * 2 * 2 * EW_ROWS)       // dd's partial sums
#define KW_CT (2 * 2 * 32 * 8)             // coordinates in [warpgroup][2 tiles][32 rows]

// An instance: NH channels a warpgroup; SPLIT, the two warpgroups split
// c_pad = 2 NH channels over the same 64 stacked rows (one ring each),
// else each holds all c_pad = NH channels of its own 64 rows (one ring
// both take).
__host__ __device__ constexpr int kw_cp(int nh, bool split) { return split ? 2 * nh : nh; }
__host__ __device__ constexpr int kw_rings(bool split) { return split ? 2 : 1; }
// alignment slack, two sets of A boxes (a warpgroup's own, or shared),
// then past the rings dd's partial sums, the coordinates in and the
// vectors (KV_N x c_pad fp32)
__host__ __device__ constexpr int kw_fixed(int nh, bool split) {
  return 1024 + (split ? 2 : 4) * (kw_cp(nh, split) / 64) * EW_BOX + KW_RED + KW_CT +
         7 * 4 * kw_cp(nh, split);
}
__host__ __device__ constexpr int kw_slots(int nh, bool split) {
  return (HW_SMEM_LIMIT - kw_fixed(nh, split)) / (kw_rings(split) * (EW_BOX + 16)) < KW_MAX_SLOTS
             ? (HW_SMEM_LIMIT - kw_fixed(nh, split)) / (kw_rings(split) * (EW_BOX + 16))
             : KW_MAX_SLOTS;
}
__host__ __device__ constexpr int kw_smem(int nh, bool split) {
  return kw_fixed(nh, split) + kw_rings(split) * kw_slots(nh, split) * (EW_BOX + 16);
}
static_assert(kw_slots(256, true) >= 4 && kw_slots(256, false) >= 4 &&
                  kw_smem(256, true) <= HW_SMEM_LIMIT && kw_smem(256, false) <= HW_SMEM_LIMIT &&
                  kw_smem(192, true) <= HW_SMEM_LIMIT,
              "kpt_head_wide_kernel's rings do not fit a block");

// The instance of C channels: {NH, split}.
static void kw_instance(int C, int& nh, bool& split) {
  split = C > 256;
  nh = split ? ew_half(C) : (C + 63) / 64 * 64;
}

struct KptWideArgs {
  const bf16 *x, *wo;
  const float *g, *be, *b0, *b1, *b2, *bo, *ct;
  float *pts, *outs;
  long R;
  int C;
  float eps, ieps;
};

// Source rows a tile: 32 a warpgroup.
__host__ __device__ constexpr int kw_rows(bool split) { return split ? 32 : 64; }

// The source row of a warpgroup's product row r (rows r and r + 32 take
// the same one) in tile `it`.
__device__ __forceinline__ long kw_src(long it, int r, bool split, int wg) {
  return kw_rows(split) * it + (split ? 0 : 32 * wg) + (r & 31);
}

// The warpgroup's 32 rows of tile `it`, columns [c0, c0 + COLS), into rows
// 0-31 of the boxes at bx (as head_wide.cuh ew_load_att), and their
// coordinates into cts: cp.async, zeros past R and C, and where C is no
// multiple of 8 element loads of the run that C cuts, from clamped
// addresses, so that no load waits on a branch.
template <int COLS>
__device__ __forceinline__ void kw_load_x(unsigned char* bx, float* cts, const bf16* x,
                                          const float* ct, long it, long R, int C, int c0,
                                          int ct_, bool split, int wg) {
  const bool vec = !(C & 7);
  for (int i = ct_; i < 32 * COLS / 8; i += 128) {
    const int r = i / (COLS / 8), c = c0 + (i % (COLS / 8)) * 8;
    unsigned char* dst = bx + ew_off(r, c);
    const long row = kw_src(it, r, split, wg);
    if (vec && row < R && c + 8 <= C) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                   "l"(x + row * C + c));
    } else if (c >= C || row >= R) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      const bf16* src = x + row * C;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = __bfloat162float(src[c + e < C ? c + e : C - 1]);
        f[e] = c + e < C ? v : 0.0f;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                                  pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    }
  }
  if (ct_ < 32) {
    const long row = kw_src(it, ct_, split, wg);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(cts + 2 * ct_)),
                 "l"(ct + 2 * (row < R ? row : R - 1)));
  }
}

// The block's vectors in shared memory, c_pad floats each, zero past C:
// the three biases, the final norm's gamma and beta, Wo's two rows.
enum { KV_B0, KV_G = 3, KV_BE, KV_WO, KV_N = 7 };

// Columns c, c + 1 of vector k.
__device__ __forceinline__ float2 kw_vec(const float* vec, int cp, int k, int c) {
  return *reinterpret_cast<const float2*>(vec + k * cp + c);
}

// The plain version's GELU and LayerNorm, ops/plain.py gelu and
// layer_norm, step by step as PyTorch rounds them (exact erf; mean times
// 1 / C; (v - mean) * inv * g + b), so that the kernel's roundings of h to
// bf16 flip against the plain version's only where their sums differ.
__device__ __forceinline__ float kw_gelu(float z) {
  return __fmul_rn(__fmul_rn(0.5f, z),
                   __fadd_rn(1.0f, erff(__fmul_rn(z, 0.7071067811865476f))));
}
__device__ __forceinline__ float kw_ln(float v, float mean, float inv, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), inv), g), b);
}

// The final norm of the tile's rows 0-31 into rows 32-63 of the boxes at
// bx (c_pad CP columns): a warp takes rows w, w + WARPS, ... side by side,
// a lane the 16-byte runs l, l + 32, ... of a row (8 columns each, zero
// past C); fp32 statistics over the true C with the two-pass variance, as
// ops/plain.py layer_norm (kw_ln): a row's sums over the lane's columns in order,
// then over the warp by shuffles, the same for every row; gamma and beta
// from shared memory, zero past C, so the padding stays zero.
template <int CP, int WARPS>
__device__ __forceinline__ void kw_layernorm(unsigned char* bx, const float* vec, int C,
                                             float eps, int w, int lane) {
  constexpr int RUNS = (CP / 8 + 31) / 32, ROWS = 32 / WARPS;
  // the warp's rows side by side, so that their shuffles overlap
  float v[ROWS][RUNS][8], mean[ROWS], inv[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      const int c = 8 * (lane + 32 * i);
      const uint4 u = c < CP ? *reinterpret_cast<const uint4*>(bx + ew_off(w + k * WARPS, c))
                             : make_uint4(0u, 0u, 0u, 0u);
      const unsigned uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[k][i][2 * e] = __uint_as_float(uu[e] << 16);
        v[k][i][2 * e + 1] = __uint_as_float(uu[e] & 0xffff0000u);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[k][i][e];
    }
    mean[k] = s;
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) mean[k] = __fmul_rn(warp_sum(mean[k]), 1.0f / (float)C);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < RUNS; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = 8 * (lane + 32 * i) + e < C ? __fsub_rn(v[k][i][e], mean[k]) : 0.0f;
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    inv[k] = q;
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    inv[k] = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(inv[k]), 1.0f / (float)C), eps));
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    const int c = 8 * (lane + 32 * i);
    if (c >= CP) continue;
    float2 gg[4], bb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gg[e] = kw_vec(vec, CP, KV_G, c + 2 * e);
      bb[e] = kw_vec(vec, CP, KV_BE, c + 2 * e);
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      unsigned o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = pack_bf16(kw_ln(v[k][i][2 * e], mean[k], inv[k], gg[e].x, bb[e].x),
                         kw_ln(v[k][i][2 * e + 1], mean[k], inv[k], gg[e].y, bb[e].y));
      *reinterpret_cast<uint4*>(bx + ew_off(w + k * WARPS + 32, c)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// One pass: sum = the layer input at xa (KS k slabs) times the pass's 64 PQ
// rows of W, unit by unit from the ring (k slab ks of 64-row part u): each
// unit's products into a fresh accumulator tmp[i % 2], added into the
// part's sum (fp32, round to nearest) once they are done, while the next
// unit's run.
template <int KS, int PQ, int S>
__device__ __forceinline__ void kw_pass(float (&sum)[PQ * 32], float (&tmp)[2][32],
                                        EwRing<S, EW_BOX>& ring, unsigned xa, int lane) {
  acc_zero(sum);
#pragma unroll
  for (int i = 0; i < KS * PQ; ++i) {
    const int ks = i / PQ;
    const unsigned b = ring.next();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(tmp[i & 1], wg_desc(xa + ks * EW_BOX + kk * 32, 16),
                         wg_desc(b + kk * 32, 16), kk > 0);
    wg_commit();
    if (i > 0) {
      wg_wait<1>();
      ring.give(lane);
      reg_fence(tmp[(i - 1) & 1]);
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[32 * ((i - 1) % PQ) + e] += tmp[(i - 1) & 1][e];
    }
  }
  wg_wait<0>();
  ring.give(lane);
  reg_fence(tmp[(KS * PQ - 1) & 1]);
#pragma unroll
  for (int e = 0; e < 32; ++e) sum[32 * (PQ - 1) + e] += tmp[(KS * PQ - 1) & 1][e];
}

// Per tile, each ring's load units: for each layer, each pass (64 PQ rows
// of the ring's NH rows of W_i), each 64-deep k slab, each 64-row part.
template <int NH, bool SPLIT>
__global__ void __launch_bounds__(EW_THREADS, 1)
    kpt_head_wide_kernel(const __grid_constant__ CUtensorMap map_w0,
                         const __grid_constant__ CUtensorMap map_w1,
                         const __grid_constant__ CUtensorMap map_w2, KptWideArgs p) {
  constexpr int CP = kw_cp(NH, SPLIT), KS = CP / 64, NQ = NH / 64, RINGS = kw_rings(SPLIT);
  constexpr int PQ = NQ % 2 ? 1 : 2, NP = NQ / PQ;   // 64-column parts a pass, passes
  constexpr int S = kw_slots(NH, SPLIT);
  extern __shared__ unsigned char hw_raw[];
  unsigned char* boxes = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(hw_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring_at = boxes + (SPLIT ? 2 : 4) * KS * EW_BOX;
  float* part = reinterpret_cast<float*>(ring_at + RINGS * S * EW_BOX);   // dd's [o][wg][64]
  float* ctin = part + KW_RED / 4;            // coordinates in [warpgroup][2 tiles][32][2]
  float* vec = ctin + KW_CT / 4;              // the vectors [KV_N][CP]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vec + KV_N * CP);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RINGS * S; ++s) {
      mbar_init(&bars[2 * S * (s / S) + s % S], 1);                      // full
      mbar_init(&bars[2 * S * (s / S) + S + s % S], SPLIT ? 4 : 8);      // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long tiles = (p.R + kw_rows(SPLIT) - 1) / kw_rows(SPLIT);

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      EwRing<S, EW_BOX> ring[RINGS];
      for (int w = 0; w < RINGS; ++w) ring[w].place(ring_at + w * S * EW_BOX, bars + 2 * S * w);
      const CUtensorMap* maps[3] = {&map_w0, &map_w1, &map_w2};
      for (long it = blockIdx.x; it < tiles; it += gridDim.x)
        for (int l = 0; l < 3; ++l)
          for (int q = 0; q < NP; ++q)
            for (int ks = 0; ks < KS; ++ks)
              for (int u = 0; u < PQ; ++u)
                for (int w = 0; w < RINGS; ++w)
                  dw_unit(ring[w], maps[l], 64 * ks, w * NH + 64 * (PQ * q + u));
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1, ct = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = (ct >> 5) * 16 + (lane >> 2);      // tile rows row, row + 8
  const bool normed = row >= 32;                      // warps 2 and 3
  const int C = p.C, c0 = SPLIT ? wg * NH : 0;        // the warpgroup's first channel
  EwRing<S, EW_BOX> ring;
  ring.place(ring_at + (SPLIT ? wg : 0) * S * EW_BOX, bars + 2 * S * (SPLIT ? wg : 0));
  // the warpgroup's A boxes: set 0 takes x and the final norm, layer l
  // reads set l % 2 and writes set (l + 1) % 2
  unsigned char* bx[2];
  for (int b = 0; b < 2; ++b) bx[b] = boxes + (SPLIT ? b : 2 * wg + b) * KS * EW_BOX;
  const bool split = SPLIT;
  // both warpgroups of a split tile, or the warpgroup alone
  auto sync = [&]() {
    if (SPLIT) bar_consumers();
    else bar_wg(wg);
  };

  // the coordinates of the warpgroup's rows of its n-th tile: buffer n % 2
  float* const cts = ctin + wg * 2 * 64;
  kw_load_x<NH>(bx[0], cts, p.x, p.ct, blockIdx.x, p.R, C, c0, ct, split, wg);
  cp_async_commit();
  {
    // the vectors: every thread's loads at once, from clamped addresses
    const float* src[KV_WO] = {p.b0, p.b1, p.b2, p.g, p.be};
    for (int c = threadIdx.x - 128; c < CP; c += 256) {
      const int cc = c < C ? c : C - 1;
      float v[KV_N];
#pragma unroll
      for (int k = 0; k < KV_WO; ++k) v[k] = src[k][cc];
#pragma unroll
      for (int k = KV_WO; k < KV_N; ++k) v[k] = __bfloat162float(p.wo[(k - KV_WO) * C + cc]);
#pragma unroll
      for (int k = 0; k < KV_N; ++k) vec[k * CP + c] = c < C ? v[k] : 0.0f;
    }
  }
  bar_consumers();                   // the vectors are whole

  unsigned n = 0;
  for (long it = blockIdx.x; it < tiles; it += gridDim.x, ++n) {
    cp_async_wait<0>();
    sync();                          // the tile's rows are in the boxes
    // rows 32-63: the final norm of rows 0-31 (rows past R: of zeros), the
    // warpgroup's warps, or both warpgroups' over the shared boxes
    if (SPLIT) kw_layernorm<CP, 8>(bx[0], vec, C, p.eps, (threadIdx.x >> 5) - 4, lane);
    else kw_layernorm<CP, 4>(bx[0], vec, C, p.eps, ct >> 5, lane);
    fence_view_async();
    sync();                          // the tile's A rows are in the boxes

    float sum[PQ * 32], tmp[2][32];
    float dd[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int l = 0; l < 3; ++l) {
      const unsigned xa = smem_u32(bx[l & 1]);
      for (int q = 0; q < NP; ++q) {
        kw_pass<KS, PQ, S>(sum, tmp, ring, xa, lane);
        if (l == 2 && q == NP - 1) {
          sync();                    // every product of the tile's x boxes is done
          if (it + gridDim.x < tiles) {
            kw_load_x<NH>(bx[0], cts + ((n + 1) & 1) * 64, p.x, p.ct, it + gridDim.x, p.R, C,
                          c0, ct, split, wg);
            cp_async_commit();       // the next tile's rows, under this one's end
          }
        }
        // h = gelu(sum + b_l) over the pass's columns c: the padding columns
        // stay zero (zero weight rows and bias; groups of 8 wholly past C
        // skip the GELU)
        const int cq = c0 + 64 * PQ * q;
#pragma unroll
        for (int j = 0; j < 8 * PQ; ++j) {
          const int c = cq + 8 * j + 2 * t;
          if (cq + 8 * j >= C) {
            if (l < 2)
#pragma unroll
              for (int rh = 0; rh < 2; ++rh)
                *reinterpret_cast<unsigned*>(bx[(l + 1) & 1] + ew_off(row + 8 * rh, c)) = 0u;
            continue;
          }
          const float2 bb = kw_vec(vec, CP, KV_B0 + l, c);
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const float h0 = kw_gelu(sum[4 * j + 2 * rh] + bb.x);
            const float h1 = kw_gelu(sum[4 * j + 2 * rh + 1] + bb.y);
            if (l < 2) {
              *reinterpret_cast<unsigned*>(bx[(l + 1) & 1] + ew_off(row + 8 * rh, c)) =
                  pack_bf16(h0, h1);
            } else {
              // dd = bf16(h) . Wo^T, the thread's columns in order
              const float2 w0 = kw_vec(vec, CP, KV_WO, c), w1 = kw_vec(vec, CP, KV_WO + 1, c);
              dd[rh][0] = fmaf(bfr(h1), w0.y, fmaf(bfr(h0), w0.x, dd[rh][0]));
              dd[rh][1] = fmaf(bfr(h1), w1.y, fmaf(bfr(h0), w1.x, dd[rh][1]));
            }
          }
        }
      }
      if (l < 2) {
        fence_view_async();
        sync();                      // h is whole in the next boxes
      }
    }

#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int o = 0; o < 2; ++o) dd[rh][o] = quad_sum(dd[rh][o]);
    if constexpr (SPLIT) {
      if (t == 0)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
#pragma unroll
          for (int o = 0; o < 2; ++o) part[(2 * o + wg) * EW_ROWS + row + 8 * rh] = dd[rh][o];
      bar_consumers();
      // warpgroup w writes coordinate o = w: warpgroup 0's part plus 1's
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r = row + 8 * rh;
        dd[rh][wg] = part[2 * wg * EW_ROWS + r] + part[(2 * wg + 1) * EW_ROWS + r];
      }
    }
    if (t == 0) {
      const float* cin = cts + (n & 1) * 64;
      float* dst = normed ? p.outs : p.pts;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const long r = kw_src(it, row + 8 * rh, split, wg);
        if (r >= p.R) continue;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          if (SPLIT && o != wg) continue;
          const float c = fminf(fmaxf(cin[2 * ((row + 8 * rh) & 31) + o], 0.0f), 1.0f);
          const float inv = logf(fmaxf(c, p.ieps) / fmaxf(1.0f - c, p.ieps));
          dst[2 * r + o] = 1.0f / (1.0f + expf(-(inv + (dd[rh][o] + p.bo[o]))));
        }
      }
    }
  }
}

// ------------------------------------------------------------ entry points
// Return cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape they do not take.

template <int NH, bool SPLIT>
static int launch_kpt_wide(const CUtensorMap (&m)[3], const KptWideArgs& p, cudaStream_t s) {
  static bool configured = false;
  constexpr int smem = kw_smem(NH, SPLIT);
  unsigned grid = 0;
  int rc = dw_configure((const void*)kpt_head_wide_kernel<NH, SPLIT>, smem, configured);
  if (!rc) rc = dw_grid((p.R + kw_rows(SPLIT) - 1) / kw_rows(SPLIT), grid);
  if (rc) return rc;
  kpt_head_wide_kernel<NH, SPLIT><<<grid, EW_THREADS, smem, s>>>(m[0], m[1], m[2], p);
  return (int)cudaGetLastError();
}

// x [R, C] bf16, 16-byte aligned; w0, w1, w2 [Cp, Cp] bf16, zero past C
// (ops/kernels.py pad_cols), 32-byte aligned, with Cp the plan's c_pad (C
// rounded up to 64 up to 256 channels, else 2 ew_half(C)); wo [2, C] bf16;
// fp32 vectors g, be, b0, b1, b2 of C values, bo of 2; ct, pts, outs fp32
// [R, 2], ct 8-byte aligned.
extern "C" int ec_kpt_head_wide(const void* x, const void* g, const void* be, const void* w0,
                                const void* b0, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* wo, const void* bo, const void* ct,
                                void* pts, void* outs, long R, int C, int Cp, float eps,
                                float ieps, void* stream) {
  int nh = 0;
  bool split = false;
  if (C > 0) kw_instance(C, nh, split);
  if (R <= 0 || C <= 0 || C > HW_MAX_C || Cp != kw_cp(nh, split) || !x ||
      (reinterpret_cast<uintptr_t>(x) & 15) || !ct || (reinterpret_cast<uintptr_t>(ct) & 7) ||
      !hw_aligned(w0) || !hw_aligned(w1) || !hw_aligned(w2) || !wo || !g || !be || !b0 || !b1 ||
      !b2 || !bo || !pts || !outs)
    return (int)cudaErrorInvalidValue;
  // every weight in boxes of [64 rows x 64]
  CUtensorMap m[3];
  if (!encode_map(&m[0], w0, Cp, Cp, Cp, 0, 1, 64) ||
      !encode_map(&m[1], w1, Cp, Cp, Cp, 0, 1, 64) ||
      !encode_map(&m[2], w2, Cp, Cp, Cp, 0, 1, 64))
    return (int)cudaErrorInvalidValue;
  KptWideArgs p;
  p.x = static_cast<const bf16*>(x); p.wo = static_cast<const bf16*>(wo);
  p.g = static_cast<const float*>(g); p.be = static_cast<const float*>(be);
  p.b0 = static_cast<const float*>(b0); p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2); p.bo = static_cast<const float*>(bo);
  p.ct = static_cast<const float*>(ct);
  p.pts = static_cast<float*>(pts); p.outs = static_cast<float*>(outs);
  p.R = R; p.C = C; p.eps = eps; p.ieps = ieps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split) return nh == 192 ? launch_kpt_wide<192, true>(m, p, s) : launch_kpt_wide<256, true>(m, p, s);
  switch (nh) {
    case 64: return launch_kpt_wide<64, false>(m, p, s);
    case 128: return launch_kpt_wide<128, false>(m, p, s);
    case 192: return launch_kpt_wide<192, false>(m, p, s);
    default: return launch_kpt_wide<256, false>(m, p, s);
  }
}

// The layout the launch above takes at C channels, into out[5]: c_pad, the
// channels a warpgroup holds, rings, slots a ring, dynamic shared memory
// (ops/kernels.py kpt_wide_layout holds the same arithmetic for a plan
// made off the card).
extern "C" int ec_kpt_wide_layout(int C, int* out) {
  if (!out || C <= 0 || C > HW_MAX_C) return (int)cudaErrorInvalidValue;
  int nh = 0;
  bool split = false;
  kw_instance(C, nh, split);
  out[0] = kw_cp(nh, split);
  out[1] = nh;
  out[2] = kw_rings(split);
  out[3] = kw_slots(nh, split);
  out[4] = kw_smem(nh, split);
  return 0;
}
