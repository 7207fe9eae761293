// dec_post_self_wide_kernel, the decoder layer after its self-attention
// at every width but 256 channels: the design, bound and shared memory
// are dec_wide.cuh's.

#include "dec_wide.cuh"

// ---- dec_post_self_wide_kernel. Per tile, each warpgroup's load units:
// Wso's KS k slabs x NQ 64-row parts (a = att . Wso^T into part q of x),
// then for each 128-column chunk j of q2 the KS k slabs of its 64 rows of
// Wcq_x, then of Wcq_p.
struct DecSelfWideArgs {
  const bf16 *att, *xb, *qpos;
  const float *bso, *g1, *be1, *bcq;
  float* x1;
  bf16* q2;
  long R;
  int C;
  float eps;
};

template <int NH>
__global__ void __launch_bounds__(EW_THREADS, 1)
    dec_post_self_wide_kernel(const __grid_constant__ CUtensorMap map_wso,
                              const __grid_constant__ CUtensorMap map_wcqx,
                              const __grid_constant__ CUtensorMap map_wcqp, DecSelfWideArgs p) {
  constexpr int S = dw_slots(dw_self_fixed(NH));
  constexpr int KS = NH / 32;        // 64-column k slabs of the 2 NH padded channels
  constexpr int NQ = NH / 64;        // 64-column parts of a warpgroup's NH channels
  constexpr int CH = NH / 32;        // 128-column chunks of q2's 4 NH padded columns
  extern __shared__ unsigned char hw_raw[];
  const DwSmem sm = dw_smem_init<S>(hw_raw, 2 * NH * 256);
  unsigned char* xs = sm.boxes;               // att, then bf16(x1)
  unsigned char* qs = xs + NH * 256;          // qpos
  const int tiles = (int)((p.R + EW_ROWS - 1) / EW_ROWS);

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      EwRing<S, DW_SLOT> ring[2];
      ring[0].place(sm.ring, sm.bars);
      ring[1].place(sm.ring + S * DW_SLOT, sm.bars + 2 * S);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int ks = 0; ks < KS; ++ks)
          for (int q = 0; q < NQ; ++q)
            for (int w = 0; w < 2; ++w) dw_unit(ring[w], &map_wso, 64 * ks, w * NH + 64 * q);
        for (int j = 0; j < CH; ++j)
          for (int h = 0; h < 2; ++h)
            for (int ks = 0; ks < KS; ++ks)
              for (int w = 0; w < 2; ++w)
                dw_unit(ring[w], h ? &map_wcqp : &map_wcqx, 64 * ks, EW_CHUNK * j + 64 * w);
      }
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1, ct = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = (ct >> 5) * 16 + (lane >> 2);      // tile rows row, row + 8
  const int C = p.C;
  EwRing<S, DW_SLOT> ring;
  ring.place(sm.ring + wg * S * DW_SLOT, sm.bars + wg * 2 * S);
  const unsigned xa = smem_u32(xs), qa = smem_u32(qs);
  ew_load_att<NH>(xs, p.att, (long)blockIdx.x * EW_ROWS, p.R, C, wg, ct);
  ew_load_att<NH>(qs, p.qpos, (long)blockIdx.x * EW_ROWS, p.R, C, wg, ct);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long r0 = (long)tile * EW_ROWS + row, r1 = r0 + 8;
    const long s0 = r0 < p.R ? r0 : p.R - 1, s1 = r1 < p.R ? r1 : p.R - 1;
    ew_prefetch<NH>(p.xb, s0, C, wg * NH, t);
    ew_prefetch<NH>(p.xb, s1, C, wg * NH, t);
    cp_async_wait<0>();
    fence_view_async();
    bar_consumers();                 // the tile's att and qpos rows are in their boxes

    // a = att . Wso^T
    float x[NH / 2];
    acc_zero(x);
    reg_fence(x);
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const unsigned b = ring.next();
        ew_mma<64>(dw_part(x, q), xa + ks * EW_BOX, b);
        ring.issued(lane, ks == 0 && q == 0);
      }
    ring.drain(lane);
    reg_fence(x);

    // x1 = LN1(xb + (a + bso)), fp32 out, bf16 over the att boxes (both
    // warpgroups' products of them are complete: the LayerNorm's barriers)
    dw_residual<NH>(x, p.xb, s0, s1, p.bso, C, wg, t);
    ew_layernorm<NH>(x, sm.red, p.g1, p.be1, C, p.eps, wg, row, t);
    dw_store<NH>(x, p.x1, DT_F32, r0 < p.R ? r0 : -1, r1 < p.R ? r1 : -1, C, wg, t);
    dw_to_boxes<NH>(x, xs, wg, row, t);
    fence_view_async();
    bar_consumers();

    // q2 = bf16(bf16(x1) . Wcq_x^T + qpos . Wcq_p^T + bcq), 64 columns a
    // warpgroup a chunk
    for (int j = 0; j < CH; ++j) {
      float z[32];
      acc_zero(z);
      reg_fence(z);
      for (int h = 0; h < 2; ++h)
        for (int ks = 0; ks < KS; ++ks) {
          const unsigned b = ring.next();
          ew_mma<64>(z, (h ? qa : xa) + ks * EW_BOX, b);
          ring.issued(lane, h == 0 && ks == 0);
        }
      ring.drain(lane);
      reg_fence(z);
      if (j == CH - 1) {
        bar_consumers();             // both warpgroups' products of the boxes are done
        if (tile + (int)gridDim.x < tiles) {
          const long next = (long)(tile + gridDim.x) * EW_ROWS;
          ew_load_att<NH>(xs, p.att, next, p.R, C, wg, ct);
          ew_load_att<NH>(qs, p.qpos, next, p.R, C, wg, ct);
          cp_async_commit();         // the next tile's rows, under this one's end
        }
      }
      dw_store_chunk(z, p.q2, p.bcq, r0, r1, p.R, 2 * C, EW_CHUNK * j + 64 * wg, t);
    }
  }
}

// ------------------------------------------------------------ entry point
// Returns cudaGetLastError() after its launch, or cudaErrorInvalidValue
// for a shape it does not take.

template <int NH>
static int launch_dec_self(const CUtensorMap (&m)[3], const DecSelfWideArgs& p, cudaStream_t s) {
  static bool configured = false;
  constexpr int smem = dw_smem(dw_self_fixed(NH));
  unsigned grid = 0;
  int rc = dw_configure((const void*)dec_post_self_wide_kernel<NH>, smem, configured);
  if (!rc) rc = dw_grid((p.R + EW_ROWS - 1) / EW_ROWS, grid);
  if (rc) return rc;
  dec_post_self_wide_kernel<NH><<<grid, EW_THREADS, smem, s>>>(m[0], m[1], m[2], p);
  return (int)cudaGetLastError();
}

// att, xb, qpos [R, C] bf16, att and qpos 16-byte aligned; wso [Cp, Cp],
// wcqx, wcqp [C2p, Cp] bf16, zero past C and 2C (ops/kernels.py pad_cols),
// 32-byte aligned, with Cp = 2 ew_half(C) and C2p = 2 Cp, so that every
// box the tensor maps read lies inside them; fp32 vectors of C values
// (bcq: 2C); x1 [R, C] fp32 and q2 [R, 2C] bf16 out.
extern "C" int ec_dec_post_self_wide(const void* att, const void* xb, const void* qpos,
                                     const void* wso, const void* bso, const void* g1,
                                     const void* be1, const void* wcqx, const void* wcqp,
                                     const void* bcq, void* x1, void* q2, long R, int C,
                                     int Cp, int C2p, float eps, void* stream) {
  const int nh = ew_half(C);
  if (R <= 0 || R > 2147483647L * EW_ROWS || C <= 0 || C > HW_MAX_C || Cp != 2 * nh ||
      C2p != 2 * Cp || !att || !xb || !qpos || !x1 || !q2 ||
      (reinterpret_cast<uintptr_t>(att) & 15) || (reinterpret_cast<uintptr_t>(qpos) & 15) ||
      !hw_aligned(wso) || !hw_aligned(wcqx) || !hw_aligned(wcqp))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  if (!encode_map(&m[0], wso, Cp, Cp, Cp, 0, 1, 64) ||
      !encode_map(&m[1], wcqx, Cp, C2p, Cp, 0, 1, 64) ||
      !encode_map(&m[2], wcqp, Cp, C2p, Cp, 0, 1, 64))
    return (int)cudaErrorInvalidValue;
  DecSelfWideArgs p;
  p.att = static_cast<const bf16*>(att); p.xb = static_cast<const bf16*>(xb);
  p.qpos = static_cast<const bf16*>(qpos);
  p.bso = static_cast<const float*>(bso); p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1); p.bcq = static_cast<const float*>(bcq);
  p.x1 = static_cast<float*>(x1); p.q2 = static_cast<bf16*>(q2);
  p.R = R; p.C = C; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nh) {
    case 64: return launch_dec_self<64>(m, p, s);
    case 128: return launch_dec_self<128>(m, p, s);
    case 192: return launch_dec_self<192>(m, p, s);
    default: return launch_dec_self<256>(m, p, s);
  }
}
