// dec_post_cross_wide_kernel and dec_post_gcn_wide_kernel, the decoder
// layer after its cross-attention at every width but 256 channels, and at
// 256 channels above 128 keypoints a batch row, two launches: the design,
// bound and shared memory are dec_wide.cuh's.

#include "dec_wide.cuh"

// ---- dec_post_cross_wide_kernel. Per tile, each warpgroup's load units:
// for each 128-column chunk j of o2, the KO k slabs of its 64 rows of Wco
// (o2's chunk), then Wch's two 64-column k slabs of the chunk x NQ parts
// (x += o2 . Wch^T); then for each 128-column chunk of y the KS k slabs
// of its 64 rows of Wg.
struct DecCrossWideArgs {
  const bf16* att2;         // [R, 2C]
  const float *bco, *bch, *g2, *be2, *bg;
  const float* x1;          // [R, C]
  float* x2;                // [R, C]
  bf16* y;                  // [R, 2 Fp]
  long R;
  int C, Fp;
  float eps;
};

template <int NH>
__global__ void __launch_bounds__(EW_THREADS, 1)
    dec_post_cross_wide_kernel(const __grid_constant__ CUtensorMap map_wco,
                               const __grid_constant__ CUtensorMap map_wch,
                               const __grid_constant__ CUtensorMap map_wg, DecCrossWideArgs p) {
  constexpr int S = dw_slots(dw_cross_fixed(NH));
  constexpr int KO = NH / 16;        // k slabs of att2's 4 NH padded columns
  constexpr int CH = NH / 32;        // 128-column chunks of o2
  constexpr int KS = NH / 32;        // k slabs of x2's 2 NH padded channels
  constexpr int NQ = NH / 64;
  extern __shared__ unsigned char hw_raw[];
  const DwSmem sm = dw_smem_init<S>(hw_raw, NH * 512 + 4 * EW_BOX);
  unsigned char* as = sm.boxes;               // att2; then bf16(x2) over its first half
  unsigned char* hs = as + NH * 512;          // two buffers of an o2 chunk
  const int tiles = (int)((p.R + EW_ROWS - 1) / EW_ROWS);
  const int ych = 2 * p.Fp / EW_CHUNK;

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      EwRing<S, DW_SLOT> ring[2];
      ring[0].place(sm.ring, sm.bars);
      ring[1].place(sm.ring + S * DW_SLOT, sm.bars + 2 * S);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int j = 0; j < CH; ++j) {
          for (int ks = 0; ks < KO; ++ks)
            for (int w = 0; w < 2; ++w) dw_unit(ring[w], &map_wco, 64 * ks, EW_CHUNK * j + 64 * w);
          for (int kh = 0; kh < 2; ++kh)
            for (int q = 0; q < NQ; ++q)
              for (int w = 0; w < 2; ++w)
                dw_unit(ring[w], &map_wch, EW_CHUNK * j + 64 * kh, w * NH + 64 * q);
        }
        for (int j = 0; j < ych; ++j)
          for (int ks = 0; ks < KS; ++ks)
            for (int w = 0; w < 2; ++w) dw_unit(ring[w], &map_wg, 64 * ks, EW_CHUNK * j + 64 * w);
      }
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1, ct = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = (ct >> 5) * 16 + (lane >> 2);
  const int C = p.C;
  EwRing<S, DW_SLOT> ring;
  ring.place(sm.ring + wg * S * DW_SLOT, sm.bars + wg * 2 * S);
  const unsigned aa = smem_u32(as), ha = smem_u32(hs);
  ew_load_att<2 * NH>(as, p.att2, (long)blockIdx.x * EW_ROWS, p.R, 2 * C, wg, ct);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long r0 = (long)tile * EW_ROWS + row, r1 = r0 + 8;
    const long s0 = r0 < p.R ? r0 : p.R - 1, s1 = r1 < p.R ? r1 : p.R - 1;
    // the fp32 rows of x1, as bf16 rows of 2C values
    ew_prefetch<2 * NH>(reinterpret_cast<const bf16*>(p.x1), s0, 2 * C, 2 * wg * NH, t);
    ew_prefetch<2 * NH>(reinterpret_cast<const bf16*>(p.x1), s1, 2 * C, 2 * wg * NH, t);
    cp_async_wait<0>();
    fence_view_async();
    bar_consumers();                 // the tile's att2 rows are in their boxes

    float x[NH / 2];
    acc_zero(x);
    reg_fence(x);
    for (int j = 0; j < CH; ++j) {
      // this warpgroup's 64 columns of o2's chunk j
      float f[32];
      acc_zero(f);
      reg_fence(f);
      for (int ks = 0; ks < KO; ++ks) {
        const unsigned b = ring.next();
        ew_mma<64>(f, aa + ks * EW_BOX, b);
        ring.issued(lane, ks == 0);
      }
      ring.drain(lane);
      reg_fence(f);
      // bf16(o2 + bco) into buffer j % 2: the other warpgroup read that
      // buffer (chunk j - 2) before the barrier of chunk j - 1 below
      unsigned char* hb = hs + (j & 1) * 2 * EW_BOX;
      dw_chunk_to_box(f, hb + wg * EW_BOX, p.bco, EW_CHUNK * j + 64 * wg, 2 * C, false, row, t);
      fence_view_async();
      bar_consumers();               // the chunk of o2 is whole
      reg_fence(x);
      // x += o2 . Wch^T: unit (kh, q) holds k slab kh of the chunk for part q
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const unsigned b = ring.next();
          ew_mma<64>(dw_part(x, q), ha + (j & 1) * 2 * EW_BOX + kh * EW_BOX, b);
          ring.issued(lane, kh == 0 && q == 0);
        }
      ring.drain(lane);
      reg_fence(x);
    }

    // x2 = LN2(x1 + (x + bch)), fp32 out, bf16 over the att2 boxes (both
    // warpgroups' products of att2 are complete: the LayerNorm's barriers)
    dw_residual<NH>(x, p.x1, s0, s1, p.bch, C, wg, t);
    ew_layernorm<NH>(x, sm.red, p.g2, p.be2, C, p.eps, wg, row, t);
    dw_store<NH>(x, p.x2, DT_F32, r0 < p.R ? r0 : -1, r1 < p.R ? r1 : -1, C, wg, t);
    dw_to_boxes<NH>(x, as, wg, row, t);
    fence_view_async();
    bar_consumers();

    // y = bf16(bf16(x2) . Wg^T + bg), 64 columns a warpgroup a chunk
    for (int j = 0; j < ych; ++j) {
      float f[32];
      acc_zero(f);
      reg_fence(f);
      for (int ks = 0; ks < KS; ++ks) {
        const unsigned b = ring.next();
        ew_mma<64>(f, aa + ks * EW_BOX, b);
        ring.issued(lane, ks == 0);
      }
      ring.drain(lane);
      reg_fence(f);
      if (j == ych - 1) {
        bar_consumers();             // both warpgroups' products of the boxes are done
        if (tile + (int)gridDim.x < tiles) {
          ew_load_att<2 * NH>(as, p.att2, (long)(tile + gridDim.x) * EW_ROWS, p.R, 2 * C, wg, ct);
          cp_async_commit();         // the next tile's att2, under this one's end
        }
      }
      dw_store_chunk(f, p.y, p.bg, r0, r1, p.R, 2 * p.Fp, EW_CHUNK * j + 64 * wg, t);
    }
  }
}

// ---- dec_post_gcn_wide_kernel. A tile: 64 rows of one batch row (kt =
// ceil(K / 64) tiles a batch row). Per tile, each warpgroup's load units:
// for each 128-column chunk j of F, y0's then y1's kt boxes of 64 keys of
// its 64 columns (m), then Wf's two 64-column k slabs of the chunk x NQ
// parts (f += bf16(relu(m)) . Wf^T).
struct DecGcnWideArgs {
  const void* adj; int adj_dt;   // [B, 2, K, K]
  const float *x2, *bf, *g3, *be3;
  void* out; int out_dt;         // [B K, C]
  int B, K, C, Fp;
  float eps;
};

// Up to 128 keypoints (kt <= 2): the tile's rows of both adjacency slices
// as bf16, zero past K, slice s in boxes 2 s, 2 s + 1: two threads a row
// of a slice, each loading all of its half row (16-byte loads where the
// rows allow) before it stores.
__device__ __forceinline__ void dw_adj_rows(unsigned char* js, const DecGcnWideArgs& p, int b,
                                            int i0, int kt) {
  const int K = p.K;
  const int sr = (threadIdx.x - 128) >> 1, s = sr >> 6, r = sr & 63, i = i0 + r;
  const int half = 32 * kt, c0 = (threadIdx.x & 1) * half;
  const long off = (((long)b * 2 + s) * K + (i < K ? i : 0)) * K;
  const bool f32 = p.adj_dt == DT_F32;
  const bool vec = !(K & 3) && !(reinterpret_cast<uintptr_t>(p.adj) & 15);
  float v[64];
#pragma unroll
  for (int g = 0; g < 16; ++g) {
    const int c = c0 + 4 * g;
    if (4 * g < half && i < K && vec && c + 3 < K) {
      if (f32) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(
            static_cast<const float*>(p.adj) + off + c));
        v[4 * g] = q.x; v[4 * g + 1] = q.y; v[4 * g + 2] = q.z; v[4 * g + 3] = q.w;
      } else {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(
            static_cast<const bf16*>(p.adj) + off + c));
        v[4 * g] = __uint_as_float(q.x << 16);
        v[4 * g + 1] = __uint_as_float(q.x & 0xffff0000u);
        v[4 * g + 2] = __uint_as_float(q.y << 16);
        v[4 * g + 3] = __uint_as_float(q.y & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[4 * g + e] = 4 * g < half && i < K && c + e < K ? ld_val(p.adj, p.adj_dt, off + c + e)
                                                          : 0.0f;
    }
  }
#pragma unroll
  for (int g = 0; g < 16; ++g)
    if (4 * g < half)
      *reinterpret_cast<uint2*>(js + s * 2 * EW_BOX + ew_off(r, c0 + 4 * g)) =
          make_uint2(pack_bf16(v[4 * g], v[4 * g + 1]), pack_bf16(v[4 * g + 2], v[4 * g + 3]));
}

// Above 128 keypoints: the adjacency boxes of units [e0, e0 + n) of the
// tile of batch row b
// from row i0 (unit e: slice e / kt, keys 64 (e % kt) ..) into boxes 0 ..
// n - 1 of js, as bf16, zero past K: the consumer thread ct (0 .. 255)
// takes 16 keys of row ct / 4 of every box, G boxes at a time, all of
// their loads (16-byte where the rows allow) before its stores.
template <int G>
__device__ __forceinline__ void dw_adj_boxes(unsigned char* js, const DecGcnWideArgs& p, int b,
                                             int i0, int kt, int e0, int n, int ct) {
  const int r = ct >> 2, c16 = (ct & 3) * 16, i = i0 + r, K = p.K;
  const bool f32 = p.adj_dt == DT_F32;
  const bool vec = !(K & 3) && !(reinterpret_cast<uintptr_t>(p.adj) & 15);
  for (int e = 0; e < n; e += G) {
    unsigned u[G][8];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int unit = e0 + e + gi, s = unit / kt, c0 = 64 * (unit % kt) + c16;
      const bool row = e + gi < n && i < K;
      const long off = (((long)b * 2 + s) * K + (row ? i : 0)) * K;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + 4 * q;
        float v[4];
        if (row && vec && c + 3 < K) {
          if (f32) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(
                static_cast<const float*>(p.adj) + off + c));
            v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
          } else {
            const uint2 w = __ldg(reinterpret_cast<const uint2*>(
                static_cast<const bf16*>(p.adj) + off + c));
            v[0] = __uint_as_float(w.x << 16);
            v[1] = __uint_as_float(w.x & 0xffff0000u);
            v[2] = __uint_as_float(w.y << 16);
            v[3] = __uint_as_float(w.y & 0xffff0000u);
          }
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            v[x] = row && c + x < K ? ld_val(p.adj, p.adj_dt, off + c + x) : 0.0f;
        }
        u[gi][2 * q] = pack_bf16(v[0], v[1]);
        u[gi][2 * q + 1] = pack_bf16(v[2], v[3]);
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (e + gi < n) {
        unsigned char* box = js + (e + gi) * EW_BOX;
        *reinterpret_cast<uint4*>(box + ew_off(r, c16)) =
            make_uint4(u[gi][0], u[gi][1], u[gi][2], u[gi][3]);
        *reinterpret_cast<uint4*>(box + ew_off(r, c16 + 8)) =
            make_uint4(u[gi][4], u[gi][5], u[gi][6], u[gi][7]);
      }
  }
}

template <int NH, int W>
__global__ void __launch_bounds__(EW_THREADS, 1)
    dec_post_gcn_wide_kernel(const __grid_constant__ CUtensorMap map_y,
                             const __grid_constant__ CUtensorMap map_wf, DecGcnWideArgs p) {
  constexpr int S = dw_slots(dw_gcn_fixed(W));
  constexpr int NQ = NH / 64;
  extern __shared__ unsigned char hw_raw[];
  const DwSmem sm = dw_smem_init<S>(hw_raw, (W + 4) * EW_BOX);
  // the adjacency window: unit e0 + e in box e (the short window: unit
  // s kt + q in box 2 s + q)
  unsigned char* js = sm.boxes;
  unsigned char* hs = js + W * EW_BOX;        // two buffers of a relu(m) chunk
  const int kt = (p.K + 63) / 64, units = 2 * kt;
  // a tile's boxes resident, loaded once (always in the short window's
  // instance, which K <= 128 takes: no windowed code in it)
  const bool whole = W == DW_ADJ_SHORT || units <= W;
  const int tiles = p.B * kt, fch = p.Fp / EW_CHUNK;

  if (threadIdx.x < 128) {
    regs_producer();
    if (threadIdx.x == 0) {
      EwRing<S, DW_SLOT> ring[2];
      ring[0].place(sm.ring, sm.bars);
      ring[1].place(sm.ring + S * DW_SLOT, sm.bars + 2 * S);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int b = tile / kt;
        for (int j = 0; j < fch; ++j) {
          for (int s = 0; s < 2; ++s)
            for (int q = 0; q < kt; ++q)
              for (int w = 0; w < 2; ++w)
                dw_unit(ring[w], &map_y, s * p.Fp + EW_CHUNK * j + 64 * w, 64 * q, b);
          for (int kh = 0; kh < 2; ++kh)
            for (int q = 0; q < NQ; ++q)
              for (int w = 0; w < 2; ++w)
                dw_unit(ring[w], &map_wf, EW_CHUNK * j + 64 * kh, w * NH + 64 * q);
        }
      }
    }
    return;
  }

  regs_consumer();
  const int wg = (threadIdx.x >> 7) - 1, ct = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = (ct >> 5) * 16 + (lane >> 2);
  const int C = p.C, K = p.K;
  EwRing<S, DW_SLOT> ring;
  ring.place(sm.ring + wg * S * DW_SLOT, sm.bars + wg * 2 * S);
  const unsigned ja = smem_u32(js), ha = smem_u32(hs);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / kt, i0 = 64 * (tile % kt);
    const long base = (long)b * K;
    const int i_0 = i0 + row, i_1 = i_0 + 8;
    const long s0 = base + (i_0 < K ? i_0 : K - 1), s1 = base + (i_1 < K ? i_1 : K - 1);
    ew_prefetch<2 * NH>(reinterpret_cast<const bf16*>(p.x2), s0, 2 * C, 2 * wg * NH, t);
    ew_prefetch<2 * NH>(reinterpret_cast<const bf16*>(p.x2), s1, 2 * C, 2 * wg * NH, t);
    if (whole) {
      // the tile's adjacency rows (the last tile's products of these
      // boxes are complete: its LayerNorm's barriers)
      if constexpr (W == DW_ADJ_SHORT) dw_adj_rows(js, p, b, i0, kt);
      else dw_adj_boxes<4>(js, p, b, i0, kt, 0, units, threadIdx.x - 128);
      fence_view_async();
      bar_consumers();
    }

    float f[NH / 2];
    acc_zero(f);
    reg_fence(f);
    for (int j = 0; j < fch; ++j) {
      // m = adj0 . y0 + adj1 . y1 over this warpgroup's 64 columns of chunk
      // j; unit e holds keys [64 (e % kt), + 64) of y_(e / kt), MN-major
      float m[32];
      acc_zero(m);
      reg_fence(m);
      if constexpr (W == DW_ADJ_SHORT) {
        // slice s's keys [64 q, 64 q + 64) in box 2 s + q
        for (int s = 0; s < 2; ++s)
          for (int q = 0; q < kt; ++q) {
            const unsigned yb = ring.next();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64n64k16<1>(m, wg_desc(ja + (2 * s + q) * EW_BOX + kk * 32, 16),
                                 wg_desc(yb + kk * 2048, EW_BOX));
            ring.issued(lane, s == 0 && q == 0);
          }
        ring.drain(lane);
        reg_fence(m);
      } else {
        for (int e0 = 0; e0 < units; e0 += W) {
          const int n = units - e0 < W ? units - e0 : W;
          if (!whole) {
            bar_consumers();         // both warpgroups' products of the last window are done
            dw_adj_boxes<1>(js, p, b, i0, kt, e0, n, threadIdx.x - 128);
            fence_view_async();
            bar_consumers();
          }
          for (int e = 0; e < n; ++e) {
            const unsigned yb = ring.next();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64n64k16<1>(m, wg_desc(ja + e * EW_BOX + kk * 32, 16),
                                 wg_desc(yb + kk * 2048, EW_BOX));
            ring.issued(lane, e == 0);
          }
          ring.drain(lane);
          reg_fence(m);
        }
      }
      // bf16(relu(m)) into buffer j % 2 (free: see the cross kernel)
      unsigned char* hb = hs + (j & 1) * 2 * EW_BOX;
      dw_chunk_to_box(m, hb + wg * EW_BOX, nullptr, 0, 0, true, row, t);
      fence_view_async();
      bar_consumers();               // the chunk of relu(m) is whole
      reg_fence(f);
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const unsigned w = ring.next();
          ew_mma<64>(dw_part(f, q), ha + (j & 1) * 2 * EW_BOX + kh * EW_BOX, w);
          ring.issued(lane, kh == 0 && q == 0);
        }
      ring.drain(lane);
      reg_fence(f);
    }

    // out = LN3(x2 + (f + bf)) over the tile's rows below K
    dw_residual<NH>(f, p.x2, s0, s1, p.bf, C, wg, t);
    ew_layernorm<NH>(f, sm.red, p.g3, p.be3, C, p.eps, wg, row, t);
    dw_store<NH>(f, p.out, p.out_dt, i_0 < K ? base + i_0 : -1, i_1 < K ? base + i_1 : -1, C,
                 wg, t);
  }
}

// ------------------------------------------------------------ entry points
// Each returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a shape it does not take.

template <int NH, int W>
static int launch_gcn(const CUtensorMap& map_y, const CUtensorMap& map_wf,
                      const DecGcnWideArgs& pb, cudaStream_t s) {
  static bool configured = false;
  constexpr int smem = dw_smem(dw_gcn_fixed(W));
  unsigned grid = 0;
  int rc = dw_configure((const void*)dec_post_gcn_wide_kernel<NH, W>, smem, configured);
  if (!rc) rc = dw_grid((long)pb.B * ((pb.K + 63) / 64), grid);
  if (rc) return rc;
  dec_post_gcn_wide_kernel<NH, W><<<grid, EW_THREADS, smem, s>>>(map_y, map_wf, pb);
  return (int)cudaGetLastError();
}

template <int NH>
static int launch_dec_cross(const CUtensorMap (&m)[5], const DecCrossWideArgs& pa,
                            const DecGcnWideArgs& pb, cudaStream_t s) {
  static bool configured = false;
  constexpr int smem_a = dw_smem(dw_cross_fixed(NH));
  unsigned grid_a = 0;
  int rc = dw_configure((const void*)dec_post_cross_wide_kernel<NH>, smem_a, configured);
  if (!rc) rc = dw_grid((pa.R + EW_ROWS - 1) / EW_ROWS, grid_a);
  if (rc) return rc;
  dec_post_cross_wide_kernel<NH><<<grid_a, EW_THREADS, smem_a, s>>>(m[0], m[1], m[2], pa);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return dw_adj_window(pb.K) == DW_ADJ_SHORT ? launch_gcn<NH, DW_ADJ_SHORT>(m[3], m[4], pb, s)
                                             : launch_gcn<NH, DW_ADJ_LONG>(m[3], m[4], pb, s);
}

// att2 [B K, 2C] bf16, 16-byte aligned; wco [C2p, C2p], wch [Cp, C2p], wg
// [2 Fp, Cp], wf [Cp, Fp] bf16, zero past C, 2C and F (ops/kernels.py
// pad_cols, pad_gcn), 32-byte aligned, with Cp = 2 ew_half(C), C2p = 2 Cp
// and Fp a multiple of EW_CHUNK; fp32 vectors of C values (bco: 2C, bg: 2
// Fp); x1 [B K, C] fp32; adj [B, 2, K, K] fp32 or bf16 (adj_dt); the
// scratch x2 [B K, C] fp32 and y [B K, 2 Fp] bf16 (32-byte aligned); out
// [B K, C] (out_dt). Two launches: dec_post_cross_wide_kernel, then
// dec_post_gcn_wide_kernel.
extern "C" int ec_dec_post_cross_wide(const void* att2, const void* wco, const void* bco,
                                      const void* wch, const void* bch, const void* x1,
                                      const void* g2, const void* be2, const void* wg,
                                      const void* bg, const void* adj, int adj_dt,
                                      const void* wf, const void* bf, const void* g3,
                                      const void* be3, void* x2, void* y, void* out,
                                      int out_dt, int B, int K, int C, int Cp, int C2p, int Fp,
                                      float eps, void* stream) {
  const int nh = ew_half(C);
  if (B <= 0 || K <= 0 || C <= 0 || C > HW_MAX_C || Cp != 2 * nh || C2p != 2 * Cp ||
      Fp <= 0 || Fp % EW_CHUNK || (long)B * K > 2147483647L || !att2 ||
      !x1 || !adj || !x2 || !out || (reinterpret_cast<uintptr_t>(att2) & 15) ||
      !hw_aligned(wco) || !hw_aligned(wch) || !hw_aligned(wg) || !hw_aligned(wf) ||
      !hw_aligned(y))
    return (int)cudaErrorInvalidValue;
  // the weights in boxes of [64 rows x 64]; y as [B, K, 2 Fp] in boxes of
  // [64 keys x 64] (the keys past K fill with zeros)
  CUtensorMap m[5];
  if (!encode_map(&m[0], wco, C2p, C2p, C2p, 0, 1, 64) ||
      !encode_map(&m[1], wch, C2p, Cp, C2p, 0, 1, 64) ||
      !encode_map(&m[2], wg, Cp, 2L * Fp, Cp, 0, 1, 64) ||
      !encode_map(&m[3], y, 2L * Fp, K, 2L * Fp, 2L * Fp * K, B, 64) ||
      !encode_map(&m[4], wf, Fp, Cp, Fp, 0, 1, 64))
    return (int)cudaErrorInvalidValue;
  DecCrossWideArgs pa;
  pa.att2 = static_cast<const bf16*>(att2);
  pa.bco = static_cast<const float*>(bco); pa.bch = static_cast<const float*>(bch);
  pa.g2 = static_cast<const float*>(g2); pa.be2 = static_cast<const float*>(be2);
  pa.bg = static_cast<const float*>(bg);
  pa.x1 = static_cast<const float*>(x1);
  pa.x2 = static_cast<float*>(x2); pa.y = static_cast<bf16*>(y);
  pa.R = (long)B * K; pa.C = C; pa.Fp = Fp; pa.eps = eps;
  DecGcnWideArgs pb;
  pb.adj = adj; pb.adj_dt = adj_dt;
  pb.x2 = static_cast<const float*>(x2);
  pb.bf = static_cast<const float*>(bf); pb.g3 = static_cast<const float*>(g3);
  pb.be3 = static_cast<const float*>(be3);
  pb.out = out; pb.out_dt = out_dt;
  pb.B = B; pb.K = K; pb.C = C; pb.Fp = Fp; pb.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nh) {
    case 64: return launch_dec_cross<64>(m, pa, pb, s);
    case 128: return launch_dec_cross<128>(m, pa, pb, s);
    case 192: return launch_dec_cross<192>(m, pa, pb, s);
    default: return launch_dec_cross<256>(m, pa, pb, s);
  }
}

// The ring slots a warpgroup and the dynamic shared memory each launch
// above (and dec_self_wide.cu's) takes at C channels and K keypoints a
// batch row, into out[6]: the self, cross and gcn kernels' slots and bytes
// in turn (ops/kernels.py dec_wide_rings holds the same arithmetic for a
// plan made off the card).
extern "C" int ec_dec_wide_layout(int C, int K, int* out) {
  if (!out || C <= 0 || C > HW_MAX_C || K <= 0) return (int)cudaErrorInvalidValue;
  const int nh = ew_half(C);
  const int fixed[3] = {dw_self_fixed(nh), dw_cross_fixed(nh), dw_gcn_fixed(dw_adj_window(K))};
  for (int i = 0; i < 3; ++i) {
    out[2 * i] = dw_slots(fixed[i]);
    out[2 * i + 1] = dw_smem(fixed[i]);
  }
  return 0;
}
