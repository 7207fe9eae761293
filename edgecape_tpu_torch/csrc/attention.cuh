// Building blocks of the attention kernels (kernels.cu: attn_kernel,
// train_fwd_kernel, the backward pair, bias_attn_kernel; attn_long.cu:
// the same kernels with the keys or queries streamed through shared
// memory; bias_long.cu: the bias attention above 128 keys): loads into shared memory, the arguments of a call, the
// mma.sync score and P.V tiles with their key permutation, the Philox
// dropout bits and the backward's chunks. The design notes are beside the
// kernels in kernels.cu ("attention", "training attention").

#pragma once

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float ld_val(const void* p, int dt, long i) {
  return dt == DT_F32 ? static_cast<const float*>(p)[i]
                      : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

__device__ __forceinline__ void st_val(void* p, int dt, long i, float v) {
  if (dt == DT_F32) {
    static_cast<float*>(p)[i] = v;
  } else {
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  }
}

// Copy 8 consecutive bf16 values (the first `valid` of them; the rest are
// zero) into 16-byte-aligned shared memory: one 16-byte load when the
// source allows it.
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, int valid) {
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dst[i] = i < valid ? src[i] : __float2bfloat16(0.0f);
    }
  }
}

// As load8, from a bf16 or fp32 source (fp32 is rounded to bf16).
__device__ __forceinline__ void load8_any(bf16* dst, const void* base, int dt,
                                          long off, int valid) {
  if (dt == DT_BF16) {
    load8(dst, static_cast<const bf16*>(base) + off, valid);
  } else {
    const float* s = static_cast<const float*>(base) + off;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dst[i] = __float2bfloat16(i < valid ? s[i] : 0.0f);
    }
  }
}

// Copy 8 bf16 values into shared memory: an asynchronous 16-byte copy
// (cp.async, completed by cp_async_wait) when the source is whole and
// aligned, else synchronous element loads with zero fill.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int valid) {
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < valid ? src[i] : __float2bfloat16(0.0f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#define ATT_MAX_NK 512     // keys a block holds in shared memory
#define ATT_ROW16 8        // 16-key tiles of a row held in registers (one pass)
#define ATT_CH16 2         // 16-key tiles per chunk of the two-pass form
#define ATT_SMEM_LIMIT (227 * 1024)

struct AttnArgs {
  const void* q; const void* k; const void* v; int in_dt;
  long sqb, sqn, skb, skn, svb, svn;
  int H, Nq, Nk, NK16;               // NK16: 16-key tiles (keys padded to NK16 * 16)
  const unsigned char* kvalid; long skvb;   // bool [B, Nk], 1 = attend; or null
  const float* bias;                 // [B, H, Nq, Nk] or null
  float scale;
  void* out; int out_dt; long sob, son;
  // training forward
  const unsigned long long* seed;    // one value on the device; read when thresh > 0
  unsigned thresh; float inv_keep;   // thresh 0: no dropout
  float* stats;                      // [B * H, Nq, 2]: row max, 1 / exp-sum
};

// The launch plan, made by ops/kernels.py attention_plan.
struct AttnPlan { int qsplit, warps, chunk16; long smem; };

__device__ __forceinline__ void ldsm_x4(const bf16* ptr, unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(const bf16* ptr, unsigned& r0, unsigned& r1,
                                          unsigned& r2, unsigned& r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(a));
}

// c += a . b for one m16n8k16 tile: bf16 operands, fp32 accumulator. Lane
// (g = lane / 4, t = lane % 4) holds c[0..1] = rows g, columns 2t, 2t + 1
// and c[2..3] = row g + 8, the same columns.
__device__ __forceinline__ void mma16816(float* c, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 8 values of a q / k / v row into shared memory: cp.async for a whole,
// aligned bf16 source, a converting load for fp32, zeros when !valid.
__device__ __forceinline__ void stage8(bf16* dst, const void* base, int dt, long off,
                                       bool valid) {
  if (dt == DT_BF16) {
    copy8(dst, static_cast<const bf16*>(base) + off, valid ? 8 : 0);
  } else {
    load8_any(dst, base, dt, off, valid ? 8 : 0);
  }
}

#define LOG2E_F 1.4426950408889634f
#define LN2_F 0.6931471805599453f

// 2^x on the special-function unit (one instruction; 2^-inf = 0, relative
// error 2^-22, far below the bf16 rounding of the probabilities). The
// softmax runs in base 2: scores are scaled by log2(e) where they are
// finished.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Score columns are permuted inside each block of 16 keys so that a lane
// holds four neighbouring keys of a row: column n of the block's 8-key
// tile jj stands for key 4 * (n / 2) + 2 * jj + n % 2. The K rows that
// ldmatrix reads for q.k^T and the V rows it reads for P.V follow the
// same permutation, so both products are unchanged, and a lane's mask,
// bias and dropout bits of a row are one 16-byte load or one Philox
// group. Lane (g, t) holds keys 4t .. 4t + 3 of the
// block as s[j][0], s[j][1], s[j + 1][0], s[j + 1][1] (row g) and
// s[j][2], s[j][3], s[j + 1][2], s[j + 1][3] (row g + 8).
#define ATT_S(s, j, rs, e) (s)[(j) + ((e) >> 1)][(rs) * 2 + ((e) & 1)]

// row[k0 .. k0 + 3] in fp32 (0 at or beyond n): one 16-byte load when
// `vec` says the rows allow it.
__device__ __forceinline__ void load4_f32(const float* row, int k0, int n, bool vec,
                                          float* o) {
  if (vec && k0 + 3 < n) {
    const float4 v = *reinterpret_cast<const float4*>(row + k0);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = k0 + e < n ? row[k0 + e] : 0.0f;
  }
}

// What a lane needs to finish the scores of its two query rows.
struct AttnRows {
  const float* brow[2];      // bias rows (device or shared memory), or null
  bool bias_vec;             // rows take 16-byte loads
};

// Finished scores log2(e) * (q.k^T * scale + key mask + bias) of a 16-row
// query tile against the NT 8-key tiles that start at key n0, in the
// accumulator layout of mma16816 with the key permutation above. Tiles at
// or beyond NKP keys are -inf. KLD: the row stride of Ks in elements; Ks
// and kbs hold keys from ks0 on (a streamed tile; 0: the whole row).
template <int D, int NT, int KLD = D + 8>
__device__ __forceinline__ void attn_scores(float (&s)[NT][4],
                                            const unsigned (&qa)[D / 16][4],
                                            const bf16* Ks, const float* kbs, int n0,
                                            int NKP, const AttnArgs& p, const AttnRows& rw,
                                            int lane, int ks0 = 0) {
  const float sc2 = p.scale * LOG2E_F;
  const int kperm = 4 * ((lane & 7) >> 1) + (lane & 1);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {        // two score tiles: a block of 16 keys
    const int nb = n0 + j * 8;
    if (nb >= NKP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j + 1][e] = -INFINITY;
      continue;
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float* c = s[j + jj];
      c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
      for (int kq = 0; kq < D / 32; ++kq) {
        unsigned b0, b1, b2, b3;
        ldsm_x4(Ks + (size_t)(nb - ks0 + kperm + 2 * jj) * KLD + kq * 32 + (lane >> 3) * 8,
                b0, b1, b2, b3);
        mma16816(c, qa[2 * kq], b0, b1);
        mma16816(c, qa[2 * kq + 1], b2, b3);
      }
    }
    const int k0 = nb + 4 * (lane & 3);
    const float4 kb = *reinterpret_cast<const float4*>(kbs + k0 - ks0);
    float add[2][4] = {{kb.x, kb.y, kb.z, kb.w}, {kb.x, kb.y, kb.z, kb.w}};
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      if (rw.brow[rs]) {
        float bv[4];
        load4_f32(rw.brow[rs], k0, p.Nk, rw.bias_vec, bv);
#pragma unroll
        for (int e = 0; e < 4; ++e) add[rs][e] = fmaf(bv[e], LOG2E_F, add[rs][e]);
      }
    }
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ATT_S(s, j, rs, e) = fmaf(ATT_S(s, j, rs, e), sc2, add[rs][e]);
    }
  }
}

// Philox-4x32-10: the counter-based generator of the dropout bits.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Random bits of key columns [4 * cg, 4 * cg + 4) of query row `row` of
// (batch, head) `bh`, as bits[0..3].
__device__ __forceinline__ void dropout_bits(unsigned long long seed, unsigned bh,
                                             unsigned row, unsigned cg, unsigned* bits) {
  const uint4 r = philox4x32_10(make_uint4(cg, row, bh, 0u),
                                make_uint2((unsigned)seed, (unsigned)(seed >> 32)));
  bits[0] = r.x; bits[1] = r.y; bits[2] = r.z; bits[3] = r.w;
}

// O += P . V for the 16-key blocks of `s` (probabilities, in place of the
// scores) that start at block kt0; V rows in the key permutation.
template <int D, int NT, int KLD = D + 8>
__device__ __forceinline__ void attn_pv(float (&o)[D / 8][4], const float (&s)[NT][4],
                                        const bf16* Vs, int kt0, int NK16, int lane) {
  const int vperm = 4 * ((lane & 7) >> 1) + 2 * ((lane >> 3) & 1) + (lane & 1);
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
    if (kt0 + kt >= NK16) continue;
    const unsigned a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                           pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                           pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                           pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
    const bf16* vrow = Vs + (size_t)((kt0 + kt) * 16 + vperm) * KLD + (lane >> 4) * 8;
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      unsigned b0, b1, b2, b3;
      ldsm_x4_t(vrow + dd * 16, b0, b1, b2, b3);
      mma16816(o[2 * dd], a, b0, b1);
      mma16816(o[2 * dd + 1], a, b2, b3);
    }
  }
}

// Pass 1 of the two-pass form over one chunk of finished scores: the
// lane's running max (base 2) and exp-sum of its two rows, the sum
// rescaled to the new max. A fully masked row keeps max -inf: subtract 0
// there, so every 2^-inf is 0.
template <int NT>
__device__ __forceinline__ void attn_stats_chunk(const float (&s)[NT][4], float& m0, float& m1,
                                                 float& l0, float& l1) {
  float c0 = m0, c1 = m1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    c0 = fmaxf(c0, fmaxf(s[j][0], s[j][1]));
    c1 = fmaxf(c1, fmaxf(s[j][2], s[j][3]));
  }
  const float z0 = c0 == -INFINITY ? 0.0f : c0, z1 = c1 == -INFINITY ? 0.0f : c1;
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    a0 += ex2(s[j][0] - z0) + ex2(s[j][1] - z0);
    a1 += ex2(s[j][2] - z1) + ex2(s[j][3] - z1);
  }
  l0 = l0 * ex2(m0 - z0) + a0;
  l1 = l1 * ex2(m1 - z1) + a1;
  m0 = c0;
  m1 = c1;
}

// The end of pass 1: each row's max and exp-sum joined over its quad.
__device__ __forceinline__ void attn_stats_join(float& m0, float& m1, float& l0, float& l1) {
  const float f0 = quad_max(m0), f1 = quad_max(m1);
  l0 = quad_sum(l0 * ex2(m0 - (f0 == -INFINITY ? 0.0f : f0)));
  l1 = quad_sum(l1 * ex2(m1 - (f1 == -INFINITY ? 0.0f : f1)));
  m0 = f0;
  m1 = f1;
}

// 2^(score - row max) in place of the scores (z: the rows' max, 0 for a
// fully masked row).
template <int NT>
__device__ __forceinline__ void attn_exp(float (&s)[NT][4], float z0, float z1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = ex2(s[j][0] - z0);
    s[j][1] = ex2(s[j][1] - z0);
    s[j][2] = ex2(s[j][2] - z1);
    s[j][3] = ex2(s[j][3] - z1);
  }
}

// s holds 2^(score - row max) of the chunk from key n0: normalise by the
// row's final sum (the rounding to bf16 follows in attn_pv) and, in
// training, drop with the Philox bits of (row, key / 4, bh).
template <bool TRAIN, int NT>
__device__ __forceinline__ void attn_probs(float (&s)[NT][4], int n0, int NKP, float inv0,
                                           float inv1, const AttnArgs& p,
                                           unsigned long long seed, unsigned bh, int r0, int r1,
                                           int t) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    const int nb = n0 + j * 8;
    if (nb >= NKP) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      s[j + jj][0] *= inv0; s[j + jj][1] *= inv0;
      s[j + jj][2] *= inv1; s[j + jj][3] *= inv1;
    }
    if constexpr (TRAIN) {
      if (p.thresh) {
#pragma unroll
        for (int rs = 0; rs < 2; ++rs) {
          unsigned bits[4];
          dropout_bits(seed, bh, (unsigned)(rs ? r1 : r0), (unsigned)(nb / 4 + t), bits);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ATT_S(s, j, rs, e) = bits[e] >= p.thresh ? ATT_S(s, j, rs, e) * p.inv_keep
                                                     : 0.0f;
        }
      }
    }
  }
}

// The training forward's row statistics for the backward: the max, back
// in base e, and the reciprocal exp-sum (one lane of the quad writes).
__device__ __forceinline__ void attn_save_stats(const AttnArgs& p, size_t bh, int r0, int r1,
                                                float m0, float m1, float inv0, float inv1,
                                                int t) {
  if (t != 0) return;
  if (r0 < p.Nq) {
    p.stats[(bh * p.Nq + r0) * 2] = m0 * LN2_F;
    p.stats[(bh * p.Nq + r0) * 2 + 1] = inv0;
  }
  if (r1 < p.Nq) {
    p.stats[(bh * p.Nq + r1) * 2] = m1 * LN2_F;
    p.stats[(bh * p.Nq + r1) * 2 + 1] = inv1;
  }
}

// The output of a warp's 16-row query tile from query q0 (rows r0, r1 of
// the lane): fp32 as accumulated (training), else rounded to bf16, staged
// through the warp's query tile Qs where 16-byte stores are allowed.
template <int D, bool TRAIN>
__device__ __forceinline__ void attn_store(const float (&o)[D / 8][4], const AttnArgs& p,
                                           bf16* Qs, long b, int h, int q0, int r0, int r1,
                                           int lane) {
  constexpr int KLD = D + 8;
  const int g = lane >> 2, t = lane & 3;
  const long obase = b * p.sob + h * D;
  const size_t esz = p.out_dt == DT_F32 ? 4 : 2;
  const uintptr_t oalign = reinterpret_cast<uintptr_t>(p.out) | (size_t)p.sob * esz
                           | (size_t)p.son * esz | (size_t)(D * esz);
  if (!TRAIN && p.out_dt == DT_BF16 && (oalign & 15) == 0) {
    // through the warp's query tile, so that a lane stores 16 bytes
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<unsigned*>(&Qs[g * KLD + dt * 8 + 2 * t]) =
          pack_bf16(o[dt][0], o[dt][1]);
      *reinterpret_cast<unsigned*>(&Qs[(g + 8) * KLD + dt * 8 + 2 * t]) =
          pack_bf16(o[dt][2], o[dt][3]);
    }
    __syncwarp();
    bf16* out = static_cast<bf16*>(p.out);
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int rr = c / (D / 8), d8 = (c % (D / 8)) * 8;
      if (q0 + rr < p.Nq)
        *reinterpret_cast<uint4*>(out + obase + (long)(q0 + rr) * p.son + d8) =
            *reinterpret_cast<const uint4*>(&Qs[rr * KLD + d8]);
    }
    return;
  }
  const bool pair_ok = p.out_dt == DT_F32 && (oalign & 7) == 0;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const int row = rs ? r1 : r0;
      if (row >= p.Nq) continue;
      float v0 = o[dt][rs * 2], v1 = o[dt][rs * 2 + 1];
      if constexpr (!TRAIN) {
        v0 = __bfloat162float(__float2bfloat16(v0));
        v1 = __bfloat162float(__float2bfloat16(v1));
      }
      const long idx = obase + (long)row * p.son + dt * 8 + 2 * t;
      if (pair_ok) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) = make_float2(v0, v1);
      } else {
        st_val(p.out, p.out_dt, idx, v0);
        st_val(p.out, p.out_dt, idx + 1, v1);
      }
    }
  }
}

// The arguments of a call; false for a shape the kernels do not take
// (max_nk: keys a block holds, 0 for the streaming kernels).
static bool attn_args(AttnArgs& p, const void* q, const void* k, const void* v, int in_dt,
                      long sqb, long sqn, long skb, long skn, long svb, long svn,
                      int B, int H, int Nq, int Nk, const void* kvalid, long skvb,
                      const void* bias, float scale, int max_nk = ATT_MAX_NK) {
  const int nk16 = (Nk + 15) / 16;
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || (max_nk > 0 && nk16 * 16 > max_nk))
    return false;
  p.q = q; p.k = k; p.v = v; p.in_dt = in_dt;
  p.sqb = sqb; p.sqn = sqn; p.skb = skb; p.skn = skn; p.svb = svb; p.svn = svn;
  p.H = H; p.Nq = Nq; p.Nk = Nk; p.NK16 = nk16;
  p.kvalid = static_cast<const unsigned char*>(kvalid); p.skvb = skvb;
  p.bias = static_cast<const float*>(bias);
  p.scale = scale;
  p.out = nullptr; p.out_dt = DT_F32; p.sob = 0; p.son = 0;
  p.seed = nullptr; p.thresh = 0; p.inv_keep = 1.0f; p.stats = nullptr;
  return true;
}

#define BWD_MAX_WARPS 8
#define BWD_KCH 4          // 8-query tiles per chunk of the key-major kernel

// What the backward kernels take beside the forward's AttnArgs.
struct BwdArgs {
  const void* dout; int do_dt; long sdb, sdn;
  float* dq; float* dk; float* dv;   // fp32 [B, N, H * D], contiguous
  float* dbias;                      // [B, H, Nq, Nk] or null
  float* delta;                      // [B * H, Nq]: rowsum(dp * p), between the launches
  int NQ16;                          // 16-query tiles (queries padded to NQ16 * 16)
};

// The launch plan, made by ops/kernels.py attention_bwd_plan.
struct BwdPlan { int qsplit, qwarps, chunk16; long qsmem; int ksplit, kwarps; long ksmem; };

// c += a . rows^T for the 8 shared-memory rows whose lane addresses are
// `lane_row` (row lane % 8 of the tile, plus 8 * (lane / 8) columns): a
// 16 x 8 tile of a product over D.
template <int D>
__device__ __forceinline__ void mma_rows8(float* c, const unsigned (&a)[D / 16][4],
                                          const bf16* lane_row) {
#pragma unroll
  for (int kq = 0; kq < D / 32; ++kq) {
    unsigned b0, b1, b2, b3;
    ldsm_x4(lane_row + kq * 32, b0, b1, b2, b3);
    mma16816(c, a[2 * kq], b0, b1);
    mma16816(c, a[2 * kq + 1], b2, b3);
  }
}

// p (in s) and the dropped, rescaled dp (in dpv) of a 16-row query tile
// against the NT 8-key tiles from key n0, in the forward's layout; Ks, Vs
// and kbs hold keys from ks0 on.
template <int D, int NT>
__device__ __forceinline__ void bwd_q_chunk(float (&s)[NT][4], float (&dpv)[NT][4],
                                            const unsigned (&qa)[D / 16][4],
                                            const unsigned (&da)[D / 16][4], const bf16* Ks,
                                            const bf16* Vs, const float* kbs, int n0, int NKP,
                                            const AttnArgs& p, const AttnRows& rw, int lane,
                                            float z0, float z1, float inv0, float inv1,
                                            unsigned long long seed, unsigned bh, int r0,
                                            int r1, int ks0 = 0) {
  constexpr int KLD = D + 8;
  const int kperm = 4 * ((lane & 7) >> 1) + (lane & 1);
  const int t = lane & 3;
  attn_scores<D, NT>(s, qa, Ks, kbs, n0, NKP, p, rw, lane, ks0);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    const int nb = n0 + j * 8;
    if (nb >= NKP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j + 1][e] = dpv[j][e] = dpv[j + 1][e] = 0.0f;
      continue;
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float* c = dpv[j + jj];
      c[0] = c[1] = c[2] = c[3] = 0.0f;
      mma_rows8<D>(c, da, Vs + (size_t)(nb - ks0 + kperm + 2 * jj) * KLD + (lane >> 3) * 8);
      float* sp = s[j + jj];
      sp[0] = ex2(sp[0] - z0) * inv0;
      sp[1] = ex2(sp[1] - z0) * inv0;
      sp[2] = ex2(sp[2] - z1) * inv1;
      sp[3] = ex2(sp[3] - z1) * inv1;
    }
    if (p.thresh) {
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        unsigned bits[4];
        dropout_bits(seed, bh, (unsigned)(rs ? r1 : r0), (unsigned)(nb / 4 + t), bits);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ATT_S(dpv, j, rs, e) = bits[e] >= p.thresh ? ATT_S(dpv, j, rs, e) * p.inv_keep
                                                     : 0.0f;
      }
    }
  }
}

// A lane's two query rows r0, r1 of (batch, head) bh in the query-major
// backward: their bias and dbias rows (null past Nq or without them), the
// forward's max in base 2 (0 for a fully masked row) and 1 / exp-sum.
__device__ __forceinline__ void bwd_q_rows(AttnRows& rw, float* (&dbrow)[2], float& z0,
                                           float& z1, float& inv0, float& inv1,
                                           const AttnArgs& p, const BwdArgs& w, size_t bh,
                                           int r0, int r1) {
  rw.brow[0] = rw.brow[1] = nullptr;
  rw.bias_vec = p.Nk % 4 == 0 && (reinterpret_cast<uintptr_t>(p.bias) & 15) == 0;
  dbrow[0] = dbrow[1] = nullptr;
  z0 = z1 = inv0 = inv1 = 0.0f;
  if (r0 < p.Nq) {
    const size_t row = bh * p.Nq + r0;
    if (p.bias) rw.brow[0] = p.bias + row * p.Nk;
    if (w.dbias) dbrow[0] = w.dbias + row * p.Nk;
    const float m = p.stats[row * 2] * LOG2E_F;
    z0 = m == -INFINITY ? 0.0f : m;
    inv0 = p.stats[row * 2 + 1];
  }
  if (r1 < p.Nq) {
    const size_t row = bh * p.Nq + r1;
    if (p.bias) rw.brow[1] = p.bias + row * p.Nk;
    if (w.dbias) dbrow[1] = w.dbias + row * p.Nk;
    const float m = p.stats[row * 2] * LOG2E_F;
    z1 = m == -INFINITY ? 0.0f : m;
    inv1 = p.stats[row * 2 + 1];
  }
}

// The lane's share of delta = rowsum(dp * p) over a chunk.
template <int NT>
__device__ __forceinline__ void bwd_q_delta(const float (&s)[NT][4], const float (&dpv)[NT][4],
                                            float& delta0, float& delta1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    delta0 += s[j][0] * dpv[j][0] + s[j][1] * dpv[j][1];
    delta1 += s[j][2] * dpv[j][2] + s[j][3] * dpv[j][3];
  }
}

// ds = p * (dp - delta) in place of p over the chunk from key n0, stored
// as dbias where it is asked for.
template <int NT>
__device__ __forceinline__ void bwd_q_ds(float (&s)[NT][4], const float (&dpv)[NT][4],
                                         float delta0, float delta1, int n0,
                                         float* const* dbrow, const AttnArgs& p,
                                         const BwdArgs& w, int t) {
  const bool db_vec = p.Nk % 4 == 0 && (reinterpret_cast<uintptr_t>(w.dbias) & 15) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] *= dpv[j][0] - delta0;
    s[j][1] *= dpv[j][1] - delta0;
    s[j][2] *= dpv[j][2] - delta1;
    s[j][3] *= dpv[j][3] - delta1;
  }
  if (w.dbias) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int k0 = n0 + j * 8 + 4 * t;
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        if (!dbrow[rs] || k0 >= p.Nk) continue;
        if (db_vec) {                        // Nk % 4 == 0: the four keys exist
          *reinterpret_cast<float4*>(dbrow[rs] + k0) =
              make_float4(ATT_S(s, j, rs, 0), ATT_S(s, j, rs, 1), ATT_S(s, j, rs, 2),
                          ATT_S(s, j, rs, 3));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + e < p.Nk) dbrow[rs][k0 + e] = ATT_S(s, j, rs, e);
        }
      }
    }
  }
}

// delta (for the key-major kernel) and dq (times the scale) of the lane's
// two rows.
template <int D>
__device__ __forceinline__ void bwd_q_store(const float (&dq)[D / 8][4], float delta0,
                                            float delta1, const BwdArgs& w, const AttnArgs& p,
                                            long b, int h, int r0, int r1, int t) {
  const size_t bh = (size_t)b * p.H + h;
  if (t == 0) {
    if (r0 < p.Nq) w.delta[bh * p.Nq + r0] = delta0;
    if (r1 < p.Nq) w.delta[bh * p.Nq + r1] = delta1;
  }
  const long HD = (long)p.H * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const int row = rs ? r1 : r0;
      if (row >= p.Nq) continue;
      *reinterpret_cast<float2*>(w.dq + (b * p.Nq + row) * HD + h * D + dt * 8 + 2 * t) =
          make_float2(dq[dt][rs * 2] * p.scale, dq[dt][rs * 2 + 1] * p.scale);
    }
  }
}

// The warp's 16-key tile of the key-major backward, from key k0: its key
// and value rows (Kt, Vt in shared memory) as A operands, the lane's two
// keys, their additive mask and their Philox column group. A-operand row
// r of the tile stands for key 4 * (r % 8 / 2) + r % 2 + 2 * (r / 8): a
// lane's rows g and g + 8 are keys of one Philox group.
template <int D>
__device__ __forceinline__ void bwd_k_tile(unsigned (&ka)[D / 16][4], unsigned (&va)[D / 16][4],
                                           int (&key)[2], float (&kadd)[2], unsigned& cg,
                                           const bf16* Kt, const bf16* Vt, const AttnArgs& p,
                                           long b, int k0, int lane) {
  constexpr int KLD = D + 8;
  const int g = lane >> 2;
  const int arow = 4 * ((lane & 7) >> 1) + (lane & 1) + 2 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const size_t off = (size_t)arow * KLD + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(Kt + off, ka[kk][0], ka[kk][1], ka[kk][2], ka[kk][3]);
    ldsm_x4(Vt + off, va[kk][0], va[kk][1], va[kk][2], va[kk][3]);
  }
  const int par = g & 1;
  key[0] = k0 + 4 * (g >> 1) + par;
  key[1] = key[0] + 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool on = key[hf] < p.Nk &&
                    (p.kvalid == nullptr || p.kvalid[b * p.skvb + key[hf]] != 0);
    kadd[hf] = on ? 0.0f : -INFINITY;
  }
  cg = (unsigned)(k0 / 4 + (g >> 1));
}

// One chunk of BWD_KCH 8-query tiles of the key-major backward, from query
// q0: the transposed tiles s^T = k.q^T and dp^T = v.do^T of the warp's
// 16-key tile (ka, va: its key and value rows as A operands; key, kadd:
// the lane's two keys and their additive mask; cg: their Philox column
// group), then dv += bf16(pd^T) . do and dk += bf16(ds^T) . q. Qs, Gs and
// sts (each query's max in base 2, 1 / sum, delta) hold the queries from
// qs0 on; bias: the (batch, head)'s [Nq, Nk] rows or null.
template <int D>
__device__ __forceinline__ void bwd_k_chunk(float (&dk)[D / 8][4], float (&dv)[D / 8][4],
                                            const unsigned (&ka)[D / 16][4],
                                            const unsigned (&va)[D / 16][4], const bf16* Qs,
                                            const bf16* Gs, const float4* sts, int q0, int qs0,
                                            int NQP, const AttnArgs& p, const float* bias,
                                            const int (&key)[2], const float (&kadd)[2],
                                            unsigned long long seed, unsigned bh, unsigned cg,
                                            int lane) {
  constexpr int KLD = D + 8;
  const int g = lane >> 2, t = lane & 3, par = g & 1;
  const float sc2 = p.scale * LOG2E_F;
  float pd[BWD_KCH][4], ds[BWD_KCH][4];     // pd^T and ds^T: keys x queries
#pragma unroll
  for (int j = 0; j < BWD_KCH; ++j) {
    const int qb = q0 + 8 * j;
    pd[j][0] = pd[j][1] = pd[j][2] = pd[j][3] = 0.0f;
    ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.0f;
    if (qb >= NQP) continue;
    const size_t lane_row = (size_t)(qb - qs0 + (lane & 7)) * KLD + (lane >> 3) * 8;
    mma_rows8<D>(pd[j], ka, Qs + lane_row);     // s^T = k . q^T
    mma_rows8<D>(ds[j], va, Gs + lane_row);     // dp^T = v . do^T
    // keep bits of the lane's two query columns: own group, neighbour's
    unsigned kq[2] = {0xfu, 0xfu};
    if (p.thresh) {
      unsigned bits[4];
      dropout_bits(seed, bh, (unsigned)(qb + 2 * t + par), cg, bits);
      const unsigned own = (bits[0] >= p.thresh ? 1u : 0u) | (bits[1] >= p.thresh ? 2u : 0u) |
                           (bits[2] >= p.thresh ? 4u : 0u) | (bits[3] >= p.thresh ? 8u : 0u);
      const unsigned other = __shfl_xor_sync(0xffffffffu, own, 4);
      kq[0] = par ? other : own;
      kq[1] = par ? own : other;
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int qi = qb + 2 * t + cc;
      const float4 st = sts[qi - qs0];
      const float* brow = bias && qi < p.Nq ? bias + (size_t)qi * p.Nk : nullptr;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int e = hf * 2 + cc;
        float s2 = fmaf(pd[j][e], sc2, kadd[hf]);
        if (brow && key[hf] < p.Nk) s2 = fmaf(brow[key[hf]], LOG2E_F, s2);
        const float pr = ex2(s2 - st.x) * st.y;
        const bool keep = (kq[cc] >> (par + 2 * hf)) & 1u;
        const float dpm = keep ? ds[j][e] * p.inv_keep : 0.0f;
        pd[j][e] = keep ? pr * p.inv_keep : 0.0f;
        ds[j][e] = pr * (dpm - st.z);
      }
    }
  }
#pragma unroll
  for (int kt = 0; kt < BWD_KCH / 2; ++kt) {
    if (q0 + 16 * kt >= NQP) continue;
    const unsigned ap[4] = {pack_bf16(pd[2 * kt][0], pd[2 * kt][1]),
                            pack_bf16(pd[2 * kt][2], pd[2 * kt][3]),
                            pack_bf16(pd[2 * kt + 1][0], pd[2 * kt + 1][1]),
                            pack_bf16(pd[2 * kt + 1][2], pd[2 * kt + 1][3])};
    const unsigned as[4] = {pack_bf16(ds[2 * kt][0], ds[2 * kt][1]),
                            pack_bf16(ds[2 * kt][2], ds[2 * kt][3]),
                            pack_bf16(ds[2 * kt + 1][0], ds[2 * kt + 1][1]),
                            pack_bf16(ds[2 * kt + 1][2], ds[2 * kt + 1][3])};
    const size_t off = (size_t)(q0 - qs0 + 16 * kt + (lane & 7) + 8 * ((lane >> 3) & 1)) * KLD
                       + (lane >> 4) * 8;
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      unsigned b0, b1, b2, b3;
      ldsm_x4_t(Gs + off + dd * 16, b0, b1, b2, b3);
      mma16816(dv[2 * dd], ap, b0, b1);
      mma16816(dv[2 * dd + 1], ap, b2, b3);
      ldsm_x4_t(Qs + off + dd * 16, b0, b1, b2, b3);
      mma16816(dk[2 * dd], as, b0, b1);
      mma16816(dk[2 * dd + 1], as, b2, b3);
    }
  }
}

// dk (times the scale) and dv of the lane's two keys into the fp32 [B, Nk,
// H * D] gradients.
template <int D>
__device__ __forceinline__ void bwd_k_store(const float (&dk)[D / 8][4],
                                            const float (&dv)[D / 8][4], const BwdArgs& w,
                                            const AttnArgs& p, long b, int h,
                                            const int (&key)[2], int t) {
  const long HD = (long)p.H * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (key[hf] >= p.Nk) continue;
      const long o = (b * p.Nk + key[hf]) * HD + h * D + dt * 8 + 2 * t;
      *reinterpret_cast<float2*>(w.dv + o) = make_float2(dv[dt][hf * 2], dv[dt][hf * 2 + 1]);
      *reinterpret_cast<float2*>(w.dk + o) =
          make_float2(dk[dt][hf * 2] * p.scale, dk[dt][hf * 2 + 1] * p.scale);
    }
  }
}
