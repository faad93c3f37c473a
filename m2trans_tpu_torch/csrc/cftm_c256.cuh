// K1's C = 256 body (cftm_branch.cu, which states the design) up to the
// probabilities, as device functions: the forward kernel runs them and goes
// on to P v; K1b's cluster body (cftm_branch_bwd_attn.cu) runs the same code, so
// that it recomputes q, k + rel, v and P with the forward's own roundings,
// and goes on to the attention VJP.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "cftm_common.cuh"
#include "mma_ptx.cuh"

#ifndef M2T_K1_STOP
#define M2T_K1_STOP 0
#endif

// Timing ablation inside the shared steps: true = the kernel returns.
#define M2T_K1_STOP_AT(n)                  \
  if (M2T_K1_STOP == (n)) {                \
    m2t_ptx::cp_async_wait<0>();           \
    if ((n) == 3) m2t_ptx::cluster_wait(); \
    return true;                           \
  }

namespace m2t_cftm_c256 {

using namespace m2t_cftm;
using namespace m2t_ptx;
namespace cg = cooperative_groups;

constexpr int CB = 16;          // base channels
constexpr int G = 16;           // subbands at L = 2
constexpr int C = CB * G;       // 256 coarse channels
constexpr int SPLIT = 4;        // CTAs per window
constexpr int CBL = CB / SPLIT; // base channels of one CTA
constexpr int CL = C / SPLIT;   // 64 coarse channels of one CTA
constexpr int SUB = G / SPLIT;  // its 4 subbands
constexpr int NT = 256;         // threads: 8 warps, two CTAs to an SM
constexpr int NW = NT / 32;
constexpr int QPIX = 32;        // full-resolution side of the query block
constexpr int KCH = 32;         // weight rows per ring chunk
constexpr int NCH = C / KCH;    // 8 chunks
constexpr int RING = 3;

// pitches in elements; each row is a multiple of 16 bytes and an odd
// number of them, so the 8 rows of an ldmatrix fall on different banks
constexpr int ZLD = C + 8;        // zc, bf16
constexpr int QLD = CL + 8;       // q, k, v slices, bf16
constexpr int WLD = 3 * CL + 8;   // weight chunk, bf16
constexpr int PLD = NKP + 8;      // probabilities, bf16
constexpr int SLDF = NKP + 4;     // partial logits, f32
constexpr int OLD = CL + 4;       // P v, f32

// Byte offsets in shared memory. Half an SM's shared memory holds one CTA,
// so what the projection reads gives its room to what comes after it: zc to
// q, k, v and the incoming P v; the weight ring to the incoming partial
// logits and P. Other CTAs of the cluster store into the second pair, so a
// cluster barrier stands between a CTA's projection and those stores.
constexpr int OFF_ZC = 0;
constexpr int ZC_BYTES = NKP * ZLD * 2;
constexpr int OFF_Q = OFF_ZC;
constexpr int OFF_K = OFF_Q + NQ * QLD * 2;
constexpr int OFF_V = OFF_K + NKP * QLD * 2;
constexpr int OFF_O = OFF_V + NKP * QLD * 2;            // P v of this CTA's channels
constexpr int OFF_W = OFF_ZC + ZC_BYTES;
constexpr int W_BYTES = KCH * WLD * 2;
constexpr int OFF_S = OFF_W;
constexpr int OFF_P = OFF_S + NQ * SLDF * 4;
constexpr int SP_BYTES = OFF_P + NQ * PLD * 2 - OFF_S;
constexpr int WR_BYTES = RING * W_BYTES > SP_BYTES ? RING * W_BYTES : SP_BYTES;
constexpr int OFF_ZRES = OFF_W + WR_BYTES;              // own z, later the output
constexpr int ZRES_BYTES = QPIX * QPIX * CBL * 2;
constexpr int SMEM = OFF_ZRES + ZRES_BYTES;
static_assert(OFF_O + NQ * OLD * 4 <= OFF_ZC + ZC_BYTES, "q k v O fit zc's space");
static_assert(2 * (SMEM + 1024) <= 233472, "two CTAs to an SM");
static_assert(OFF_K % 16 == 0 && OFF_V % 16 == 0 && OFF_O % 16 == 0 &&
              OFF_W % 16 == 0 && W_BYTES % 16 == 0 && OFF_P % 16 == 0 &&
              OFF_ZRES % 16 == 0, "16-byte alignment");

// chunk `ch` of the rank's weight slice -> ring stage: rows KCH*ch ..,
// columns part*64 + j from global column part*256 + 64*rank + j, 16 bytes
// a copy
__device__ __forceinline__ void load_w_chunk(const bf16* w, int rank, int ch,
                                             uint32_t dst) {
  constexpr int VPR = 3 * CL / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < KCH * VPR; i += NT) {
    const int kr = i / VPR, v = i % VPR;
    const int part = v / (CL / 8), j = (v % (CL / 8)) * 8;
    cp_async16(dst + (kr * WLD + part * CL + j) * 2,
               w + (size_t)(ch * KCH + kr) * (3 * C) + part * C + CL * rank + j,
               16);
  }
}

// Steps 0-3 of the body for the window (b, bi, bj) in the CTA of `rank`:
// the weight ring, z and zc, the projection of this CTA's 64 columns of q,
// k (+ rel) and v (left in shared memory at OFF_Q, OFF_K, OFF_V), and the
// partial logits exchanged through distributed shared memory; ends with the
// cluster barrier after which this CTA's sp holds the four partials of its
// 16 query rows. z of the CTA's own 4 channels is kept at OFF_ZRES.
__device__ __forceinline__ bool project_and_partial_logits(
    const BranchArgs& a, cg::cluster_group& cluster, int rank, int b, int bi,
    int bj, unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  bf16* zc = reinterpret_cast<bf16*>(smem + OFF_ZC);
  bf16* qs = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* ks = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(smem + OFF_V);
  float* sp = reinterpret_cast<float*>(smem + OFF_S);
  bf16* zres = reinterpret_cast<bf16*>(smem + OFF_ZRES);
  const uint32_t sm0 = smem_u32(smem);
  M2T_K1_STOP_AT(1)

  // 0. the first weight chunks, in flight while zc is formed
#pragma unroll
  for (int ch = 0; ch < RING; ++ch) {
    load_w_chunk(a.w, rank, ch, sm0 + OFF_W + ch * W_BYTES);
    cp_async_commit();
  }

  // 1. z = bf16(x*s + t [+ r*x_add]) (zero outside the frame) and zc =
  // bf16(DWT^2(z)): a thread per (window slot, 4 base channels) loads its
  // 4x4 pixels as 8-byte vectors, all in flight together. Rows = window
  // slots, columns g*16 + c. z of this CTA's own 4 channels of the query
  // pixels is kept for the residual.
  {
    const int qt = tid % 4;  // NT is a multiple of 4: one quarter per thread
    float sv[4], tv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) affine_coef(a, b, qt * 4 + e, sv[e], tv[e]);
    for (int item = tid; item < NK * 4; item += NT) {
      const int slot = item / 4;
      int wr, wc;
      win_coord(slot, wr, wc);
      const int cr = bi * BLOCK - 1 + wr, cc = bj * BLOCK - 1 + wc;
      const bool inside = cr >= 0 && cr < a.H / 4 && cc >= 0 && cc < a.W / 4;
      uint2 xv[16], av[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        xv[i] = av[i] = make_uint2(0u, 0u);
        if (inside) {
          const int y = cr * 4 + i / 4, xx = cc * 4 + i % 4;
          xv[i] = __ldg(reinterpret_cast<const uint2*>(
              a.x + b * a.x_sb + y * a.x_sh + xx * a.x_sw + qt * 4));
          if (a.xadd)
            av[i] = __ldg(reinterpret_cast<const uint2*>(
                a.xadd + b * a.a_sb + y * a.a_sh + xx * a.a_sw + qt * 4));
        }
      }
      uint2 zq[16];  // z of the 16 pixels, 4 channels each, bf16
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bf16* xe = reinterpret_cast<const bf16*>(&xv[i]);
        const bf16* ae = reinterpret_cast<const bf16*>(&av[i]);
        float z[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          z[e] = __bfloat162float(xe[e]) * sv[e] + tv[e];
          if (a.xadd) z[e] += a.r * __bfloat162float(ae[e]);
        }
        zq[i] = inside ? make_uint2(pack_bf16(z[0], z[1]), pack_bf16(z[2], z[3]))
                       : make_uint2(0u, 0u);
      }
      if (qt == rank && slot < NQ) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          *reinterpret_cast<uint2*>(
              zres + (((slot / BLOCK) * 4 + i / 4) * QPIX + (slot % BLOCK) * 4 +
                      i % 4) * CBL) = zq[i];
      }
      float o[4][G];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          p[i / 4][i % 4] =
              __bfloat162float(reinterpret_cast<const bf16*>(&zq[i])[e]);
        dwt<2>(p, o[e]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        *reinterpret_cast<uint2*>(zc + slot * ZLD + g * CB + qt * 4) =
            make_uint2(pack_bf16(o[0][g], o[1][g]), pack_bf16(o[2][g], o[3][g]));
    }
    // the pad rows NK..NKP-1 are zero
    for (int i = tid; i < (NKP - NK) * (C / 8); i += NT)
      *reinterpret_cast<uint4*>(zc + (NK + i / (C / 8)) * ZLD + (i % (C / 8)) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  // (the barrier before the first chunk's products also orders zc)
  M2T_K1_STOP_AT(2)

  // 2. q | k | v slice = zc * W slice, in 16x16 units (row tile x 16 slice
  // columns: q 0-63, k 64-127, v 128-191). Warp w takes the k|v columns
  // 16*w with all 7 row tiles, and q's columns 16*(w % 4) with two of its 4
  // row tiles: 9 units, 9 ldmatrix for 18 products a k step.
  {
    const int part = 1 + warp / 4;
    const int qg = warp % 4, qmt0 = 2 * (warp / 4);
    constexpr int NMT = NKP / 16;
    float acc[NMT][2][4], qacc[2][2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int i = 0; i < NMT; ++i) acc[i][nt][e] = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) qacc[j][nt][e] = 0.f;
      }
    const uint32_t zrow = sm0 + OFF_ZC + (lrow * ZLD + lcol) * 2;
#pragma unroll 1
    for (int ch = 0; ch < NCH; ++ch) {
      // chunk ch has landed: chunks requested so far are min(ch + RING - 1, NCH)
      if (ch + RING - 2 < NCH) cp_async_wait<RING - 2>();
      else cp_async_wait<0>();
      __syncthreads();  // ... for every thread, and chunk ch - 1 is consumed
      if (ch >= 1 && ch - 1 + RING < NCH)
        load_w_chunk(a.w, rank, ch - 1 + RING,
                     sm0 + OFF_W + ((ch - 1) % RING) * W_BYTES);
      cp_async_commit();  // (an empty group keeps the count in step)
      const uint32_t wst =
          sm0 + OFF_W + (ch % RING) * W_BYTES + (lrow * WLD + lcol) * 2;
#pragma unroll
      for (int kk = 0; kk < KCH / 16; ++kk) {
        uint32_t fbk[4], fbq[4], fa[4];
        ldmatrix_x4_trans(fbk, wst + (kk * 16 * WLD + CL + 16 * warp) * 2);
        ldmatrix_x4_trans(fbq, wst + (kk * 16 * WLD + 16 * qg) * 2);
#pragma unroll
        for (int i = 0; i < NMT; ++i) {
          ldmatrix_x4(fa, zrow + (i * 16 * ZLD + ch * KCH + kk * 16) * 2);
          mma_bf16(acc[i][0], fa, fbk[0], fbk[1]);
          mma_bf16(acc[i][1], fa, fbk[2], fbk[3]);
          if (i < NQ / 16) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (i == qmt0 + j) {
                mma_bf16(qacc[j][0], fa, fbq[0], fbq[1]);
                mma_bf16(qacc[j][1], fa, fbq[2], fbq[3]);
              }
          }
        }
      }
    }
    __syncthreads();  // zc and the ring are read; their room is given away
    cluster_arrive();

    // k + rel, v -> bf16 slices
    bf16* dst = part == 1 ? ks : vs;
#pragma unroll
    for (int i = 0; i < NMT; ++i) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int lc = (warp % 4) * 16 + nt * 8 + 2 * t4;  // slice channel
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = i * 16 + g8 + hr * 8;
          float v0 = acc[i][nt][2 * hr], v1 = acc[i][nt][2 * hr + 1];
          if (part == 1 && row < NK) {
            const int chn = CL * rank + lc;
            int wr, wc;
            win_coord(row, wr, wc);
            const float* rel = chn < C / 2 ? a.relh + wr * (C / 2) + chn
                                           : a.relw + wc * (C / 2) + chn - C / 2;
            v0 += rel[0];
            v1 += rel[1];
          }
          *reinterpret_cast<uint32_t*>(dst + row * QLD + lc) = pack_bf16(v0, v1);
        }
      }
    }
    // q * C^-0.5
    const float scale = 0.0625f;  // 256^-0.5
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(qs + ((qmt0 + j) * 16 + g8 + hr * 8) * QLD +
                                       qg * 16 + nt * 8 + 2 * t4) =
              pack_bf16(qacc[j][nt][2 * hr] * scale, qacc[j][nt][2 * hr + 1] * scale);
  }
  __syncthreads();
  M2T_K1_STOP_AT(3)

  // 3. partial logits over this CTA's 64 channels, (64 x 64) (112 x 64)^T.
  // Row tile mt holds the 16 query rows whose softmax CTA mt takes: the
  // tile goes to slab `rank` of that CTA's sp, [4 slabs][16 rows][SLDF],
  // through distributed shared memory, once every CTA of the cluster is
  // done with its weight ring (whose room sp is).
  {
    // k is [key][channel]: matrices (keys 0-7, ch 0-7), (keys 0-7, ch 8-15),
    // (keys 8-15, ch 0-7), (keys 8-15, ch 8-15) are b0, b1 of two key tiles
    const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
    bool waited = false;
    for (int unit = warp; unit < (NQ / 16) * (NKP / 16); unit += NW) {
      const int mt = unit / (NKP / 16), kt = unit % (NKP / 16);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < CL / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldmatrix_x4(fa, sm0 + OFF_Q + ((mt * 16 + lrow) * QLD + kk * 16 + lcol) * 2);
        ldmatrix_x4(fb, sm0 + OFF_K + ((kt * 16 + krow) * QLD + kk * 16 + kcol) * 2);
        mma_bf16(acc[0], fa, fb[0], fb[1]);
        mma_bf16(acc[1], fa, fb[2], fb[3]);
      }
      if (!waited) {
        cluster_wait();
        waited = true;
      }
      float* slab = cluster.map_shared_rank(sp, mt) + rank * 16 * SLDF;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(slab + (g8 + hr * 8) * SLDF + kt * 16 +
                                     nt * 8 + 2 * t4) =
              make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
    }
  }
  cluster.sync();  // the four partials of this CTA's 16 rows have arrived
  M2T_K1_STOP_AT(4)
  return false;
}

// Step 4: the softmax of this CTA's 16 query rows, bf16 P stored into all
// four CTAs (at OFF_P). The f32 probabilities of the rows this warp took
// (rows warp and warp + 8 of the 16; keys 4*lane .. 4*lane + 3, zero beyond
// the 100 real keys) are handed back in pkeep. The caller runs the cluster
// barrier that makes P complete.
__device__ __forceinline__ void softmax_own_rows(cg::cluster_group& cluster,
                                                 int rank, unsigned char* smem,
                                                 float (&pkeep)[2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sp = reinterpret_cast<float*>(smem + OFF_S);
  bf16* P = reinterpret_cast<bf16*>(smem + OFF_P);
  // 4. logits = the partials summed in rank order, softmax over the 100
  // real keys in f32, P in bf16 (zero on pad slots) written to all four
  // CTAs; a lane per 4 keys
  {
    bf16* pdst[SPLIT];
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) pdst[r] = cluster.map_shared_rank(P, r);
#pragma unroll
    for (int it = 0; it < NQ / SPLIT / NW; ++it) {
      const int rl = warp + it * NW;
      float v[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
      if (lane < NK / 4) {
        float4 s4 = *reinterpret_cast<const float4*>(sp + rl * SLDF + 4 * lane);
#pragma unroll
        for (int r = 1; r < SPLIT; ++r) {
          const float4 o4 = *reinterpret_cast<const float4*>(
              sp + (r * 16 + rl) * SLDF + 4 * lane);
          s4.x += o4.x; s4.y += o4.y; s4.z += o4.z; s4.w += o4.w;
        }
        v[0] = s4.x; v[1] = s4.y; v[2] = s4.z; v[3] = s4.w;
      }
      float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
      for (int off = 16; off > 0; off /= 2)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = lane < NK / 4 ? expf(v[j] - m) : 0.f;
        sum += v[j];
      }
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float inv = 1.f / sum;
#pragma unroll
      for (int j = 0; j < 4; ++j) pkeep[it][j] = v[j] * inv;
      if (lane < NKP / 4) {
        const uint2 pk = make_uint2(pack_bf16(v[0] * inv, v[1] * inv),
                                    pack_bf16(v[2] * inv, v[3] * inv));
        const int row = rank * (NQ / SPLIT) + rl;
#pragma unroll
        for (int r = 0; r < SPLIT; ++r)
          *reinterpret_cast<uint2*>(pdst[r] + row * PLD + 4 * lane) = pk;
      }
    }
  }
}

}  // namespace m2t_cftm_c256
