// K1 / K1n at base width 16, L = 0 (C = 16) and L = 1 (C = 64): the bodies
// that give a window to a warp (w16) or to a group of four warps (w64).
// Included by cftm_branch.cu, whose header states the function, and by
// cftm_branch_bwd_attn.cu, whose window body shares the pieces above the kernels.
//
// What bounds these shapes on the card: nothing the arithmetic or the bytes
// would explain (0.6 and 4.6 MFLOP a window, ~7 MB a launch, a bound of 1.4
// and 2.1 us at 8 x 96 x 96): a chain of latencies. The general body of
// cftm_branch.cu (one block per window, six phases between block barriers,
// 2-byte loads, the weight as fragments from L2, f32 logits through shared
// memory) takes 0.08 / 0.06 ms a launch at these shapes, five times what
// these bodies take (PERF.md). Design:
//   * a window belongs to one warp (C = 16) or to four warps that share its
//     k and v behind a named barrier of their own (C = 64); no block
//     barrier inside the window loop; several windows in flight per block
//     (4 warps x 3 blocks an SM at C = 16, 3 groups a block at C = 64), so
//     the 1,152 / 288 windows of 8 x 96 x 96 are resident in one round, and
//     larger frames are walked by the same warps;
//   * x and x_add enter as 16-byte vectors (a pixel's 16 base channels are
//     two), all of a thread's loads in flight before the affine and the Haar
//     arithmetic; z of the query pixels stays in shared memory for the
//     residual, and the output leaves as 16-byte vectors;
//   * the projection, q k^T and P v run on mma.sync.m16n8k16. At C = 16 the
//     16x48 weight lives in 12 registers of B fragments; at C = 64 the 24 KB
//     weight is copied into shared memory once per block. q never visits
//     shared memory: the projection's accumulators are the A fragments of
//     q k^T. k (+ rel-pos) and v go through shared memory once, read back
//     with ldmatrix (.trans for v);
//   * the softmax runs on the accumulator registers: a warp owns 16 query
//     rows, a row's 112 logits sit in the four lanes of a quad, the max and
//     the sum go by two shuffles over the 100 real keys (pad slots masked),
//     and bf16(P) feeds P v from registers as A fragments, so neither the
//     f32 logits nor P touch shared memory;
//   * at C = 64 the accumulator layout puts all four subbands of a base
//     channel into one thread, so the inverse Haar step is register
//     arithmetic too.

#pragma once

#include "cftm_common.cuh"
#include "mma_ptx.cuh"

namespace m2t_cftm_win {

using namespace m2t_cftm;
using namespace m2t_ptx;

#ifndef M2T_K1_STOP
#define M2T_K1_STOP 0
#endif

// Timing ablation: the window's work stops after step n (2 zc, 3 projection,
// 4 logits, 5 softmax, 6 P v); values still in registers go to `sink`.
#define M2T_K1_DONE(n) (M2T_K1_STOP != 0 && M2T_K1_STOP <= (n))

// bf16(x*s + t [+ r*x_add]) of the 8 channels c0.. of image b, packed.
__device__ __forceinline__ uint4 affine8(const BranchArgs& a, int b, int c0,
                                         uint4 xv, uint4 av) {
  float sv[8], tv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sv[e] = 1.f;
    tv[e] = 0.f;
  }
  if (a.s) {
    const float4* sp = reinterpret_cast<const float4*>(a.s + b * a.Cb + c0);
    const float4* tp = reinterpret_cast<const float4*>(a.t + b * a.Cb + c0);
    const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
    const float4 t0 = __ldg(tp), t1 = __ldg(tp + 1);
    sv[0] = s0.x; sv[1] = s0.y; sv[2] = s0.z; sv[3] = s0.w;
    sv[4] = s1.x; sv[5] = s1.y; sv[6] = s1.z; sv[7] = s1.w;
    tv[0] = t0.x; tv[1] = t0.y; tv[2] = t0.z; tv[3] = t0.w;
    tv[4] = t1.x; tv[5] = t1.y; tv[6] = t1.z; tv[7] = t1.w;
  }
  const bf16* xe = reinterpret_cast<const bf16*>(&xv);
  const bf16* ae = reinterpret_cast<const bf16*>(&av);
  float z[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    z[e] = __bfloat162float(xe[e]) * sv[e] + tv[e];
    if (a.xadd) z[e] += a.r * __bfloat162float(ae[e]);
  }
  return make_uint4(pack_bf16(z[0], z[1]), pack_bf16(z[2], z[3]),
                    pack_bf16(z[4], z[5]), pack_bf16(z[6], z[7]));
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// First half of the softmax of this warp's 16 query rows over the 100 real
// keys, on the logits' accumulator registers (row g8: s[nt][0..1], row
// g8 + 8: s[nt][2..3], key nt*8 + 2*t4 + e): s becomes exp(s - rowmax), zero
// on the pad slots, and inv the reciprocal of each row's sum.
__device__ __forceinline__ void softmax_exp(float (&s)[NKP / 8][4], int t4,
                                            float (&inv)[2]) {
  constexpr int NT = NKP / 8;
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (nt * 8 + 2 * t4 + (e & 1) >= NK) s[nt][e] = -INFINITY;
      m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
    m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // ex2.approx: P is rounded to bf16 next; exp(-inf) = 0 on pad slots
      s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
      sum[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
    inv[hr] = 1.f / sum[hr];
  }
}

// Softmax of this warp's 16 query rows (softmax_exp), and bf16(P) as the A
// fragments of P v.
__device__ __forceinline__ void softmax_fragments(float (&s)[NKP / 8][4], int t4,
                                                  uint32_t (&pf)[NKP / 16][4]) {
  float inv[2];
  softmax_exp(s, t4, inv);
#pragma unroll
  for (int kk = 0; kk < NKP / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        pf[kk][2 * h + hr] = pack_bf16(s[2 * kk + h][2 * hr] * inv[hr],
                                       s[2 * kk + h][2 * hr + 1] * inv[hr]);
}

// rel-pos of key slot `row` for the channel pair (ch, ch + 1); rel holds
// rel_h then rel_w, (10, C/2) each
template <int C>
__device__ __forceinline__ float2 rel_pair(const float* rel, int row, int ch) {
  int wr, wc;
  win_coord(row, wr, wc);
  const float* p = ch < C / 2 ? rel + wr * (C / 2) + ch
                              : rel + 10 * (C / 2) + wc * (C / 2) + ch - C / 2;
  return make_float2(p[0], p[1]);
}

// The kernels below belong to cftm_branch.cu's object alone; a source that
// wants only the pieces above defines M2T_WINDOW_PIECES_ONLY.
#ifndef M2T_WINDOW_PIECES_ONLY

// ---- C = 16 (L = 0): a window to a warp ----------------------------------

namespace w16 {

constexpr int C = 16;
constexpr int NWARP = 4;             // windows in flight per block
constexpr int NT = NWARP * 32;
constexpr int LD = C + 8;            // row pitch: 48 bytes, ldmatrix-friendly
constexpr int WIN_BYTES = 3 * NKP * LD * 2;  // zc | k | v of one warp
constexpr int REL_BYTES = 2 * 10 * (C / 2) * 4;
constexpr int SMEM = NWARP * WIN_BYTES + REL_BYTES;
constexpr int PER_SM = 3;            // blocks an SM holds (shared memory)

__global__ void __launch_bounds__(NT, PER_SM) cftm_branch_w16_kernel(BranchArgs a) {
  if (M2T_K1_STOP == 1) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* zc = reinterpret_cast<bf16*>(smem + warp * WIN_BYTES);
  bf16* ks = zc + NKP * LD;
  bf16* vs = ks + NKP * LD;
  float* rel = reinterpret_cast<float*>(smem + NWARP * WIN_BYTES);
  const uint32_t zc_s = smem_u32(zc), ks_s = smem_u32(ks), vs_s = smem_u32(vs);

  for (int i = tid; i < 2 * 10 * (C / 2); i += NT)
    rel[i] = i < 10 * (C / 2) ? a.relh[i] : a.relw[i - 10 * (C / 2)];
  // the 16x48 weight as B fragments: tile nt holds columns nt*8 + g8, rows
  // (2*t4, 2*t4 + 1) and (2*t4 + 8, 2*t4 + 9)
  uint32_t wf[6][2];
  {
    const unsigned short* w = reinterpret_cast<const unsigned short*>(a.w);
#pragma unroll
    for (int nt = 0; nt < 6; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * t4 + 8 * h, n = nt * 8 + g8;
        wf[nt][h] = (uint32_t)w[k * 3 * C + n] | ((uint32_t)w[(k + 1) * 3 * C + n] << 16);
      }
  }
  __syncthreads();

  const int nbw = a.W / BLOCK, per_img = (a.H / BLOCK) * nbw;
  const int nwin = a.B * per_img;
  uint32_t sink = 0;
  for (int win = blockIdx.x * NWARP + warp; win < nwin; win += gridDim.x * NWARP) {
    const int b = win / per_img, bi = (win % per_img) / nbw, bj = win % nbw;

    // 1. z = zc of the 100 window slots, a slot to a lane, 16-byte loads
    {
      uint4 xv[4][2], av[4][2];
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int slot = lane + 32 * it;
        xv[it][0] = xv[it][1] = av[it][0] = av[it][1] = make_uint4(0u, 0u, 0u, 0u);
        if (slot < NK) {
          int wr, wc;
          win_coord(slot, wr, wc);
          const int y = bi * BLOCK - 1 + wr, xx = bj * BLOCK - 1 + wc;
          if (y >= 0 && y < a.H && xx >= 0 && xx < a.W) {
            const uint4* xp = reinterpret_cast<const uint4*>(
                a.x + b * a.x_sb + y * a.x_sh + xx * a.x_sw);
            xv[it][0] = __ldg(xp);
            xv[it][1] = __ldg(xp + 1);
            if (a.xadd) {
              const uint4* ap = reinterpret_cast<const uint4*>(
                  a.xadd + b * a.a_sb + y * a.a_sh + xx * a.a_sw);
              av[it][0] = __ldg(ap);
              av[it][1] = __ldg(ap + 1);
            }
          }
        }
      }
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int slot = lane + 32 * it;
        if (slot >= NKP) continue;
        bool inside = false;
        if (slot < NK) {
          int wr, wc;
          win_coord(slot, wr, wc);
          const int y = bi * BLOCK - 1 + wr, xx = bj * BLOCK - 1 + wc;
          inside = y >= 0 && y < a.H && xx >= 0 && xx < a.W;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint4*>(zc + slot * LD + 8 * h) =
              inside ? affine8(a, b, 8 * h, xv[it][h], av[it][h])
                     : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncwarp();
    do {
      if (M2T_K1_DONE(2)) break;

      // 2. q | k | v = zc W (K = 16: one step); q stays in registers as the
      // A fragments of q k^T, k (+ rel) and v go to shared memory
      uint32_t qf[NQ / 16][4];
#pragma unroll
      for (int mt = 0; mt < NKP / 16; ++mt) {
        uint32_t fa[4];
        ldmatrix_x4(fa, zc_s + ((mt * 16 + lrow) * LD + lcol) * 2);
#pragma unroll
        for (int nt = (mt < NQ / 16 ? 0 : 2); nt < 6; ++nt) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(acc, fa, wf[nt][0], wf[nt][1]);
          if (nt < 2) {  // only for mt < NQ / 16; 16^-0.5 = 0.25
            qf[mt % (NQ / 16)][2 * nt] = pack_bf16(acc[0] * 0.25f, acc[1] * 0.25f);
            qf[mt % (NQ / 16)][2 * nt + 1] = pack_bf16(acc[2] * 0.25f, acc[3] * 0.25f);
          } else {
            const int ch = (nt & 1) * 8 + 2 * t4;
            bf16* dst = nt < 4 ? ks : vs;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = mt * 16 + g8 + 8 * hr;
              float v0 = acc[2 * hr], v1 = acc[2 * hr + 1];
              if (nt < 4 && row < NK) {
                const float2 rp = rel_pair<C>(rel, row, ch);
                v0 += rp.x;
                v1 += rp.y;
              }
              *reinterpret_cast<uint32_t*>(dst + row * LD + ch) = pack_bf16(v0, v1);
            }
          }
        }
      }
      __syncwarp();
      if (M2T_K1_DONE(3)) {
#pragma unroll
        for (int mt = 0; mt < NQ / 16; ++mt)
          sink ^= qf[mt][0] ^ qf[mt][1] ^ qf[mt][2] ^ qf[mt][3];
        break;
      }

#pragma unroll 1
      for (int mt = 0; mt < NQ / 16; ++mt) {
        // 3. logits of 16 query rows against the 112 key slots
        float s[NKP / 8][4];
#pragma unroll
        for (int nt = 0; nt < NKP / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kt = 0; kt < NKP / 16; ++kt) {
          uint32_t fb[4];
          ldmatrix_x4(fb, ks_s + ((kt * 16 + krow) * LD + kcol) * 2);
          mma_bf16(s[2 * kt], qf[mt], fb[0], fb[1]);
          mma_bf16(s[2 * kt + 1], qf[mt], fb[2], fb[3]);
        }
        if (M2T_K1_DONE(4)) {
#pragma unroll
          for (int nt = 0; nt < NKP / 8; ++nt) sink ^= __float_as_uint(s[nt][0] + s[nt][3]);
          continue;
        }
        // 4. softmax in registers
        uint32_t pf[NKP / 16][4];
        softmax_fragments(s, t4, pf);
        if (M2T_K1_DONE(5)) {
#pragma unroll
          for (int kk = 0; kk < NKP / 16; ++kk) sink ^= pf[kk][0] ^ pf[kk][3];
          continue;
        }
        // 5. O = P v
        float o[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NKP / 16; ++kk) {
          uint32_t fb[4];
          ldmatrix_x4_trans(fb, vs_s + ((kk * 16 + lrow) * LD + lcol) * 2);
          mma_bf16(o[0], pf[kk], fb[0], fb[1]);
          mma_bf16(o[1], pf[kk], fb[2], fb[3]);
        }
        if (M2T_K1_DONE(6)) {
          sink ^= __float_as_uint(o[0][0] + o[1][3]);
          continue;
        }
        // 6. + z (none for the bare branch), in place over the query rows of zc
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            uint32_t* zp = reinterpret_cast<uint32_t*>(
                zc + (mt * 16 + g8 + 8 * hr) * LD + nt * 8 + 2 * t4);
            const uint32_t zv = a.s ? *zp : 0u;
            *zp = pack_bf16(o[nt][2 * hr] + bf_lo(zv), o[nt][2 * hr + 1] + bf_hi(zv));
          }
      }
      if (M2T_K1_STOP) break;
      __syncwarp();
      // the 8x8 output pixels, two 16-byte vectors each
#pragma unroll
      for (int i = lane; i < NQ * 2; i += 32) {
        const int p = i / 2, h = i % 2;
        const int y = bi * BLOCK + p / BLOCK, xx = bj * BLOCK + p % BLOCK;
        *reinterpret_cast<uint4*>(a.out + (((size_t)b * a.H + y) * a.W + xx) * C + 8 * h) =
            *reinterpret_cast<const uint4*>(zc + p * LD + 8 * h);
      }
    } while (0);
    __syncwarp();  // the window's buffers are free again
  }
  if (M2T_K1_STOP && a.B < 0) a.out[0] = __ushort_as_bfloat16((unsigned short)sink);
}

}  // namespace w16

// ---- C = 64 (L = 1): a window to a group of four warps -------------------

namespace w64 {

constexpr int CB = 16;               // base channels
constexpr int C = 64;                // coarse channels, g*16 + c
constexpr int NG = 3;                // window groups per block
constexpr int GT = 128;              // threads of a group
constexpr int NT = NG * GT;
constexpr int LD = C + 8;            // zc, k, v row pitch (144 bytes)
constexpr int WLD = 3 * C + 8;       // weight row pitch
constexpr int ZLD = 4 * CB + 8;      // kept z: a slot's 2x2 pixels x 16 channels
constexpr int W_BYTES = C * WLD * 2;
constexpr int REL_BYTES = 2 * 10 * (C / 2) * 4;
constexpr int OFF_K = NKP * LD * 2;
constexpr int OFF_V = 2 * OFF_K;
constexpr int OFF_Z = 3 * OFF_K;
constexpr int GRP_BYTES = OFF_Z + NQ * ZLD * 2;
constexpr int SMEM = W_BYTES + REL_BYTES + NG * GRP_BYTES;
static_assert(SMEM <= 232448, "one block an SM");
static_assert(W_BYTES % 16 == 0 && REL_BYTES % 16 == 0 && GRP_BYTES % 16 == 0 &&
              OFF_K % 16 == 0 && OFF_Z % 16 == 0, "16-byte alignment");

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(GT) : "memory");
}

__global__ void __launch_bounds__(NT, 1) cftm_branch_w64_kernel(BranchArgs a) {
  if (M2T_K1_STOP == 1) return;
  const int tid = threadIdx.x, grp = tid / GT, gt = tid % GT;
  const int gw = gt / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  extern __shared__ __align__(128) unsigned char smem[];
  float* rel = reinterpret_cast<float*>(smem + W_BYTES);
  unsigned char* gbase = smem + W_BYTES + REL_BYTES + grp * GRP_BYTES;
  bf16* zc = reinterpret_cast<bf16*>(gbase);
  bf16* ks = reinterpret_cast<bf16*>(gbase + OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(gbase + OFF_V);
  bf16* zres = reinterpret_cast<bf16*>(gbase + OFF_Z);
  const uint32_t w_s = smem_u32(smem), zc_s = smem_u32(zc), ks_s = smem_u32(ks),
                 vs_s = smem_u32(vs);

  // once per block: the 64x192 weight and the rel-pos tables
  for (int i = tid; i < C * (3 * C / 8); i += NT) {
    const int row = i / (3 * C / 8), v = i % (3 * C / 8);
    cp_async16(w_s + (row * WLD + v * 8) * 2, a.w + (size_t)row * 3 * C + v * 8, 16);
  }
  cp_async_commit();
  for (int i = tid; i < 2 * 10 * (C / 2); i += NT)
    rel[i] = i < 10 * (C / 2) ? a.relh[i] : a.relw[i - 10 * (C / 2)];
  cp_async_wait<0>();
  __syncthreads();

  const int Hc = a.H / 2, Wc = a.W / 2;
  const int nbw = Wc / BLOCK, per_img = (Hc / BLOCK) * nbw;
  const int nwin = a.B * per_img;
  uint32_t sink = 0;
  for (int win = grp * gridDim.x + blockIdx.x; win < nwin; win += NG * gridDim.x) {
    const int b = win / per_img, bi = (win % per_img) / nbw, bj = win % nbw;

    // 1. a window slot to a thread: its 2x2 pixels as 16-byte loads, z kept
    // for the query slots, one Haar step, zc row = [LL | HL | LH | HH] x 16
    if (gt < NKP) {
      const int slot = gt;
      bool inside = false;
      int cr = 0, cc = 0;
      if (slot < NK) {
        int wr, wc;
        win_coord(slot, wr, wc);
        cr = bi * BLOCK - 1 + wr;
        cc = bj * BLOCK - 1 + wc;
        inside = cr >= 0 && cr < Hc && cc >= 0 && cc < Wc;
      }
      if (inside) {
        uint4 xv[4][2], av[4][2];
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const int y = 2 * cr + px / 2, xx = 2 * cc + px % 2;
          const uint4* xp = reinterpret_cast<const uint4*>(
              a.x + b * a.x_sb + y * a.x_sh + xx * a.x_sw);
          xv[px][0] = __ldg(xp);
          xv[px][1] = __ldg(xp + 1);
          av[px][0] = av[px][1] = make_uint4(0u, 0u, 0u, 0u);
          if (a.xadd) {
            const uint4* ap = reinterpret_cast<const uint4*>(
                a.xadd + b * a.a_sb + y * a.a_sh + xx * a.a_sw);
            av[px][0] = __ldg(ap);
            av[px][1] = __ldg(ap + 1);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint4 zq[4];
#pragma unroll
          for (int px = 0; px < 4; ++px) {
            zq[px] = affine8(a, b, 8 * h, xv[px][h], av[px][h]);
            if (slot < NQ)
              *reinterpret_cast<uint4*>(zres + slot * ZLD + px * CB + 8 * h) = zq[px];
          }
          uint32_t sub[4][4];  // [subband][channel pair]
#pragma unroll
          for (int cp = 0; cp < 4; ++cp) {
            float lo[4], hi[4];
            // haar(a = (0,0), b = (1,0), c = (0,1), d = (1,1)), pixel = dy*2 + dx
            const uint32_t pa = reinterpret_cast<const uint32_t*>(&zq[0])[cp];
            const uint32_t pb = reinterpret_cast<const uint32_t*>(&zq[2])[cp];
            const uint32_t pc = reinterpret_cast<const uint32_t*>(&zq[1])[cp];
            const uint32_t pd = reinterpret_cast<const uint32_t*>(&zq[3])[cp];
            haar(bf_lo(pa), bf_lo(pb), bf_lo(pc), bf_lo(pd), lo);
            haar(bf_hi(pa), bf_hi(pb), bf_hi(pc), bf_hi(pd), hi);
#pragma unroll
            for (int g = 0; g < 4; ++g) sub[g][cp] = pack_bf16(lo[g], hi[g]);
          }
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<uint4*>(zc + slot * LD + g * CB + 8 * h) =
                make_uint4(sub[g][0], sub[g][1], sub[g][2], sub[g][3]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < C / 8; ++v)
          *reinterpret_cast<uint4*>(zc + slot * LD + 8 * v) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    group_sync(grp);
    do {
      if (M2T_K1_DONE(2)) break;

      // 2. projection. This warp's 16 query rows of q stay in registers as
      // A fragments; of k and v it takes the columns 16*gw.. of all 7 row
      // tiles, their B fragments held in registers.
      uint32_t qf[C / 16][4];
      {
        uint32_t zf[C / 16][4];
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
          ldmatrix_x4(zf[kk], zc_s + ((gw * 16 + lrow) * LD + kk * 16 + lcol) * 2);
        float acc[C / 8][4];
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
          for (int n2 = 0; n2 < C / 16; ++n2) {
            uint32_t fb[4];
            ldmatrix_x4_trans(fb, w_s + ((kk * 16 + lrow) * WLD + n2 * 16 + lcol) * 2);
            mma_bf16(acc[2 * n2], zf[kk], fb[0], fb[1]);
            mma_bf16(acc[2 * n2 + 1], zf[kk], fb[2], fb[3]);
          }
        const float sc = 0.125f;  // 64^-0.5
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              qf[kk][2 * h + hr] = pack_bf16(acc[2 * kk + h][2 * hr] * sc,
                                             acc[2 * kk + h][2 * hr + 1] * sc);
      }
      {
        uint32_t bk[C / 16][4], bv[C / 16][4];
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          ldmatrix_x4_trans(bk[kk],
                            w_s + ((kk * 16 + lrow) * WLD + C + 16 * gw + lcol) * 2);
          ldmatrix_x4_trans(bv[kk],
                            w_s + ((kk * 16 + lrow) * WLD + 2 * C + 16 * gw + lcol) * 2);
        }
#pragma unroll 1
        for (int mt = 0; mt < NKP / 16; ++mt) {
          float kacc[2][4], vacc[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) kacc[nt][e] = vacc[nt][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < C / 16; ++kk) {
            uint32_t fa[4];
            ldmatrix_x4(fa, zc_s + ((mt * 16 + lrow) * LD + kk * 16 + lcol) * 2);
            mma_bf16(kacc[0], fa, bk[kk][0], bk[kk][1]);
            mma_bf16(kacc[1], fa, bk[kk][2], bk[kk][3]);
            mma_bf16(vacc[0], fa, bv[kk][0], bv[kk][1]);
            mma_bf16(vacc[1], fa, bv[kk][2], bv[kk][3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int ch = 16 * gw + nt * 8 + 2 * t4;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = mt * 16 + g8 + 8 * hr;
              float k0 = kacc[nt][2 * hr], k1 = kacc[nt][2 * hr + 1];
              if (row < NK) {
                const float2 rp = rel_pair<C>(rel, row, ch);
                k0 += rp.x;
                k1 += rp.y;
              }
              *reinterpret_cast<uint32_t*>(ks + row * LD + ch) = pack_bf16(k0, k1);
              *reinterpret_cast<uint32_t*>(vs + row * LD + ch) =
                  pack_bf16(vacc[nt][2 * hr], vacc[nt][2 * hr + 1]);
            }
          }
        }
      }
      group_sync(grp);  // k and v of the window are complete
      if (M2T_K1_DONE(3)) {
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) sink ^= qf[kk][0] ^ qf[kk][3];
        break;
      }

      // 3. logits of this warp's 16 query rows
      float s[NKP / 8][4];
#pragma unroll
      for (int nt = 0; nt < NKP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NKP / 16; ++kt)
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          uint32_t fb[4];
          ldmatrix_x4(fb, ks_s + ((kt * 16 + krow) * LD + kk * 16 + kcol) * 2);
          mma_bf16(s[2 * kt], qf[kk], fb[0], fb[1]);
          mma_bf16(s[2 * kt + 1], qf[kk], fb[2], fb[3]);
        }
      if (M2T_K1_DONE(4)) {
#pragma unroll
        for (int nt = 0; nt < NKP / 8; ++nt) sink ^= __float_as_uint(s[nt][0] + s[nt][3]);
        break;
      }
      // 4. softmax in registers
      uint32_t pf[NKP / 16][4];
      softmax_fragments(s, t4, pf);
      if (M2T_K1_DONE(5)) {
#pragma unroll
        for (int kk = 0; kk < NKP / 16; ++kk) sink ^= pf[kk][0] ^ pf[kk][3];
        break;
      }
      // 5. O = P v, 16 rows x 64 coarse channels
      float o[C / 8][4];
#pragma unroll
      for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKP / 16; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < C / 16; ++n2) {
          uint32_t fb[4];
          ldmatrix_x4_trans(fb, vs_s + ((kk * 16 + lrow) * LD + n2 * 16 + lcol) * 2);
          mma_bf16(o[2 * n2], pf[kk], fb[0], fb[1]);
          mma_bf16(o[2 * n2 + 1], pf[kk], fb[2], fb[3]);
        }
      if (M2T_K1_DONE(6)) {
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt) sink ^= __float_as_uint(o[nt][0] + o[nt][3]);
        break;
      }
      // 6. inverse Haar step in registers: tile nt = 2*g + h holds subband g
      // of base channels 8*h + 2*t4 (+1); + z, in place over the kept z
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int slot = gw * 16 + g8 + 8 * hr;
          float p0[2][2], p1[2][2];
          ihaar(o[h][2 * hr], o[2 + h][2 * hr], o[4 + h][2 * hr], o[6 + h][2 * hr], p0);
          ihaar(o[h][2 * hr + 1], o[2 + h][2 * hr + 1], o[4 + h][2 * hr + 1],
                o[6 + h][2 * hr + 1], p1);
#pragma unroll
          for (int px = 0; px < 4; ++px) {
            uint32_t* zp = reinterpret_cast<uint32_t*>(zres + slot * ZLD + px * CB +
                                                       8 * h + 2 * t4);
            const uint32_t zv = a.s ? *zp : 0u;
            *zp = pack_bf16(p0[px / 2][px % 2] + bf_lo(zv),
                            p1[px / 2][px % 2] + bf_hi(zv));
          }
        }
      __syncwarp();
      // this warp's 16 query slots: 2x2 pixels x two 16-byte vectors each
#pragma unroll
      for (int i = lane; i < 16 * 8; i += 32) {
        const int slot = gw * 16 + i / 8, px = (i / 2) % 4, h = i % 2;
        const int y = 2 * (bi * BLOCK + slot / BLOCK) + px / 2;
        const int xx = 2 * (bj * BLOCK + slot % BLOCK) + px % 2;
        *reinterpret_cast<uint4*>(a.out + (((size_t)b * a.H + y) * a.W + xx) * CB + 8 * h) =
            *reinterpret_cast<const uint4*>(zres + slot * ZLD + px * CB + 8 * h);
      }
    } while (0);
    group_sync(grp);  // the window's buffers are free again
  }
  if (M2T_K1_STOP && a.B < 0) a.out[0] = __ushort_as_bfloat16((unsigned short)sink);
}

}  // namespace w64

#endif  // M2T_WINDOW_PIECES_ONLY

}  // namespace m2t_cftm_win
