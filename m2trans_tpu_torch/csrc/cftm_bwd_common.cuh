// What the three sources of K1b share (cftm_branch_bwd.cu states the design;
// cftm_branch_bwd_attn.cu holds kernel (a) of base width 16,
// cftm_branch_bwd_general.cu the body of other widths): the operand struct,
// the timing-ablation macro, the affine's VJP at the end of kernel (b), the
// row builders of base width 16, and each source's launchers.

#pragma once

#include <stdint.h>

#include "cftm_common.cuh"
#include "mma_ptx.cuh"

#define M2T_WINDOW_PIECES_ONLY
#include "cftm_window.cuh"

// Timing ablation (tools/kernel_ablation.py builds it; results are wrong by
// design): with M2T_K1B_STOP = n the work ends after step n: 1 the launches
// alone, 2 the recompute to P, 3 dO, 4 dP, 5 dS, 6 dq, 7 kernel (a) whole
// (dv, dk, rel-pos partials), 8 kernel (b) up to its gather, 9 kernel (b)
// whole; the reduction runs only with 0. (The general body: 4 dv + dP,
// 6 dq + dk.)
#ifndef M2T_K1B_STOP
#define M2T_K1B_STOP 0
#endif
#define M2T_K1B_DONE(n) (M2T_K1B_STOP != 0 && M2T_K1B_STOP <= (n))

namespace m2t_cftm_bwd {

using namespace m2t_cftm;
using namespace m2t_ptx;

struct BwdArgs {
  BranchArgs f;        // the forward's operands (out unused)
  const bf16* gout;    // (B, H, W, Cb) contiguous
  float* dq;           // (nwin, 64, C), times C^-0.5
  float* dk;           // (nwin, NKP, C), rows < 100 written
  float* dv;           // (nwin, NKP, C), rows < 100 written
  float* drel_part;    // (nwin, 2, 10, C/2): rel_h, then rel_w
  float* dw_part;      // (nwin, C, 3C)
  float* st_part;      // (B, blocks an image, 2, Cb): ds | dt of a block
  bf16* dx;            // (B, H, W, Cb)
  bf16* dxadd;         // (B, H, W, Cb), or null
};

// Kernel (a) of base width 16 at `levels` (cftm_branch_bwd_attn.cu) and its
// shared memory.
cudaError_t launch_attn_b16(const BwdArgs& a, int levels, int nblk, cudaStream_t st);
int attn_b16_smem(int levels);
// Kernels (a) and (b) of every other base width (cftm_branch_bwd_general.cu)
// and the shared memory of kernel (a) (which = 0) or (b) (which = 1).
cudaError_t launch_general(const BwdArgs& a, int levels, int nblk, cudaStream_t st);
int general_smem(int C, int Cb, int which);

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// ---- pieces of (b)'s epilogue, shared by its two bodies -------------------

// dz of the S x S pixels of coarse pixel (cr, cc), channel c: writes dx and
// dx_add, returns the pixel's share of ds (sx) and dt (st).
template <int L>
__device__ __forceinline__ void affine_vjp(const BwdArgs& a, int b, int cr, int cc,
                                           int c, const float* o, float& sx,
                                           float& st) {
  constexpr int S = 1 << L;
  const BranchArgs& f = a.f;
  float px[S][S];
  iwt<L>(o, px);
  const float sv = f.s[b * f.Cb + c];
  sx = 0.f;
  st = 0.f;
#pragma unroll
  for (int dy = 0; dy < S; ++dy)
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      const int y = cr * S + dy, xx = cc * S + dx;
      const size_t i = (((size_t)b * f.H + y) * f.W + xx) * f.Cb + c;
      const float dz = px[dy][dx] + __bfloat162float(a.gout[i]);
      a.dx[i] = __float2bfloat16(dz * sv);
      if (a.dxadd) a.dxadd[i] = __float2bfloat16(f.r * dz);
      sx += dz * __bfloat162float(f.x[b * f.x_sb + y * f.x_sh + xx * f.x_sw + c]);
      st += dz;
    }
}

// ---- pieces shared by the bodies of base width 16 -------------------------

// One row of C = 16 * 4^L coarse channels (L = 0 or 1) from the S x S pixels
// at coarse position (cr, cc), 16 base channels each, read as 16-byte
// vectors from `src` (pixel strides sb, sh, sw): with AFFINE z = bf16(x*s + t
// [+ r*x_add]) first (the forward's zc row), else the pixels as they are
// (dO = DWT^L(gout)). Zero where `inside` is false.
template <int L, bool AFFINE>
__device__ __forceinline__ void form_row(const BranchArgs& f, const bf16* src,
                                         long long sb, long long sh, long long sw,
                                         int b, int cr, int cc, bool inside,
                                         bf16* row) {
  using namespace m2t_cftm_win;
  constexpr int S = 1 << L, CB = 16;
  if (!inside) {
#pragma unroll
    for (int v = 0; v < CB * S * S / 8; ++v)
      *reinterpret_cast<uint4*>(row + 8 * v) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  uint4 xv[S * S][2], av[S * S][2];
#pragma unroll
  for (int px = 0; px < S * S; ++px) {
    const int y = S * cr + px / S, xx = S * cc + px % S;
    const uint4* xp = reinterpret_cast<const uint4*>(src + b * sb + y * sh + xx * sw);
    xv[px][0] = __ldg(xp);
    xv[px][1] = __ldg(xp + 1);
    av[px][0] = av[px][1] = make_uint4(0u, 0u, 0u, 0u);
    if (AFFINE && f.xadd) {
      const uint4* ap = reinterpret_cast<const uint4*>(
          f.xadd + b * f.a_sb + y * f.a_sh + xx * f.a_sw);
      av[px][0] = __ldg(ap);
      av[px][1] = __ldg(ap + 1);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 zq[S * S];
#pragma unroll
    for (int px = 0; px < S * S; ++px)
      zq[px] = AFFINE ? affine8(f, b, 8 * h, xv[px][h], av[px][h]) : xv[px][h];
    if constexpr (L == 0) {
      *reinterpret_cast<uint4*>(row + 8 * h) = zq[0];
    } else {
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
        *reinterpret_cast<uint4*>(row + g * CB + 8 * h) =
            make_uint4(sub[g][0], sub[g][1], sub[g][2], sub[g][3]);
    }
  }
}

// The 4 x 4 pixels of coarse position (cr, cc) at L = 2, base channels
// 4*qt .. 4*qt + 3, as 8-byte loads, and their DWT^2: o[e][g], e the channel
// of the four, g the subband. With AFFINE the forward's z first.
template <bool AFFINE>
__device__ __forceinline__ void dwt2_quarter(const BranchArgs& f, const bf16* src,
                                             long long sb, long long sh,
                                             long long sw, int b, int cr, int cc,
                                             int qt, float (&o)[4][16]) {
  uint2 xv[16], av[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int y = cr * 4 + i / 4, xx = cc * 4 + i % 4;
    xv[i] = __ldg(reinterpret_cast<const uint2*>(src + b * sb + y * sh + xx * sw + qt * 4));
    av[i] = make_uint2(0u, 0u);
    if (AFFINE && f.xadd)
      av[i] = __ldg(reinterpret_cast<const uint2*>(
          f.xadd + b * f.a_sb + y * f.a_sh + xx * f.a_sw + qt * 4));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float sv = 1.f, tv = 0.f;
    if (AFFINE) affine_coef(f, b, qt * 4 + e, sv, tv);
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float z = __bfloat162float(reinterpret_cast<const bf16*>(&xv[i])[e]);
      if (AFFINE) {
        z = z * sv + tv;
        if (f.xadd) z += f.r * __bfloat162float(reinterpret_cast<const bf16*>(&av[i])[e]);
        z = round_bf16(z);
      }
      p[i / 4][i % 4] = z;
    }
    dwt<2>(p, o[e]);
  }
}

}  // namespace m2t_cftm_bwd
