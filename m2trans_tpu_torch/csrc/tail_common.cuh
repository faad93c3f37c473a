// Shared pieces of K2 (tail_band.cu, forward) and K2b (tail_band_bwd.cu,
// its VJP): the operand struct, the exact GELU and the phase-block and tap
// maps. (tail_chain.cuh has the pieces of K2's register chain that K2b
// runs as well.) The pre-clamp outputs, and with them K2b's clip mask, come
// from K2's own kernel (m2t_tail_band_gm in tail_band.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace m2t_tail {

typedef __nv_bfloat16 bf16;


struct TailArgs {
  const bf16* y;                 // (B, H, W, nf)
  const bf16 *w0, *b0;           // (nf, cp0), (cp0); cp0 = 4nf at x4
  const bf16 *w1, *b1;           // (nf, 4nf), (4nf); x4 only
  const bf16* w3;                // (3, 3, nf, 3) HWIO
  const float *lc, *rc;          // (B, H+2, P*nf) by padded row
  const float *top, *bot;        // (B, W+2, P*nf) by padded column
  bf16* out;                     // (B, H, W, P*3)
  int B, H, W, nf, scale;
  float rgb_range;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ int phase_block(int pi, int pj, int s) {
  if (s == 4) return ((pi >> 1) * 2 + (pj >> 1)) * 4 + (pi & 1) * 2 + (pj & 1);
  return pi * s + pj;
}

// Output phase q = (i, j), tap (dr, dc) -> the LR offset (yo, xo) and the
// phase block it reads.
__device__ __forceinline__ int tap_source(int i, int j, int dr, int dc, int s,
                                          int& yo, int& xo) {
  const int ii = i + dr, jj = j + dc;
  yo = ii < 0 ? -1 : (ii >= s ? 1 : 0);
  xo = jj < 0 ? -1 : (jj >= s ? 1 : 0);
  return phase_block(ii - yo * s, jj - xo * s, s);
}

}  // namespace m2t_tail
