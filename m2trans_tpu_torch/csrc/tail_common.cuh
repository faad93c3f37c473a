// Shared pieces of K2 (tail_band.cu, forward) and K2b (tail_band_bwd.cu,
// its VJP): the operand struct, the exact GELU, the phase-block and tap
// maps, and K2b's recompute of the phase band over the 6x18 halo of one of
// its 4x16 LR tiles (stage products on WMMA, one 4-block chunk at a time).
// The pre-clamp outputs, and with them K2b's clip mask, come from K2's own
// kernel (m2t_tail_band_gm in tail_band.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace m2t_tail {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;


constexpr int TR = 4;                  // LR rows per tile
constexpr int TW = 16;                 // LR columns per tile
constexpr int HW_ = TW + 2;            // halo tile width
constexpr int NPIX = (TR + 2) * HW_;   // 108 halo pixels
constexpr int NP = 112;                // padded to the 16-row MMA tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Row strides in shared memory are padded by 16 bytes, so that the rows of
// an MMA fragment, and the 16-byte loads of neighbouring pixels, fall on
// different banks.
__host__ __device__ inline int ph_ld(int nf) { return 4 * nf + 8; }
__host__ __device__ inline int a_ld(int nf) { return nf + 8; }  // y, h0
constexpr int SLD = 20;  // f32 per-warp staging tile

struct Layout {
  size_t h0, ph, w3, stage, info, total;
};

__host__ __device__ inline Layout layout(int nf) {
  // [y tile] [h0 group] [phase chunk] [w3 f32] [per-warp f32 staging]
  // [per-pixel (class, Y, X)]
  Layout l;
  l.h0 = (size_t)NP * a_ld(nf) * 2;
  l.ph = l.h0 + (size_t)NP * a_ld(nf) * 2;
  l.w3 = l.ph + (size_t)NP * ph_ld(nf) * 2;
  l.stage = l.w3 + (((size_t)9 * nf * 3 * 4 + 127) / 128) * 128;
  l.info = l.stage + (size_t)WARPS * 16 * SLD * 4;
  l.total = l.info + (size_t)NP * 3 * 4;
  return l;
}

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

// Source of halo pixel `pix` of the tile at (r0, c0): 0 computed in the
// frame, 1 top ring row, 2 bottom ring row, 3 left ring column, 4 right
// ring column, 5 unused (beyond the ring or padding).
__device__ __forceinline__ int pixel_class(const TailArgs& a, int pix, int r0,
                                           int c0, int& Y, int& X) {
  if (pix >= NPIX) return 5;
  Y = r0 - 1 + pix / HW_;
  X = c0 - 1 + pix % HW_;
  if (Y < -1 || Y > a.H || X < -1 || X > a.W) return 5;
  if (Y == -1) return 1;
  if (Y == a.H) return 2;
  if (X == -1) return 3;
  if (X == a.W) return 4;
  return 0;
}

// dst[NP x ncols] (bf16, ld ldd) = gelu(A[NP x nf] B[:, :ncols] + bias),
// A with row stride a_ld(nf);
// with `edges`, ring pixels take the phase-remapped edge values of channel
// chan0 + col instead, and unused pixels 0. Each warp owns whole 16-column
// tiles of B (and a share of the row tiles where there are fewer column
// tiles than warps) and sweeps them with the accumulators in registers:
// every weight fragment is read from L2 once per call and feeds 7 MMAs,
// the next one loaded before the current MMAs issue.
__device__ inline void stage_gemm(const TailArgs& a, const bf16* A, const bf16* Bm,
                           int ldb, const bf16* bias, int ncols, bf16* dst,
                           int ldd, bool edges, int chan0, int b,
                           const int* info, float* stage, int warp, int lane) {
  constexpr int NRT = NP / 16;
  const int nf = a.nf, cp = a.scale * a.scale * nf;
  const int nct = ncols / 16, nkt = nf / 16, lda = a_ld(nf);
  const int nsplit = nct >= WARPS ? 1 : WARPS / nct;
  for (int item = warp; item < nct * nsplit; item += WARPS) {
    const int ct = item / nsplit, part = item % nsplit;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NRT];
#pragma unroll
    for (int r = 0; r < NRT; ++r) wmma::fill_fragment(acc[r], 0.f);
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb0, fb1;
    const bf16* bcol = Bm + ct * 16;
    wmma::load_matrix_sync(fb0, bcol, ldb);
    for (int kk = 0; kk < nkt; kk += 2) {
      if (kk + 1 < nkt)
        wmma::load_matrix_sync(fb1, bcol + (size_t)(kk + 1) * 16 * ldb, ldb);
#pragma unroll
      for (int r = 0; r < NRT; ++r) {
        if (r % nsplit != part) continue;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, A + r * 16 * lda + kk * 16, lda);
        wmma::mma_sync(acc[r], fa, fb0, acc[r]);
      }
      if (kk + 1 >= nkt) break;
      if (kk + 2 < nkt)
        wmma::load_matrix_sync(fb0, bcol + (size_t)(kk + 2) * 16 * ldb, ldb);
#pragma unroll
      for (int r = 0; r < NRT; ++r) {
        if (r % nsplit != part) continue;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, A + r * 16 * lda + (kk + 1) * 16, lda);
        wmma::mma_sync(acc[r], fa, fb1, acc[r]);
      }
    }
#pragma unroll
    for (int rt = 0; rt < NRT; ++rt) {
      if (rt % nsplit != part) continue;
      wmma::store_matrix_sync(stage, acc[rt], SLD, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = rt * 16 + e / 16, col = ct * 16 + e % 16;
        float v = gelu(stage[(e / 16) * SLD + e % 16] +
                       __bfloat162float(bias[col]));
        if (edges) {
          const int cls = info[row * 3], Y = info[row * 3 + 1],
                    X = info[row * 3 + 2];
          const int ch = chan0 + col;
          if (cls == 1) v = a.top[((size_t)b * (a.W + 2) + X + 1) * cp + ch];
          else if (cls == 2) v = a.bot[((size_t)b * (a.W + 2) + X + 1) * cp + ch];
          else if (cls == 3) v = a.lc[((size_t)b * (a.H + 2) + Y + 1) * cp + ch];
          else if (cls == 4) v = a.rc[((size_t)b * (a.H + 2) + Y + 1) * cp + ch];
          else if (cls == 5) v = 0.f;
        }
        dst[row * ldd + col] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
}

// Per-tile set-up: pixel classes, the y tile (zero off the frame) and w3 in
// f32. The caller synchronises.
__device__ inline void tile_load(const TailArgs& a, const Layout& lay,
                          unsigned char* smem, int b, int r0, int c0) {
  const int nf = a.nf, tid = threadIdx.x;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* w3 = reinterpret_cast<float*>(smem + lay.w3);
  int* info = reinterpret_cast<int*>(smem + lay.info);
  if (tid < NP) {
    int Y = 0, X = 0;
    info[tid * 3] = pixel_class(a, tid, r0, c0, Y, X);
    info[tid * 3 + 1] = Y;
    info[tid * 3 + 2] = X;
  }
  __syncthreads();
  for (int e = tid; e < NP * nf; e += THREADS) {
    const int pix = e / nf, c = e % nf;
    const int Y = info[pix * 3 + 1], X = info[pix * 3 + 2];
    ys[pix * a_ld(nf) + c] =
        info[pix * 3] == 0 ? a.y[(((size_t)b * a.H + Y) * a.W + X) * nf + c]
                           : __float2bfloat16(0.f);
  }
  for (int e = tid; e < 9 * nf * 3; e += THREADS)
    w3[e] = __bfloat162float(a.w3[e]);
}

// Phase-band chunk g (blocks 4g .. 4g+3) of the tile's 6x18 halo, bf16, in
// the ph buffer (at x4 through h0, the stage-0 output of group g). The
// caller synchronises.
__device__ inline void phase_chunk(const TailArgs& a, const Layout& lay,
                            unsigned char* smem, int g, int b) {
  const int nf = a.nf, s = a.scale, P = s * s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* h0 = reinterpret_cast<bf16*>(smem + lay.h0);
  bf16* ph = reinterpret_cast<bf16*>(smem + lay.ph);
  float* stage = reinterpret_cast<float*>(smem + lay.stage) + warp * 16 * SLD;
  const int* info = reinterpret_cast<const int*>(smem + lay.info);
  const int nblk = min(4, P - 4 * g), ldph = ph_ld(nf);
  if (s == 4) {
    // stage 0 for group g only (its nf columns), then stage 1 -> 4 blocks
    stage_gemm(a, ys, a.w0 + g * nf, 4 * nf, a.b0 + g * nf, nf, h0, a_ld(nf),
               false, 0, b, info, stage, warp, lane);
    __syncthreads();
    stage_gemm(a, h0, a.w1, 4 * nf, a.b1, 4 * nf, ph, ldph, true, 4 * g * nf,
               b, info, stage, warp, lane);
  } else {
    stage_gemm(a, ys, a.w0 + 4 * g * nf, P * nf, a.b0 + 4 * g * nf,
               nblk * nf, ph, ldph, true, 4 * g * nf, b, info, stage, warp,
               lane);
  }
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
