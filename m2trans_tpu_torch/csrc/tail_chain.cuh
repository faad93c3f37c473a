// Pieces of K2's register chain (tail_band.cu, which states the design)
// that K2b's second pass (tail_band_bwd.cu) runs as well: the 8x16 LR tile
// and the order of its halo slots, and one stage product of 16 pixels held
// as fragments against a weight slice in shared memory.

#pragma once

#include "mma_ptx.cuh"
#include "tail_common.cuh"

#ifndef M2T_K2_ABLATE
#define M2T_K2_ABLATE 0
#endif

namespace m2t_tail_chain {

using namespace m2t_tail;
using namespace m2t_ptx;

constexpr int FTR = 8, FTW = 16;          // LR rows, columns of a tile
constexpr int FHW = FTW + 2;              // halo width
constexpr int FNPIX = (FTR + 2) * FHW;    // 180 halo pixels
constexpr int FNP = 192;                  // padded to 12 m16 row tiles
constexpr int FWARPS = FNP / 16;          // one warp per row tile
constexpr int FTHREADS = FWARPS * 32;     // 384
constexpr int NOUT = FTR * FTW;           // 128 output pixels
static_assert(NOUT + 2 * FTW + 2 * FTR + 4 == FNPIX && FNPIX <= FNP,
              "tile pixels, ring rows, ring columns and corners fill the slots");
constexpr int W3LD = 40;                  // w3's row pitch (32 columns + 8)

// Row r of the 192 -> its pixel in the 10x18 halo (row * FHW + column), or
// -1 for the 12 pad rows. The 128 tile pixels come first (warps 0..7), then
// the ring by kind: top row, bottom row (warps 8, 9), left and right column
// (the two halves of warp 10), the four corners (warp 11). A ring pixel
// feeds only the phase blocks that face the tile, so the warps that hold
// the ring skip the others, and the schedulers each have one of them.
__device__ __forceinline__ int slot_pixel(int r) {
  if (r < NOUT) return (r / FTW + 1) * FHW + r % FTW + 1;
  r -= NOUT;
  if (r < FTW) return r + 1;
  if (r < 2 * FTW) return (FTR + 1) * FHW + r - FTW + 1;
  r -= 2 * FTW;
  if (r < FTR) return (r + 1) * FHW;
  if (r < 2 * FTR) return (r - FTR + 1) * FHW + FHW - 1;
  r -= 2 * FTR;
  if (r < 4) return (r / 2) * (FTR + 1) * FHW + (r % 2) * (FHW - 1);
  return -1;
}

// acc (16 rows x NF columns) = A (16 x NF, fragments) * B (NF x NF slice in
// shared memory, [k][n] with row pitch ldb bytes; bsm is this lane's
// ldmatrix address in the slice's first 16x16 tile).
template <int NKT>
__device__ __forceinline__ void block_product(float (&acc)[2 * NKT][4],
                                              const uint32_t (&af)[NKT][4],
                                              uint32_t bsm, int ldb) {
#pragma unroll
  for (int nt = 0; nt < 2 * NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  if (M2T_K2_ABLATE & 4) return;
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk)
#pragma unroll
    for (int n2 = 0; n2 < NKT; ++n2) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, bsm + kk * 16 * ldb + n2 * 32);
      mma_bf16(acc[2 * n2], af[kk], fb[0], fb[1]);
      mma_bf16(acc[2 * n2 + 1], af[kk], fb[2], fb[3]);
    }
}

}  // namespace m2t_tail_chain
