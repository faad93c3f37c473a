// Shared pieces of K1 (cftm_branch.cu, forward) and K1b
// (cftm_branch_bwd.cu, its VJP): constants, the shared-memory layout of one
// 10x10 key window, the Haar transforms, and the forward's steps up to the
// softmax, so that the backward recomputes exactly what the forward
// computed (same products, same bf16 roundings).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace m2t_cftm {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BLOCK = 8;      // query block side
constexpr int NQ = 64;        // queries per block
constexpr int NK = 100;       // keys per 10x10 window
constexpr int NKP = 112;      // keys padded to the 16-row MMA tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Leading dimensions in shared memory are padded by 16 bytes so that the
// rows of one 16x16 MMA fragment fall on different banks.
constexpr int LDS = NKP + 4;  // f32 logits
constexpr int LDP = NKP + 8;  // bf16 probabilities
constexpr int SLD = 20;       // f32 per-warp staging tile
__host__ __device__ inline int ld_bf(int C) { return C + 8; }  // zc q k v
__host__ __device__ inline int ld_o(int C) { return C + 4; }   // f32 output

struct Layout {
  size_t p, q, k, v, stage, total;
};

__host__ __device__ inline Layout layout(int C) {
  // [zc | sim f32 + P bf16] [q] [k] [v] [per-warp f32 staging];
  // the f32 output O (NQ x C) overlays q and k once the logits are taken.
  const size_t ld = ld_bf(C);
  size_t zc = (size_t)NKP * ld * 2;
  size_t simp = (size_t)NQ * LDS * 4 + (size_t)NQ * LDP * 2;
  Layout l;
  l.p = (size_t)NQ * LDS * 4;
  l.q = zc > simp ? zc : simp;
  l.k = l.q + (size_t)NQ * ld * 2;
  l.v = l.k + (size_t)NKP * ld * 2;
  l.stage = l.v + (size_t)NKP * ld * 2;
  l.total = l.stage + (size_t)WARPS * 16 * SLD * 4;
  return l;
}

// Window slot -> (row, col) in the 10x10 key window. Slots 0..63 are the 8x8
// query block in row-major order (so q is the first 64 rows of the
// projection), 64..99 the halo ring. Softmax is order-free over keys.
__device__ __forceinline__ void win_coord(int idx, int& wr, int& wc) {
  if (idx < NQ) {
    wr = 1 + idx / BLOCK;
    wc = 1 + idx % BLOCK;
    return;
  }
  int h = idx - NQ;
  if (h < 10) { wr = 0; wc = h; }
  else if (h < 20) { wr = 9; wc = h - 10; }
  else if (h < 28) { wr = 1 + (h - 20); wc = 0; }
  else { wr = 1 + (h - 28); wc = 9; }
}

// inverse of win_coord: (row, col) in the 10x10 window -> slot
__device__ __forceinline__ int win_slot(int wr, int wc) {
  if (wr >= 1 && wr <= BLOCK && wc >= 1 && wc <= BLOCK)
    return (wr - 1) * BLOCK + wc - 1;
  if (wr == 0) return NQ + wc;
  if (wr == 9) return NQ + 10 + wc;
  if (wc == 0) return NQ + 20 + wr - 1;
  return NQ + 28 + wr - 1;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Haar quad a=(0,0) b=(1,0) c=(0,1) d=(1,1) -> [LL, HL, LH, HH]
__device__ __forceinline__ void haar(float a, float b, float c, float d,
                                     float* o) {
  o[0] = (a + b + c + d) * 0.5f;
  o[1] = (-a - b + c + d) * 0.5f;
  o[2] = (-a + b - c + d) * 0.5f;
  o[3] = (a - b - c + d) * 0.5f;
}

// inverse: [LL, HL, LH, HH] -> quad p[row][col]
__device__ __forceinline__ void ihaar(float ll, float hl, float lh, float hh,
                                      float p[2][2]) {
  p[0][0] = (ll - hl - lh + hh) * 0.5f;
  p[1][0] = (ll - hl + lh - hh) * 0.5f;
  p[0][1] = (ll + hl - lh - hh) * 0.5f;
  p[1][1] = (ll + hl + lh + hh) * 0.5f;
}

// DWT^L of one (2^L x 2^L) pixel patch; the transform is orthonormal, so
// it is also the adjoint of iwt<L>.
template <int L>
__device__ __forceinline__ void dwt(float (*p)[1 << L], float* o) {
  if constexpr (L == 0) {
    o[0] = p[0][0];
  } else if constexpr (L == 1) {
    haar(p[0][0], p[1][0], p[0][1], p[1][1], o);
  } else {
    float l1[4][2][2];  // [sb1][row][col] at level 1
    for (int qy = 0; qy < 2; ++qy)
      for (int qx = 0; qx < 2; ++qx) {
        float h[4];
        haar(p[2 * qy][2 * qx], p[2 * qy + 1][2 * qx], p[2 * qy][2 * qx + 1],
             p[2 * qy + 1][2 * qx + 1], h);
        for (int sb = 0; sb < 4; ++sb) l1[sb][qy][qx] = h[sb];
      }
    for (int sb1 = 0; sb1 < 4; ++sb1) {
      float h[4];
      haar(l1[sb1][0][0], l1[sb1][1][0], l1[sb1][0][1], l1[sb1][1][1], h);
      for (int sb2 = 0; sb2 < 4; ++sb2) o[sb2 * 4 + sb1] = h[sb2];
    }
  }
}

// IWT^L, the inverse (and adjoint) of dwt<L>
template <int L>
__device__ __forceinline__ void iwt(const float* o, float (*p)[1 << L]) {
  if constexpr (L == 0) {
    p[0][0] = o[0];
  } else if constexpr (L == 1) {
    float q[2][2];
    ihaar(o[0], o[1], o[2], o[3], q);
    for (int y = 0; y < 2; ++y)
      for (int x = 0; x < 2; ++x) p[y][x] = q[y][x];
  } else {
    float l1[4][2][2];  // undo level 2 per sb1
    for (int sb1 = 0; sb1 < 4; ++sb1)
      ihaar(o[0 * 4 + sb1], o[1 * 4 + sb1], o[2 * 4 + sb1], o[3 * 4 + sb1],
            l1[sb1]);
    for (int qy = 0; qy < 2; ++qy)
      for (int qx = 0; qx < 2; ++qx) {
        float q[2][2];
        ihaar(l1[0][qy][qx], l1[1][qy][qx], l1[2][qy][qx], l1[3][qy][qx], q);
        for (int y = 0; y < 2; ++y)
          for (int x = 0; x < 2; ++x) p[2 * qy + y][2 * qx + x] = q[y][x];
      }
  }
}

struct BranchArgs {
  const bf16* x;
  const bf16* xadd;  // may be null
  const float* s;    // null (with t) for the bare branch: no affine
  const float* t;
  const bf16* w;     // (C, 3C), q|k|v columns
  const float* relh; // (10, C/2)
  const float* relw; // (10, C/2)
  bf16* out;         // (B, H, W, Cb) contiguous
  int B, H, W, Cb;
  long long x_sb, x_sh, x_sw, a_sb, a_sh, a_sw;
  float r;
};

// The affine of image b, channel c; the identity where there is none.
__device__ __forceinline__ void affine_coef(const BranchArgs& a, int b, int c,
                                            float& sv, float& tv) {
  sv = a.s ? a.s[b * a.Cb + c] : 1.f;
  tv = a.s ? a.t[b * a.Cb + c] : 0.f;
}

// bf16(x*s + t [+ r*x_add]) at full-res pixel (y, xx), channel c
__device__ __forceinline__ float affine_z(const BranchArgs& a, int b, int y,
                                          int xx, int c, float sv, float tv) {
  float z = __bfloat162float(a.x[b * a.x_sb + y * a.x_sh + xx * a.x_sw + c]) *
                sv + tv;
  if (a.xadd)
    z += a.r * __bfloat162float(a.xadd[b * a.a_sb + y * a.a_sh + xx * a.a_sw + c]);
  return round_bf16(z);
}

// Step 1: affine + mask + cascade add, DWT^L -> zc rows 0..nslots-1 of the
// window of coarse query block (bi, bj); rows >= NK (and pixels outside
// the frame) are zero.
template <int L>
__device__ inline void load_zc(const BranchArgs& a, int b, int bi, int bj,
                        int nslots, bf16* zc) {
  constexpr int S = 1 << L;
  constexpr int G = S * S;
  const int Cb = a.Cb, LD = ld_bf(Cb * G);
  const int Hc = a.H / S, Wc = a.W / S;
  for (int item = threadIdx.x; item < nslots * Cb; item += THREADS) {
    const int idx = item / Cb, c = item % Cb;
    float vals[G];
    bool inside = false;
    if (idx < NK) {
      int wr, wc;
      win_coord(idx, wr, wc);
      const int cr = bi * BLOCK - 1 + wr, cc = bj * BLOCK - 1 + wc;
      inside = cr >= 0 && cr < Hc && cc >= 0 && cc < Wc;
      if (inside) {
        float sv, tv;
        affine_coef(a, b, c, sv, tv);
        float p[S][S];
        for (int dy = 0; dy < S; ++dy)
          for (int dx = 0; dx < S; ++dx)
            p[dy][dx] = affine_z(a, b, cr * S + dy, cc * S + dx, c, sv, tv);
        dwt<L>(p, vals);
      }
    }
    for (int g = 0; g < G; ++g)
      zc[idx * LD + g * Cb + c] = __float2bfloat16(inside ? vals[g] : 0.f);
  }
}

// Step 2: qkv projection on the tensor cores; q only for the 64 query rows.
// Each warp owns whole 16-column tiles of W (and, where there are fewer
// tiles than warps, a share of the row tiles) and sweeps its row tiles
// with the accumulators in registers, so each weight fragment is read
// from L2 once per block and feeds up to 7 MMAs; the next fragment is
// loaded before the current MMAs issue.
//   q = bf16(zc Wq * C^-0.5), k = bf16(zc Wk + rel), v = bf16(zc Wv)
__device__ inline void project_qkv(const BranchArgs& a, int C, const bf16* zc,
                            bf16* qs, bf16* ks, bf16* vs, float* stage) {
  constexpr int NRT = NKP / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C3 = 3 * C, C2 = C / 2, LD = ld_bf(C);
  const float scale = 1.f / sqrtf((float)C);  // exact for C = 4^n
  const int nct = C3 / 16, nkt = C / 16, qct = C / 16;
  const int nsplit = nct >= WARPS ? 1 : WARPS / nct;
  for (int item = warp; item < nct * nsplit; item += WARPS) {
    const int ct = item / nsplit, part = item % nsplit;
    const int nrt = ct < qct ? NQ / 16 : NRT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NRT];
#pragma unroll
    for (int r = 0; r < NRT; ++r) wmma::fill_fragment(acc[r], 0.f);
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb0, fb1;
    const bf16* wcol = a.w + ct * 16;
    wmma::load_matrix_sync(fb0, wcol, C3);
    for (int kk = 0; kk < nkt; kk += 2) {
      if (kk + 1 < nkt)
        wmma::load_matrix_sync(fb1, wcol + (size_t)(kk + 1) * 16 * C3, C3);
#pragma unroll
      for (int r = 0; r < NRT; ++r) {
        if (r < nrt && r % nsplit == part) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, zc + r * 16 * LD + kk * 16, LD);
          wmma::mma_sync(acc[r], fa, fb0, acc[r]);
        }
      }
      if (kk + 1 >= nkt) break;
      if (kk + 2 < nkt)
        wmma::load_matrix_sync(fb0, wcol + (size_t)(kk + 2) * 16 * C3, C3);
#pragma unroll
      for (int r = 0; r < NRT; ++r) {
        if (r < nrt && r % nsplit == part) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, zc + r * 16 * LD + (kk + 1) * 16, LD);
          wmma::mma_sync(acc[r], fa, fb1, acc[r]);
        }
      }
    }
#pragma unroll
    for (int rt = 0; rt < NRT; ++rt) {
      if (rt >= nrt) break;
      if (rt % nsplit != part) continue;
      wmma::store_matrix_sync(stage, acc[rt], SLD, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = rt * 16 + e / 16, col = ct * 16 + e % 16;
        const float v = stage[(e / 16) * SLD + e % 16];
        if (col < C) {
          qs[row * LD + col] = __float2bfloat16(v * scale);
        } else if (col < 2 * C) {
          const int ch = col - C;
          float rel = 0.f;
          if (row < NK) {
            int wr, wc;
            win_coord(row, wr, wc);
            rel = ch < C2 ? a.relh[wr * C2 + ch] : a.relw[wc * C2 + ch - C2];
          }
          ks[row * LD + ch] = __float2bfloat16(v + rel);
        } else {
          vs[row * LD + col - 2 * C] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

// Step 3: logits q k^T (f32) over the padded key slots
__device__ inline void logits(int C, const bf16* qs, const bf16* ks, float* sim) {
  const int warp = threadIdx.x / 32, LD = ld_bf(C), nkt = C / 16;
  for (int tile = warp; tile < (NQ / 16) * (NKP / 16); tile += WARPS) {
    const int rt = tile / (NKP / 16), ct = tile % (NKP / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < nkt; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, qs + rt * 16 * LD + kk * 16, LD);
      wmma::load_matrix_sync(fb, ks + ct * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sim + rt * 16 * LDS + ct * 16, acc, LDS,
                            wmma::mem_row_major);
  }
}

// Step 4: softmax over the 100 real keys, f32; P in bf16, zero on pad
// slots. With keep_f32 the f32 probabilities overwrite the logits.
__device__ inline void softmax_rows(float* sim, bf16* P, bool keep_f32) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < NQ; row += WARPS) {
    float v[4];
    float m = -INFINITY;
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      v[j] = col < NK ? sim[row * LDS + col] : -INFINITY;
      m = fmaxf(m, v[j]);
    }
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      v[j] = col < NK ? expf(v[j] - m) : 0.f;
      sum += v[j];
    }
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.f / sum;
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      if (col < NKP) {
        P[row * LDP + col] = __float2bfloat16(v[j] * inv);
        if (keep_f32) sim[row * LDS + col] = v[j] * inv;
      }
    }
  }
}

}  // namespace m2t_cftm
