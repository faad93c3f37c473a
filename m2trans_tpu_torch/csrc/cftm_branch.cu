// K1: the fused CFTM wavelet branch, forward, for sm_90a.
//
// Replaces the TPU kernels of m2trans_tpu/ops/pallas/halo_attn.py
// (_cascade_kernel / _cascade_tile_kernel, reached through
// cftm_branch_fused) and m2trans_tpu/ops/pallas/halo_attn_packed.py
// (_packed_cascade_kernel, _packed_front_kernel): one function, whose
// row bands, column slabs and lane packing were TPU choices.
//
//   z   = bf16((x*s + t) [+ r*x_add])              zero outside the frame
//   zc  = bf16(DWT^L(z))                            Haar, [LL, HL, LH, HH]
//   q   = bf16(zc Wq * C^-0.5)   k = bf16(zc Wk + rel)   v = bf16(zc Wv)
//   o   = softmax_f32(q k^T) v over the 10x10 zero-padded key window of
//         each 8x8 query block (padded keys are 0 + rel, values 0)
//   out = bf16(IWT^L(o) + z)
//
// At L=2 the coarse channel index is sb2*4Cb + sb1*Cb + c, the order of two
// stacked haar_dwt calls.
//
// One thread block per (image, coarse 8x8 query block). It recomputes the
// q/k/v projection of its 10x10 window (the 100/64 halo overlap) so that
// nothing but x, x_add and the output crosses device memory.
//
// What bounds it on the card: the qkv projection, 3*C^2 MACs per window
// pixel (C = 256 at L=2: the 256x768 weight alone is 384 KB in bf16, over
// the 227 KB a block may hold). Design: the projection, q k^T and P v run
// on the tensor cores through WMMA (bf16 in, f32 accumulate), with the
// weight streamed from L2 tile by tile and never staged whole; the
// window's zc/q/k/v live in shared memory in bf16 (221,440 bytes in all at
// C=256, with the f32 logits and the f32 output overlaid on buffers already
// consumed; rows padded by 16 bytes against bank conflicts in the fragment
// loads).
// Softmax, the wavelets and the affine stay on the CUDA cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

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
  const float* s;
  const float* t;
  const bf16* w;     // (C, 3C), q|k|v columns
  const float* relh; // (10, C/2)
  const float* relw; // (10, C/2)
  bf16* out;         // (B, H, W, Cb) contiguous
  int B, H, W, Cb;
  long long x_sb, x_sh, x_sw, a_sb, a_sh, a_sw;
  float r;
};

template <int L>
__global__ void __launch_bounds__(THREADS)
cftm_branch_kernel(BranchArgs a) {
  constexpr int S = 1 << L;  // full-res pixels per coarse pixel side
  constexpr int G = S * S;   // subband channels per base channel
  const int Cb = a.Cb, C = Cb * G, C3 = 3 * C, C2 = C / 2;
  const int LD = ld_bf(C), LO = ld_o(C);
  const int Hc = a.H / S, Wc = a.W / S;
  const int nbw = Wc / BLOCK;
  const int b = blockIdx.y;
  const int bi = blockIdx.x / nbw, bj = blockIdx.x % nbw;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(C);
  bf16* zc = reinterpret_cast<bf16*>(smem);
  float* sim = reinterpret_cast<float*>(smem);
  bf16* P = reinterpret_cast<bf16*>(smem + lay.p);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.v);
  float* O = reinterpret_cast<float*>(smem + lay.q);
  float* stage = reinterpret_cast<float*>(smem + lay.stage) + warp * 16 * SLD;

  // 1. affine + mask + cascade add, DWT^L -> zc (rows >= NK are zero)
  for (int item = tid; item < NKP * Cb; item += THREADS) {
    const int idx = item / Cb, c = item % Cb;
    float vals[G];
    bool inside = false;
    if (idx < NK) {
      int wr, wc;
      win_coord(idx, wr, wc);
      const int cr = bi * BLOCK - 1 + wr, cc = bj * BLOCK - 1 + wc;
      inside = cr >= 0 && cr < Hc && cc >= 0 && cc < Wc;
      if (inside) {
        const float sv = a.s[b * Cb + c], tv = a.t[b * Cb + c];
        float p[S][S];
        for (int dy = 0; dy < S; ++dy)
          for (int dx = 0; dx < S; ++dx) {
            const int y = cr * S + dy, xx = cc * S + dx;
            float z = __bfloat162float(
                          a.x[b * a.x_sb + y * a.x_sh + xx * a.x_sw + c]) *
                          sv + tv;
            if (a.xadd)
              z += a.r * __bfloat162float(
                             a.xadd[b * a.a_sb + y * a.a_sh + xx * a.a_sw + c]);
            p[dy][dx] = round_bf16(z);
          }
        dwt<L>(p, vals);
      }
    }
    for (int g = 0; g < G; ++g)
      zc[idx * LD + g * Cb + c] = __float2bfloat16(inside ? vals[g] : 0.f);
  }
  __syncthreads();

  // 2. qkv projection on the tensor cores; q only for the 64 query rows.
  // Each warp owns whole 16-column tiles of W (and, where there are fewer
  // tiles than warps, a share of the row tiles) and sweeps its row tiles
  // with the accumulators in registers, so each weight fragment is read
  // from L2 once per block and feeds up to 7 MMAs; the next fragment is
  // loaded before the current MMAs issue.
  {
    constexpr int NRT = NKP / 16;
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
  __syncthreads();

  // 3. logits q k^T (f32) over the padded key slots
  {
    const int nkt = C / 16;
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
  __syncthreads();

  // 4. softmax over the 100 real keys, f32; P in bf16, zero on pad slots
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
      if (col < NKP) P[row * LDP + col] = __float2bfloat16(v[j] * inv);
    }
  }
  __syncthreads();

  // 5. O = P v (f32), over q and k which are consumed
  {
    const int qct = C / 16;
    for (int tile = warp; tile < (NQ / 16) * qct; tile += WARPS) {
      const int rt = tile / qct, ct = tile % qct;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < NKP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, P + rt * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, vs + kk * 16 * LD + ct * 16, LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(O + rt * 16 * LO + ct * 16, acc, LO,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // 6. IWT^L + residual z, bf16 out
  for (int item = tid; item < NQ * Cb; item += THREADS) {
    const int p = item / Cb, c = item % Cb;
    const int cr = bi * BLOCK + p / BLOCK, cc = bj * BLOCK + p % BLOCK;
    float o[G];
    for (int g = 0; g < G; ++g) o[g] = O[p * LO + g * Cb + c];
    float px[S][S];
    iwt<L>(o, px);
    const float sv = a.s[b * Cb + c], tv = a.t[b * Cb + c];
    for (int dy = 0; dy < S; ++dy)
      for (int dx = 0; dx < S; ++dx) {
        const int y = cr * S + dy, xx = cc * S + dx;
        float z = __bfloat162float(
                      a.x[b * a.x_sb + y * a.x_sh + xx * a.x_sw + c]) * sv + tv;
        if (a.xadd)
          z += a.r * __bfloat162float(
                         a.xadd[b * a.a_sb + y * a.a_sh + xx * a.a_sw + c]);
        a.out[(((size_t)b * a.H + y) * a.W + xx) * Cb + c] =
            __float2bfloat16(px[dy][dx] + round_bf16(z));
      }
  }
}

template <int L>
cudaError_t launch(const BranchArgs& a, cudaStream_t stream) {
  const int S = 1 << L;
  const int C = a.Cb * S * S;
  const size_t smem = layout(C).total;
  cudaError_t err = cudaFuncSetAttribute(
      cftm_branch_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.H / S / BLOCK) * (a.W / S / BLOCK), a.B);
  cftm_branch_kernel<L><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int m2t_cftm_branch_smem(int C) { return (int)layout(C).total; }

extern "C" int m2t_cftm_branch(const void* x, const void* xadd, const void* s,
                               const void* t, const void* w, const void* relh,
                               const void* relw, void* out, int B, int H,
                               int W, int Cb, int levels, long long x_sb,
                               long long x_sh, long long x_sw, long long a_sb,
                               long long a_sh, long long a_sw, float r,
                               void* stream) {
  BranchArgs a;
  a.x = static_cast<const bf16*>(x);
  a.xadd = static_cast<const bf16*>(xadd);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.w = static_cast<const bf16*>(w);
  a.relh = static_cast<const float*>(relh);
  a.relw = static_cast<const float*>(relw);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.W = W; a.Cb = Cb;
  a.x_sb = x_sb; a.x_sh = x_sh; a.x_sw = x_sw;
  a.a_sb = a_sb; a.a_sh = a_sh; a.a_sw = a_sw;
  a.r = r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (levels) {
    case 0: return (int)launch<0>(a, st);
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
