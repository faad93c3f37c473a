// K1b at base widths other than 16 (none on a model path): the first
// version's two kernels, one block a window on WMMA through the steps of
// cftm_common.cuh, with dO and dP in shared memory. cftm_branch_bwd.cu
// states the function and the design.

#include "cftm_bwd_common.cuh"

namespace m2t_cftm_bwd {

namespace {

// ---- the general body (base widths other than 16) -------------------------

// Shared memory of its kernel (a): K1's layout, then dO (bf16, 64 x ld_bf)
// and dP (f32, 64 x NKP); of its kernel (b): [zc 64 x ld_bf(C) bf16]
// [dqkv 64 x ld_q bf16] [dzc 64 x ld_o(C) f32] [ds | dt shares 64 x Cb x 2]
__host__ __device__ inline int ld_q(int C) { return 3 * C + 8; }
__host__ __device__ inline size_t attn_general_smem(int C) {
  return layout(C).total + (size_t)NQ * ld_bf(C) * 2 + (size_t)NQ * NKP * 4;
}
__host__ __device__ inline size_t proj_general_smem(int C, int Cb) {
  return (size_t)NQ * ld_bf(C) * 2 + (size_t)NQ * ld_q(C) * 2 +
         (size_t)NQ * ld_o(C) * 4 + (size_t)NQ * Cb * 2 * 4;
}

template <int L>
__global__ void __launch_bounds__(THREADS) cftm_bwd_attn_general_kernel(BwdArgs a) {
  constexpr int S = 1 << L;
  constexpr int G = S * S;
  const BranchArgs& f = a.f;
  const int Cb = f.Cb, C = Cb * G, C2 = C / 2;
  const int nbw = f.W / S / BLOCK, nblk = (f.H / S / BLOCK) * nbw;
  const int b = blockIdx.y;
  const int bi = blockIdx.x / nbw, bj = blockIdx.x % nbw;
  const size_t win = (size_t)b * nblk + blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int LD = ld_bf(C);
  const float scale = 1.f / sqrtf((float)C);

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(C);
  bf16* zc = reinterpret_cast<bf16*>(smem);
  float* sim = reinterpret_cast<float*>(smem);
  bf16* P = reinterpret_cast<bf16*>(smem + lay.p);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.v);
  float* stage = reinterpret_cast<float*>(smem + lay.stage) + warp * 16 * SLD;

  bf16* dO = reinterpret_cast<bf16*>(smem + lay.total);  // 64 x LD
  float* dp = reinterpret_cast<float*>(smem + lay.total + (size_t)NQ * LD * 2);
  float* dq = a.dq + win * NQ * C;
  float* dk = a.dk + win * NKP * C;
  float* dv = a.dv + win * NKP * C;

  if (M2T_K1B_DONE(1)) return;
  // forward recompute: zc, q/k/v, logits
  load_zc<L>(f, b, bi, bj, NKP, zc);
  __syncthreads();
  project_qkv(f, C, zc, qs, ks, vs, stage);
  __syncthreads();
  logits(C, qs, ks, sim);
  // dO = DWT^L(gout) of the block's 64 coarse pixels, bf16, in shared memory
  for (int item = tid; item < (M2T_K1B_DONE(2) ? 0 : NQ * Cb); item += THREADS) {
    const int p = item / Cb, c = item % Cb;
    const int cr = bi * BLOCK + p / BLOCK, cc = bj * BLOCK + p % BLOCK;
    float px[S][S], o[G];
    for (int dy = 0; dy < S; ++dy)
      for (int dx = 0; dx < S; ++dx)
        px[dy][dx] = __bfloat162float(
            a.gout[(((size_t)b * f.H + cr * S + dy) * f.W + cc * S + dx) * Cb + c]);
    dwt<L>(px, o);
    for (int g = 0; g < G; ++g) dO[p * LD + g * Cb + c] = __float2bfloat16(o[g]);
  }
  __syncthreads();
  softmax_rows(sim, P, true);  // P f32 in sim, bf16 in P
  __syncthreads();
  if (M2T_K1B_DONE(3)) return;

  // dv = P^T dO (NKP x C) to scratch and dP = dO v^T (64 x NKP) in shared
  // memory
  {
    const int nct = C / 16, nv = (NKP / 16) * nct;
    for (int tile = warp; tile < nv + (NQ / 16) * (NKP / 16); tile += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      if (tile < nv) {
        const int rt = tile / nct, ct = tile % nct;
        for (int kk = 0; kk < NQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, P + kk * 16 * LDP + rt * 16, LDP);
          wmma::load_matrix_sync(fb, dO + kk * 16 * LD + ct * 16, LD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dv + rt * 16 * C + ct * 16, acc, C,
                                wmma::mem_row_major);
      } else {
        const int t = tile - nv, rt = t / (NKP / 16), ct = t % (NKP / 16);
        for (int kk = 0; kk < C / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, dO + rt * 16 * LD + kk * 16, LD);
          wmma::load_matrix_sync(fb, vs + ct * 16 * LD + kk * 16, LD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dp + rt * 16 * NKP + ct * 16, acc, NKP,
                                wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  if (M2T_K1B_DONE(4)) return;

  // dS = P * (dP - rowsum(dP * P)), f32, to bf16 over P (zero on pad keys)
  for (int row = warp; row < NQ; row += WARPS) {
    float pv[4], gv[4], rs = 0.f;
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      pv[j] = col < NK ? sim[row * LDS + col] : 0.f;
      gv[j] = col < NK ? dp[row * NKP + col] : 0.f;
      rs += pv[j] * gv[j];
    }
    for (int off = 16; off > 0; off /= 2)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      if (col < NKP) P[row * LDP + col] = __float2bfloat16(pv[j] * (gv[j] - rs));
    }
  }
  __syncthreads();
  if (M2T_K1B_DONE(5)) return;

  // dq = dS k (64 x C) and dk = dS^T q (NKP x C), to scratch
  {
    const int nct = C / 16, nq = (NQ / 16) * nct;
    for (int tile = warp; tile < nq + (NKP / 16) * nct; tile += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      if (tile < nq) {
        const int rt = tile / nct, ct = tile % nct;
        for (int kk = 0; kk < NKP / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, P + rt * 16 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(fb, ks + kk * 16 * LD + ct * 16, LD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= scale;
        wmma::store_matrix_sync(dq + rt * 16 * C + ct * 16, acc, C,
                                wmma::mem_row_major);
      } else {
        const int t = tile - nq, rt = t / nct, ct = t % nct;
        for (int kk = 0; kk < NQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, P + kk * 16 * LDP + rt * 16, LDP);
          wmma::load_matrix_sync(fb, qs + kk * 16 * LD + ct * 16, LD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dk + rt * 16 * C + ct * 16, acc, C,
                                wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  if (M2T_K1B_DONE(6)) return;

  // rel-pos partials of this window: rel_h by window row, rel_w by column
  // (dk is read back from global memory by the threads that wrote it or
  // after the barrier above)
  float* dr = a.drel_part + win * 10 * C;
  for (int item = tid; item < 10 * C; item += THREADS) {
    const int r = item / C, ch = item % C;
    float s = 0.f;
    for (int u = 0; u < 10; ++u)
      s += dk[win_slot(ch < C2 ? r : u, ch < C2 ? u : r) * C + ch];
    dr[ch < C2 ? r * C2 + ch : 10 * C2 + r * C2 + ch - C2] = s;
  }
}

template <int L>
__global__ void __launch_bounds__(THREADS) cftm_bwd_proj_general_kernel(BwdArgs a) {
  constexpr int S = 1 << L;
  constexpr int G = S * S;
  const BranchArgs& f = a.f;
  const int Cb = f.Cb, C = Cb * G, C3 = 3 * C;
  const int nbh = f.H / S / BLOCK, nbw = f.W / S / BLOCK, nblk = nbh * nbw;
  const int b = blockIdx.y;
  const int bi = blockIdx.x / nbw, bj = blockIdx.x % nbw;
  const size_t blk = (size_t)b * nblk + blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32;
  const int LD = ld_bf(C), LQ = ld_q(C), LO = ld_o(C);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* zc = reinterpret_cast<bf16*>(smem);
  bf16* dqkv = zc + NQ * LD;
  float* dzc = reinterpret_cast<float*>(dqkv + NQ * LQ);
  float* red = dzc + NQ * LO;  // 64 x Cb x (ds, dt) shares

  if (M2T_K1B_DONE(7)) return;
  // zc of the 64 block pixels (window slots 0..63), as the forward
  load_zc<L>(f, b, bi, bj, NQ, zc);

  // dqkv: own window's dq (kernel (a) applied C^-0.5), and dk | dv summed over every
  // window that holds the pixel as a key, in a fixed order
  for (int item = tid; item < NQ * C3; item += THREADS) {
    const int p = item / C3, col = item % C3;
    const int li = p / BLOCK, lj = p % BLOCK;
    float v;
    if (col < C) {
      v = a.dq[(blk * NQ + p) * C + col];
    } else {
      const float* src = col < 2 * C ? a.dk : a.dv;
      const int c = col < 2 * C ? col - C : col - 2 * C;
      v = 0.f;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          const int nbi = bi + dy, nbj = bj + dx;
          const int wr = 1 + li - BLOCK * dy, wc = 1 + lj - BLOCK * dx;
          if (nbi < 0 || nbi >= nbh || nbj < 0 || nbj >= nbw || wr < 0 ||
              wr > 9 || wc < 0 || wc > 9)
            continue;
          const size_t w = (size_t)b * nblk + nbi * nbw + nbj;
          v += src[(w * NKP + win_slot(wr, wc)) * C + c];
        }
    }
    dqkv[p * LQ + col] = __float2bfloat16(v);
  }
  __syncthreads();
  if (M2T_K1B_DONE(8)) return;

  // dW partial = zc^T dqkv (C x 3C) to global; dzc = dqkv W^T (64 x C)
  {
    const int nw = (C / 16) * (C3 / 16), nz = (NQ / 16) * (C / 16);
    float* dwp = a.dw_part + blk * C * C3;
    for (int tile = warp; tile < nw + nz; tile += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      if (tile < nw) {
        const int rt = tile / (C3 / 16), ct = tile % (C3 / 16);
        for (int kk = 0; kk < NQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, zc + kk * 16 * LD + rt * 16, LD);
          wmma::load_matrix_sync(fb, dqkv + kk * 16 * LQ + ct * 16, LQ);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dwp + (size_t)rt * 16 * C3 + ct * 16, acc, C3,
                                wmma::mem_row_major);
      } else {
        const int t = tile - nw, rt = t / (C / 16), ct = t % (C / 16);
        for (int kk = 0; kk < C3 / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, dqkv + rt * 16 * LQ + kk * 16, LQ);
          wmma::load_matrix_sync(fb, f.w + (size_t)ct * 16 * C3 + kk * 16, C3);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dzc + rt * 16 * LO + ct * 16, acc, LO,
                                wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  // dz = IWT^L(dzc) + gout (the residual); dx, dx_add and the block's
  // shares of ds and dt, summed over its 64 coarse pixels in order
  for (int item = tid; item < NQ * Cb; item += THREADS) {
    const int p = item / Cb, c = item % Cb;
    float o[G];
    for (int g = 0; g < G; ++g) o[g] = dzc[p * LO + g * Cb + c];
    affine_vjp<L>(a, b, bi * BLOCK + p / BLOCK, bj * BLOCK + p % BLOCK, c, o,
                  red[item * 2], red[item * 2 + 1]);
  }
  __syncthreads();
  for (int item = tid; item < 2 * Cb; item += THREADS) {
    const int which = item / Cb, c = item % Cb;
    float sum = 0.f;
    for (int p = 0; p < NQ; ++p) sum += red[(p * Cb + c) * 2 + which];
    a.st_part[(blk * 2 + which) * Cb + c] = sum;
  }
}

template <int L>
cudaError_t launch_general_at(const BwdArgs& a, int nblk, cudaStream_t st) {
  const int C = a.f.Cb << (2 * L);
  const size_t sa = attn_general_smem(C), sb = proj_general_smem(C, a.f.Cb);
  cudaError_t err = set_smem(cftm_bwd_attn_general_kernel<L>, sa);
  if (err != cudaSuccess) return err;
  if ((err = set_smem(cftm_bwd_proj_general_kernel<L>, sb)) != cudaSuccess) return err;
  dim3 grid(nblk, a.f.B);
  cftm_bwd_attn_general_kernel<L><<<grid, THREADS, sa, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cftm_bwd_proj_general_kernel<L><<<grid, THREADS, sb, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_general(const BwdArgs& a, int levels, int nblk, cudaStream_t st) {
  switch (levels) {
    case 0: return launch_general_at<0>(a, nblk, st);
    case 1: return launch_general_at<1>(a, nblk, st);
    case 2: return launch_general_at<2>(a, nblk, st);
    default: return cudaErrorInvalidValue;
  }
}

int general_smem(int C, int Cb, int which) {
  return (int)(which == 0 ? attn_general_smem(C) : proj_general_smem(C, Cb));
}

}  // namespace m2t_cftm_bwd
