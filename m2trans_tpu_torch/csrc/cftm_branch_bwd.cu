// K1b: the VJP of the fused CFTM wavelet branch (K1), for sm_90a.
//
// Replaces the TPU backward kernels behind cftm_branch_fused's custom_vjp:
// m2trans_tpu/ops/pallas/halo_attn.py _cascade_bwd_kernel (via
// _cascade_bwd_impl) and _cascade_bwd_tile_kernel (via
// _cascade_bwd_tiled_impl); m2trans_tpu/ops/pallas/halo_attn_packed.py
// _packed_bwd_kernel, _packed_bwd_tile_kernel and _packed_front_bwd_kernel.
// All five compute one function; their bands, slabs and lane packing were
// TPU choices.
//
// Given gout = d out (B, H, W, Cb), with the forward of cftm_branch.cu
// recomputed (nothing but its inputs is saved; the same bf16 roundings of
// z, zc, q, k+rel, v and P):
//   dO   = DWT^L(gout)                     (the adjoint of IWT^L)
//   dv   = P^T dO,   dP = dO v^T,   dS = P * (dP - rowsum(dP * P))
//   dq   = dS k,     dk = dS^T q            (q carries C^-0.5)
//   drel_h[r] += dk[slots of window row r, :C/2], drel_w likewise by column
//   dqkv = the per-pixel sum of the <= 4 window contributions (a halo
//          pixel is a key of up to 3 neighbouring windows); pad keys
//          outside the frame are dropped (zc is 0 there)
//   dW   = zc^T dqkv,   dzc = dqkv W^T,   dz = IWT^L(dzc) + gout
// The caller forms dx = dz*s, dx_add = r*dz, ds = sum dz*x, dt = sum dz.
//
// What bounds it on the card: shared memory. The forward already holds a
// window's zc/q/k/v in 221,440 of the 232,448 bytes a block may use at
// C = 256, and the backward also needs dO, dP, dS and dq/dk/dv. Design, two
// kernels and a reduction:
//   (a) cftm_bwd_attn_kernel, per (image, 8x8 query block): the forward
//       recompute up to P (shared memory laid out as K1's), then the
//       attention VJP on the tensor cores (WMMA, bf16 in, f32 accumulate).
//       dO goes through a per-window global scratch (bf16) and dP through
//       another (f32), both read back from L2, so nothing beyond K1's
//       shared memory is needed. dq, dk, dv leave per window (f32), with
//       the window's rel-pos partials.
//   (b) cftm_bwd_proj_kernel, per (image, 8x8 coarse pixel block): gathers
//       dqkv of its 64 pixels from the windows in a fixed order (no
//       atomics, so runs repeat exactly), then dW's per-block partial
//       zc^T dqkv and dzc = dqkv W^T on the tensor cores, with W^T read
//       from L2 as a column-major fragment, and the IWT^L + residual.
//   reduce_rows_kernel sums the per-block weight partials in a fixed order
//   (also used by K2b, tail_band_bwd.cu).

#include "cftm_common.cuh"

namespace {

using namespace m2t_cftm;

struct BwdArgs {
  BranchArgs f;        // the forward's operands (out unused)
  const bf16* gout;    // (B, H, W, Cb) contiguous
  bf16* dO;            // (nwin, 64, C) scratch
  float* dp;           // (nwin, 64, NKP) scratch
  float* dq;           // (nwin, 64, C)
  float* dk;           // (nwin, NKP, C)
  float* dv;           // (nwin, NKP, C)
  float* drel_part;    // (nwin, 10, C): [:, :, :C/2] rel_h, [:, :, C/2:] rel_w
  float* dw_part;      // (nwin, C, 3C)
  float* dz;           // (B, H, W, Cb) f32
};

// Shared memory of kernel (b): [zc 64 x ld_bf(C) bf16] [dqkv 64 x ld_q bf16]
// [dzc 64 x ld_o(C) f32]
__host__ __device__ inline int ld_q(int C) { return 3 * C + 8; }
__host__ __device__ inline size_t proj_smem(int C) {
  return (size_t)NQ * ld_bf(C) * 2 + (size_t)NQ * ld_q(C) * 2 +
         (size_t)NQ * ld_o(C) * 4;
}

template <int L>
__global__ void __launch_bounds__(THREADS) cftm_bwd_attn_kernel(BwdArgs a) {
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

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(C);
  bf16* zc = reinterpret_cast<bf16*>(smem);
  float* sim = reinterpret_cast<float*>(smem);
  bf16* P = reinterpret_cast<bf16*>(smem + lay.p);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.v);
  float* stage = reinterpret_cast<float*>(smem + lay.stage) + warp * 16 * SLD;

  bf16* dO = a.dO + win * NQ * C;
  float* dp = a.dp + win * NQ * NKP;
  float* dq = a.dq + win * NQ * C;
  float* dk = a.dk + win * NKP * C;
  float* dv = a.dv + win * NKP * C;

  // forward recompute: zc, q/k/v, logits
  load_zc<L>(f, b, bi, bj, NKP, zc);
  __syncthreads();
  project_qkv(f, C, zc, qs, ks, vs, stage);
  __syncthreads();
  logits(C, qs, ks, sim);
  // dO = DWT^L(gout) of the block's 64 coarse pixels, bf16, to scratch
  for (int item = tid; item < NQ * Cb; item += THREADS) {
    const int p = item / Cb, c = item % Cb;
    const int cr = bi * BLOCK + p / BLOCK, cc = bj * BLOCK + p % BLOCK;
    float px[S][S], o[G];
    for (int dy = 0; dy < S; ++dy)
      for (int dx = 0; dx < S; ++dx)
        px[dy][dx] = __bfloat162float(
            a.gout[(((size_t)b * f.H + cr * S + dy) * f.W + cc * S + dx) * Cb + c]);
    dwt<L>(px, o);
    for (int g = 0; g < G; ++g) dO[p * C + g * Cb + c] = __float2bfloat16(o[g]);
  }
  __syncthreads();
  softmax_rows(sim, P, true);  // P f32 in sim, bf16 in P
  __syncthreads();

  // dv = P^T dO (NKP x C) and dP = dO v^T (64 x NKP), to scratch
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
          wmma::load_matrix_sync(fb, dO + kk * 16 * C + ct * 16, C);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dv + rt * 16 * C + ct * 16, acc, C,
                                wmma::mem_row_major);
      } else {
        const int t = tile - nv, rt = t / (NKP / 16), ct = t % (NKP / 16);
        for (int kk = 0; kk < C / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, dO + rt * 16 * C + kk * 16, C);
          wmma::load_matrix_sync(fb, vs + ct * 16 * LD + kk * 16, LD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dp + rt * 16 * NKP + ct * 16, acc, NKP,
                                wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

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

  // rel-pos partials of this window: rel_h by window row, rel_w by column
  float* dr = a.drel_part + win * 10 * C;
  for (int item = tid; item < 10 * C; item += THREADS) {
    const int r = item / C, ch = item % C;
    float s = 0.f;
    for (int u = 0; u < 10; ++u)
      s += dk[win_slot(ch < C2 ? r : u, ch < C2 ? u : r) * C + ch];
    dr[item] = s;
  }
}

template <int L>
__global__ void __launch_bounds__(THREADS) cftm_bwd_proj_kernel(BwdArgs a) {
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
  const float scale = 1.f / sqrtf((float)C);

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* zc = reinterpret_cast<bf16*>(smem);
  bf16* dqkv = zc + NQ * LD;
  float* dzc = reinterpret_cast<float*>(dqkv + NQ * LQ);

  // zc of the 64 block pixels (window slots 0..63), as the forward
  load_zc<L>(f, b, bi, bj, NQ, zc);

  // dqkv: own window's dq (times C^-0.5), and dk | dv summed over every
  // window that holds the pixel as a key, in a fixed order
  for (int item = tid; item < NQ * C3; item += THREADS) {
    const int p = item / C3, col = item % C3;
    const int li = p / BLOCK, lj = p % BLOCK;
    float v;
    if (col < C) {
      v = a.dq[(blk * NQ + p) * C + col] * scale;
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

  // dz = IWT^L(dzc) + gout (the residual), f32
  for (int item = tid; item < NQ * Cb; item += THREADS) {
    const int p = item / Cb, c = item % Cb;
    const int cr = bi * BLOCK + p / BLOCK, cc = bj * BLOCK + p % BLOCK;
    float o[G], px[S][S];
    for (int g = 0; g < G; ++g) o[g] = dzc[p * LO + g * Cb + c];
    iwt<L>(o, px);
    for (int dy = 0; dy < S; ++dy)
      for (int dx = 0; dx < S; ++dx) {
        const size_t i =
            (((size_t)b * f.H + cr * S + dy) * f.W + cc * S + dx) * Cb + c;
        a.dz[i] = px[dy][dx] + __bfloat162float(a.gout[i]);
      }
  }
}

// out[j] = sum_i part[i * len + j], i in order
__global__ void reduce_rows_kernel(const float* part, int n, long long len,
                                   float* out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += part[(size_t)i * len + j];
  out[j] = s;
}

template <int L>
cudaError_t launch_bwd(const BwdArgs& a, float* dw, float* drel,
                       cudaStream_t st) {
  const int S = 1 << L;
  const int C = a.f.Cb * S * S;
  const size_t sa = layout(C).total, sb = proj_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      cftm_bwd_attn_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sa);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(cftm_bwd_proj_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sb);
  if (err != cudaSuccess) return err;
  const int nblk = (a.f.H / S / BLOCK) * (a.f.W / S / BLOCK);
  dim3 grid(nblk, a.f.B);
  cftm_bwd_attn_kernel<L><<<grid, THREADS, sa, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cftm_bwd_proj_kernel<L><<<grid, THREADS, sb, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nwin = nblk * a.f.B;
  const long long lw = (long long)C * 3 * C, lr = 10LL * C;
  reduce_rows_kernel<<<(unsigned)((lw + 255) / 256), 256, 0, st>>>(
      a.dw_part, nwin, lw, dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_rows_kernel<<<(unsigned)((lr + 255) / 256), 256, 0, st>>>(
      a.drel_part, nwin, lr, drel);
  return cudaGetLastError();
}

}  // namespace

extern "C" int m2t_reduce_rows(const void* part, int n, long long len,
                               void* out, void* stream) {
  reduce_rows_kernel<<<(unsigned)((len + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), n, len, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Shared memory of kernel (a) (which = 0) and (b) (which = 1) at width C.
extern "C" int m2t_cftm_branch_bwd_smem(int C, int which) {
  return (int)(which == 0 ? layout(C).total : proj_smem(C));
}

extern "C" int m2t_cftm_branch_bwd(
    const void* x, const void* xadd, const void* s, const void* t,
    const void* w, const void* relh, const void* relw, const void* gout,
    void* dO, void* dp, void* dq, void* dk, void* dv, void* drel_part,
    void* dw_part, void* dz, void* dw, void* drel, int B, int H, int W,
    int Cb, int levels, long long x_sb, long long x_sh, long long x_sw,
    long long a_sb, long long a_sh, long long a_sw, float r, void* stream) {
  BwdArgs a;
  a.f.x = static_cast<const bf16*>(x);
  a.f.xadd = static_cast<const bf16*>(xadd);
  a.f.s = static_cast<const float*>(s);
  a.f.t = static_cast<const float*>(t);
  a.f.w = static_cast<const bf16*>(w);
  a.f.relh = static_cast<const float*>(relh);
  a.f.relw = static_cast<const float*>(relw);
  a.f.out = nullptr;
  a.f.B = B; a.f.H = H; a.f.W = W; a.f.Cb = Cb;
  a.f.x_sb = x_sb; a.f.x_sh = x_sh; a.f.x_sw = x_sw;
  a.f.a_sb = a_sb; a.f.a_sh = a_sh; a.f.a_sw = a_sw;
  a.f.r = r;
  a.gout = static_cast<const bf16*>(gout);
  a.dO = static_cast<bf16*>(dO);
  a.dp = static_cast<float*>(dp);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.drel_part = static_cast<float*>(drel_part);
  a.dw_part = static_cast<float*>(dw_part);
  a.dz = static_cast<float*>(dz);
  float* dwf = static_cast<float*>(dw);
  float* drf = static_cast<float*>(drel);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (levels) {
    case 0: return (int)launch_bwd<0>(a, dwf, drf, st);
    case 1: return (int)launch_bwd<1>(a, dwf, drf, st);
    case 2: return (int)launch_bwd<2>(a, dwf, drf, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
