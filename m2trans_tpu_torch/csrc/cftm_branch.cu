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
// K1n, the bare wavelet branch (halo_attention_qkv_fused of halo_attn.py:
// _kernel, _tile_kernel, _multiband_kernel), is the same kernel entered
// through m2t_halo_attn_qkv with no affine, no cascade add and no residual:
//   out = bf16(IWT^L(o)),  z = x.
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

#include "cftm_common.cuh"

namespace {

using namespace m2t_cftm;

template <int L>
__global__ void __launch_bounds__(THREADS)
cftm_branch_kernel(BranchArgs a) {
  constexpr int S = 1 << L;  // full-res pixels per coarse pixel side
  constexpr int G = S * S;   // subband channels per base channel
  const int Cb = a.Cb, C = Cb * G;
  const int LO = ld_o(C);
  const int Wc = a.W / S;
  const int nbw = Wc / BLOCK;
  const int b = blockIdx.y;
  const int bi = blockIdx.x / nbw, bj = blockIdx.x % nbw;
  const int tid = threadIdx.x, warp = tid / 32;

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
  load_zc<L>(a, b, bi, bj, NKP, zc);
  __syncthreads();

  // 2. qkv projection on the tensor cores
  project_qkv(a, C, zc, qs, ks, vs, stage);
  __syncthreads();

  // 3. logits q k^T (f32) over the padded key slots
  logits(C, qs, ks, sim);
  __syncthreads();

  // 4. softmax over the 100 real keys, f32; P in bf16, zero on pad slots
  softmax_rows(sim, P, false);
  __syncthreads();

  // 5. O = P v (f32), over q and k which are consumed
  {
    const int LD = ld_bf(C);
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

  // 6. IWT^L + residual z (none for the bare branch), bf16 out
  for (int item = tid; item < NQ * Cb; item += THREADS) {
    const int p = item / Cb, c = item % Cb;
    const int cr = bi * BLOCK + p / BLOCK, cc = bj * BLOCK + p % BLOCK;
    float o[G];
    for (int g = 0; g < G; ++g) o[g] = O[p * LO + g * Cb + c];
    float px[S][S];
    iwt<L>(o, px);
    float sv, tv;
    affine_coef(a, b, c, sv, tv);
    for (int dy = 0; dy < S; ++dy)
      for (int dx = 0; dx < S; ++dx) {
        const int y = cr * S + dy, xx = cc * S + dx;
        const float res = a.s ? affine_z(a, b, y, xx, c, sv, tv) : 0.f;
        a.out[(((size_t)b * a.H + y) * a.W + xx) * Cb + c] =
            __float2bfloat16(px[dy][dx] + res);
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

// K1n: the branch without affine, cascade add and residual (s = t = null).
extern "C" int m2t_halo_attn_qkv(const void* x, const void* w, const void* relh,
                                 const void* relw, void* out, int B, int H,
                                 int W, int Cb, int levels, long long x_sb,
                                 long long x_sh, long long x_sw, void* stream) {
  return m2t_cftm_branch(x, nullptr, nullptr, nullptr, w, relh, relw, out, B,
                         H, W, Cb, levels, x_sb, x_sh, x_sw, x_sb, x_sh, x_sw,
                         0.f, stream);
}
