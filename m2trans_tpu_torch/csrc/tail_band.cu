// K2: the fused phase-plane upsampling tail, forward, for sm_90a.
//
// Replaces the TPU kernel m2trans_tpu/ops/pallas/tail_band.py _kernel
// (launched by tail_band_fused, reached through tail_band_apply).
//
// For each LR pixel of the (B, H, W, nf) body output y:
//   h  = gelu(y w0 + b0)                                stage 0, f32
//   x4: ph = gelu(bf16(h_g) w1 + b1) for the 4 groups g   stage 1, f32
//   else ph = h                       -> (.., P*nf) phase band, P = s*s
//   out = clamp(sum_taps bf16(ph[nbr]) w3[tap], 0, rgb_range)
// The 3x3 HR reflect conv is the 3x3 LR-grid conv with the selector-
// expanded kernel K (tail_phase.expand_phase_kernel). K is 15/16 zeros:
// output phase (i, j) at tap (dr, dc) reads one nf-channel source block
// L[(i+dr)%s, (j+dc)%s] of the LR neighbour ((i+dr)//s, (j+dc)//s) through
// w3[dr+1, dc+1], which is exactly K's only non-zero block there. So the
// kernel takes the HWIO (3, 3, nf, 3) weight and walks that structure.
// Outside the frame the phase band is the phase-remapped HR reflect ring,
// precomputed on 1-px slices (tail_phase.phase_edges) and spliced in.
// GELU is exact (erff).
//
// One thread block per (image, 4x16 LR tile). Its 6x18 halo tile of phase
// pixels is recomputed (108/64), one 4-block chunk (4*nf channels) at a
// time, so the (B, H, W, P*nf) phase tensor never reaches device memory.
// Each thread owns one output pixel and a quarter of its phases (so every
// branch on the phase and tap is uniform across a warp).
//
// What bounds it on the card: the stage products, (1 + 4) * nf * 4nf MACs
// per halo pixel at x4, and shared memory (the whole 6x18x1024 bf16 phase
// band would be 221 KB). Design: stage products on the tensor cores through
// WMMA (bf16 in, f32 accumulate) with each weight fragment loaded once per
// block and reused over all row tiles, one chunk of the phase band (59,136
// bytes at nf=64; 109,888 bytes in all) held in shared memory in bf16; the structured phase conv (27.6K
// MACs per LR pixel at x4) runs on the CUDA cores from shared memory into
// per-thread f32 accumulators that persist across chunks.

#include "tail_common.cuh"

namespace {

using namespace m2t_tail;

__global__ void __launch_bounds__(THREADS) tail_band_kernel(TailArgs a) {
  const int s = a.scale, P = s * s;
  const int ntw = (a.W + TW - 1) / TW;
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / ntw) * TR, c0 = (blockIdx.x % ntw) * TW;
  const int tid = threadIdx.x;
  // this thread's output pixel and phases q = qg + QGROUPS*m
  const int po = tid % (TR * TW), qg = tid / (TR * TW);
  const int ty = po / TW, tx = po % TW;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(a.nf);
  float acc[MAX_Q][3];
  tile_outputs(a, lay, smem, b, r0, c0, ty, tx, qg, acc);

  const int Y = r0 + ty, X = c0 + tx;
  if (Y < a.H && X < a.W) {
    bf16* o = a.out + (((size_t)b * a.H + Y) * a.W + X) * P * 3;
#pragma unroll
    for (int m = 0; m < MAX_Q; ++m) {
      const int q = qg + QGROUPS * m;
      if (q >= P) break;
      for (int c = 0; c < 3; ++c)
        o[q * 3 + c] =
            __float2bfloat16(fminf(fmaxf(acc[m][c], 0.f), a.rgb_range));
    }
  }
}

}  // namespace

extern "C" int m2t_tail_band_smem(int nf) { return (int)layout(nf).total; }

extern "C" int m2t_tail_band(const void* y, const void* w0, const void* b0,
                             const void* w1, const void* b1, const void* w3,
                             const void* lc, const void* rc, const void* top,
                             const void* bot, void* out, int B, int H, int W,
                             int nf, int scale, float rgb_range,
                             void* stream) {
  if (scale < 2 || scale > 4 || nf % 16 != 0) return (int)cudaErrorInvalidValue;
  TailArgs a;
  a.y = static_cast<const bf16*>(y);
  a.w0 = static_cast<const bf16*>(w0);
  a.b0 = static_cast<const bf16*>(b0);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const bf16*>(b1);
  a.w3 = static_cast<const bf16*>(w3);
  a.lc = static_cast<const float*>(lc);
  a.rc = static_cast<const float*>(rc);
  a.top = static_cast<const float*>(top);
  a.bot = static_cast<const float*>(bot);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.W = W; a.nf = nf; a.scale = scale;
  a.rgb_range = rgb_range;
  const size_t smem = layout(nf).total;
  cudaError_t err = cudaFuncSetAttribute(
      tail_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(((H + TR - 1) / TR) * ((W + TW - 1) / TW), B);
  tail_band_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
