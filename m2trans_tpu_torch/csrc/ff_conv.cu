// K3: the CFTM's fused feed-forward conv, for sm_90a.
//
// Replaces the TPU kernels of m2trans_tpu/ops/pallas/ff_pair.py
// (ff_pair_conv_fused -> _kernel) and m2trans_tpu/ops/pallas/ff_packed.py
// (packed_ff_conv -> _kernel): one function, whose lane packing and
// pair-major permutations were TPU choices.
//
//   out = bf16( bf16( bf16(conv3x3_zeros(oc, w)) + b ) + x )
//
// oc, x, out: (B, H, W, C) contiguous NHWC bf16; w: (3, 3, C_in, C_out)
// bf16; b: (C,) bf16; products in bf16 with f32 accumulation. The three
// roundings are the ones the plain composition makes (conv rounded to
// bf16, bias add in bf16, residual add in bf16), so the kernel and its
// plain version differ only in the f32 order of the tap sums.
//
// What bounds it on the card: bytes. At the flagship shape (8 x 96 x 96 x
// 64) it reads oc and x and writes out, 3 x 9.4 MB, for 5.4 GFLOP: 8.5 us
// of memory time against 5.5 us of tensor-core time. Design: each block
// keeps the whole 9*C*C weight in shared memory for its lifetime and walks
// over 8x16-pixel output tiles (a persistent grid of two blocks per SM,
// so one block's loads overlap the other's products); a tile's 10x18xC
// input window is staged once, with zeros beyond the frame written by the
// staging loop, and the nine taps are nine shifted (128 x C)*(C x C) WMMA
// products into f32 fragments, one tile row of 16 pixels per warp. The
// epilogue goes through shared memory (over the consumed window) for the
// rounding sequence, and reads x and writes out as 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 16;          // output tile, rows x columns
constexpr int WH = TH + 2, WW = TW + 2; // input window
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;     // = TH: one tile row per warp
constexpr int SLD = 20;                 // f32 per-warp staging tile
constexpr int NACC = 6;                 // 16-column output tiles: C <= 96

// Window pixels are fragment rows that start at any pixel, and a WMMA
// fragment must start on 32 bytes: the window's row pitch is a multiple of
// 16 elements. The weight's fragments start on multiples of 16 rows, so
// its pitch takes the 16-byte pad that spreads the rows over the banks.
__host__ __device__ inline int ld_in(int C) { return C + 16; }
__host__ __device__ inline int ld_w(int C) { return C + 8; }

__host__ __device__ inline size_t weight_bytes(int C) {
  return (size_t)9 * C * ld_w(C) * 2;
}

__host__ __device__ inline size_t smem_bytes(int C) {
  size_t win = (size_t)WH * WW * ld_in(C) * 2;
  const size_t stage = (size_t)WARPS * 16 * SLD * 4;
  if (stage > win) win = stage;
  return weight_bytes(C) + win;
}

struct FfArgs {
  const bf16* oc;
  const bf16* x;
  const bf16* w;  // (3, 3, C, C), input channel major
  const bf16* b;
  bf16* out;
  int B, H, W, C;
  int tiles_h, tiles_w;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__global__ void __launch_bounds__(THREADS, 2) ff_conv_kernel(FfArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, H = a.H, W = a.W;
  const int LDI = ld_in(C), LDW = ld_w(C);
  const int nct = C / 16, cv = C / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* win = reinterpret_cast<bf16*>(smem + weight_bytes(C));
  float* stage = reinterpret_cast<float*>(win) + warp * 16 * SLD;

  // the weight, once per block
  for (int i = tid; i < 9 * C * cv; i += THREADS) {
    const int row = i / cv, v = i % cv;
    *reinterpret_cast<uint4*>(ws + row * LDW + v * 8) =
        *reinterpret_cast<const uint4*>(a.w + (size_t)row * C + v * 8);
  }

  const int per_img = a.tiles_h * a.tiles_w;
  const int ntiles = a.B * per_img;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / per_img, rem = tile % per_img;
    const int y0 = (rem / a.tiles_w) * TH, x0 = (rem % a.tiles_w) * TW;

    // the last tile's epilogue is done with the window's space
    __syncthreads();
    for (int i = tid; i < WH * WW * cv; i += THREADS) {
      const int p = i / cv, v = i % cv;
      const int y = y0 - 1 + p / WW, xx = x0 - 1 + p % WW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (y >= 0 && y < H && xx >= 0 && xx < W)
        val = *reinterpret_cast<const uint4*>(
            a.oc + (((size_t)b * H + y) * W + xx) * C + v * 8);
      *reinterpret_cast<uint4*>(win + p * LDI + v * 8) = val;
    }
    __syncthreads();

    // nine shifted products; warp r owns tile row r, all output channels
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* arow = win + ((warp + tap / 3) * WW + tap % 3) * LDI;
      const bf16* wt = ws + tap * C * LDW;
      for (int kk = 0; kk < nct; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, arow + kk * 16, LDI);
#pragma unroll
        for (int j = 0; j < NACC; ++j) {
          if (j < nct) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, wt + kk * 16 * LDW + j * 16, LDW);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the window

    // bf16(conv), + b in bf16, + x in bf16; lane = (pixel, 8-channel half)
    const int y = y0 + warp, p = lane / 2, half = lane % 2;
    const int xx = x0 + p;
    const bool inside = y < H && xx < W;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if (j < nct) {
        wmma::store_matrix_sync(stage, acc[j], SLD, wmma::mem_row_major);
        __syncwarp();
        if (inside) {
          const int ch = j * 16 + half * 8;
          const size_t off = (((size_t)b * H + y) * W + xx) * C + ch;
          const uint4 xv = *reinterpret_cast<const uint4*>(a.x + off);
          const uint4 bv = *reinterpret_cast<const uint4*>(a.b + ch);
          const bf16* xe = reinterpret_cast<const bf16*>(&xv);
          const bf16* be = reinterpret_cast<const bf16*>(&bv);
          uint4 ov;
          bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float v = round_bf16(stage[p * SLD + half * 8 + e]);
            v = round_bf16(v + __bfloat162float(be[e]));
            oe[e] = __float2bfloat16(v + __bfloat162float(xe[e]));
          }
          *reinterpret_cast<uint4*>(a.out + off) = ov;
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// Shared memory of one block at width C.
extern "C" int m2t_ff_conv_smem(int C) { return (int)smem_bytes(C); }

extern "C" int m2t_ff_conv(const void* oc, const void* x, const void* w,
                           const void* b, void* out, int B, int H, int W,
                           int C, void* stream) {
  if (C % 16 != 0 || C / 16 > NACC) return (int)cudaErrorInvalidValue;
  FfArgs a;
  a.oc = static_cast<const bf16*>(oc);
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const bf16*>(b);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.W = W; a.C = C;
  a.tiles_h = (H + TH - 1) / TH;
  a.tiles_w = (W + TW - 1) / TW;
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      ff_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (long long)B * a.tiles_h * a.tiles_w;
  const int grid = (int)(ntiles < 2LL * sms ? ntiles : 2LL * sms);
  ff_conv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
