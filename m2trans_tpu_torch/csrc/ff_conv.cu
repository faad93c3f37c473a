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
// of memory time against 5.5 us of tensor-core time.
//
// Design: a persistent grid of one block per SM. A block copies the
// 9*C*C weight into shared memory once, asynchronously (cp.async), beside
// the copies of its first input windows, and then walks over 8x16-pixel
// output tiles. Its warps form up to four groups of four, and its 10x18xC
// input windows a ring of as many shared-memory buffers filled by cp.async,
// whose zero-fill form writes the zeros beyond the frame: tile n of the
// block goes to buffer n mod G and is worked by group n mod G, which
// synchronises on a named barrier of its own 128 threads, so that the
// windows of tiles n+1.. are in flight, and tile n-1 is stored, while
// tile n multiplies; all groups share the one weight. (G = 4 up to
// C = 64; at C = 80 three buffers fit beside the weight, at C = 96 one.)
// The nine taps are nine shifted (128 x C)*(C x C) products on
// mma.sync.m16n8k16, operands loaded with ldmatrix from rows pitched C+8
// elements (16-byte aligned and free of bank conflicts; WMMA's 32-byte
// rule forced C+16). A warp owns two tile rows and all output channels,
// so each weight fragment it loads feeds two rows' products and each
// window fragment C/8 products: 6 ldmatrix per 16 products at C = 64.
// The epilogue rounds the accumulators to bf16 into the consumed window
// buffer, then adds b and x and stores out as 16-byte vectors, x loaded
// four vectors ahead.
//
// mma.sync with ldmatrix and not wgmma: a wgmma operand in shared memory
// is described by one stride per 8 rows, and a 16-pixel tile row inside
// an 18-pixel window row has no such stride across tile rows; the
// ablation (PERF.md) shows what the time goes to instead.

#include "mma_ptx.cuh"

// Timing ablations (tools/kernel_ablation.py builds them; results are
// wrong by design): bit 0 drops the products, bit 1 the window copies,
// bit 2 the x loads and the out stores.
#ifndef M2T_FF_ABLATE
#define M2T_FF_ABLATE 0
#endif

namespace {

using namespace m2t_ptx;
typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 16;          // output tile, rows x columns
constexpr int WH = TH + 2, WW = TW + 2; // input window
constexpr int GT = 128;                 // threads of a group: 4 warps x 2 rows
constexpr int MAXG = 4;                 // most groups of a block
constexpr int MAX_NCT = 6;              // 16-channel groups: C <= 96
constexpr int MAX_SMEM = 232448;

// Rows of the window, of the weight and of the staged tile are pitched C + 8
// elements: 16-byte aligned, and 8 consecutive rows fall on different banks.
__host__ __device__ inline int ld_s(int C) { return C + 8; }
__host__ __device__ inline int weight_bytes(int C) { return 9 * C * ld_s(C) * 2; }
__host__ __device__ inline int window_bytes(int C) { return WH * WW * ld_s(C) * 2; }
// Groups (= window buffers) of a block: what fits beside the weight, and
// keeps the accumulators within the registers of 128 * groups threads.
__host__ __device__ inline int groups_of(int C) {
  const int fit = (MAX_SMEM - weight_bytes(C)) / window_bytes(C);
  const int regs = C <= 64 ? MAXG : C <= 80 ? 3 : 1;
  return fit < regs ? fit : regs;
}
__host__ __device__ inline int smem_bytes(int C) {
  return weight_bytes(C) + groups_of(C) * window_bytes(C);
}

struct FfArgs {
  const bf16* oc;
  const bf16* x;
  const bf16* w;  // (3, 3, C, C), input channel major
  const bf16* b;
  bf16* out;
  int B, H, W, C;
  int tiles_h, tiles_w, groups;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(GT) : "memory");
}

// The 10x18xC window of the tile at (b, y0, x0) -> shared memory at dst,
// zeros beyond the frame; by the 128 threads of a group.
__device__ __forceinline__ void load_window(const FfArgs& a, int b, int y0,
                                            int x0, uint32_t dst, int gtid) {
  const int C = a.C, cv = C / 8, LD = ld_s(C);
  if (M2T_FF_ABLATE & 2) return;
  for (int i = gtid; i < WH * WW * cv; i += GT) {
    const int p = i / cv, v = i % cv;
    const int y = y0 - 1 + p / WW, xx = x0 - 1 + p % WW;
    const bool ok = y >= 0 && y < a.H && xx >= 0 && xx < a.W;
    const bf16* src =
        ok ? a.oc + (((size_t)b * a.H + y) * a.W + xx) * C + v * 8 : a.oc;
    cp_async16(dst + (p * LD + v * 8) * 2, src, ok ? 16 : 0);
  }
}

template <int NCT>  // C / 16
__global__ void __launch_bounds__(NCT <= 4 ? 512 : NCT == 5 ? 384 : 128, 1)
ff_conv_kernel(FfArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int C = NCT * 16, LD = C + 8, cv = C / 8;
  const int H = a.H, W = a.W;
  const int tid = threadIdx.x, grp = tid / GT, gtid = tid % GT;
  const int warp = gtid / 32, lane = tid % 32;
  const uint32_t ws = smem_u32(smem);
  const int woff = weight_bytes(C) + grp * window_bytes(C);
  const uint32_t wbuf = ws + woff;
  bf16* stg = reinterpret_cast<bf16*>(smem + woff);
  const int per_img = a.tiles_h * a.tiles_w;
  const int ntiles = a.B * per_img;
  const int stride = a.groups * gridDim.x;

  // the weight, once per block, beside each group's first window
  for (int i = tid; i < 9 * C * cv; i += blockDim.x) {
    const int row = i / cv, v = i % cv;
    cp_async16(ws + (row * LD + v * 8) * 2, a.w + (size_t)row * C + v * 8, 16);
  }
  int tile = grp * gridDim.x + blockIdx.x;
  if (tile < ntiles) {
    const int rem = tile % per_img;
    load_window(a, tile / per_img, (rem / a.tiles_w) * TH,
                (rem % a.tiles_w) * TW, wbuf, gtid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the only block-wide barrier: the weight has landed

  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  const int g = lane / 4, t = lane % 4;

  for (bool first = true; tile < ntiles; tile += stride, first = false) {
    const int b = tile / per_img, rem = tile % per_img;
    const int y0 = (rem / a.tiles_w) * TH, x0 = (rem % a.tiles_w) * TW;
    if (!first) {
      load_window(a, b, y0, x0, wbuf, gtid);
      cp_async_commit();
      cp_async_wait<0>();
      group_sync(grp);
    }

    // nine shifted products; this warp: tile rows 2*warp, 2*warp + 1
    float acc[2][NCT][2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < NCT; ++j)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][nt][e] = 0.f;
    for (int tap = 0; tap < ((M2T_FF_ABLATE & 1) ? 0 : 9); ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint32_t arow =
          wbuf + (((2 * warp + dy) * WW + dx + lrow) * LD + lcol) * 2;
      const uint32_t wrow = ws + ((tap * C + lrow) * LD + lcol) * 2;
#pragma unroll
      for (int kk = 0; kk < NCT; ++kk) {
        uint32_t fa[2][4];
        ldmatrix_x4(fa[0], arow + kk * 32);
        ldmatrix_x4(fa[1], arow + (WW * LD + kk * 16) * 2);
#pragma unroll
        for (int j = 0; j < NCT; ++j) {
          uint32_t fb[4];
          ldmatrix_x4_trans(fb, wrow + (kk * 16 * LD + j * 16) * 2);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mma_bf16(acc[r][j][0], fa[r], fb[0], fb[1]);
            mma_bf16(acc[r][j][1], fa[r], fb[2], fb[3]);
          }
        }
      }
    }
    group_sync(grp);  // every warp of the group is done with the window

    // bf16(conv) of the 128 pixels into the window's space, [pixel][C + 8]
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < NCT; ++j)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int ch = j * 16 + nt * 8 + 2 * t;
          const int p = (2 * warp + r) * TW + g;
          *reinterpret_cast<uint32_t*>(stg + p * LD + ch) =
              pack_bf16(acc[r][j][nt][0], acc[r][j][nt][1]);
          *reinterpret_cast<uint32_t*>(stg + (p + 8) * LD + ch) =
              pack_bf16(acc[r][j][nt][2], acc[r][j][nt][3]);
        }
    group_sync(grp);

    // + b in bf16, + x in bf16; one 8-channel vector per item, x loaded
    // four items ahead
    constexpr int ITEMS = TH * TW * cv / GT;  // 2 * NCT
    static_assert(ITEMS % 2 == 0, "items go in batches");
    constexpr int BATCH = ITEMS % 4 == 0 ? 4 : 2;
#pragma unroll
    for (int k0 = 0; k0 < ITEMS; k0 += BATCH) {
      uint4 xr[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int item = gtid + (k0 + k) * GT;
        const int p = item / cv, v = item % cv;
        const int y = y0 + p / TW, xx = x0 + p % TW;
        xr[k] = make_uint4(0u, 0u, 0u, 0u);
        if (y < H && xx < W && !(M2T_FF_ABLATE & 4))
          xr[k] = __ldg(reinterpret_cast<const uint4*>(
              a.x + (((size_t)b * H + y) * W + xx) * C + v * 8));
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int item = gtid + (k0 + k) * GT;
        const int p = item / cv, v = item % cv;
        const int y = y0 + p / TW, xx = x0 + p % TW;
        if (y < H && xx < W) {
          const uint4 cvv = *reinterpret_cast<const uint4*>(stg + p * LD + v * 8);
          const uint4 bv = __ldg(reinterpret_cast<const uint4*>(a.b + v * 8));
          const bf16* ce = reinterpret_cast<const bf16*>(&cvv);
          const bf16* be = reinterpret_cast<const bf16*>(&bv);
          const bf16* xe = reinterpret_cast<const bf16*>(&xr[k]);
          uint4 ov;
          bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float v1 =
                round_bf16(__bfloat162float(ce[e]) + __bfloat162float(be[e]));
            oe[e] = __float2bfloat16(v1 + __bfloat162float(xe[e]));
          }
          if (!(M2T_FF_ABLATE & 4) || ov.x == 0x7fc17fc2u)
            *reinterpret_cast<uint4*>(
                a.out + (((size_t)b * H + y) * W + xx) * C + v * 8) = ov;
        }
      }
    }
    group_sync(grp);  // the staged tile is read; its space takes a window
  }
}

template <int NCT>
cudaError_t launch(const FfArgs& a, int grid, cudaStream_t stream) {
  const int smem = smem_bytes(a.C);
  cudaError_t err = cudaFuncSetAttribute(
      ff_conv_kernel<NCT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ff_conv_kernel<NCT><<<grid, GT * a.groups, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block at width C.
extern "C" int m2t_ff_conv_smem(int C) { return smem_bytes(C); }

extern "C" int m2t_ff_conv(const void* oc, const void* x, const void* w,
                           const void* b, void* out, int B, int H, int W,
                           int C, void* stream) {
  if (C % 16 != 0 || C / 16 > MAX_NCT || C < 16) return (int)cudaErrorInvalidValue;
  FfArgs a;
  a.oc = static_cast<const bf16*>(oc);
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const bf16*>(b);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.W = W; a.C = C;
  a.tiles_h = (H + TH - 1) / TH;
  a.tiles_w = (W + TW - 1) / TW;
  a.groups = groups_of(C);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (long long)B * a.tiles_h * a.tiles_w;
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C / 16) {
    case 1: return (int)launch<1>(a, grid, st);
    case 2: return (int)launch<2>(a, grid, st);
    case 3: return (int)launch<3>(a, grid, st);
    case 4: return (int)launch<4>(a, grid, st);
    case 5: return (int)launch<5>(a, grid, st);
    default: return (int)launch<6>(a, grid, st);
  }
}
