// SS2D's four-way selective scan (MambaIR, Guo et al., ECCV 2024,
// basicsr/archs/mambair_arch.py, SS2D.forward_core with mamba_ssm's
// selective_scan_fn), forward only, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no MambaIR. In plain torch the
// scan needs the (B, 4, D, L) cross-scan copies (425 MB in f32 a tensor at
// 8 x 96^2 and D = 360) and a loop over the L = 9,216 tokens; no kernel of
// the port computes a long linear recurrence.
//
// What it computes, for x (B, H, W, D) bf16 and xdbl (B, H, W, 4, R + 2N)
// bf16 (each token's x_proj for every direction k: dt_k (R), B_k (N), C_k
// (N)), N = 16, R a multiple of 4 up to 16, with the f32 tables dtw
// (4, D, R), dtb (4, D), A (4, D, N) (negative: -exp(A_log)) and Ds (4, D):
//
//   direction k scans the tokens in order k: 0 row-major, 1 column-major
//   (position w_ * H + h_ is pixel (h_, w_)), 2 and 3 the same reversed;
//   delta = softplus(dtw[k, d] . dt_k + dtb[k, d]) (threshold 20),
//   h[d, n] = exp2(delta * A[k, d, n] * log2 e) * h[d, n] + delta x[d] B_k[n],
//   y_k[d] = sum_n C_k[n] h[d, n] + Ds[k, d] x[d],
//
// the state in f32 from 0, and writes y (B, H, W, D) bf16, rounded once
// from the f32 sum (y_0 + y_2) + (y_1 + y_3) at each pixel. The orders are
// index arithmetic: no transposed or flipped copy of anything exists.
//
// What bounds it: the FP32 work. At 8 x 96^2, D = 360 a launch makes
// 8 * 4 * 360 * 16 * 9,216 = 1.70 G state updates (36 launches a MambaIR
// x4 request: 61 G); at 6 FP32 operations an update and 67 TFLOP/s, 0.152
// ms; its operands (x, xdbl, y) are 132 MB, 0.039 ms at 3.35 TB/s. Each
// update also takes one exponential, here on the special-function units
// (16 a clock an SM: 0.40 ms a launch at 1.98 GHz), and the update's own
// instructions (two multiplies, two FMAs, the exponential) leave the issue
// slots little room for the loads, the reduction over the states and
// delta's projection. Measured (H100 SXM, 700 W): 1.42 ms a launch, 10.7%
// of the bound. Parts compiled out one at a time: the recurrence costs 0.66
// ms, of which the butterfly over the lanes 0.28 and the exponentials 0.05;
// delta's softplus 0.1, the copies 0.12, the stores of the planes 0.09, their
// sum into y 0.1; the rest, 0.27 ms, is delta's projection, the barriers
// and the tile bookkeeping. The issue slots and the phases' latency, not the
// exponentials, set the rate.
//
// Design. A cluster of four CTAs owns (image b, 24 channels); CTA k of it
// scans direction k. A CTA is 6 warps; a warp 4 channels x 8 lanes, each
// lane two of the 16 states of its channel, so the sum over n is a
// reduction over 8 lanes. Tokens go in tiles of 64 positions of the order:
//   (0) a table of the next tiles' pixels, and cp.async copies of the
//       next tile's x (the CTA's 24 channels) and xdbl (direction k's
//       R + 2N) rows into one of two raw bf16 stages, in flight while this
//       tile computes;
//   (1) x and dt of the landed stage to f32 in shared memory (B_k and C_k
//       stay bf16: each lane reads its two of each as one 32-bit word);
//   (2) delta and delta x: each lane one position in eight (the dt
//       projection from registers, four positions at a time; softplus
//       through the hardware exp2 / log2);
//   (3) the recurrence, position by position in 8-position groups: two
//       exp2 (ex2.approx), multiplies and FMAs a lane and position; after
//       a group a transposing butterfly over the 8 lanes (7 shuffles) leaves
//       lane g the full sum of position g, which adds Ds x in place of x;
//   (4) the tile's y, 64 positions x 24 channels, to the CTA's f32 plane of
//       `part` (4, B, H, W, D) with 16-byte stores.
// Then a cluster barrier, after which each CTA of the four sums a quarter
// of the pixels' planes, (part[0] + part[2]) + (part[1] + part[3]), into y.
// No float atomics: two runs give the same bits. Positions past L (the
// last tile) are copied as zeros, get delta = 0 (they leave the state as it
// was) and are not written.
//
// Grid: (D / 24, 4, B) CTAs in clusters of (1, 4, 1); at 8 x 96^2, D = 360,
// 480 CTAs of 192 threads, four to an SM, one wave. Nothing is allocated
// here: the wrapper gives `part`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace m2t_ss2d {

constexpr int K = 4;                 // directions
constexpr int N = 16;                // states a channel
constexpr int LANES = 8;             // lanes a channel
constexpr int SL = N / LANES;        // states a lane
constexpr int CW = 32 / LANES;       // channels a warp
constexpr int CT = 24;               // channels a CTA
constexpr int WARPS = CT / CW;
constexpr int THREADS = WARPS * 32;
constexpr int T = 64;                // positions a tile
constexpr int RMAX = 16;             // dt rank at most
constexpr int RS = RMAX + 4;         // row stride of the staged dt (no bank conflicts)
constexpr int XS = 28;               // row stride of the staged x, then y
constexpr int DDS = T + 1;           // row stride of (delta, delta x)
constexpr int XROW = CT * 2;         // bytes of a position's x
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* __restrict__ x;
  const __nv_bfloat16* __restrict__ xdbl;
  const float* __restrict__ dtw;
  const float* __restrict__ dtb;
  const float* __restrict__ A;
  const float* __restrict__ Ds;
  float* __restrict__ part;
  __nv_bfloat16* __restrict__ y;
  int B, H, W, D;
};

template <int E>
struct Smem {
  uint8_t raw[2][T][XROW + (2 * E + 15) / 16 * 16];  // the copied rows: x, then the projections
  int pix[3][T];                   // pixel of each position of three tiles (-1 past L)
  float dt[T][RS];
  float xs[T][XS];                 // x in f32, then y
  float2 dd[CT][DDS];              // (delta, delta x)
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// softplus with torch's threshold 20; log1p(e) as e (1 - e / 2) below 1e-3,
// where 1 + e would round away most of e
__device__ __forceinline__ float softplus(float v) {
  const float e = __expf(fminf(v, 20.f));
  const float s = e < 1e-3f ? e * (1.f - 0.5f * e) : __logf(1.f + e);
  return v > 20.f ? v : s;
}

// The image's pixel at position s of direction k, or -1 past L.
__device__ __forceinline__ int pixel_of(int s, int k, int H, int W, int L) {
  if (s >= L) return -1;
  const int l = k >= 2 ? L - 1 - s : s;
  if ((k & 1) == 0) return l;
  const int wc = l / H;
  return (l - wc * H) * W + wc;
}

// 8 bytes global -> shared; with bytes = 0 nothing is read and the 8 bytes
// are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

}  // namespace m2t_ss2d

using namespace m2t_ptx;
using namespace m2t_ss2d;

template <int R4>  // R / 4
__global__ void __cluster_dims__(1, K, 1) __launch_bounds__(THREADS, 4)
m2t_ss2d_scan_kernel(Args a) {
  constexpr int R = 4 * R4, E = R + 2 * N, CPR = E / 4;  // projections, 8-byte pieces a position
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cw = lane / LANES, g = lane % LANES;  // channel of the warp, lane of the channel
  const int cl = warp * CW + cw;                 // channel of the CTA
  const int k = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * CT, d = c0 + cl;
  const int H = a.H, W = a.W, D = a.D;
  const int L = H * W;
  const long long img = (long long)b * L;        // first pixel of the image
  const int ntiles = (L + T - 1) / T;

  // this direction's tables for channel d and this lane's states
  float w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = a.dtw[((long long)k * D + d) * R + r];
  const float bias = a.dtb[k * D + d], dk = a.Ds[k * D + d];
  float av[SL], h[SL];
#pragma unroll
  for (int i = 0; i < SL; ++i) {
    av[i] = a.A[((long long)k * D + d) * N + SL * g + i] * LOG2E;
    h[i] = 0.f;
  }

  // (0) copies of a tile into raw stage `st`: x as 16-byte pieces (3 a
  // position), the projections as 8-byte pieces (E / 4 a position)
  auto copy_tile = [&](int tile, int st) {
    const int* pix = sm.pix[tile % 3];
#pragma unroll
    for (int i = tid; i < T * 3; i += THREADS) {
      const int p = i / 3, q = i - 3 * p, px = pix[p];
      const __nv_bfloat16* src = a.x + (img + (px < 0 ? 0 : px)) * D + c0 + 8 * q;
      cp_async16(smem_u32(&sm.raw[st][p][16 * q]), src, px >= 0 ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < T * CPR; i += THREADS) {
      const int p = i / CPR, q = i - CPR * p, px = pix[p];
      const __nv_bfloat16* src = a.xdbl + ((img + (px < 0 ? 0 : px)) * K + k) * E + 4 * q;
      cp_async8(smem_u32(&sm.raw[st][p][XROW + 8 * q]), src, px >= 0 ? 8 : 0);
    }
    cp_async_commit();
  };
  auto fill_pix = [&](int tile) {
    for (int p = tid; p < T; p += THREADS) sm.pix[tile % 3][p] = pixel_of(tile * T + p, k, H, W, L);
  };

  fill_pix(0);
  fill_pix(1);
  __syncthreads();
  copy_tile(0, 0);
  float* plane = a.part + ((long long)k * a.B * L + img) * D + c0;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < ntiles) copy_tile(tile + 1, st ^ 1);  // in flight while this tile computes
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's copies have landed, for every thread
    // (1) the landed stage to f32
#pragma unroll
    for (int i = tid; i < T * 3; i += THREADS) {
      const int p = i / 3, q = i - 3 * p;
      const uint4 v = *reinterpret_cast<const uint4*>(&sm.raw[st][p][16 * q]);
      float4* dst = reinterpret_cast<float4*>(&sm.xs[p][8 * q]);
      dst[0] = make_float4(lo_bf16(v.x), hi_bf16(v.x), lo_bf16(v.y), hi_bf16(v.y));
      dst[1] = make_float4(lo_bf16(v.z), hi_bf16(v.z), lo_bf16(v.w), hi_bf16(v.w));
    }
#pragma unroll
    for (int i = tid; i < T * R4; i += THREADS) {  // dt only: B and C are read as bf16
      const int p = i / R4, q = i - R4 * p, e = 4 * q;
      const uint2 v = *reinterpret_cast<const uint2*>(&sm.raw[st][p][XROW + 8 * q]);
      const float f[4] = {lo_bf16(v.x), hi_bf16(v.x), lo_bf16(v.y), hi_bf16(v.y)};
      if (e < R) *reinterpret_cast<float4*>(&sm.dt[p][e]) = make_float4(f[0], f[1], f[2], f[3]);
    }
    if (tile + 2 < ntiles) fill_pix(tile + 2);
    __syncthreads();
    const int* pix = sm.pix[tile % 3];
    // (2) delta and delta x of positions g, g + LANES, ... for channel d, four at a time
#pragma unroll 1
    for (int i0 = 0; i0 < T / LANES; i0 += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = bias;
#pragma unroll
      for (int r4 = 0; r4 < R4; ++r4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 t = reinterpret_cast<const float4*>(&sm.dt[g + LANES * (i0 + u)][0])[r4];
          v[u] = fmaf(w[4 * r4], t.x, v[u]);
          v[u] = fmaf(w[4 * r4 + 1], t.y, v[u]);
          v[u] = fmaf(w[4 * r4 + 2], t.z, v[u]);
          v[u] = fmaf(w[4 * r4 + 3], t.w, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = g + LANES * (i0 + u);
        const float dlt = pix[p] >= 0 ? softplus(v[u]) : 0.f;
        sm.dd[cl][p] = make_float2(dlt, dlt * sm.xs[p][cl]);
      }
    }
    __syncwarp();  // a channel's deltas are its own warp's
    // (3) the recurrence, LANES positions a group
#pragma unroll 1
    for (int q = 0; q < T; q += LANES) {
      float yv[LANES];
#pragma unroll
      for (int j = 0; j < LANES; ++j) {
        const float2 e = sm.dd[cl][q + j];
        const uint8_t* row = &sm.raw[st][q + j][XROW + 2 * (R + SL * g)];
        const uint32_t bu = *reinterpret_cast<const uint32_t*>(row);
        const uint32_t cu = *reinterpret_cast<const uint32_t*>(row + 2 * N);
        h[0] = fmaf(ex2(e.x * av[0]), h[0], e.y * lo_bf16(bu));
        h[1] = fmaf(ex2(e.x * av[1]), h[1], e.y * hi_bf16(bu));
        yv[j] = fmaf(h[1], hi_bf16(cu), h[0] * lo_bf16(cu));
      }
      // transposing butterfly: lane g ends with the sum over the LANES lanes of position q + g
#pragma unroll
      for (int m = LANES / 2; m >= 1; m /= 2) {
        const bool up = g & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float send = up ? yv[i] : yv[i + m], keep = up ? yv[i + m] : yv[i];
          yv[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
      sm.xs[q + g][cl] = fmaf(dk, sm.xs[q + g][cl], yv[0]);  // y in place of x
    }
    __syncthreads();
    // (4) the tile's y to this direction's plane
    for (int i = tid; i < T * (CT / 4); i += THREADS) {
      const int p = i / (CT / 4), v = i - (CT / 4) * p, px = pix[p];
      if (px >= 0)
        *reinterpret_cast<float4*>(plane + (long long)px * D + 4 * v) =
            *reinterpret_cast<const float4*>(&sm.xs[p][4 * v]);
    }
  }

  // every direction's plane is written: y = (y_0 + y_2) + (y_1 + y_3), a quarter of the pixels each
  __threadfence();
  cluster_arrive();
  cluster_wait();
  const long long pl = (long long)a.B * L * D;  // floats a plane
  const float* p0 = a.part + img * D + c0;
  __nv_bfloat16* yo = a.y + img * D + c0;
  const int quarter = (L + K - 1) / K, lo = k * quarter, hi = min(L, lo + quarter);
  const int n = (hi - lo) * (CT / 4);  // float4 of the CTA's pixels
#pragma unroll 4
  for (int i = tid; i < n; i += THREADS) {
    const int px = lo + i / (CT / 4), v = i - (i / (CT / 4)) * (CT / 4);
    const float* src = p0 + (long long)px * D + 4 * v;
    const float4 s0 = *reinterpret_cast<const float4*>(src);
    const float4 s1 = *reinterpret_cast<const float4*>(src + pl);
    const float4 s2 = *reinterpret_cast<const float4*>(src + 2 * pl);
    const float4 s3 = *reinterpret_cast<const float4*>(src + 3 * pl);
    uint2 out;
    out.x = pack_bf16((s0.x + s2.x) + (s1.x + s3.x), (s0.y + s2.y) + (s1.y + s3.y));
    out.y = pack_bf16((s0.z + s2.z) + (s1.z + s3.z), (s0.w + s2.w) + (s1.w + s3.w));
    *reinterpret_cast<uint2*>(yo + (long long)px * D + 4 * v) = out;
  }
}

template <int R4>
static int launch(const Args& a, void* stream) {
  const int smem = (int)sizeof(Smem<4 * R4 + 2 * N>);
  cudaError_t e = cudaFuncSetAttribute(m2t_ss2d_scan_kernel<R4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  m2t_ss2d_scan_kernel<R4><<<dim3(a.D / CT, K, a.B), THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// One launch on `stream`: the whole four-direction scan of x into y.
// part: (4, B, H, W, D) f32 scratch. D a multiple of 24, R a multiple of 4
// from 4 to 16.
extern "C" int m2t_ss2d_scan(const void* x, const void* xdbl, const void* dtw,
                             const void* dtb, const void* A, const void* Ds,
                             void* part, void* y, int B, int H, int W, int D,
                             int R, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || D <= 0 || D % CT != 0 || R < 4 ||
      R > RMAX || R % 4 != 0 || (long long)H * W >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(xdbl) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(part) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(xdbl),
         static_cast<const float*>(dtw), static_cast<const float*>(dtb),
         static_cast<const float*>(A), static_cast<const float*>(Ds),
         static_cast<float*>(part), static_cast<__nv_bfloat16*>(y), B, H, W, D};
  switch (R / 4) {
    case 1: return launch<1>(a, stream);
    case 2: return launch<2>(a, stream);
    case 3: return launch<3>(a, stream);
    default: return launch<4>(a, stream);
  }
}
