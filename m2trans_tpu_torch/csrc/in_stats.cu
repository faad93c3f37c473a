// The instance-norm statistics of a CFTM's input, as K1's per-branch
// affine, for sm_90a.
//
// Replaces no TPU kernel: the JAX package takes these statistics in plain
// XLA (m2trans_tpu/models/m2trans.py, _cftm_apply_fused: a cast to f32, two
// means, rsqrt). In plain torch that was about 24 launches a CFTM (a 4-byte
// copy of the map, its square, two reductions with only B x C outputs, the
// affine's small ops, per-branch slices and halvings), 1.4 ms of the 9.4 ms
// of device a 512^2 x4 request takes on an H100.
//
//   x: (B, H, W, C) contiguous NHWC bf16, C = 4 * cb
//   mean = E[x], var = E[x^2] - E[x]^2 (biased), over H, W, in f32
//   st[0, k, b, :] = h_k * rsqrt(var + eps), st[1, k, b, :] = h_k * -mean * rsqrt(var + eps)
//
// over branch k's channels [k*cb, (k+1)*cb), with h_0 = 1 and h_k = 0.5 for
// k > 0: the cascade's halving (models/m2trans.py's docstring), a power of
// two, so it rounds nothing. Each st[i, k] is a contiguous (B, cb) f32 block
// that K1's wrapper takes as it stands.
//
// What bounds it on the card: bytes, one read of x (33.5 MB a block at
// 512^2, 10 us at 3.35 TB/s); the partials are 0.1% of that. Design, two
// launches:
//   (1) in_stats_sum_kernel: a CTA an (image, chunk of pixels); a thread
//       keeps one 16-byte vector (8 channels) of every ppi-th pixel and
//       sums x and x^2 of its 8 channels in f32 registers, four loads in
//       flight; the CTA's rows are then summed in shared memory in a fixed
//       order and written as the chunk's partial. Chunks are sized so that
//       about four CTAs an SM read at once, from the shape alone.
//   (2) in_stats_finish_kernel: a CTA 16 channels of one image; 32 lanes
//       a column sum the chunks' partials in a fixed order, a fixed tree
//       joins the lanes, and 16 threads write s and t.
// No atomics: two runs give the same bits. Nothing is allocated here: the
// wrapper gives the partials' buffer, (B, nchunk, 2, C) f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace m2t_in {

constexpr int THREADS = 256;     // of a sum CTA
constexpr int UNROLL = 4;        // 16-byte loads in flight a thread
constexpr int TARGET_CTAS = 528; // 4 a SM of 132, whatever the card
constexpr int MIN_ROUNDS = 8;    // rows of vectors a sum CTA reads at least
constexpr int MAX_C = 2048;      // the rows' sums fill 16 KB of shared memory
constexpr int FIN_COLS = 32;     // 16 channels x (sum, sum of squares)
constexpr int FIN_LANES = 32;

struct Shape {
  int vecs;       // 16-byte vectors a pixel, C / 8
  int ppi;        // pixels a sum CTA reads a round
  int nchunk;     // chunks an image
  long long px;   // pixels a chunk
};

inline Shape shape_of(int B, long long hw, int C) {
  Shape s;
  s.vecs = C / 8;
  s.ppi = s.vecs >= THREADS ? 1 : THREADS / s.vecs;
  const long long min_px = (long long)MIN_ROUNDS * s.ppi;
  long long want = (TARGET_CTAS + B - 1) / B;
  const long long most = (hw + min_px - 1) / min_px;
  if (want > most) want = most;
  if (want < 1) want = 1;
  s.px = (hw + want - 1) / want;
  s.px = (s.px + s.ppi - 1) / s.ppi * s.ppi;  // whole rounds
  s.nchunk = (int)((hw + s.px - 1) / s.px);
  return s;
}

__device__ __forceinline__ void add_vec(const uint4& r, float* s, float* q) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of its f32; the lower address is the low half
    const float lo = __uint_as_float(w[i] << 16);
    const float hi = __uint_as_float(w[i] & 0xffff0000u);
    s[2 * i] += lo;
    q[2 * i] = fmaf(lo, lo, q[2 * i]);
    s[2 * i + 1] += hi;
    q[2 * i + 1] = fmaf(hi, hi, q[2 * i + 1]);
  }
}

// grid (nchunk, B), block vecs * ppi threads; part: (B, nchunk, 2, C)
__global__ void __launch_bounds__(THREADS)
in_stats_sum_kernel(const uint4* __restrict__ x, float* __restrict__ part,
                    long long hw, int vecs, int ppi, long long px) {
  __shared__ __align__(16) float red[2][8 * THREADS];  // [sum | sq][row][C]
  const int b = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x;
  const int C = vecs * 8;
  const int v = threadIdx.x % vecs, row = threadIdx.x / vecs;
  const long long p1 = min(hw, (long long)(chunk + 1) * px);
  const uint4* xb = x + (long long)b * hw * vecs + v;
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
  long long p = (long long)chunk * px + row;
  for (; p + (UNROLL - 1) * (long long)ppi < p1; p += UNROLL * (long long)ppi) {
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = __ldg(xb + (p + (long long)u * ppi) * vecs);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_vec(r[u], s, q);
  }
  for (; p < p1; p += ppi) add_vec(__ldg(xb + p * vecs), s, q);

  float4* rs = reinterpret_cast<float4*>(&red[0][row * C + v * 8]);
  float4* rq = reinterpret_cast<float4*>(&red[1][row * C + v * 8]);
  rs[0] = make_float4(s[0], s[1], s[2], s[3]);
  rs[1] = make_float4(s[4], s[5], s[6], s[7]);
  rq[0] = make_float4(q[0], q[1], q[2], q[3]);
  rq[1] = make_float4(q[4], q[5], q[6], q[7]);
  __syncthreads();
  // column (which, c): the ppi rows in four strided sums, then a fixed tree
  float* out = part + ((long long)b * nchunk + chunk) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    const float* col = &red[i / C][i % C];
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < ppi; ++r) a[r & 3] += col[r * C];
    out[i] = (a[0] + a[1]) + (a[2] + a[3]);
  }
}

// grid (C / 16, B), block (FIN_COLS, FIN_LANES); st: (2, 4, B, cb)
__global__ void __launch_bounds__(FIN_COLS * FIN_LANES)
in_stats_finish_kernel(const float* __restrict__ part, float* __restrict__ st,
                       int B, int C, int nchunk, float inv_n, float eps) {
  __shared__ float red[FIN_LANES][FIN_COLS + 1];
  __shared__ float tot[FIN_COLS];
  const int b = blockIdx.y, c0 = blockIdx.x * 16;
  const int col = threadIdx.x, lane = threadIdx.y;
  const int which = col / 16, c = c0 + col % 16;
  const float* p = part + (long long)b * nchunk * 2 * C + which * C + c;
  float a = 0.f;
#pragma unroll 4
  for (int k = lane; k < nchunk; k += FIN_LANES) a += p[(long long)k * 2 * C];
  red[lane][col] = a;
  __syncthreads();
  if (lane == 0) {
    float r[FIN_LANES];
#pragma unroll
    for (int l = 0; l < FIN_LANES; ++l) r[l] = red[l][col];
#pragma unroll
    for (int w = FIN_LANES / 2; w >= 1; w /= 2)
#pragma unroll
      for (int l = 0; l < w; ++l) r[l] = r[l] + r[l + w];
    tot[col] = r[0];
  }
  __syncthreads();
  if (lane == 0 && col < 16) {
    const float mean = tot[col] * inv_n;
    const float var = tot[16 + col] * inv_n - mean * mean;
    const float inv = rsqrtf(var + eps);
    const int cb = C / 4, k = c / cb, cc = c % cb;
    const float h = k == 0 ? 1.f : 0.5f;
    const long long o = ((long long)k * B + b) * cb + cc;
    st[o] = inv * h;
    st[(long long)4 * B * cb + o] = (-mean * inv) * h;
  }
}

}  // namespace m2t_in

// Floats of the partials' buffer the wrapper allocates, B * nchunk * 2 * C
// (under 2^31: B * nchunk is at most TARGET_CTAS + B), or -1.
extern "C" int m2t_in_stats_part_floats(int B, long long hw, int C) {
  if (B <= 0 || B > 65535 || hw <= 0 || C <= 0 || C % 32 != 0 || C > m2t_in::MAX_C)
    return -1;
  const m2t_in::Shape s = m2t_in::shape_of(B, hw, C);
  return B * s.nchunk * 2 * C;
}

// Two launches on `stream`: the chunks' sums into `part`, then s and t into
// `st`. x: (B, hw, C) bf16, 16-byte aligned.
extern "C" int m2t_in_stats(const void* x, void* part, void* st, int B,
                            long long hw, int C, float eps, void* stream) {
  using namespace m2t_in;
  if (B <= 0 || hw <= 0 || C <= 0 || C % 32 != 0 || C > MAX_C ||
      B > 65535 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Shape s = shape_of(B, hw, C);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  in_stats_sum_kernel<<<dim3(s.nchunk, B), s.vecs * s.ppi, 0, cs>>>(
      static_cast<const uint4*>(x), static_cast<float*>(part), hw, s.vecs, s.ppi,
      s.px);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  in_stats_finish_kernel<<<dim3(C / 16, B), dim3(FIN_COLS, FIN_LANES), 0, cs>>>(
      static_cast<const float*>(part), static_cast<float*>(st), B, C, s.nchunk,
      1.f / (float)hw, eps);
  return (int)cudaGetLastError();
}
