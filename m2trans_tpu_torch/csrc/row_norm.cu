// LayerNorm over the channels of bf16 NHWC rows, for sm_90a, in three forms
// that take in the elementwise pass before or after it (HAT's and MambaIR's
// served forward, models/sr_blocks.py::layer_norm).
//
// Replaces no TPU kernel: the JAX package has neither HAT nor MambaIR. It
// was added because torch's LayerNorm (vectorized_layer_norm_kernel) moved
// its 26.5-53 MB a call at ~0.5 TB/s of the H100's 3.35 and took 9-12 ms of
// every 8 x 96^2 request of both models, and the residual sums and the gate
// around it were passes of their own over the same rows.
//
//   plain:     out = LN(x)
//   residual:  x' = rnd(rnd(a * s) + b) (s optional, per channel), out = LN(x')
//              x' and out both written: x' is the next residual
//   gated:     out = rnd(rnd(LN(y)) * rnd(SiLU(z)))
//
// LN(x) = gamma * (rstd * (x - mean)) + beta with mean and rstd =
// rsqrt(var + eps) (biased variance) in f32 and the result rounded to bf16;
// SiLU(z) = z / (1 + exp(-z)) in f32. rnd is the round to bf16 (nearest,
// even) at exactly the places where the plain torch composition
// (ops/kernels/row_norm.py::row_norm_plain) rounds, so x' is that
// composition's bits and out differs from it only through the order of the
// statistics' sums.
//
// What bounds it on the card: bytes. Each row is read once (two or three
// maps in the residual and gated forms) and written once (twice in the
// residual form); gamma, beta and s are a few hundred bytes that the L1
// keeps. At 8 x 96^2 x 180 the plain form moves 53 MB, 15.8 us at 3.35
// TB/s. What it must not be is bound by issue: this kernel's first designs
// spent ~500 instructions a lane on two rows of 180 (picking each vector's
// row, divisions, a full warp's shuffles for every row) and took as long
// with the rows in the L2 as from HBM. Design: a row
// belongs to an aligned group of `lanes` lanes (16 at C = 180, 32 at 360),
// each lane VPL 8-byte vectors of it (a row of 180 bf16 is 360 B, 8- but
// not 16-byte aligned), so a row's sums are log2(lanes) xor shuffles and
// no lane selects among rows. A warp walks steps of 32 / lanes rows, every
// (warps of the grid)-th step, the grid being as many CTAs of four warps as
// are resident at once; it keeps STAGES - 1 steps ahead in flight as
// cp.async copies into its own ring in shared memory, which hold no
// registers while they wait. Each row is read into registers once: its
// sum, the mean, the centred squares' sum, then the write. No atomics: two
// runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace m2t_rn {

constexpr int WARPS = 4;       // of a CTA
constexpr int STAGES = 3;      // a warp's ring of steps: STAGES - 1 in flight
constexpr int VPL = 3;         // 8-byte vectors a lane
constexpr int MAX_C = 32 * VPL * 4;

enum Form { PLAIN = 0, RESIDUAL = 1, SCALED = 2, GATED = 3 };

struct Args {
  const uint2* x;      // the norm's input; a in the residual forms
  const uint2* other;  // b in the residual forms, z in the gated one
  const uint2* scale;  // s (C,), the scaled residual form only
  const uint2* gamma;  // (C,)
  const uint2* beta;   // (C,)
  uint2* xout;         // x' in the residual forms
  uint2* out;
  long long rows;
  int vpr;             // 8-byte vectors a row, C / 4
  int lanes;           // lanes a row, a power of two with lanes * VPL >= vpr
  float inv_c, eps;
};

__device__ __forceinline__ void unpack(const uint2 v, float f[4]) {
  // a bf16 is the high half of its f32; the lower address is the low half
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ uint2 pack(const float f[4]) {
  return make_uint2(m2t_ptx::pack_bf16(f[0], f[1]), m2t_ptx::pack_bf16(f[2], f[3]));
}

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the sum over a row's lanes (aligned groups of `lanes`), the same bits in
// each of them
__device__ __forceinline__ float row_sum(float v, int lanes) {
  for (int o = lanes / 2; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid: the CTAs resident at once, at most one a WARPS steps; block WARPS *
// 32; dynamic shared memory ring_bytes. A step is 32 / lanes consecutive
// rows, one to each group of `lanes` lanes. A warp walks the steps w, w +
// (warps of the grid), ... through a ring of STAGES slots in shared memory:
// each lane copies its own vectors of the step STAGES - 1 ahead with
// cp.async (8 bytes a copy), waits for the oldest, reads its vectors back
// and computes. A lane reads only what it copied itself, so no barrier is
// needed, and the copies hold no registers while they are in flight.
template <int FORM>
__global__ void __launch_bounds__(WARPS * 32) row_norm_kernel(const Args a) {
  constexpr int OPS = FORM == PLAIN ? 1 : 2;
  extern __shared__ __align__(16) uint2 ring_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  uint2* const ring = ring_all + (size_t)warp * STAGES * OPS * VPL * 32;
  const int per_step = 32 / a.lanes;
  const long long steps = (a.rows + per_step - 1) / per_step;
  const long long stride = (long long)gridDim.x * WARPS;
  const long long first = (long long)blockIdx.x * WARPS + warp;
  if (first >= steps) return;

  // a lane's row of the step and its vectors of the row: lane % lanes + lanes * k
  const int rin = lane / a.lanes;
  bool has[VPL];
  int col[VPL];
  uint2 rg[VPL], rbeta[VPL], rs[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    col[k] = lane % a.lanes + a.lanes * k;
    has[k] = col[k] < a.vpr;
    if (has[k]) {
      rg[k] = __ldg(a.gamma + col[k]);
      rbeta[k] = __ldg(a.beta + col[k]);
      if (FORM == SCALED) rs[k] = __ldg(a.scale + col[k]);
    }
  }
  auto slot = [&](int stage, int op, int k) {
    return ring + ((stage * OPS + op) * VPL + k) * 32 + lane;
  };
  auto issue = [&](long long step, int stage) {  // one commit group, empty past the end
    const long long row = step * per_step + rin;
    if (step < steps && row < a.rows) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        if (!has[k]) continue;
        const long long i = row * a.vpr + col[k];
        m2t_ptx::cp_async8(m2t_ptx::smem_u32(slot(stage, 0, k)), a.x + i);
        if (OPS == 2) m2t_ptx::cp_async8(m2t_ptx::smem_u32(slot(stage, 1, k)), a.other + i);
      }
    }
    m2t_ptx::cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(first + s * stride, s);
  int stage = 0;
  for (long long step = first; step < steps; step += stride) {
    // the slot refilled here held the step before this one, read back already
    issue(step + (STAGES - 1) * stride, (stage + STAGES - 1) % STAGES);
    m2t_ptx::cp_async_wait<STAGES - 1>();

    // a row past the end (the last step) computes on zeros and writes nothing
    const long long row = step * per_step + rin;
    const bool live = row < a.rows;
    uint2 ro[VPL];
    float v[VPL][4];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const bool ok = has[k] && live;
      unpack(ok ? *slot(stage, 0, k) : make_uint2(0u, 0u), v[k]);
      if (OPS == 2) ro[k] = ok ? *slot(stage, 1, k) : make_uint2(0u, 0u);
      if (FORM == RESIDUAL || FORM == SCALED) {
        float b[4];
        unpack(ro[k], b);
        if (FORM == SCALED) {
          float sc[4];
          unpack(has[k] ? rs[k] : make_uint2(0u, 0u), sc);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[k][j] = rnd(v[k][j] * sc[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k][j] = rnd(v[k][j] + b[j]);
        if (ok) a.xout[row * a.vpr + col[k]] = pack(v[k]);
      }
      sum += (v[k][0] + v[k][1]) + (v[k][2] + v[k][3]);
    }
    const float mean = row_sum(sum, a.lanes) * a.inv_c;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (!has[k]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = v[k][j] - mean;
        sq = fmaf(d, d, sq);
      }
    }
    const float rstd = rsqrtf(row_sum(sq, a.lanes) * a.inv_c + a.eps);

#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (!(has[k] && live)) continue;
      float g[4], be[4], o[4];
      unpack(rg[k], g);
      unpack(rbeta[k], be);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = g[j] * (rstd * (v[k][j] - mean)) + be[j];
      if (FORM == GATED) {
        float z[4];
        unpack(ro[k], z);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = rnd(o[j]) * rnd(z[j] / (1.f + expf(-z[j])));
      }
      a.out[row * a.vpr + col[k]] = pack(o);
    }
    stage = (stage + 1) % STAGES;
  }
  m2t_ptx::cp_async_wait<0>();
}

template <int FORM>
cudaError_t launch(const Args& a, long long steps, cudaStream_t s) {
  auto kernel = row_norm_kernel<FORM>;
  const int ring_bytes = WARPS * STAGES * (FORM == PLAIN ? 1 : 2) * VPL * 32 * 8;  // <= 18 KB
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, ring_bytes);
  if (e != cudaSuccess) return e;
  const long long want = (steps + WARPS - 1) / WARPS;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(want < resident ? want : resident), WARPS * 32, ring_bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace m2t_rn

// One launch on `stream`. x, other, xout, out: (rows, C) contiguous bf16;
// scale, gamma, beta: (C,) bf16; every pointer 8-byte aligned. The form
// follows the pointers: other and xout set, gated 0: residual (scaled if
// scale is set); other set, gated 1: gated; other null: plain.
extern "C" int m2t_row_norm(const void* x, const void* other, const void* scale,
                            const void* gamma, const void* beta, void* xout, void* out,
                            long long rows, int C, int gated, float eps, void* stream) {
  using namespace m2t_rn;
  const void* ptrs[] = {x, other, scale, gamma, beta, xout, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || C <= 0 || C % 4 != 0 || C > MAX_C || !x || !gamma || !beta || !out)
    return (int)cudaErrorInvalidValue;
  const bool residual = other && !gated;
  if ((gated && (!other || scale || xout)) || (residual != (xout != nullptr)) ||
      (scale && !residual))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const uint2*>(x);
  a.other = static_cast<const uint2*>(other);
  a.scale = static_cast<const uint2*>(scale);
  a.gamma = static_cast<const uint2*>(gamma);
  a.beta = static_cast<const uint2*>(beta);
  a.xout = static_cast<uint2*>(xout);
  a.out = static_cast<uint2*>(out);
  a.rows = rows;
  a.vpr = C / 4;
  a.lanes = 1;
  while (a.lanes * VPL < a.vpr) a.lanes *= 2;
  a.inv_c = 1.f / (float)C;
  a.eps = eps;
  const int per_step = 32 / a.lanes;
  const long long steps = (rows + per_step - 1) / per_step;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gated) return (int)launch<GATED>(a, steps, s);
  if (scale) return (int)launch<SCALED>(a, steps, s);
  if (residual) return (int)launch<RESIDUAL>(a, steps, s);
  return (int)launch<PLAIN>(a, steps, s);
}
