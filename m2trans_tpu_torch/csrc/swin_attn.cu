// MedCLIP's Swin window attention, forward and backward, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's MedCLIP attention
// (m2trans_tpu/models/medclip/swin.py, `_attention`) is plain XLA, and so
// was the port's. It was added because the plain form spends most of its
// device time outside its matrix products: a roll, a window partition, a
// head split, the scale, the bias gathered and added as a permuted
// broadcast, the shift mask, the softmax, the head merge, a window reverse
// and a roll back, each a launch that writes its tensor to device memory
// and reads it back, and at stage 1 the logits alone are 11 MB a pass.
//
// What it computes, for a (B, H, W, C) map of q, k and v (the projections,
// run on the image layout; a per-token product commutes with the windows)
// and one (window, head) a CTA: the window's 49 tokens are the pixels of
// the map rolled by -shift, so token (r, c) of window (wi, wj) reads pixel
// ((7 wi + r + shift) mod H, (7 wj + c + shift) mod W); then
//
//   S = (q * hd^-0.5) k^T + table[rel(i, j), head] (+ -100 where the
//       SW-MSA regions of i and j differ, shift > 0),
//   P = softmax(S), out = P v,
//
// written back to the token's own pixel (the roll back and the window
// reverse), channel head * hd + d. The backward recomputes P from q and k
// and forms dV = P^T dO, dS = P * (dP - rowsum(P * dP)) with dP = dO v^T,
// dK = dS^T q_s and dQ = (dS k) * hd^-0.5. A window partitions the map, so
// every element of dQ, dK and dV has one writer: no atomics, the same bits
// every run. The bias table gets no gradient (MedCLIP's weights are frozen).
//
// Precision: for f32 inputs every product and sum is an f32 FFMA, no TF32.
// For bf16 inputs the kernel keeps the plain version's rounding points: q
// scaled then rounded to bf16, logits and softmax in f32, P rounded to
// bf16 before P v, each product's result rounded to bf16 where the plain
// version's bf16 product writes one (out, dP, dV, dK, dQ before and after
// its scale). The softmax scales by one correctly rounded reciprocal of
// its sum a row, within an ulp of dividing by it.
//
// What bounds it on the card: bytes. A Swin-tiny forward at batch 6 reads
// q, k, v and writes the output once, about 41 us at 3.35 TB/s over the
// four stages; its 1.7 GFLOP of Q K^T and P V take about 25 us at the FP32
// FMA rate. So the design keeps loads in flight and feeds the FMAs from
// registers rather than from shared memory, whose bandwidth (one 128-byte
// wavefront a clock) would bound products that broadcast their operands.
// A CTA (four warps) stages its window's q, k and v (and dO) in shared
// memory as f32, each thread issuing all its 16-byte loads of every tensor
// before it stores any. A warp takes four query rows at a time with its
// lane's two keys (j = lane, lane + 32) in registers: Q K^T is broadcast
// float4s of q against registers, the softmax four independent pairs of
// warp reductions; P goes to shared memory (transposed, 10 KB). P V, and
// the backward's dV, dK and dQ, are then tiled products: a thread holds a
// 4 x 4 tile of the output in registers and, for each of the 49 terms,
// loads a float4 of each operand for 16 FMAs. Nothing of S, P or dS goes
// to device memory. Window 7, head dims 8, 16 and 32 (the published
// Swin-tiny is 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WS = 7;                             // window side
constexpr int N = WS * WS;                        // tokens a window
constexpr int SPAN = 2 * WS - 1;                  // relative offsets an axis
constexpr int TBL = SPAN * SPAN;                  // rows of the bias table
constexpr int TBL_PAD = (TBL + 3) / 4 * 4;
constexpr int NT = 128, NWARP = NT / 32;
constexpr int R = 4;                              // query rows a warp takes at once
constexpr int NG = (N + R - 1) / R;               // groups of R rows
constexpr int NP = (N + 3) / 4 * 4;               // 52: N padded to whole float4s
constexpr int NQ = NP / 4;                        // quads of output rows in a tile
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* table;  // ((2*WS-1)^2, heads)
  const void* gout;   // dO (backward)
  void* out;          // forward
  void* dq;           // backward
  void* dk;
  void* dv;
  int H, W, C, heads, shift;
  int nww, nw;        // windows a row of windows, windows an image
  float scale;
};

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T cast(float x);
template <> __device__ __forceinline__ float cast<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 cast<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T's precision, as f32: where the plain version stores a T
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return f32(cast<T>(x));
}

// four consecutive values of a row, 16 (f32) or 8 (bf16) bytes aligned
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// the SW-MSA region of a rolled coordinate x of an axis of n: the slices
// [0, n - WS), [n - WS, n - shift), [n - shift, n)
__device__ __forceinline__ int region(int x, int n, int shift) {
  return x < n - WS ? 0 : (x < n - shift ? 1 : 2);
}

// The CTA's window (blockIdx.x) and head (blockIdx.y): the window's origin
// on the rolled map, and each token's element offset of its head slice
// (its pixel after the roll by -shift).
struct Win {
  int b, r0, c0, head;

  __device__ __forceinline__ explicit Win(const Args& a) {
    const int wr = blockIdx.x % a.nw;
    b = blockIdx.x / a.nw;
    r0 = wr / a.nww * WS;
    c0 = wr % a.nww * WS;
    head = blockIdx.y;
  }

  template <int HD>
  __device__ __forceinline__ long long offset(const Args& a, int t) const {
    int sr = r0 + t / WS + a.shift, sc = c0 + t % WS + a.shift;
    if (sr >= a.H) sr -= a.H;
    if (sc >= a.W) sc -= a.W;
    return (((long long)b * a.H + sr) * a.W + sc) * a.C + (long long)head * HD;
  }
};

// each token's offset and region (0 where unshifted), and the head's
// column of the bias table as f32
template <typename T, int HD>
__device__ void load_map(const Args& a, const Win& w, long long* pix, int* reg, float* tb) {
  for (int t = threadIdx.x; t < N; t += NT) {
    pix[t] = w.offset<HD>(a, t);
    reg[t] = a.shift ? region(w.r0 + t / WS, a.H, a.shift) * 3 +
                           region(w.c0 + t % WS, a.W, a.shift)
                     : 0;
  }
  const T* table = static_cast<const T*>(a.table);
  for (int i = threadIdx.x; i < TBL; i += NT) tb[i] = f32(table[i * a.heads + w.head]);
}

// A thread's share of one tensor's (window, head) slice, as 16-byte vectors
// in registers: load() issues every load, store() then writes them to
// shared memory as f32 (row stride LD), scaled and rounded for q.
template <typename T, int HD>
struct Slice {
  static constexpr int VEC = 16 / sizeof(T), VPT = HD / VEC, V = N * VPT;
  static constexpr int IT = (V + NT - 1) / NT;
  uint4 r[IT];

  __device__ __forceinline__ void load(const void* src, const Args& a, const Win& w) {
    const T* x = static_cast<const T*>(src);
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int vi = threadIdx.x + it * NT;
      if (vi < V)
        r[it] = *reinterpret_cast<const uint4*>(x + w.offset<HD>(a, vi / VPT) +
                                                (vi % VPT) * VEC);
    }
  }

  template <int LD, bool SCALE>
  __device__ __forceinline__ void store(float* s, float scale) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int vi = threadIdx.x + it * NT;
      if (vi >= V) continue;
      const T* e = reinterpret_cast<const T*>(&r[it]);
      float* dst = s + (vi / VPT) * LD + (vi % VPT) * VEC;
#pragma unroll
      for (int u = 0; u < VEC; ++u) dst[u] = SCALE ? rnd<T>(f32(e[u]) * scale) : f32(e[u]);
    }
  }
};

// rows j0 = lane and j1 = lane + 32 (0 where j1 >= N) of a [N][LD] array
// in shared memory, into registers
template <int HD, int LD>
__device__ __forceinline__ void key_rows(const float* s, int lane, float (&r0)[HD],
                                         float (&r1)[HD]) {
  const bool has1 = lane + 32 < N;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(s + lane * LD + d);
    const float4 y = has1 ? *reinterpret_cast<const float4*>(s + (lane + 32) * LD + d)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    r0[d] = x.x; r0[d + 1] = x.y; r0[d + 2] = x.z; r0[d + 3] = x.w;
    r1[d] = y.x; r1[d + 1] = y.y; r1[d + 2] = y.z; r1[d + 3] = y.w;
  }
}

// the rows of a group (the last group's rows past N read row N - 1)
__device__ __forceinline__ int row_of(int grp, int r) {
  const int i = grp * R + r;
  return i < N ? i : N - 1;
}

// What a lane knows of its two keys j0 = lane and j1 = lane + 32 (valid
// where j1 < N): their offsets into the bias table (rel(i, j) = i's part +
// the key's) and their regions.
struct LaneKeys {
  int kb0, kb1, rg0, rg1;
  bool has1;

  __device__ __forceinline__ LaneKeys(int lane, const int* reg) {
    const int j1 = lane + 32 < N ? lane + 32 : lane;
    kb0 = (WS - 1 - lane / WS) * SPAN + (WS - 1 - lane % WS);
    kb1 = (WS - 1 - j1 / WS) * SPAN + (WS - 1 - j1 % WS);
    rg0 = reg[lane];
    rg1 = reg[j1];
    has1 = lane + 32 < N;
  }
};

// The four rows grp*R.. of S . r0 / r1 for the lane's keys: acc0[r] =
// x[row] . r0, acc1[r] = x[row] . r1 (x rows [N][HD] broadcast from shared
// memory)
template <int HD>
__device__ __forceinline__ void row_dots(const float* x, int grp, const float (&r0)[HD],
                                         const float (&r1)[HD], float (&acc0)[R],
                                         float (&acc1)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(x + row_of(grp, r) * HD + d);
      acc0[r] = fmaf(v.x, r0[d], acc0[r]);
      acc0[r] = fmaf(v.y, r0[d + 1], acc0[r]);
      acc0[r] = fmaf(v.z, r0[d + 2], acc0[r]);
      acc0[r] = fmaf(v.w, r0[d + 3], acc0[r]);
      acc1[r] = fmaf(v.x, r1[d], acc1[r]);
      acc1[r] = fmaf(v.y, r1[d + 1], acc1[r]);
      acc1[r] = fmaf(v.z, r1[d + 2], acc1[r]);
      acc1[r] = fmaf(v.w, r1[d + 3], acc1[r]);
    }
  }
}

// Rows grp*R.. of P for the lane's keys (p1 is 0 where j1 >= N): the
// logits against k0 / k1 in registers, the bias, the mask, and the f32
// softmax over the warp, the R rows' reductions interleaved.
template <int HD>
__device__ __forceinline__ void softmax_rows(const float* qs, int grp, const float (&k0)[HD],
                                             const float (&k1)[HD], const LaneKeys& lk,
                                             const float* tb, const int* reg, bool shifted,
                                             float (&p0)[R], float (&p1)[R]) {
  float m[R], sum[R];
  row_dots<HD>(qs, grp, k0, k1, p0, p1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row_of(grp, r);
    const int qb = (i / WS) * SPAN + i % WS;
    p0[r] += tb[qb + lk.kb0];
    if (shifted && reg[i] != lk.rg0) p0[r] += -100.f;
    p1[r] += tb[qb + lk.kb1];
    if (shifted && reg[i] != lk.rg1) p1[r] += -100.f;
    m[r] = lk.has1 ? fmaxf(p0[r], p1[r]) : p0[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(FULL, m[r], o));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    p0[r] = expf(p0[r] - m[r]);
    p1[r] = lk.has1 ? expf(p1[r] - m[r]) : 0.f;
    sum[r] = p0[r] + p1[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(FULL, sum[r], o);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // one correctly rounded reciprocal a row: within an ulp of dividing,
    // and without a division's slow path in every lane
    const float inv = 1.f / sum[r];
    p0[r] *= inv;
    p1[r] *= inv;
  }
}

// A tiled product over the N terms k: the thread's 4 x 4 tile (output rows
// 4*rq.., channels 4*cq..) of sum_k a[k*LA + 4*rq + r] * b[k*LB + 4*cq + c]
template <int LA, int LB>
__device__ __forceinline__ void tile_product(const float* a, const float* b, int rq, int cq,
                                             float (&c)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) c[r][u] = 0.f;
#pragma unroll 7
  for (int k = 0; k < N; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(a + k * LA + 4 * rq);
    const float4 y = *reinterpret_cast<const float4*>(b + k * LB + 4 * cq);
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) c[r][u] = fmaf(xs[r], ys[u], c[r][u]);
  }
}

// out[token 4*rq + r][channels 4*cq..] = c[r] (rows past N dropped), each
// value through f
template <typename T, typename F>
__device__ __forceinline__ void store_tile(T* out, const long long* pix, int rq, int cq,
                                           const float (&c)[4][4], F f) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = 4 * rq + r;
    if (t >= N) break;
    const float x[4] = {f(c[r][0]), f(c[r][1]), f(c[r][2]), f(c[r][3])};
    store4(out + pix[t] + 4 * cq, x);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) swin_attn_fwd_kernel(Args a) {
  constexpr int LK = HD + 4;                   // k's row stride: conflict-free float4 rows
  __shared__ __align__(16) float qs[N * HD];   // q scaled (and rounded to T)
  __shared__ __align__(16) float ks[N * LK];
  __shared__ __align__(16) float vs[N * HD];
  __shared__ __align__(16) float pt[N * NP];   // P^T rounded to T: pt[j][i]
  __shared__ float tb[TBL];
  __shared__ long long pix[N];
  __shared__ int reg[N];

  {
    const Win w(a);
    Slice<T, HD> sq, sk, sv;
    sq.load(a.q, a, w);
    sk.load(a.k, a, w);
    sv.load(a.v, a, w);
    load_map<T, HD>(a, w, pix, reg, tb);
    sq.template store<HD, true>(qs, a.scale);
    sk.template store<LK, false>(ks, 0.f);
    sv.template store<HD, false>(vs, 0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float k0[HD], k1[HD];
  key_rows<HD, LK>(ks, lane, k0, k1);
  const LaneKeys lk(lane, reg);
  for (int grp = warp; grp < NG; grp += NWARP) {
    float p0[R], p1[R];
    softmax_rows<HD>(qs, grp, k0, k1, lk, tb, reg, a.shift != 0, p0, p1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = grp * R + r;
      if (i >= N) break;
      pt[lane * NP + i] = rnd<T>(p0[r]);
      if (lk.has1) pt[(lane + 32) * NP + i] = rnd<T>(p1[r]);
    }
  }
  __syncthreads();

  // out = P V: tiles of 4 query rows x 4 channels
  T* out = static_cast<T*>(a.out);
  for (int tile = threadIdx.x; tile < NQ * (HD / 4); tile += NT) {
    const int rq = tile / (HD / 4), cq = tile % (HD / 4);
    float c[4][4];
    tile_product<NP, HD>(pt, vs, rq, cq, c);
    store_tile(out, pix, rq, cq, c, [](float x) { return x; });
  }
}

// the backward's shared memory, in floats: q (scaled), dO, k, P rounded,
// P then dS, and v, whose space dS^T takes once v is in registers
template <int HD>
struct BwdSmem {
  static constexpr int LK = HD + 4;                 // conflict-free float4 rows
  static constexpr int QS = 0;                      // [N][HD]
  static constexpr int GS = QS + N * HD;            // [N][HD] dO
  static constexpr int KS = GS + N * HD;            // [N][LK]
  static constexpr int PS = KS + N * LK;            // [N][NP] P rounded to T
  static constexpr int DS = PS + N * NP;            // [N][NP] P in f32, then dS
  static constexpr int VS = DS + N * NP;            // [N][LK] v, then [N][NP] dS^T
  static constexpr int TB = VS + N * NP;
  static constexpr int FLOATS = TB + TBL_PAD;
  static constexpr int BYTES = FLOATS * 4 + N * 8 + N * 4;  // + token offsets, regions
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) swin_attn_bwd_kernel(Args a) {
  using S = BwdSmem<HD>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* qs = sm + S::QS;
  float* gs = sm + S::GS;
  float* ks = sm + S::KS;
  float* ps = sm + S::PS;
  float* ds = sm + S::DS;
  float* vs = sm + S::VS;
  float* dst = sm + S::VS;
  float* tb = sm + S::TB;
  long long* pix = reinterpret_cast<long long*>(sm + S::FLOATS);
  int* reg = reinterpret_cast<int*>(pix + N);

  {
    const Win w(a);
    Slice<T, HD> sq, sk, sv, sg;
    sq.load(a.q, a, w);
    sk.load(a.k, a, w);
    sv.load(a.v, a, w);
    sg.load(a.gout, a, w);
    load_map<T, HD>(a, w, pix, reg, tb);
    sq.template store<HD, true>(qs, a.scale);
    sk.template store<S::LK, false>(ks, 0.f);
    sv.template store<S::LK, false>(vs, 0.f);
    sg.template store<HD, false>(gs, 0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const LaneKeys lk(lane, reg);
  const int j1 = lane + 32;
  float r0[HD], r1[HD];
  // P, recomputed: the lane's keys in registers
  key_rows<HD, S::LK>(ks, lane, r0, r1);
  for (int grp = warp; grp < NG; grp += NWARP) {
    float p0[R], p1[R];
    softmax_rows<HD>(qs, grp, r0, r1, lk, tb, reg, a.shift != 0, p0, p1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = grp * R + r;
      if (i >= N) break;
      ds[i * NP + lane] = p0[r];
      if (lk.has1) ds[i * NP + j1] = p1[r];
    }
  }
  // dP = dO v^T (rounded where the plain product writes a T), then dS; the
  // rows are the warp's own from the loop above. v's space becomes dS^T
  // once every warp holds its rows of v.
  key_rows<HD, S::LK>(vs, lane, r0, r1);
  __syncthreads();
  for (int grp = warp; grp < NG; grp += NWARP) {
    float dp0[R], dp1[R], dot[R];
    row_dots<HD>(gs, grp, r0, r1, dp0, dp1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row_of(grp, r);
      dp0[r] = rnd<T>(dp0[r]);
      dp1[r] = rnd<T>(dp1[r]);
      dot[r] = ds[i * NP + lane] * dp0[r] + (lk.has1 ? ds[i * NP + j1] * dp1[r] : 0.f);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] += __shfl_xor_sync(FULL, dot[r], o);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = grp * R + r;
      if (i >= N) break;
      const float p0 = ds[i * NP + lane], g0 = p0 * (dp0[r] - dot[r]);
      ds[i * NP + lane] = g0;
      dst[lane * NP + i] = g0;
      ps[i * NP + lane] = rnd<T>(p0);
      if (lk.has1) {
        const float p1 = ds[i * NP + j1], g1 = p1 * (dp1[r] - dot[r]);
        ds[i * NP + j1] = g1;
        dst[j1 * NP + i] = g1;
        ps[i * NP + j1] = rnd<T>(p1);
      }
    }
  }
  __syncthreads();

  // dV = P^T dO, dK = dS^T q_s, dQ = (dS k) * scale: tiles of 4 tokens x 4
  // channels, a tile of each a thread
  const float scale = a.scale;
  for (int tile = threadIdx.x; tile < NQ * (HD / 4); tile += NT) {
    const int rq = tile / (HD / 4), cq = tile % (HD / 4);
    float c[4][4];
    tile_product<NP, HD>(ps, gs, rq, cq, c);
    store_tile(static_cast<T*>(a.dv), pix, rq, cq, c, [](float x) { return x; });
    tile_product<NP, HD>(ds, qs, rq, cq, c);
    store_tile(static_cast<T*>(a.dk), pix, rq, cq, c, [](float x) { return x; });
    tile_product<NP, S::LK>(dst, ks, rq, cq, c);
    store_tile(static_cast<T*>(a.dq), pix, rq, cq, c,
               [scale](float x) { return rnd<T>(x) * scale; });
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int windows, bool bwd, cudaStream_t st) {
  const dim3 grid(windows, a.heads);
  if (bwd) {
    constexpr int smem = BwdSmem<HD>::BYTES;
    const cudaError_t err = cudaFuncSetAttribute(
        swin_attn_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    swin_attn_bwd_kernel<T, HD><<<grid, NT, smem, st>>>(a);
  } else {
    swin_attn_fwd_kernel<T, HD><<<grid, NT, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, int hd, int windows, bool bwd, cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8>(a, windows, bwd, st);
    case 16: return launch<T, 16>(a, windows, bwd, st);
    case 32: return launch<T, 32>(a, windows, bwd, st);
    default: return cudaErrorInvalidValue;
  }
}

int run(Args& a, int B, int is_bf16, bool bwd, void* stream) {
  if (B < 0 || a.heads < 1 || a.C % a.heads != 0 || a.H % WS != 0 || a.W % WS != 0 ||
      a.shift < 0 || a.shift >= WS)
    return (int)cudaErrorInvalidValue;
  const int hd = a.C / a.heads;
  if (hd != 8 && hd != 16 && hd != 32) return (int)cudaErrorInvalidValue;
  a.nww = a.W / WS;
  a.nw = (a.H / WS) * a.nww;
  const long long windows = (long long)B * a.nw;
  if (windows == 0) return 0;
  if (windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_hd<bf16>(a, hd, (int)windows, bwd, st)
                       : launch_hd<float>(a, hd, (int)windows, bwd, st));
}

}  // namespace

// q, k, v, out: (B, H, W, C) contiguous, f32 (is_bf16 = 0) or bf16; table:
// ((2*7-1)^2, heads) of the same type. C / heads in {8, 16, 32}, H and W
// multiples of 7, 0 <= shift < 7.
extern "C" int m2t_swin_attn(const void* q, const void* k, const void* v,
                             const void* table, void* out, int B, int H, int W, int C,
                             int heads, int shift, float scale, int is_bf16,
                             void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.table = table; a.out = out;
  a.H = H; a.W = W; a.C = C; a.heads = heads; a.shift = shift; a.scale = scale;
  return run(a, B, is_bf16, false, stream);
}

// The VJP of m2t_swin_attn with respect to q, k and v: gout is dO, dq / dk
// / dv are written whole (same layout and type as q).
extern "C" int m2t_swin_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* table, const void* gout, void* dq, void* dk,
                                 void* dv, int B, int H, int W, int C, int heads,
                                 int shift, float scale, int is_bf16, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.table = table; a.gout = gout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.W = W; a.C = C; a.heads = heads; a.shift = shift; a.scale = scale;
  return run(a, B, is_bf16, true, stream);
}
