// HAT's two attentions, forward only, bf16 on the tensor cores (sm_90a):
// the shifted 16x16 window self-attention of a hybrid attention block
// (SW-MSA, m2t_hat_wattn_kernel) and the overlapping cross-attention of a
// group's last block (OCA, m2t_hat_oca_kernel).
//
// Replaces no TPU kernel: the JAX package has no HAT. Added because HAT x4
// (Chen et al., CVPR 2023, hat/archs/hat_arch.py) spends 18% of its
// operations in these two attentions, MedCLIP's window kernel
// (swin_attn.cu) takes window 7 and head dims 8 / 16 / 32 only and runs
// on the FP32 FMAs, and the plain form writes every (query, key, head)
// logit to device memory (an OCAB of an 8 x 96^2 request: 8 * 36 * 6 *
// 256 * 576 f32 logits, 255 MB, each written and read back several times).
//
// What it computes, for q, k and v in image layout (B, H, W, *), pixel
// stride `ps` elements (views of the qkv projection's output, q | k | v)
// and one (window, head) a CTA, with s = head dim^-0.5:
//
//   SW-MSA: the window's 256 queries and 256 keys are the pixels of the
//     map rolled by -shift: token (r, c) of window (wi, wj) reads pixel
//     ((16 wi + r + shift) mod H, (16 wj + c + shift) mod W);
//     S = bf16(q s) k^T + table[rel(i, j), head] (+ -100 where the SW-MSA
//     regions of i and j differ, shift > 0); the output goes back to the
//     query's own pixel (the roll back and the window reverse).
//   OCA: the 256 queries of the unshifted window against the 576 keys of
//     the 24 x 24 frame centred on it (rows 16 wi - 4 ... 16 wi + 19); keys
//     outside the map are zero vectors that stay in the softmax (logit =
//     bias, value 0), as nn.Unfold's zero padding of k and v gives them;
//     the bias of key (kr, kc) of the 24^2 frame and query (qr, qc) of the
//     16^2 window is table[((kr - qr - 7) * 39 + (kc - qc - 7)) mod 1521],
//     the released calc_rpi_oca with its negative entries wrapped as
//     PyTorch indexing wraps them.
//   Both: P = softmax(S), out = P v, channel head * hd + d of (B, H, W, C).
//
// Both bias tables are laid into shared memory so that one rule indexes
// them: entry (kr - qr + 15) * P + (kc - qc + 15), P = 31 or 39 (SW-MSA's
// table read backwards, OCA's rotated by 641 rows); the plain version
// mirrors it (ops/kernels/hat_attn.py::bias_rows).
//
// Precision: bf16 operands, f32 accumulation (mma.sync m16n8k16), logits
// and the softmax in f32 (base 2, the bias and mask pre-scaled by log2 e),
// q scaled by s and rounded to bf16 as the plain version rounds it, P
// rounded to bf16 before P v; the row sum stays f32 and divides the f32
// output once before its one rounding to bf16.
//
// What bounds it on the card: bytes on paper. An SW-MSA launch of an 8 x
// 96^2 request reads q, k, v (80 MB of the 540-channel qkv) and writes 27
// MB, 32 us at 3.35 TB/s, for 13.6 GFLOP (14 us at the bf16 peak); OCA
// reads and writes the same for 30.6 GFLOP (31 us). Measured on an H100
// at that shape: 0.176-0.192 ms an SW-MSA launch and 0.344 an OCA launch,
// 16-18% and 9% of those bounds; how the time splits between mma.sync
// issue, the softmax's exp2 and the bias gathers is not measured (no
// instruction profiler). Design: a CTA of 8 warps takes one (window,
// head); it stages q (scaled), k and v of that head into shared memory
// once (64-byte rows, head dim 30 zero-padded to 32, XOR-swizzled so
// ldmatrix is conflict-free), with every thread issuing all its 4-byte
// loads before it stores any, and the bias column of its head as f32. Each
// warp then owns 32 query rows (two m16 tiles that share every K and V
// fragment) with Q in registers, and walks the keys in tiles of 32:
// Q K^T on the tensor cores, bias and mask added in registers, an online
// (flash) softmax with the running max and sum in registers, P packed to
// bf16 A fragments and P V on the tensor cores. Nothing of S or P leaves
// the SM. Heads are the fastest grid index, so the six CTAs of a window run
// together and read each pixel's 1080 bytes of qkv from L2 once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace {

using namespace m2t_ptx;
using bf16 = __nv_bfloat16;

constexpr int WQ = 16;                  // query window side
constexpr int NQ = WQ * WQ;             // 256 queries a window
constexpr int WK_OCA = 24;              // OCA key window side (overlap 0.5)
constexpr int HDP = 32;                 // head dim padded on chip
constexpr int ROW_BYTES = HDP * 2;      // 64 bytes a token row
constexpr int NWARP = 8, NT = NWARP * 32;
constexpr int MT = NQ / 16 / NWARP;     // m16 tiles a warp: 2
constexpr int KT = 32;                  // keys a tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -100.0f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* table;  // (P*P, heads): (2*16-1)^2 for SW-MSA, (16+24-1)^2 for OCA
  bf16* out;           // (B, H, W, C) contiguous
  long long ps;        // elements from one pixel to the next in q, k and v
  int H, W, C, heads, hd, shift;
  int nww, nw;         // windows a row of windows, windows an image
  float scale;
};

// byte offset of 4-byte word w (0..15) of token row `row` in a swizzled
// [rows][64 B] array: 16-byte chunk (w / 4) ^ ((row / 2) % 4)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * ROW_BYTES + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// The CTA's window and head, and the pixels its tokens read.
template <int WK>
struct Win {
  int b, wi, wj, head;

  __device__ __forceinline__ explicit Win(const Args& a) {
    head = blockIdx.x % a.heads;
    const int bw = blockIdx.x / a.heads;
    b = bw / a.nw;
    const int w = bw % a.nw;
    wi = w / a.nww;
    wj = w % a.nww;
  }

  // flat pixel of query token t (SW-MSA: on the map rolled by -shift)
  __device__ __forceinline__ long long query_pixel(const Args& a, int t) const {
    int y = wi * WQ + t / WQ + a.shift, x = wj * WQ + t % WQ + a.shift;
    if (y >= a.H) y -= a.H;
    if (x >= a.W) x -= a.W;
    return ((long long)b * a.H + y) * a.W + x;
  }

  // flat pixel of key token t, or -1 where it lies outside the map (OCA)
  __device__ __forceinline__ long long key_pixel(const Args& a, int t) const {
    if (WK == WQ) return query_pixel(a, t);
    const int pad = (WK - WQ) / 2;
    const int y = wi * WQ - pad + t / WK, x = wj * WQ - pad + t % WK;
    if (y < 0 || y >= a.H || x < 0 || x >= a.W) return -1;
    return ((long long)b * a.H + y) * a.W + x;
  }
};

// Stage ROWS token rows of one head of `src` into swizzled shared memory:
// every 4-byte load of the thread first, then the stores; words past the
// head dim and rows outside the map are zero. With SCALE the pair is
// multiplied by a.scale and rounded to bf16 (q).
template <int ROWS, bool SCALE, typename PixFn>
__device__ __forceinline__ void stage(unsigned char* dst, const bf16* src, int chan,
                                      const Args& a, PixFn pix) {
  constexpr int WORDS = ROWS * 16;
  constexpr int PER = (WORDS + NT - 1) / NT;
  uint32_t r[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * NT;
    const int row = e >> 4, w = e & 15;
    r[i] = 0u;
    if (e < WORDS && 2 * w < a.hd) {
      const long long p = pix(row);
      if (p >= 0)
        r[i] = __ldg(reinterpret_cast<const uint32_t*>(src + p * a.ps + chan + 2 * w));
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e >= WORDS) continue;
    const int row = e >> 4, w = e & 15;
    uint32_t x = r[i];
    if (SCALE) {
      __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&x);
      x = pack_bf16(__low2float(h) * a.scale, __high2float(h) * a.scale);
    }
    *reinterpret_cast<uint32_t*>(dst + swz(row, w >> 2) + (w & 3) * 4) = x;
  }
}

// the SW-MSA region of a rolled coordinate x of an axis of n: the slices
// [0, n - 16), [n - 16, n - shift), [n - shift, n)
__device__ __forceinline__ int region(int x, int n, int shift) {
  return x < n - WQ ? 0 : (x < n - shift ? 1 : 2);
}

template <int WK>
struct Smem {
  static constexpr int NK = WK * WK;
  static constexpr int P = WQ + WK - 1;           // relative offsets an axis
  static constexpr int TBL = P * P;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + NQ * ROW_BYTES;
  static constexpr int V_OFF = K_OFF + NK * ROW_BYTES;
  static constexpr int TB_OFF = V_OFF + NK * ROW_BYTES;
  static constexpr int REG_OFF = TB_OFF + (TBL * 4 + 15) / 16 * 16;
  static constexpr int BYTES = REG_OFF + NQ;       // a region byte a token
};

template <int WK>
__device__ __forceinline__ void attend(const Args& a) {
  using S = Smem<WK>;
  constexpr int NK = S::NK, P = S::P;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem + S::Q_OFF;
  unsigned char* ks = smem + S::K_OFF;
  unsigned char* vs = smem + S::V_OFF;
  float* tb = reinterpret_cast<float*>(smem + S::TB_OFF);
  unsigned char* reg = smem + S::REG_OFF;

  const Win<WK> win(a);
  const int chan = win.head * a.hd;
  const bool masked = WK == WQ && a.shift > 0;

  // 1. q (scaled), k and v of the head; its bias column; the regions
  stage<NQ, true>(qs, a.q, chan, a, [&](int t) { return win.query_pixel(a, t); });
  stage<NK, false>(ks, a.k, chan, a, [&](int t) { return win.key_pixel(a, t); });
  stage<NK, false>(vs, a.v, chan, a, [&](int t) { return win.key_pixel(a, t); });
  for (int i = threadIdx.x; i < S::TBL; i += NT) {
    // the table row of shared-memory entry i (see the header)
    const int row = WK == WQ ? S::TBL - 1 - i : (i + (2 - WK) * (P + 1) + S::TBL) % S::TBL;
    tb[i] = a.table[(long long)row * a.heads + win.head] * LOG2E;
  }
  if (masked)
    for (int t = threadIdx.x; t < NQ; t += NT)
      reg[t] = (unsigned char)(3 * region(win.wi * WQ + t / WQ, a.H, a.shift) +
                               region(win.wj * WQ + t % WQ, a.W, a.shift));
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
  const uint32_t qs_s = smem_u32(qs), ks_s = smem_u32(ks), vs_s = smem_u32(vs);

  // 2. this warp's query rows as A fragments: m-tile mt is window row
  // warp * MT + mt, its rows g8 and g8 + 8 are columns g8 and g8 + 8
  uint32_t qf[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4(qf[mt][kk], qs_s + swz((warp * MT + mt) * 16 + lrow, 2 * kk + lcol / 8));
  int qreg[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      qreg[mt][hr] = masked ? reg[(warp * MT + mt) * 16 + g8 + 8 * hr] : 0;

  float o[MT][4][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

#pragma unroll 1
  for (int k0 = 0; k0 < NK; k0 += KT) {
    // 3. S = q_s k^T for KT keys
    float s[MT][KT / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT / 16; ++kt)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t fb[4];
        ldmatrix_x4(fb, ks_s + swz(k0 + kt * 16 + krow, 2 * kk + kcol / 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * kt], qf[mt][kk], fb[0], fb[1]);
          mma_bf16(s[mt][2 * kt + 1], qf[mt][kk], fb[2], fb[3]);
        }
      }

    // 4. + bias (+ mask), base 2; the tile's row max; rescale
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int qr = warp * MT + mt;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + nt * 8 + 2 * t4 + (e & 1), hr = e >> 1;
          const int kr = j / WK, kc = j % WK, qc = g8 + 8 * hr;
          float x = s[mt][nt][e] * LOG2E + tb[(kr - qr + WQ - 1) * P + (kc - qc + WQ - 1)];
          if (masked && reg[j] != qreg[mt][hr]) x += MASK * LOG2E;
          s[mt][nt][e] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float mnew = fmaxf(m[mt][hr], mx[hr]);
        const float corr = exp2f(m[mt][hr] - mnew);
        m[mt][hr] = mnew;
        l[mt][hr] *= corr;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          o[mt][nt][2 * hr] *= corr;
          o[mt][nt][2 * hr + 1] *= corr;
        }
      }
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[mt][nt][e] - m[mt][e >> 1]);
          s[mt][nt][e] = p;
          l[mt][e >> 1] += p;
        }
    }

    // 5. O += P v
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pf[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            pf[mt][2 * h + hr] = pack_bf16(s[mt][2 * kk + h][2 * hr], s[mt][2 * kk + h][2 * hr + 1]);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, vs_s + swz(k0 + kk * 16 + lrow, 2 * n2 + lcol / 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * n2], pf[mt], fb[0], fb[1]);
          mma_bf16(o[mt][2 * n2 + 1], pf[mt], fb[2], fb[3]);
        }
      }
    }
  }

  // 6. O / rowsum, to the query's pixel
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float sum = l[mt][hr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      const int t = (warp * MT + mt) * 16 + g8 + 8 * hr;
      bf16* dst = a.out + win.query_pixel(a, t) * a.C + chan;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int d = nt * 8 + 2 * t4;
        if (d < a.hd)
          *reinterpret_cast<uint32_t*>(dst + d) =
              pack_bf16(o[mt][nt][2 * hr] * inv, o[mt][nt][2 * hr + 1] * inv);
      }
    }
}

__global__ void __launch_bounds__(NT, 2) m2t_hat_wattn_kernel(Args a) { attend<WQ>(a); }

__global__ void __launch_bounds__(NT, 2) m2t_hat_oca_kernel(Args a) { attend<WK_OCA>(a); }

int run(Args& a, int B, bool oca, void* stream) {
  if (B < 0 || a.heads < 1 || a.C % a.heads != 0 || a.H % WQ != 0 || a.W % WQ != 0 ||
      a.shift < 0 || a.shift >= WQ || (oca && a.shift != 0) || a.ps % 2 != 0)
    return (int)cudaErrorInvalidValue;
  a.hd = a.C / a.heads;
  if (a.hd > HDP || a.hd % 2 != 0) return (int)cudaErrorInvalidValue;
  a.nww = a.W / WQ;
  a.nw = (a.H / WQ) * a.nww;
  const long long ctas = (long long)B * a.nw * a.heads;
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = oca ? Smem<WK_OCA>::BYTES : Smem<WQ>::BYTES;
  const void* fn = oca ? (const void*)m2t_hat_oca_kernel : (const void*)m2t_hat_wattn_kernel;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (oca)
    m2t_hat_oca_kernel<<<(int)ctas, NT, smem, st>>>(a);
  else
    m2t_hat_wattn_kernel<<<(int)ctas, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

Args args(const void* q, const void* k, const void* v, long long ps, const void* table,
          void* out, int H, int W, int C, int heads, int shift, float scale) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.table = static_cast<const float*>(table);
  a.out = static_cast<bf16*>(out);
  a.ps = ps;
  a.H = H; a.W = W; a.C = C; a.heads = heads; a.shift = shift; a.scale = scale;
  return a;
}

}  // namespace

// q, k, v: bf16 (B, H, W, *) with `ps` elements between pixels (views of
// one (B, H, W, 3C) tensor, or contiguous with ps = C), 4-byte aligned;
// table: f32 ((2*16-1)^2, heads); out: bf16 (B, H, W, C) contiguous. H and W
// multiples of 16, C / heads even and at most 32, 0 <= shift < 16.
extern "C" int m2t_hat_wattn(const void* q, const void* k, const void* v, long long ps,
                             const void* table, void* out, int B, int H, int W, int C,
                             int heads, int shift, float scale, void* stream) {
  Args a = args(q, k, v, ps, table, out, H, W, C, heads, shift, scale);
  return run(a, B, false, stream);
}

// The same operands, table f32 ((16+24-1)^2, heads): the 16^2 windows
// against the 24^2 key windows centred on them, keys outside the map zero.
extern "C" int m2t_hat_oca(const void* q, const void* k, const void* v, long long ps,
                           const void* table, void* out, int B, int H, int W, int C,
                           int heads, float scale, void* stream) {
  Args a = args(q, k, v, ps, table, out, H, W, C, heads, 0, scale);
  return run(a, B, true, stream);
}
