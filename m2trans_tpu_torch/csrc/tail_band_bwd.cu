// K2b: the VJP of the fused phase-plane tail (K2), for sm_90a.
//
// Replaces the four TPU kernels of tail_band_bwd_fused
// (m2trans_tpu/ops/pallas/tail_band.py: _bwd_recompute_kernel,
// _bwd_dk_kernel, _bwd_dph_kernel, _bwd_stage_kernel), reached through
// tail_band_apply's custom_vjp. Given the cotangent g of K2's phase-plane
// output (B, H, W, P*3), it returns the gradients of K2's operands:
// dy (B, H, W, nf), dw0/db0, dw1/db1 (the permuted stage weights), dw3
// (3, 3, nf, 3) and the spliced reflect-ring slices dlc/drc/dtop/dbot.
//
// Two passes and a reduction:
//   pass 0 is K2's own kernel (m2t_tail_band_gm in tail_band.cu) run with
//     the cotangent: it recomputes the pre-clamp outputs exactly as the
//     forward did (so the clip mask is K2's bit for bit) and writes
//     gm = g * [0 <= out <= rgb_range] (f32): torch.clamp's and jnp.clip's
//     gradient rule;
//   pass 1, this file's kernel, walks K2's 8x16 LR tiles. For one phase
//     block blk of a pixel s, with GT[s, tap*3 + c] = gm[s - off(tap), q(tap),
//     c] (every tap of a source block is read by exactly one output phase q
//     of one LR neighbour, so GT is a gather through a list of nine taps,
//     the transpose of K2's tap lists):
//       d(ph)[s, blk, :] = GT[s] w3^T         dw3 += ph[s, blk, :]^T GT[s]
//     and then, through GELU' on the accumulator registers, the stage
//     transposes (x4: d(og) = d(ph) gelu'(og), dw1 += h^T d(og), dh0 =
//     d(og) w1^T, d(pre0) = dh0 gelu'(pre0); then dw0 += y^T d(pre0), dy +=
//     d(pre0) w0^T). Every pixel of the frame and of its 1-px ring belongs to
//     one tile (the ring to the tile it borders); a ring pixel's d(ph) is its
//     edge gradient.
//   reduce: the partial sums, in the fixed tree order of cftm_branch_bwd.cu's
//     reduction. No atomics on floats: runs repeat exactly.
//
// What bounded the first version on the card (PERF.md has its ablation):
// five parts of 0.4 ms each: the recompute over the whole halo on WMMA with
// an f32 staging tile, the conv adjoint, dw3 and the stage-0 transposes on
// the CUDA cores with every (offset, tap) pair tested a thread, 190 KB a
// block, and weight partials of 66 KB a tile summed serially a thread.
//
// Design. A thread block has a ROLE: one phase block blk = 4g + j (x4: stage-0
// group g, stage-1 block j; x2 / x3: the stage-0 block), fixed for its life;
// the blocks of a role share the frame's tiles (a persistent grid of roles x
// blocks-a-role). The role's weight slices (w0's and w1's nf columns, w3) sit
// in shared memory, staged once (cp.async). A tile's 128 pixels are 8 row
// tiles of 16, one a warp, and a warp takes its 16 pixels through the whole
// chain in registers, as K2 does (tail_chain.cuh): y -> pre0 -> h -> og ->
// ph with GELU and GELU' taken from one erff on the accumulators; GT is
// gathered from the gm halo (bf16: gm is a bf16 cotangent or zero) straight
// into A fragments; d(ph) = GT w3^T lands in the accumulator layout of og, so
// d(og) is a register product and feeds dh0 = d(og) w1^T as A fragments, and
// so on down to dy, which leaves as the role's partial plane. Only what the
// weight gradients need crosses shared memory, once, in bf16: h, d(og),
// d(pre0), ph and GT of the tile. After one block barrier the weight
// gradients' 16x16 output units (dw1 | db1 and dw0 | db0 through a column of
// ones, dw3) are spread over the warps and accumulated in registers over all
// the block's tiles: one partial a block, written at the end. The stage-0
// recompute is repeated by the four roles of a group (a fifth more products
// and GELUs), the price of accumulators that fit registers.
// Ring pixels (frame border tiles only) take ph from the spliced edge values,
// no products; their d(ph) goes to the edge gradients.
//
// GELU' uses erff (exact); the JAX backward uses its polynomial erf
// (|difference| <= 1e-4). mma.sync and not wgmma: 16 pixels a warp keep the
// chain in registers, as in K2.

#include "tail_chain.cuh"

extern "C" int m2t_reduce_batched(const void* part, int nbatch, int n,
                                  long long len, void* out, void* stream);
extern "C" int m2t_tail_band_gm(const void* y, const void* w0, const void* b0,
                                const void* w1, const void* b1, const void* w3,
                                const void* lc, const void* rc, const void* top,
                                const void* bot, void* out, const void* g,
                                void* gm, int B, int H, int W, int nf, int scale,
                                float rgb_range, void* stream);
extern "C" int m2t_tail_band_smem(int nf, int scale);

// Timing ablation (tools/kernel_ablation.py builds it; results are wrong by
// design): M2T_K2B_ABLATE is a set of bits, each compiling a part of the
// second pass out: 1 the recompute of the phase band, 2 dw3, 4 the
// structured-conv adjoint (GT and d(ph)), 8 the stage-1 products (x4),
// 16 the stage-0 transposes, 32 the reductions, 64 the first pass (K2's
// kernel).
#ifndef M2T_K2B_ABLATE
#define M2T_K2B_ABLATE 0
#endif
#define M2T_K2B_OFF(bit) ((M2T_K2B_ABLATE & (bit)) != 0)

namespace {

using namespace m2t_tail_chain;

constexpr int BT = 256;       // threads: a warp a row tile of the 128 pixels
constexpr int BW = BT / 32;
constexpr int GMP = 56;       // gm halo pitch, bf16 (P*3 <= 48, + 8)
constexpr int GTLD = 40;      // GT pitch, bf16 (27 columns in 32, + 8)

struct BwdArgs {
  TailArgs f;                    // K2's operands (out unused)
  const float* gm;               // (B, H, W, P*3) clip-masked cotangent
  float* partA;                  // last stage's dw | db a block, (nf+1) x nf
  float* partB;                  // x4: the share of dw0 | db0 a block
  float* part3;                  // (blocks, 27*nf) dw3 shares
  float* dy_part;                // (roles, B, H, W, nf)
  float *dlc, *drc;              // (B, H+2, P*nf), zeroed by the caller
  float *dtop, *dbot;            // (B, W+2, P*nf)
};

struct BwdLayout {
  int h, w0, w1, w3, b0, b1, gm, dog, dpre, ph, gt, tab, total;
};

// [y 128 x (nf+24)] [h likewise] [w0 slice nf x (nf+8)] [w1 slice] [w3 padded]
// [b0 | b1 f32] [gm halo bf16] [d(og)] [d(pre0)] [ph 192 rows] [GT 192 rows]
// [tap table]; y and h carry a column of ones at nf for the bias gradients
__host__ __device__ inline BwdLayout bwd_layout(int nf) {
  BwdLayout l;
  l.h = NOUT * (nf + 24) * 2;
  l.w0 = 2 * l.h;
  l.w1 = l.w0 + nf * (nf + 8) * 2;
  l.w3 = l.w1 + nf * (nf + 8) * 2;
  l.b0 = l.w3 + nf * W3LD * 2;
  l.b1 = l.b0 + nf * 4;
  l.gm = l.b1 + nf * 4;
  l.dog = l.gm + FNPIX * GMP * 2;
  l.dpre = l.dog + NOUT * (nf + 8) * 2;
  l.ph = l.dpre + NOUT * (nf + 8) * 2;
  l.gt = l.ph + FNP * (nf + 8) * 2;
  l.tab = l.gt + FNP * GTLD * 2;
  l.total = l.tab + 128;
  return l;
}

// gelu(v) and gelu'(v) from one erff
__device__ __forceinline__ void gelu_both(float v, float& act, float& grad) {
  const float cdf = 0.5f * (1.f + erff(v * 0.70710678118654752f));
  act = v * cdf;
  grad = cdf + v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// acc (16 x NF) = A (16 x NF, fragments) * B^T, B (NF x NF) in shared memory
// as [n][k] with row pitch ldb bytes; bsm is this lane's ldmatrix address
// (row krow, column kcol) in B's first 16x16 tile.
template <int NKT>
__device__ __forceinline__ void block_product_nt(float (&acc)[2 * NKT][4],
                                                 const uint32_t (&af)[NKT][4],
                                                 uint32_t bsm, int ldb) {
#pragma unroll
  for (int nt = 0; nt < 2 * NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk)
#pragma unroll
    for (int n2 = 0; n2 < NKT; ++n2) {
      uint32_t fb[4];
      ldmatrix_x4(fb, bsm + n2 * 16 * ldb + kk * 32);
      mma_bf16(acc[2 * n2], af[kk], fb[0], fb[1]);
      mma_bf16(acc[2 * n2 + 1], af[kk], fb[2], fb[3]);
    }
}

// A fragments (16 x NF, bf16) -> rows `row0 + g8 (+ 8)` of a [row][col] buffer
template <int NKT>
__device__ __forceinline__ void store_fragments(const uint32_t (&fr)[NKT][4],
                                                bf16* buf, int ld, int row0,
                                                int g8, int t4) {
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(buf + (row0 + g8 + 8 * hr) * ld + kk * 16 +
                                     h * 8 + 2 * t4) = fr[kk][2 * h + hr];
}

template <int NF>
__global__ void __launch_bounds__(BT, 1) tail_band_bwd_kernel(BwdArgs a) {
  constexpr int NKT = NF / 16, YLD = NF + 24, LDB = NF + 8, CV = NF / 8;
  constexpr int NA = (NKT + 1) * NKT;  // units of one stage's dw | db
  constexpr int MAXU = (2 * NA + 2 * NKT + BW - 1) / BW;
  const TailArgs& f = a.f;
  const int s = f.scale, P = s * s, P3 = P * 3, cp = P * NF;
  const int cp0 = s == 4 ? 4 * NF : cp;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
  // the role: phase block blk; x4: stage-0 group grp, stage-1 block jb
  const int blk = blockIdx.x % P, idx = blockIdx.x / P, npr = gridDim.x / P;
  const int grp = blk / 4, jb = blk % 4;
  const int w0col = s == 4 ? grp * NF : blk * NF;

  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout lay = bwd_layout(NF);
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.h);
  bf16* w3s = reinterpret_cast<bf16*>(smem + lay.w3);
  float* b0f = reinterpret_cast<float*>(smem + lay.b0);
  float* b1f = reinterpret_cast<float*>(smem + lay.b1);
  bf16* gms = reinterpret_cast<bf16*>(smem + lay.gm);
  bf16* dogs = reinterpret_cast<bf16*>(smem + lay.dog);
  bf16* dpres = reinterpret_cast<bf16*>(smem + lay.dpre);
  bf16* phs = reinterpret_cast<bf16*>(smem + lay.ph);
  bf16* gts = reinterpret_cast<bf16*>(smem + lay.gt);
  int* tab = reinterpret_cast<int*>(smem + lay.tab);  // [tap]: q*3, yo, xo
  const uint32_t sm0 = smem_u32(smem);

  // once per block: the role's weight slices, w3, the biases, the ones
  // columns and the tap list of its phase block
  for (int i = tid; i < NF * CV; i += BT) {
    const int row = i / CV, v = i % CV;
    cp_async16(sm0 + lay.w0 + (row * LDB + v * 8) * 2,
               f.w0 + (size_t)row * cp0 + w0col + v * 8, 16);
    if (s == 4)
      cp_async16(sm0 + lay.w1 + (row * LDB + v * 8) * 2,
                 f.w1 + (size_t)row * 4 * NF + jb * NF + v * 8, 16);
  }
  cp_async_commit();
  for (int i = tid; i < NF * 32; i += BT) {
    const int ch = i / 32, col = i % 32;
    w3s[ch * W3LD + col] =
        col < 27 ? f.w3[((col / 3) * NF + ch) * 3 + col % 3] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < NF; i += BT) {
    b0f[i] = __bfloat162float(f.b0[w0col + i]);
    b1f[i] = s == 4 ? __bfloat162float(f.b1[jb * NF + i]) : 0.f;
  }
  for (int i = tid; i < NOUT * 16; i += BT) {
    const bf16 v = __float2bfloat16(i % 16 == 0 ? 1.f : 0.f);
    ys[(i / 16) * YLD + NF + i % 16] = v;
    hs[(i / 16) * YLD + NF + i % 16] = v;
  }
  // tap (dr, dc) reads this block of the neighbour at (yo, xo) for exactly
  // one output phase q: GT[s, tap] = gm[s - (yo, xo), q]
  if (tid < 9) {
    const int dr = tid / 3 - 1, dc = tid % 3 - 1;
    int fq = 0, fy = 0, fx = 0;
    for (int q = 0; q < P; ++q) {
      int yo, xo;
      if (tap_source(q / s, q % s, dr, dc, s, yo, xo) == blk) {
        fq = q; fy = yo; fx = xo;
      }
    }
    tab[tid * 3] = fq * 3;
    tab[tid * 3 + 1] = fy;
    tab[tid * 3 + 2] = fx;
  }
  cp_async_wait<0>();
  __syncthreads();

  // this lane's GT columns k = kk*16 + h*8 + 2*t4 + e, packed: the gm column
  // q*3 + c in the low byte, (yo + 1) and (xo + 1) above it; -1 beyond 27
  int gsel[2][2][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = kk * 16 + h * 8 + 2 * t4 + e;
        gsel[kk][h][e] = k < 27 ? (tab[(k / 3) * 3] + k % 3) |
                                      ((tab[(k / 3) * 3 + 1] + 1) << 8) |
                                      ((tab[(k / 3) * 3 + 2] + 1) << 12)
                                : -1;
      }

  const int nth = (f.H + FTR - 1) / FTR, ntw = (f.W + FTW - 1) / FTW;
  const int per_img = nth * ntw, ntiles = f.B * per_img;
  float wacc[MAXU][2][4];
#pragma unroll
  for (int i = 0; i < MAXU; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) wacc[i][nt][e] = 0.f;
  const int nB = s == 4 ? NA : 0, nunits = NA + nB + 2 * NKT;

  for (int tile = idx; tile < ntiles; tile += npr) {
    const int b = tile / per_img, rem = tile % per_img;
    const int r0 = (rem / ntw) * FTR, c0 = (rem % ntw) * FTW;
    const bool border = r0 == 0 || c0 == 0 || r0 + FTR >= f.H || c0 + FTW >= f.W;
    __syncthreads();  // the previous tile's buffers are consumed

    // y of the 128 tile pixels (zero off the frame) and the gm halo in bf16
    for (int i = tid; i < NOUT * CV; i += BT) {
      const int row = i / CV, v = i % CV;
      const int Y = r0 + row / FTW, X = c0 + row % FTW;
      const bool ok = Y < f.H && X < f.W;
      const bf16* src = ok ? f.y + (((size_t)b * f.H + Y) * f.W + X) * NF + v * 8 : f.y;
      cp_async16(sm0 + (row * YLD + v * 8) * 2, src, ok ? 16 : 0);
    }
    cp_async_commit();
    if (P3 % 4 == 0) {  // x2, x4: 16-byte loads
      const int nv = P3 / 4;
      for (int i = tid; i < FNPIX * nv; i += BT) {
        const int pix = i / nv, k = (i % nv) * 4;
        const int Y = r0 - 1 + pix / FHW, X = c0 - 1 + pix % FHW;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (Y >= 0 && Y < f.H && X >= 0 && X < f.W)
          v = *reinterpret_cast<const float4*>(
              a.gm + (((size_t)b * f.H + Y) * f.W + X) * P3 + k);
        *reinterpret_cast<uint2*>(gms + pix * GMP + k) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
    } else {
      for (int i = tid; i < FNPIX * P3; i += BT) {
        const int pix = i / P3, k = i % P3;
        const int Y = r0 - 1 + pix / FHW, X = c0 - 1 + pix % FHW;
        float v = 0.f;
        if (Y >= 0 && Y < f.H && X >= 0 && X < f.W)
          v = a.gm[(((size_t)b * f.H + Y) * f.W + X) * P3 + k];
        gms[pix * GMP + k] = __float2bfloat16(v);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // pass 0: the warp's 16 tile pixels; pass 1 (border tiles, warps 0..3):
    // a row tile of the ring slots
    for (int pass = 0; pass < (border && warp < 4 ? 2 : 1); ++pass) {
      const int rt = pass == 0 ? warp : BW + warp;
      // this lane's two rows: halo position, kind (0 interior, 1 owned ring,
      // 2 dead), the edge slice of a ring pixel
      int hy[2], hx[2], kind[2], Yf[2], Xf[2];
      const float* eptr[2] = {nullptr, nullptr};
      float* gptr[2] = {nullptr, nullptr};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int hix = slot_pixel(rt * 16 + g8 + 8 * hr);
        hy[hr] = hix < 0 ? 0 : hix / FHW;
        hx[hr] = hix < 0 ? 0 : hix % FHW;
        const int Y = r0 - 1 + hy[hr], X = c0 - 1 + hx[hr];
        Yf[hr] = Y;
        Xf[hr] = X;
        int cls = 0;
        if (hix < 0 || Y < -1 || Y > f.H || X < -1 || X > f.W) cls = 5;
        else if (Y == -1) cls = 1;
        else if (Y == f.H) cls = 2;
        else if (X == -1) cls = 3;
        else if (X == f.W) cls = 4;
        kind[hr] = 2;
        if (cls == 0) {
          if (pass == 0) kind[hr] = 0;
        } else if (cls != 5) {
          const int Yc = min(max(Y, 0), f.H - 1), Xc = min(max(X, 0), f.W - 1);
          if (Yc >= r0 && Yc < r0 + FTR && Xc >= c0 && Xc < c0 + FTW) {
            kind[hr] = 1;
            const size_t o = cls <= 2 ? ((size_t)b * (f.W + 2) + X + 1) * cp
                                      : ((size_t)b * (f.H + 2) + Y + 1) * cp;
            eptr[hr] = (cls == 1 ? f.top : cls == 2 ? f.bot : cls == 3 ? f.lc : f.rc) + o;
            gptr[hr] = (cls == 1 ? a.dtop : cls == 2 ? a.dbot : cls == 3 ? a.dlc : a.drc) + o;
          }
        }
      }
      const bool ring = border && __any_sync(0xffffffffu, kind[0] == 1 || kind[1] == 1);

      // the recompute in registers: pre0 -> h (x4) -> the phase block, with
      // the GELU' of each stage kept on the accumulator registers
      uint32_t pf[NKT][4];
      float gp0[2 * NKT][4], gpl[2 * NKT][4];  // gelu' of stage 0 (x4), last stage
#pragma unroll
      for (int nt = 0; nt < 2 * NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) gp0[nt][e] = gpl[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pf[kk][r] = 0u;
      if (pass == 0 && !M2T_K2B_OFF(1)) {
        uint32_t yf[NKT][4];
#pragma unroll
        for (int kk = 0; kk < NKT; ++kk)
          ldmatrix_x4(yf[kk], sm0 + ((rt * 16 + lrow) * YLD + kk * 16 + lcol) * 2);
        float acc[2 * NKT][4];
        block_product<NKT>(acc, yf, sm0 + lay.w0 + (lrow * LDB + lcol) * 2, LDB * 2);
        if (s == 4) {
          uint32_t hf[NKT][4];
#pragma unroll
          for (int nt = 0; nt < 2 * NKT; ++nt) {
            const float2 bb = *reinterpret_cast<const float2*>(b0f + nt * 8 + 2 * t4);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float v0, v1;
              gelu_both(acc[nt][2 * hr] + bb.x, v0, gp0[nt][2 * hr]);
              gelu_both(acc[nt][2 * hr + 1] + bb.y, v1, gp0[nt][2 * hr + 1]);
              hf[nt / 2][(nt & 1) * 2 + hr] = pack_bf16(v0, v1);
            }
          }
          store_fragments<NKT>(hf, hs, YLD, rt * 16, g8, t4);
          block_product<NKT>(acc, hf, sm0 + lay.w1 + (lrow * LDB + lcol) * 2, LDB * 2);
        }
        const float* bl = s == 4 ? b1f : b0f;
#pragma unroll
        for (int nt = 0; nt < 2 * NKT; ++nt) {
          const float2 bb = *reinterpret_cast<const float2*>(bl + nt * 8 + 2 * t4);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float v0, v1;
            gelu_both(acc[nt][2 * hr] + bb.x, v0, gpl[nt][2 * hr]);
            gelu_both(acc[nt][2 * hr + 1] + bb.y, v1, gpl[nt][2 * hr + 1]);
            pf[nt / 2][(nt & 1) * 2 + hr] = kind[hr] == 0 ? pack_bf16(v0, v1) : 0u;
          }
        }
      }
      if (ring) {  // ring pixels take the spliced edge values
#pragma unroll
        for (int nt = 0; nt < 2 * NKT; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            if (kind[hr] == 1) {
              const float2 ev = *reinterpret_cast<const float2*>(
                  eptr[hr] + blk * NF + nt * 8 + 2 * t4);
              pf[nt / 2][(nt & 1) * 2 + hr] = pack_bf16(ev.x, ev.y);
            }
      }
      store_fragments<NKT>(pf, phs, LDB, rt * 16, g8, t4);

      // GT of the 16 pixels, gathered from the gm halo into A fragments
      uint32_t gt[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            unsigned short v[2] = {0, 0};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int sel = gsel[kk][h][e];
              const int oy = hy[hr] - (((sel >> 8) & 15) - 1);
              const int ox = hx[hr] - (((sel >> 12) & 15) - 1);
              if (kind[hr] != 2 && sel >= 0 && oy >= 0 && oy < FTR + 2 && ox >= 0 &&
                  ox < FHW && !M2T_K2B_OFF(4))
                v[e] = __bfloat16_as_ushort(gms[(oy * FHW + ox) * GMP + (sel & 255)]);
            }
            gt[kk][2 * h + hr] = (uint32_t)v[0] | ((uint32_t)v[1] << 16);
          }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<uint32_t*>(gts + (rt * 16 + g8 + 8 * hr) * GTLD + kk * 16 +
                                         h * 8 + 2 * t4) = gt[kk][2 * h + hr];

      // d(ph) = GT w3^T, in og's accumulator layout
      float dacc[2 * NKT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[nt][e] = 0.f;
      if (!M2T_K2B_OFF(4)) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int n2 = 0; n2 < NKT; ++n2) {
            uint32_t fb[4];
            ldmatrix_x4(fb, sm0 + lay.w3 + ((n2 * 16 + krow) * W3LD + kk * 16 + kcol) * 2);
            mma_bf16(dacc[2 * n2], gt[kk], fb[0], fb[1]);
            mma_bf16(dacc[2 * n2 + 1], gt[kk], fb[2], fb[3]);
          }
      }
      if (ring) {  // a ring pixel's d(ph) is its edge gradient
#pragma unroll
        for (int nt = 0; nt < 2 * NKT; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            if (kind[hr] == 1)
              *reinterpret_cast<float2*>(gptr[hr] + blk * NF + nt * 8 + 2 * t4) =
                  make_float2(dacc[nt][2 * hr], dacc[nt][2 * hr + 1]);
      }
      if (pass == 1) continue;

      // d(last stage's pre-activation) = d(ph) * gelu', bf16 (zero on rows
      // that are no interior pixel), and down the stages
      uint32_t dl[NKT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * NKT; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          dl[nt / 2][(nt & 1) * 2 + hr] =
              kind[hr] == 0 ? pack_bf16(dacc[nt][2 * hr] * gpl[nt][2 * hr],
                                        dacc[nt][2 * hr + 1] * gpl[nt][2 * hr + 1])
                            : 0u;
      if (s == 4) {
        store_fragments<NKT>(dl, dogs, LDB, rt * 16, g8, t4);
        if (!M2T_K2B_OFF(8))
          block_product_nt<NKT>(dacc, dl, sm0 + lay.w1 + (krow * LDB + kcol) * 2, LDB * 2);
#pragma unroll
        for (int nt = 0; nt < 2 * NKT; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            dl[nt / 2][(nt & 1) * 2 + hr] =
                pack_bf16(dacc[nt][2 * hr] * gp0[nt][2 * hr],
                          dacc[nt][2 * hr + 1] * gp0[nt][2 * hr + 1]);
      }
      store_fragments<NKT>(dl, dpres, LDB, rt * 16, g8, t4);
      // the role's share of dy = d(pre0) w0^T, to its plane
      if (!M2T_K2B_OFF(16)) {
        block_product_nt<NKT>(dacc, dl, sm0 + lay.w0 + (krow * LDB + kcol) * 2, LDB * 2);
        float* plane = a.dy_part + (size_t)blk * f.B * f.H * f.W * NF;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          if (kind[hr] == 0) {
            float* dst = plane + (((size_t)b * f.H + Yf[hr]) * f.W + Xf[hr]) * NF;
#pragma unroll
            for (int nt = 0; nt < 2 * NKT; ++nt)
              *reinterpret_cast<float2*>(dst + nt * 8 + 2 * t4) =
                  make_float2(dacc[nt][2 * hr], dacc[nt][2 * hr + 1]);
          }
      }
    }
    __syncthreads();  // h, d(og), d(pre0), ph and GT of the tile are complete

    // the weight gradients' 16x16 units, accumulated over the block's tiles:
    // [0, NA) the last stage's dw | db = (x4: h, else y)^T d(last pre),
    // [NA, NA + nB) x4's dw0 | db0 share = y^T d(pre0), then dw3 = ph^T GT
    const int k3 = border ? FNP / 16 : NOUT / 16;
#pragma unroll
    for (int i = 0; i < MAXU; ++i) {
      const int u = warp + BW * i;
      if (u >= nunits) continue;
      if (u < NA + nB) {
        if (M2T_K2B_OFF(16)) continue;
        const bool second = u >= NA;
        const int v = second ? u - NA : u, mt = v / NKT, ct = v % NKT;
        const uint32_t hin = sm0 + (s == 4 && !second ? lay.h : 0);
        const uint32_t din = sm0 + (s == 4 && !second ? lay.dog : lay.dpre);
#pragma unroll
        for (int kk = 0; kk < NOUT / 16; ++kk) {
          uint32_t fa[4], fb[4];
          ldmatrix_x4_trans(fa, hin + ((kk * 16 + krow) * YLD + mt * 16 + kcol) * 2);
          ldmatrix_x4_trans(fb, din + ((kk * 16 + lrow) * LDB + ct * 16 + lcol) * 2);
          mma_bf16(wacc[i][0], fa, fb[0], fb[1]);
          mma_bf16(wacc[i][1], fa, fb[2], fb[3]);
        }
      } else {
        if (M2T_K2B_OFF(2)) continue;
        const int v = u - NA - nB, mt = v / 2, ct = v % 2;
        for (int kk = 0; kk < k3; ++kk) {
          uint32_t fa[4], fb[4];
          ldmatrix_x4_trans(fa, sm0 + lay.ph + ((kk * 16 + krow) * LDB + mt * 16 + kcol) * 2);
          ldmatrix_x4_trans(fb, sm0 + lay.gt + ((kk * 16 + lrow) * GTLD + ct * 16 + lcol) * 2);
          mma_bf16(wacc[i][0], fa, fb[0], fb[1]);
          mma_bf16(wacc[i][1], fa, fb[2], fb[3]);
        }
      }
    }
  }

  // one partial a block. partA: batch = x4 ? jb : blk, row = x4 ? grp*npr +
  // idx : idx; partB (x4): batch grp, row jb*npr + idx; part3: row blockIdx.x
  constexpr int WSZ = (NF + 1) * NF;
  float* pa = a.partA + ((size_t)(s == 4 ? jb * 4 * npr + grp * npr : blk * npr) + idx) * WSZ;
  float* pb = a.partB + ((size_t)(grp * 4 * npr + jb * npr) + idx) * WSZ;
  float* p3 = a.part3 + (size_t)blockIdx.x * 27 * NF;
#pragma unroll
  for (int i = 0; i < MAXU; ++i) {
    const int u = warp + BW * i;
    if (u >= nunits) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float val = wacc[i][nt][2 * hr + e];
          if (u < NA + nB) {
            const int v = u >= NA ? u - NA : u;
            const int m = (v / NKT) * 16 + g8 + 8 * hr;
            const int n = (v % NKT) * 16 + nt * 8 + 2 * t4 + e;
            if (m <= NF) (u >= NA ? pb : pa)[m * NF + n] = val;
          } else {
            const int v = u - NA - nB;
            const int ch = (v / 2) * 16 + g8 + 8 * hr;
            const int col = (v % 2) * 16 + nt * 8 + 2 * t4 + e;
            if (col < 27) p3[((col / 3) * NF + ch) * 3 + col % 3] = val;
          }
        }
  }
}

template <int NF>
cudaError_t launch(const BwdArgs& a, int grid, cudaStream_t st) {
  const int smem = bwd_layout(NF).total;
  cudaError_t err = cudaFuncSetAttribute(
      tail_band_bwd_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tail_band_bwd_kernel<NF><<<grid, BT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of pass 0 (which = 0: K2's kernel, at x4, its largest) and
// pass 1 (which = 1) at n_feats nf.
extern "C" int m2t_tail_band_bwd_smem(int nf, int which) {
  return which == 0 ? m2t_tail_band_smem(nf, 4) : bwd_layout(nf).total;
}

// Thread blocks a role of pass 1 gets on this card at this scale (the grid is
// scale^2 roles times this many), or minus a CUDA error.
extern "C" int m2t_tail_band_bwd_blocks(int scale) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int npr = sms / (scale * scale);
  return npr < 1 ? 1 : npr;
}

// partA: (x4 ? 4 : P batches, x4 ? 4*npr : npr rows, (nf+1)*nf); partB: (4,
// 4*npr, (nf+1)*nf), x4 only; part3: (P*npr, 27*nf); dy_part: (P, B, H, W,
// nf); outA, outB: the batches reduced; npr = m2t_tail_band_bwd_blocks(scale).
extern "C" int m2t_tail_band_bwd(
    const void* y, const void* w0, const void* b0, const void* w1,
    const void* b1, const void* w3, const void* lc, const void* rc,
    const void* top, const void* bot, const void* g, void* gm, void* partA,
    void* partB, void* part3, void* dy_part, void* dy, void* outA, void* outB,
    void* dw3, void* dlc, void* drc, void* dtop, void* dbot, int B, int H, int W,
    int nf, int scale, float rgb_range, void* stream) {
  if (scale < 2 || scale > 4 || nf % 16 != 0 || nf < 16 || nf > 64)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.f.y = static_cast<const bf16*>(y);
  a.f.w0 = static_cast<const bf16*>(w0);
  a.f.b0 = static_cast<const bf16*>(b0);
  a.f.w1 = static_cast<const bf16*>(w1);
  a.f.b1 = static_cast<const bf16*>(b1);
  a.f.w3 = static_cast<const bf16*>(w3);
  a.f.lc = static_cast<const float*>(lc);
  a.f.rc = static_cast<const float*>(rc);
  a.f.top = static_cast<const float*>(top);
  a.f.bot = static_cast<const float*>(bot);
  a.f.out = nullptr;
  a.f.B = B; a.f.H = H; a.f.W = W; a.f.nf = nf; a.f.scale = scale;
  a.f.rgb_range = rgb_range;
  a.gm = static_cast<const float*>(gm);
  a.partA = static_cast<float*>(partA);
  a.partB = static_cast<float*>(partB);
  a.part3 = static_cast<float*>(part3);
  a.dy_part = static_cast<float*>(dy_part);
  a.dlc = static_cast<float*>(dlc);
  a.drc = static_cast<float*>(drc);
  a.dtop = static_cast<float*>(dtop);
  a.dbot = static_cast<float*>(dbot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code = M2T_K2B_OFF(64) ? 0
      : m2t_tail_band_gm(y, w0, b0, w1, b1, w3, lc, rc, top, bot, nullptr, g,
                         gm, B, H, W, nf, scale, rgb_range, stream);
  if (code) return code;
  const int P = scale * scale, npr = m2t_tail_band_bwd_blocks(scale);
  if (npr < 0) return -npr;
  const int grid = P * npr;
  cudaError_t err;
  switch (nf / 16) {
    case 1: err = launch<16>(a, grid, st); break;
    case 2: err = launch<32>(a, grid, st); break;
    case 3: err = launch<48>(a, grid, st); break;
    default: err = launch<64>(a, grid, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  if (M2T_K2B_OFF(32)) return 0;
  const long long wsz = (long long)(nf + 1) * nf;
  code = m2t_reduce_batched(partA, scale == 4 ? 4 : P, scale == 4 ? 4 * npr : npr,
                            wsz, outA, stream);
  if (code) return code;
  if (scale == 4) {
    code = m2t_reduce_batched(partB, 4, 4 * npr, wsz, outB, stream);
    if (code) return code;
  }
  code = m2t_reduce_batched(part3, 1, grid, 27LL * nf, dw3, stream);
  if (code) return code;
  return m2t_reduce_batched(dy_part, 1, P, (long long)B * H * W * nf, dy, stream);
}
