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
// w3[dr+1, dc+1], which is exactly K's only non-zero block there. Outside
// the frame the phase band is the phase-remapped HR reflect ring,
// precomputed on 1-px slices (tail_phase.phase_edges) and spliced in.
// GELU is exact (erff).
//
// What bounds it on the card: the exact GELU. At x4 a halo pixel takes
// 112K MACs (stage 0, stage 1 and the phase conv: a few us a tile on the
// tensor cores) and 1,280 erff calls of some 40 instructions each on the
// CUDA cores, several times the tensor cores' time. The memory side is
// nothing: y in, 48 values a pixel out.
//
// Design: a persistent grid of one block an SM that walks 8x16 LR tiles.
// w0, w1, w3 (27 columns tap*3 + colour, padded to 32) and the biases are
// copied into shared memory once per block (cp.async), so no weight
// crosses L2 per tile. A tile's 10x18 halo is 180 pixel rows, padded to
// 192 = 12 m16 row tiles, the 128 tile pixels first and the ring after them
// by kind (slot_pixel). A ring pixel feeds only the phase blocks that face
// the tile (a quarter of them at x4), so the four warps that hold the ring
// skip the rest, products and GELU alike, and the four schedulers of the SM
// get one such warp each. Each of the block's 12 warps owns 16 halo pixels
// and takes them through both stages and the phase conv's contraction on
// mma.sync.m16n8k16 WITHOUT touching shared memory in between: the
// accumulator layout of two neighbouring n8 tiles is the A-fragment layout
// of the next product's k16 step, so bias + GELU + bf16 pack (and, in tiles
// that touch the frame border only, the ring splice) happen in registers
// and feed the next product directly. The phase conv is contracted first,
//   T[pix, blk, tap, c] = bf16(ph[pix, blk, :]) . w3[tap, :, c]   (f32)
// a dense [16 x nf] [nf x 32] product per phase block on the tensor cores,
// and then gathered: every output (pixel, phase, colour) sums its nine
// T values of the neighbouring pixels, in a fixed order (group of blocks,
// then tap; no atomics), so the result does not depend on timing: K2b reads
// its clip mask off this kernel (m2t_tail_band_gm). T goes through shared
// memory one group of 4 phase blocks at a time (84,672 bytes, pixel-minor so
// that stores and gathers are free of bank conflicts), two block barriers a
// group; the 16 output sums of a thread persist in registers across groups
// and leave through a staging tile as 16-byte vectors. The next tile's y
// is in flight (cp.async) while this tile computes. With 12 warps an SM the
// tensor-core products of some warps overlap the GELU of others.
//
// mma.sync with ldmatrix and not wgmma: the products take a fraction of
// the time the GELU takes (the ablation in PERF.md), and wgmma's
// accumulator fragments belong to a warpgroup of 64 rows, which would put
// four times the accumulators (and the erff calls that follow) behind one
// instruction stream; sixteen rows a warp keep every intermediate in
// registers.

// Timing ablation (tools/kernel_ablation.py builds it; results are wrong by
// design): bit 0 the launch alone, bit 1 GELU replaced by the identity,
// bit 2 no stage products, bit 3 no contraction with w3 (no T), bit 4 no
// gather.
#ifndef M2T_K2_ABLATE
#define M2T_K2_ABLATE 0
#endif

#include "tail_chain.cuh"

namespace {

using namespace m2t_tail_chain;  // the tile, its slot order, block_product

constexpr int TCOLS = 27;                 // tap * 3 + colour
constexpr int TLD = FNP + 4;              // T's pixel pitch: 2 * TLD % 32 == 8
constexpr int OPITCH = 49;                // staging pitch, floats per pixel
// gather items (output pixel, phase) of a thread: 128 * 16 over 384 threads
constexpr int GITEMS = (NOUT * 16 + FTHREADS - 1) / FTHREADS;
static_assert(FTHREADS % NOUT == 0, "a thread keeps one pixel over its items");

struct FwdLayout {
  int w0, w1, w3, b0, b1, t, o, tab, total;
};

// [y halo] [w0] [w1, x4] [w3 padded] [b0 f32] [b1 f32, x4] [T of one group]
// [output staging] [tap table]
__host__ __device__ inline FwdLayout fwd_layout(int nf, int scale) {
  const int cp0 = scale == 4 ? 4 * nf : scale * scale * nf;
  FwdLayout l;
  l.w0 = FNP * (nf + 8) * 2;
  l.w1 = l.w0 + nf * (cp0 + 8) * 2;
  l.w3 = l.w1 + (scale == 4 ? nf * (4 * nf + 8) * 2 : 0);
  l.b0 = l.w3 + nf * W3LD * 2;
  l.b1 = l.b0 + cp0 * 4;
  l.t = l.b1 + (scale == 4 ? 4 * nf * 4 : 0);
  l.o = l.t + 4 * TCOLS * TLD * 4;
  l.tab = l.o + NOUT * OPITCH * 4;
  l.total = l.tab + (4 * 16 * 9 + 4 * 16) * 4;
  return l;
}

// Bit blk is set if some output pixel of the tile reads phase block blk of
// halo pixel hix: every block of a tile pixel, of a ring pixel the blocks
// whose phase row / column is the one next to the tile.
__device__ __forceinline__ int needed_blocks(int hix, int s) {
  if (hix < 0) return 0;
  const int hy = hix / FHW, hx = hix % FHW;
  int mask = 0;
  for (int pi = 0; pi < s; ++pi)
    for (int pj = 0; pj < s; ++pj) {
      const bool okr = (hy >= 1 && hy <= FTR) || (hy == 0 && pi == s - 1) ||
                       (hy == FTR + 1 && pi == 0);
      const bool okc = (hx >= 1 && hx <= FTW) || (hx == 0 && pj == s - 1) ||
                       (hx == FTW + 1 && pj == 0);
      if (okr && okc) mask |= 1 << phase_block(pi, pj, s);
    }
  return mask;
}

// The y rows of the tile at (b, r0, c0) -> shared memory in slot order,
// zeros off the frame and in the pad rows.
template <int NF>
__device__ __forceinline__ void load_y(const TailArgs& a, int b, int r0, int c0,
                                       uint32_t dst) {
  constexpr int CV = NF / 8, YLD = NF + 8;
  for (int i = threadIdx.x; i < FNP * CV; i += FTHREADS) {
    const int row = i / CV, v = i % CV;
    const int hix = slot_pixel(row);
    const int Y = r0 - 1 + hix / FHW, X = c0 - 1 + hix % FHW;
    const bool ok = hix >= 0 && Y >= 0 && Y < a.H && X >= 0 && X < a.W;
    const bf16* src =
        ok ? a.y + (((size_t)b * a.H + Y) * a.W + X) * NF + v * 8 : a.y;
    cp_async16(dst + (row * YLD + v * 8) * 2, src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ float act(float v) {
  return (M2T_K2_ABLATE & 2) ? v : gelu(v);
}

// bf16(gelu(acc + bias)) as the A fragments of the next product; with
// `edge`, rows whose class is not 0 take the spliced ring values of channels
// chan0 + column (class 5: zero) instead. Row hr of this lane is g8 + 8*hr;
// a half whose bit in `live` is clear (no output reads it) is left zero.
template <int NKT>
__device__ __forceinline__ void to_fragments(const float (&acc)[2 * NKT][4],
                                             const float* bias, int live,
                                             bool edge,
                                             const int* ecls,
                                             const float* const* eptr,
                                             int chan0, int t4,
                                             uint32_t (&out)[NKT][4]) {
#pragma unroll
  for (int nt = 0; nt < 2 * NKT; ++nt) {
    const int col = nt * 8 + 2 * t4;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (!((live >> hr) & 1)) {  // uniform over the warp
        out[nt / 2][(nt & 1) * 2 + hr] = 0u;
        continue;
      }
      float v0 = act(acc[nt][2 * hr] + bb.x), v1 = act(acc[nt][2 * hr + 1] + bb.y);
      if (edge && ecls[hr] != 0) {
        v0 = v1 = 0.f;
        if (ecls[hr] != 5) {
          const float2 ev =
              *reinterpret_cast<const float2*>(eptr[hr] + chan0 + col);
          v0 = ev.x;
          v1 = ev.y;
        }
      }
      out[nt / 2][(nt & 1) * 2 + hr] = pack_bf16(v0, v1);
    }
  }
}

// g, gm: null for K2 itself; with them the kernel writes, instead of the
// clamped output, K2b's clip-masked cotangent gm = g * [0 <= out <= rgb].
template <int NF>
__global__ void __launch_bounds__(FTHREADS, 1)
tail_band_kernel(TailArgs a, const bf16* g, float* gm) {
  constexpr int NKT = NF / 16, YLD = NF + 8;
  if (M2T_K2_ABLATE & 1) return;
  const int s = a.scale, P = s * s, cp = P * NF;
  const int cp0 = s == 4 ? 4 * NF : cp;
  const int W0B = (cp0 + 8) * 2, W1B = (4 * NF + 8) * 2;  // row pitches, bytes
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);

  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout lay = fwd_layout(NF, s);
  bf16* w3s = reinterpret_cast<bf16*>(smem + lay.w3);
  float* b0f = reinterpret_cast<float*>(smem + lay.b0);
  float* b1f = reinterpret_cast<float*>(smem + lay.b1);
  float* Tc = reinterpret_cast<float*>(smem + lay.t);
  float* obuf = reinterpret_cast<float*>(smem + lay.o);
  int* glist = reinterpret_cast<int*>(smem + lay.tab);  // [group][phase][<= 9]
  int* gcnt = glist + 4 * 16 * 9;                       // [group][phase]
  const uint32_t sm0 = smem_u32(smem);

  const int nth = (a.H + FTR - 1) / FTR, ntw = (a.W + FTW - 1) / FTW;
  const int per_img = nth * ntw, ntiles = a.B * per_img;

  // once per block: the weights, the biases in f32 and the tap table
  for (int i = tid; i < NF * (cp0 / 8); i += FTHREADS) {
    const int row = i / (cp0 / 8), v = i % (cp0 / 8);
    cp_async16(sm0 + lay.w0 + row * W0B + v * 16, a.w0 + (size_t)row * cp0 + v * 8,
               16);
  }
  if (s == 4)
    for (int i = tid; i < NF * (NF / 2); i += FTHREADS) {
      const int row = i / (NF / 2), v = i % (NF / 2);
      cp_async16(sm0 + lay.w1 + row * W1B + v * 16,
                 a.w1 + (size_t)row * 4 * NF + v * 8, 16);
    }
  for (int i = tid; i < NF * 32; i += FTHREADS) {
    const int ch = i / 32, col = i % 32;
    w3s[ch * W3LD + col] = col < TCOLS
                               ? a.w3[((col / 3) * NF + ch) * 3 + col % 3]
                               : __float2bfloat16(0.f);
  }
  for (int i = tid; i < cp0; i += FTHREADS) b0f[i] = __bfloat162float(a.b0[i]);
  if (s == 4)
    for (int i = tid; i < 4 * NF; i += FTHREADS) b1f[i] = __bfloat162float(a.b1[i]);
  // (group of 4 source blocks, output phase) -> the taps that read a block
  // of the group, in tap order: the offset of the tap's T value (colour 0)
  // from the output pixel's own halo slot
  for (int e = tid; e < 4 * 16; e += FTHREADS) {
    const int grp = e / 16, q = e % 16;
    int n = 0;
    if (q < P)
      for (int tap = 0; tap < 9; ++tap) {
        int yo, xo;
        const int blk =
            tap_source(q / s, q % s, tap / 3 - 1, tap % 3 - 1, s, yo, xo);
        if (blk / 4 == grp)
          glist[e * 9 + n++] =
              ((blk % 4) * TCOLS + tap * 3) * TLD + yo * FHW + xo;
      }
    gcnt[e] = n;
  }
  int tile = blockIdx.x;
  if (tile < ntiles) {
    const int rem = tile % per_img;
    load_y<NF>(a, tile / per_img, (rem / ntw) * FTR, (rem % ntw) * FTW, sm0);
  }
  cp_async_commit();

  // gather role: one output pixel, its phases tid / 128 + 3 * item, the
  // three colours of each
  const int po = tid % NOUT, q0 = tid / NOUT;
  const int hp = ((po / FTW) + 1) * FHW + po % FTW + 1;
  const int ngroups = (P + 3) / 4;
  uint32_t sink = 0;

  // this lane's two rows: their halo pixels, and the phase blocks that the
  // 8 rows of each half of the warp's row tile are read for
  int hix[2], need[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    hix[hr] = slot_pixel(warp * 16 + g8 + 8 * hr);
    need[hr] = __reduce_or_sync(0xffffffffu, needed_blocks(hix[hr], s));
  }

  for (; tile < ntiles; tile += gridDim.x) {
    const int b = tile / per_img, rem = tile % per_img;
    const int r0 = (rem / ntw) * FTR, c0 = (rem % ntw) * FTW;
    cp_async_wait<0>();
    __syncthreads();  // y has landed; the previous tile is stored

    uint32_t yf[NKT][4];
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk)
      ldmatrix_x4(yf[kk], sm0 + ((warp * 16 + lrow) * YLD + kk * 16 + lcol) * 2);

    // ring pixels exist only in tiles on the frame border
    const bool border =
        r0 == 0 || c0 == 0 || r0 + FTR >= a.H || c0 + FTW >= a.W;
    int ecls[2] = {0, 0};
    const float* eptr[2] = {nullptr, nullptr};
    if (border) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int Y = r0 - 1 + hix[hr] / FHW, X = c0 - 1 + hix[hr] % FHW;
        int cls = 0;
        if (hix[hr] < 0 || Y < -1 || Y > a.H || X < -1 || X > a.W) cls = 5;
        else if (Y == -1) cls = 1;
        else if (Y == a.H) cls = 2;
        else if (X == -1) cls = 3;
        else if (X == a.W) cls = 4;
        ecls[hr] = cls;
        if (cls == 1 || cls == 2)
          eptr[hr] = (cls == 1 ? a.top : a.bot) +
                     ((size_t)b * (a.W + 2) + X + 1) * cp;
        else if (cls == 3 || cls == 4)
          eptr[hr] = (cls == 3 ? a.lc : a.rc) +
                     ((size_t)b * (a.H + 2) + Y + 1) * cp;
      }
    }

    float oacc[GITEMS][3];
#pragma unroll
    for (int it = 0; it < GITEMS; ++it) oacc[it][0] = oacc[it][1] = oacc[it][2] = 0.f;

    for (int grp = 0; grp < ngroups; ++grp) {
      const int nblk = min(4, P - 4 * grp);
      // halves of this warp's rows that some block of the group is read for
      const int glive = (((need[0] >> (4 * grp)) & 15) ? 1 : 0) |
                        (((need[1] >> (4 * grp)) & 15) ? 2 : 0);
      uint32_t hf[NKT][4];  // x4: bf16(h) of this group, stage 1's A operand
      if (s == 4 && glive) {
        float acc[2 * NKT][4];
        block_product<NKT>(acc, yf,
                           sm0 + lay.w0 + lrow * W0B + (grp * NF + lcol) * 2, W0B);
        to_fragments<NKT>(acc, b0f + grp * NF, glive, false, ecls, eptr, 0, t4, hf);
      }
      for (int j = 0; j < nblk; ++j) {
        const int blk = 4 * grp + j;
        const int live = ((need[0] >> blk) & 1) | (((need[1] >> blk) & 1) << 1);
        if (!live) continue;  // uniform over the warp: a ring warp's other blocks
        float acc[2 * NKT][4];
        uint32_t pf[NKT][4];  // bf16 phase block of these 16 pixels
        if (s == 4) {
          block_product<NKT>(acc, hf,
                             sm0 + lay.w1 + lrow * W1B + (j * NF + lcol) * 2, W1B);
          to_fragments<NKT>(acc, b1f + j * NF, live, border, ecls, eptr, blk * NF,
                            t4, pf);
        } else {
          block_product<NKT>(acc, yf,
                             sm0 + lay.w0 + lrow * W0B + (blk * NF + lcol) * 2, W0B);
          to_fragments<NKT>(acc, b0f + blk * NF, live, border, ecls, eptr, blk * NF,
                            t4, pf);
        }
        if (M2T_K2_ABLATE & 8) {
#pragma unroll
          for (int kk = 0; kk < NKT; ++kk)
            sink ^= pf[kk][0] ^ pf[kk][1] ^ pf[kk][2] ^ pf[kk][3];
          continue;
        }
        // T = phase block . w3 (27 columns in 4 n8 tiles), to shared memory
        float tacc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NKT; ++kk)
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2) {
            uint32_t fb[4];
            ldmatrix_x4_trans(
                fb, sm0 + lay.w3 + ((kk * 16 + lrow) * W3LD + n2 * 16 + lcol) * 2);
            mma_bf16(tacc[2 * n2], pf[kk], fb[0], fb[1]);
            mma_bf16(tacc[2 * n2 + 1], pf[kk], fb[2], fb[3]);
          }
        float* tj = Tc + j * TCOLS * TLD;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * 8 + 2 * t4 + e;
            if (col < TCOLS) {
              if (hix[0] >= 0) tj[col * TLD + hix[0]] = tacc[nt][e];
              if (hix[1] >= 0) tj[col * TLD + hix[1]] = tacc[nt][2 + e];
            }
          }
      }
      __syncthreads();  // the group's T is complete

      // every warp has its y fragments: the next tile's y may land
      if (grp == 0) {
        const int next = tile + gridDim.x;
        if (next < ntiles) {
          const int nrem = next % per_img;
          load_y<NF>(a, next / per_img, (nrem / ntw) * FTR, (nrem % ntw) * FTW, sm0);
        }
        cp_async_commit();
      }

      // gather this group's share of the nine-term sums, in table order
      if (!(M2T_K2_ABLATE & 16)) {
#pragma unroll
        for (int it = 0; it < GITEMS; ++it) {
          const int q = q0 + (FTHREADS / NOUT) * it;  // uniform over a warp
          if (q < P) {
            const int n = gcnt[grp * 16 + q];
            const int* l = glist + (grp * 16 + q) * 9;
            for (int k = 0; k < n; ++k) {
              const float* tv = Tc + l[k] + hp;
              oacc[it][0] += tv[0];
              oacc[it][1] += tv[TLD];
              oacc[it][2] += tv[2 * TLD];
            }
          }
        }
      }
      if (grp == ngroups - 1) {
#pragma unroll
        for (int it = 0; it < GITEMS; ++it) {
          const int q = q0 + (FTHREADS / NOUT) * it;
          if (q < P) {
            float* ob = obuf + po * OPITCH + q * 3;
            ob[0] = oacc[it][0];
            ob[1] = oacc[it][1];
            ob[2] = oacc[it][2];
          }
        }
      }
      __syncthreads();  // T is consumed (and, at the end, the staging is full)
    }

    // clamp and store (or K2b's clip-masked cotangent)
    const int n = P * 3;
    if (s == 4) {
      for (int item = tid; item < NOUT * 6; item += FTHREADS) {
        const int p = item / 6, v = item % 6;
        const int Y = r0 + p / FTW, X = c0 + p % FTW;
        if (Y >= a.H || X >= a.W) continue;
        float vals[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) vals[e] = obuf[p * OPITCH + v * 8 + e];
        const size_t o = (((size_t)b * a.H + Y) * a.W + X) * 48 + v * 8;
        if (gm == nullptr) {
          uint4 ov;
          uint32_t* oe = reinterpret_cast<uint32_t*>(&ov);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oe[e] = pack_bf16(fminf(fmaxf(vals[2 * e], 0.f), a.rgb_range),
                              fminf(fmaxf(vals[2 * e + 1], 0.f), a.rgb_range));
          *reinterpret_cast<uint4*>(a.out + o) = ov;
        } else {
          const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + o));
          const bf16* ge = reinterpret_cast<const bf16*>(&gv);
          float res[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            res[e] = vals[e] >= 0.f && vals[e] <= a.rgb_range
                         ? __bfloat162float(ge[e])
                         : 0.f;
          *reinterpret_cast<float4*>(gm + o) =
              make_float4(res[0], res[1], res[2], res[3]);
          *reinterpret_cast<float4*>(gm + o + 4) =
              make_float4(res[4], res[5], res[6], res[7]);
        }
      }
    } else {
      for (int item = tid; item < NOUT * n; item += FTHREADS) {
        const int p = item / n, k = item % n;
        const int Y = r0 + p / FTW, X = c0 + p % FTW;
        if (Y >= a.H || X >= a.W) continue;
        const float v = obuf[p * OPITCH + k];
        const size_t o = (((size_t)b * a.H + Y) * a.W + X) * n + k;
        if (gm == nullptr)
          a.out[o] = __float2bfloat16(fminf(fmaxf(v, 0.f), a.rgb_range));
        else
          gm[o] = v >= 0.f && v <= a.rgb_range ? __bfloat162float(g[o]) : 0.f;
      }
    }
  }
  if (M2T_K2_ABLATE && a.B < 0) obuf[0] = __uint_as_float(sink);
}

template <int NF>
cudaError_t launch(const TailArgs& a, const bf16* g, float* gm, int grid,
                   cudaStream_t stream) {
  const int smem = fwd_layout(NF, a.scale).total;
  cudaError_t err = cudaFuncSetAttribute(
      tail_band_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tail_band_kernel<NF><<<grid, FTHREADS, smem, stream>>>(a, g, gm);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block at n_feats nf and this scale.
extern "C" int m2t_tail_band_smem(int nf, int scale) {
  return fwd_layout(nf, scale).total;
}

// The LR tile one step of the walk covers: rows (0) or columns (1).
extern "C" int m2t_tail_band_tile(int which) { return which == 0 ? FTR : FTW; }

// K2 with g and gm null; with them, K2b's first pass: the same recompute,
// and gm = g * [0 <= pre-clamp output <= rgb_range] (f32) in place of out.
extern "C" int m2t_tail_band_gm(const void* y, const void* w0, const void* b0,
                                const void* w1, const void* b1, const void* w3,
                                const void* lc, const void* rc, const void* top,
                                const void* bot, void* out, const void* g,
                                void* gm, int B, int H, int W, int nf, int scale,
                                float rgb_range, void* stream) {
  if (scale < 2 || scale > 4 || nf % 16 != 0 || nf < 16 || nf > 64)
    return (int)cudaErrorInvalidValue;
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles =
      (long long)B * ((H + FTR - 1) / FTR) * ((W + FTW - 1) / FTW);
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  const bf16* gp = static_cast<const bf16*>(g);
  float* gmp = static_cast<float*>(gm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nf / 16) {
    case 1: return (int)launch<16>(a, gp, gmp, grid, st);
    case 2: return (int)launch<32>(a, gp, gmp, grid, st);
    case 3: return (int)launch<48>(a, gp, gmp, grid, st);
    default: return (int)launch<64>(a, gp, gmp, grid, st);
  }
}

extern "C" int m2t_tail_band(const void* y, const void* w0, const void* b0,
                             const void* w1, const void* b1, const void* w3,
                             const void* lc, const void* rc, const void* top,
                             const void* bot, void* out, int B, int H, int W,
                             int nf, int scale, float rgb_range,
                             void* stream) {
  return m2t_tail_band_gm(y, w0, b0, w1, b1, w3, lc, rc, top, bot, out, nullptr,
                          nullptr, B, H, W, nf, scale, rgb_range, stream);
}
