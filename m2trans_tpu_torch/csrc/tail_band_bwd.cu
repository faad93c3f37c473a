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
// Two passes:
//   pass 0 is K2's own kernel (m2t_tail_band_gm in tail_band.cu) run with
//     the cotangent: it recomputes the pre-clamp outputs exactly as the
//     forward did (so the clip mask is K2's bit for bit) and writes
//     gm = g * [0 <= out <= rgb_range] (f32) — torch.clamp's and
//     jnp.clip's gradient rule;
//   pass 1, this file's kernel, per 4x16 LR tile and per chunk of 4 phase
//     blocks: recomputes the chunk's phase band over the 6x18 halo (WMMA
//     stage products, tail_common.cuh), accumulates dw3 = sum ph * gm straight from K's structure
//     (no dense dK), forms d(phase band) for the LR pixels the tile owns by
//     the transposed structured conv (a 3x3 gm halo suffices), routes the
//     ring pixels' share to the edge gradients, and walks the GELU' and
//     stage transposes back to dy, dw0/db0, dw1/db1.
// Every LR pixel of the frame and of its 1-px ring belongs to exactly one
// tile (the ring to the tile it borders, corners to the corner tile), so dy
// and the edge gradients need no overlap-add. Weight gradients leave as
// per-tile partials and are summed in a fixed order by reduce_rows
// (cftm_branch_bwd.cu): no atomics, runs repeat exactly.
//
// What bounds it on the card: pass 1's stage transposes (~5*nf*4nf MACs
// per LR pixel and phase group at x4) and its shared memory (190,784 bytes
// at nf = 64: the recompute's 109,888 plus the gm halo, one chunk of d(phase band) in
// bf16, the tile's stage-0 rows and the stage-0 adjoint in f32), which
// leaves one block per SM and little L1. Design: once the phase band is
// consumed its buffer stages the chunk's stage weights (read from L2 in
// the inner loops, they made the kernel latency-bound); the three x4
// stage-1 products (og, dw1, dh0) run on the tensor cores through WMMA
// (bf16 in, f32 accumulate, d(phase band) rounded to bf16 as the JAX
// backward rounds it); the structured-conv adjoint, dw3 and the stage-0
// transposes stay on the CUDA cores, each thread owning several channels.
// GELU' uses erff (exact); the JAX backward uses its polynomial erf
// (|difference| <= 1e-4).

#include "tail_common.cuh"

extern "C" int m2t_reduce_rows(const void* part, int n, long long len,
                               void* out, void* stream);
extern "C" int m2t_tail_band_gm(const void* y, const void* w0, const void* b0,
                                const void* w1, const void* b1, const void* w3,
                                const void* lc, const void* rc, const void* top,
                                const void* bot, void* out, const void* g,
                                void* gm, int B, int H, int W, int nf, int scale,
                                float rgb_range, void* stream);
extern "C" int m2t_tail_band_smem(int nf, int scale);

namespace {

using namespace m2t_tail;

constexpr int MAX_DY = 16;  // dy items per thread: 64 * nf / THREADS, nf <= 64
constexpr int MAX_W3 = 2;   // dw3 items (tap, channel pair) a thread: 9 * nf / 2 / THREADS
constexpr int GMS = 48;     // f32 per gm halo row (P*3 <= 48)

struct BwdArgs {
  TailArgs f;                    // K2's operands (out unused)
  const bf16* g;                 // (B, H, W, P*3) cotangent, phase layout
  float* gm;                     // (B, H, W, P*3) clip-masked cotangent
  float* part0;                  // (tiles, nf*cp0 + cp0) dw0 | db0
  float* part1;                  // (tiles*4, nf*4nf + 4nf) dw1 | db1, x4
  float* part3;                  // (tiles, 27*nf) dw3
  float* dy;                     // (B, H, W, nf)
  float *dlc, *drc;              // (B, H+2, P*nf), zeroed by the caller
  float *dtop, *dbot;            // (B, W+2, P*nf)
};

// bf16 row stride of the chunk's d(phase band) and of the staged w1
__host__ __device__ inline int dp_ld(int nf) { return 4 * nf + 8; }

struct BwdLayout {
  size_t gm, dph, hs, dpre, total;
};

// [K2's layout] [gm halo f32] [d(phase band) chunk bf16, NT x dp_ld]
// [the tile's stage-0 rows bf16, NT x a_ld] [d(stage-0) f32, NT x nf]
__host__ __device__ inline BwdLayout bwd_layout(int nf) {
  BwdLayout l;
  l.gm = layout(nf).total;
  l.dph = l.gm + (size_t)NP * GMS * 4;
  l.hs = l.dph + (size_t)TR * TW * dp_ld(nf) * 2;
  l.dpre = l.hs + (size_t)TR * TW * a_ld(nf) * 2;
  l.total = l.dpre + (size_t)TR * TW * nf * 4;
  return l;
}

__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

__device__ __forceinline__ float ldf(const bf16* p) {
  return __bfloat162float(*p);
}


// phase block index -> (pi, pj), the inverse of phase_block
__device__ __forceinline__ void block_phase(int blk, int s, int& pi, int& pj) {
  if (s == 4) {
    const int grp = blk / 4, in = blk % 4;
    pi = (grp / 2) * 2 + in / 2;
    pj = (grp % 2) * 2 + in % 2;
  } else {
    pi = blk / s;
    pj = blk % s;
  }
}

__global__ void __launch_bounds__(THREADS)
tail_band_bwd_kernel(BwdArgs a) {
  const TailArgs& f = a.f;
  const int nf = f.nf, s = f.scale, P = s * s, cp = P * nf;
  const int cp0 = s == 4 ? 4 * nf : cp;
  const int ntw = (f.W + TW - 1) / TW;
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / ntw) * TR, c0 = (blockIdx.x % ntw) * TW;
  const size_t tile = (size_t)b * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(nf);

  const BwdLayout bl = bwd_layout(nf);
  const bf16* ys = reinterpret_cast<const bf16*>(smem);
  const bf16* h0 = reinterpret_cast<const bf16*>(smem + lay.h0);
  const bf16* ph = reinterpret_cast<const bf16*>(smem + lay.ph);  // then w0s/w1s
  const float* w3 = reinterpret_cast<const float*>(smem + lay.w3);
  const int* info = reinterpret_cast<const int*>(smem + lay.info);
  float* gmh = reinterpret_cast<float*>(smem + bl.gm);
  bf16* dph = reinterpret_cast<bf16*>(smem + bl.dph);
  bf16* hs = reinterpret_cast<bf16*>(smem + bl.hs);
  float* dpre = reinterpret_cast<float*>(smem + bl.dpre);
  const int warp = tid / 32, lane = tid % 32;
  float* stg = reinterpret_cast<float*>(smem + lay.stage) + warp * 16 * SLD;
  const int lda = a_ld(nf), ldph = ph_ld(nf), DPL = dp_ld(nf);
  const int NT = TR * TW;
  auto hrow = [](int p) { return (p / TW + 1) * HW_ + p % TW + 1; };

  tile_load(f, lay, smem, b, r0, c0);
  __syncthreads();
  for (int e = tid; e < NP * GMS; e += THREADS) {
    const int pix = e / GMS, k = e % GMS;
    float v = 0.f;
    if (info[pix * 3] == 0 && k < P * 3)
      v = a.gm[(((size_t)b * f.H + info[pix * 3 + 1]) * f.W +
                info[pix * 3 + 2]) * P * 3 + k];
    gmh[e] = v;
  }
  float dyacc[MAX_DY], w3acc[MAX_W3][6];
#pragma unroll
  for (int m = 0; m < MAX_DY; ++m) dyacc[m] = 0.f;
#pragma unroll
  for (int m = 0; m < MAX_W3; ++m)
    for (int u = 0; u < 6; ++u) w3acc[m][u] = 0.f;
  __syncthreads();

  for (int g = 0; g < (P + 3) / 4; ++g) {
    const int nblk = min(4, P - 4 * g), ncol = nblk * nf;
    phase_chunk(f, lay, smem, g, b);
    __syncthreads();

    // dw3[tap][ch][c] += sum over the tile's outputs and phases whose tap
    // reads this chunk: ph[source] * gm; a thread owns one tap and two
    // channels, all three colours
#pragma unroll
    for (int m = 0; m < MAX_W3; ++m) {
      const int item = tid + THREADS * m;
      if (item >= 9 * nf / 2) break;
      const int tap = item / (nf / 2), ch = (item % (nf / 2)) * 2;
      const int dr = tap / 3 - 1, dc = tap % 3 - 1;
      for (int q = 0; q < P; ++q) {
        int yo, xo;
        const int src = tap_source(q / s, q % s, dr, dc, s, yo, xo) - 4 * g;
        if (src < 0 || src >= nblk) continue;
        for (int p = 0; p < NT; ++p) {
          const int hp = hrow(p);
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              ph + (hp + yo * HW_ + xo) * ldph + src * nf + ch));
          const float* gq = gmh + hp * GMS + q * 3;
          for (int c = 0; c < 3; ++c) {
            w3acc[m][c] += v.x * gq[c];
            w3acc[m][3 + c] += v.y * gq[c];
          }
        }
      }
    }

    // d(phase band) of the chunk's blocks at the pixels this tile owns:
    // interior pixels into dph (zero where the tile runs past the frame),
    // ring pixels into the edge gradients. A source block (pi, pj) is read
    // by exactly three (LR offset, tap, phase) triples per axis.
    const int nq4 = nf / 4;  // a thread owns four consecutive channels
    for (int e = tid; e < NPIX * nblk * nq4; e += THREADS) {
      const int pix = e / (nblk * nq4), bc = (e / nq4) % nblk;
      const int ch = (e % nq4) * 4, col = bc * nf + ch;
      const int cls = info[pix * 3], Y = info[pix * 3 + 1], X = info[pix * 3 + 2];
      const int hr = pix / HW_, hc = pix % HW_;
      const bool in_tile = hr >= 1 && hr <= TR && hc >= 1 && hc <= TW;
      const int Yc = min(max(Y, 0), f.H - 1), Xc = min(max(X, 0), f.W - 1);
      const bool owned = cls != 5 && Yc >= r0 && Yc < r0 + TR && Xc >= c0 &&
                         Xc < c0 + TW;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (owned) {
        int pi, pj;
        block_phase(4 * g + bc, s, pi, pj);
        int ro[3], rd[3], ri[3], co[3], cd[3], cj[3], nr = 0, nc = 0;
        for (int o = -1; o <= 1; ++o)
          for (int d = -1; d <= 1; ++d) {
            const int i = pi + o * s - d, j = pj + o * s - d;
            if (i >= 0 && i < s && nr < 3) { ro[nr] = o; rd[nr] = d; ri[nr++] = i; }
            if (j >= 0 && j < s && nc < 3) { co[nc] = o; cd[nc] = d; cj[nc++] = j; }
          }
        for (int u = 0; u < nr; ++u) {
          const int oh = hr - ro[u];
          if (oh < 0 || oh >= TR + 2) continue;
          for (int w = 0; w < nc; ++w) {
            const int ow = hc - co[w];
            if (ow < 0 || ow >= HW_) continue;
            const float* gq = gmh + (oh * HW_ + ow) * GMS + (ri[u] * s + cj[w]) * 3;
            const float4* wt = reinterpret_cast<const float4*>(
                w3 + ((rd[u] + 1) * 3 + cd[w] + 1) * nf * 3 + ch * 3);
            const float4 w0 = wt[0], w1 = wt[1], w2 = wt[2];
            const float g0 = gq[0], g1 = gq[1], g2 = gq[2];
            v[0] += g0 * w0.x + g1 * w0.y + g2 * w0.z;
            v[1] += g0 * w0.w + g1 * w1.x + g2 * w1.y;
            v[2] += g0 * w1.z + g1 * w1.w + g2 * w2.x;
            v[3] += g0 * w2.y + g1 * w2.z + g2 * w2.w;
          }
        }
        const size_t chn = (size_t)(4 * g + bc) * nf + ch;
        float* edge = cls == 1 ? a.dtop + ((size_t)b * (f.W + 2) + X + 1) * cp
                    : cls == 2 ? a.dbot + ((size_t)b * (f.W + 2) + X + 1) * cp
                    : cls == 3 ? a.dlc + ((size_t)b * (f.H + 2) + Y + 1) * cp
                    : cls == 4 ? a.drc + ((size_t)b * (f.H + 2) + Y + 1) * cp
                               : nullptr;
        if (edge)
          for (int d = 0; d < 4; ++d) edge[chn + d] = v[d];
      }
      if (in_tile)
        for (int d = 0; d < 4; ++d)
          dph[((hr - 1) * TW + hc - 1) * DPL + col + d] =
              __float2bfloat16(cls == 0 ? v[d] : 0.f);
    }
    __syncthreads();

    // The phase band is consumed: its buffer now stages this chunk's stage
    // weights: w0's columns of the chunk (rows padded by one word, so that
    // column walks are free of bank conflicts) and at x4 all of w1 (rows
    // padded for the tensor cores), with the tile's stage-0 rows copied
    // out of the halo into rows the tensor cores can load.
    const int col0 = s == 4 ? g * nf : 4 * g * nf;  // first w0 column
    const int nc0 = s == 4 ? nf : ncol;             // w0 columns of the chunk
    const int ld0s = nc0 + 2, ld1s = DPL;
    bf16* w0s = reinterpret_cast<bf16*>(smem + lay.ph);
    bf16* w1s = w0s + nf * ld0s;  // 32-byte aligned: nf is a multiple of 16
    for (int e = tid; e < nf * nc0; e += THREADS)
      w0s[(e / nc0) * ld0s + e % nc0] = f.w0[(e / nc0) * cp0 + col0 + e % nc0];
    if (s == 4) {
      for (int e = tid; e < nf * 4 * nf; e += THREADS)
        w1s[(e / (4 * nf)) * ld1s + e % (4 * nf)] = f.w1[e];
      for (int e = tid; e < NT * nf; e += THREADS)
        hs[(e / nf) * lda + e % nf] = h0[hrow(e / nf) * lda + e % nf];
    }
    __syncthreads();

    if (s == 4) {
      // d(og) = dph * gelu'(og), og = hs w1 + b1 on the tensor cores, to
      // bf16 in place (the JAX backward rounds d(og) to bf16 too)
      for (int t = warp; t < (NT / 16) * (4 * nf / 16); t += WARPS) {
        const int rt = t / (4 * nf / 16), ct = t % (4 * nf / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < nf / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, hs + rt * 16 * lda + kk * 16, lda);
          wmma::load_matrix_sync(fb, w1s + kk * 16 * ld1s + ct * 16, ld1s);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(stg, acc, SLD, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int p = rt * 16 + e / 16, n = ct * 16 + e % 16;
          bf16* d = dph + p * DPL + n;
          *d = __float2bfloat16(ldf(d) * gelu_grad(stg[(e / 16) * SLD + e % 16] +
                                                   ldf(f.b1 + n)));
        }
        __syncwarp();
      }
      __syncthreads();
      // on the tensor cores: dw1 = hs^T d(og) straight into this group's
      // partial, and dh0 = d(og) w1^T with dpre0 = dh0 * gelu'(y w0 + b0)
      float* p1 = a.part1 + (tile * 4 + g) * (size_t)(nf * 4 * nf + 4 * nf);
      const int n1 = (nf / 16) * (4 * nf / 16), n2 = (NT / 16) * (nf / 16);
      for (int t = warp; t < n1 + n2; t += WARPS) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        if (t < n1) {
          const int rt = t / (4 * nf / 16), ct = t % (4 * nf / 16);
          for (int kk = 0; kk < NT / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, hs + kk * 16 * lda + rt * 16, lda);
            wmma::load_matrix_sync(fb, dph + kk * 16 * DPL + ct * 16, DPL);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(p1 + rt * 16 * 4 * nf + ct * 16, acc, 4 * nf,
                                  wmma::mem_row_major);
        } else {
          const int rt = (t - n1) / (nf / 16), ct = (t - n1) % (nf / 16);
          for (int kk = 0; kk < 4 * nf / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, dph + rt * 16 * DPL + kk * 16, DPL);
            wmma::load_matrix_sync(fb, w1s + ct * 16 * ld1s + kk * 16, ld1s);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(stg, acc, SLD, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int p = rt * 16 + e / 16, k = ct * 16 + e % 16;
            const bf16* yr = ys + hrow(p) * lda;
            float pre = ldf(f.b0 + col0 + k);
            for (int j = 0; j < nf; ++j) pre += ldf(yr + j) * ldf(w0s + j * ld0s + k);
            dpre[p * nf + k] = stg[(e / 16) * SLD + e % 16] * gelu_grad(pre);
          }
          __syncwarp();
        }
      }
      for (int n = tid; n < 4 * nf; n += THREADS) {  // db1
        float sum = 0.f;
        for (int p = 0; p < NT; ++p) sum += ldf(dph + p * DPL + n);
        p1[nf * 4 * nf + n] = sum;
      }
    } else {
      // stage 0 is the phase band: d(pre) = dph * gelu'(y w0 + b0), in place
      for (int e = tid; e < NT * ncol; e += THREADS) {
        const int p = e / ncol, n = e % ncol;
        const bf16* yr = ys + hrow(p) * lda;
        float pre = ldf(f.b0 + col0 + n);
        for (int j = 0; j < nf; ++j) pre += ldf(yr + j) * ldf(w0s + j * ld0s + n);
        bf16* d = dph + p * DPL + n;
        *d = __float2bfloat16(ldf(d) * gelu_grad(pre));
      }
    }
    __syncthreads();
    // d(stage-0 pre-activation) at tile pixel p, chunk column n
    auto dstage0 = [&](int p, int n) {
      return s == 4 ? dpre[p * nf + n] : ldf(dph + p * DPL + n);
    };

    // dw0 | db0 of these columns, and dy += d(pre0) w0^T
    float* p0 = a.part0 + tile * (size_t)(nf * cp0 + cp0);
    for (int e = tid; e < nf * nc0 + nc0; e += THREADS) {
      float sum = 0.f;
      if (e < nf * nc0) {
        const int j = e / nc0, n = e % nc0;
        for (int p = 0; p < NT; ++p)
          sum += ldf(ys + hrow(p) * lda + j) * dstage0(p, n);
        p0[j * cp0 + col0 + n] = sum;
      } else {
        const int n = e - nf * nc0;
        for (int p = 0; p < NT; ++p) sum += dstage0(p, n);
        p0[nf * cp0 + col0 + n] = sum;
      }
    }
#pragma unroll
    for (int m = 0; m < MAX_DY; ++m) {
      const int item = tid + THREADS * m;
      if (item >= NT * nf) break;
      const int p = item / nf, j = item % nf;
      float sum = 0.f;
      for (int n = 0; n < nc0; ++n)
        sum += dstage0(p, n) * ldf(w0s + j * ld0s + n);
      dyacc[m] += sum;
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MAX_DY; ++m) {
    const int item = tid + THREADS * m;
    if (item >= NT * nf) break;
    const int p = item / nf, j = item % nf;
    const int Y = r0 + p / TW, X = c0 + p % TW;
    if (Y < f.H && X < f.W)
      a.dy[(((size_t)b * f.H + Y) * f.W + X) * nf + j] = dyacc[m];
  }
#pragma unroll
  for (int m = 0; m < MAX_W3; ++m) {
    const int item = tid + THREADS * m;
    if (item >= 9 * nf / 2) break;
    const int tap = item / (nf / 2), ch = (item % (nf / 2)) * 2;
    float* out = a.part3 + tile * 27 * nf + (tap * nf + ch) * 3;
    for (int u = 0; u < 6; ++u) out[u] = w3acc[m][u];
  }
}

}  // namespace

// Shared memory of pass 0 (which = 0: K2's kernel, at x4, its largest) and
// pass 1 (which = 1) at n_feats nf.
extern "C" int m2t_tail_band_bwd_smem(int nf, int which) {
  return which == 0 ? m2t_tail_band_smem(nf, 4) : (int)bwd_layout(nf).total;
}

extern "C" int m2t_tail_band_bwd(
    const void* y, const void* w0, const void* b0, const void* w1,
    const void* b1, const void* w3, const void* lc, const void* rc,
    const void* top, const void* bot, const void* g, void* gm, void* part0,
    void* part1, void* part3, void* dy, void* dw0b0, void* dw1b1, void* dw3,
    void* dlc, void* drc, void* dtop, void* dbot, int B, int H, int W,
    int nf, int scale, float rgb_range, void* stream) {
  if (scale < 2 || scale > 4 || nf % 16 != 0 || nf > 64)
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
  a.g = static_cast<const bf16*>(g);
  a.gm = static_cast<float*>(gm);
  a.part0 = static_cast<float*>(part0);
  a.part1 = static_cast<float*>(part1);
  a.part3 = static_cast<float*>(part3);
  a.dy = static_cast<float*>(dy);
  a.dlc = static_cast<float*>(dlc);
  a.drc = static_cast<float*>(drc);
  a.dtop = static_cast<float*>(dtop);
  a.dbot = static_cast<float*>(dbot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t s1 = bwd_layout(nf).total;
  int code = m2t_tail_band_gm(y, w0, b0, w1, b1, w3, lc, rc, top, bot, nullptr,
                              g, gm, B, H, W, nf, scale, rgb_range, stream);
  if (code) return code;
  cudaError_t err = cudaFuncSetAttribute(
      tail_band_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((H + TR - 1) / TR) * ((W + TW - 1) / TW);
  dim3 grid(tiles, B);
  tail_band_bwd_kernel<<<grid, THREADS, s1, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int cp0 = scale == 4 ? 4 * nf : scale * scale * nf;
  code = m2t_reduce_rows(part0, tiles * B, (long long)nf * cp0 + cp0,
                             dw0b0, stream);
  if (code) return code;
  if (scale == 4) {
    code = m2t_reduce_rows(part1, tiles * B * 4, (long long)nf * 4 * nf + 4 * nf,
                           dw1b1, stream);
    if (code) return code;
  }
  return m2t_reduce_rows(part3, tiles * B, 27LL * nf, dw3, stream);
}
