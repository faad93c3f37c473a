// K1b's kernel (a), the attention VJP a window, at base width 16: a window
// to a block of four warps at C = 16 / C = 64, to a cluster of four CTAs at
// C = 256. cftm_branch_bwd.cu states the function and the design.

#include <cooperative_groups.h>

#include "cftm_bwd_common.cuh"
#include "cftm_c256.cuh"

namespace m2t_cftm_bwd {

namespace {

namespace cg = cooperative_groups;

// ---- (a) at C = 16 / C = 64: a window to a block of four warps ------------

namespace bwin {

using namespace m2t_cftm_win;

constexpr int NT = 128;

template <int C>
struct Cfg {
  static constexpr int L = C == 16 ? 0 : 1;
  static constexpr int LD = C + 8;       // zc / dO, q, k, v rows, bf16
  static constexpr int WLD = 3 * C + 8;  // weight rows, bf16
  static constexpr int PLD = NKP + 8;    // P, dS rows, bf16
  static constexpr int KLD = C + 4;      // dk rows, f32
  static constexpr int OFF_REL = C * WLD * 2;
  static constexpr int OFF_ZC = OFF_REL + 2 * 10 * (C / 2) * 4;  // later dO
  static constexpr int OFF_Q = OFF_ZC + NKP * LD * 2;
  static constexpr int OFF_K = OFF_Q + NQ * LD * 2;
  static constexpr int OFF_V = OFF_K + NKP * LD * 2;
  static constexpr int OFF_P = OFF_V + NKP * LD * 2;
  static constexpr int OFF_DS = OFF_P + NQ * PLD * 2;
  static constexpr int OFF_DK = OFF_DS + NQ * PLD * 2;
  static constexpr int SMEM = OFF_DK + NKP * KLD * 4;
  static_assert(OFF_REL % 16 == 0 && OFF_ZC % 16 == 0 && OFF_Q % 16 == 0 &&
                OFF_K % 16 == 0 && OFF_V % 16 == 0 && OFF_P % 16 == 0 &&
                OFF_DS % 16 == 0 && OFF_DK % 16 == 0, "16-byte alignment");
  static_assert(SMEM <= 232448, "fits a block");
};

template <int C>
__global__ void __launch_bounds__(NT, C == 16 ? 3 : 1)
cftm_bwd_attn_win_kernel(BwdArgs a) {
  using K = Cfg<C>;
  constexpr int L = K::L, S = 1 << L, LD = K::LD, WLD = K::WLD, PLD = K::PLD,
                KLD = K::KLD, C2 = C / 2;
  if (M2T_K1B_DONE(1)) return;
  const BranchArgs& f = a.f;
  const int tid = threadIdx.x, gw = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
  const int Hc = f.H / S, Wc = f.W / S;
  const int nbw = Wc / BLOCK, per_img = (Hc / BLOCK) * nbw;
  const int win = blockIdx.x;
  const int b = win / per_img, bi = (win % per_img) / nbw, bj = win % nbw;
  const float sc = C == 16 ? 0.25f : 0.125f;  // C^-0.5

  extern __shared__ __align__(128) unsigned char smem[];
  float* rel = reinterpret_cast<float*>(smem + K::OFF_REL);
  bf16* zc = reinterpret_cast<bf16*>(smem + K::OFF_ZC);
  bf16* qs = reinterpret_cast<bf16*>(smem + K::OFF_Q);
  bf16* ks = reinterpret_cast<bf16*>(smem + K::OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(smem + K::OFF_V);
  bf16* Ps = reinterpret_cast<bf16*>(smem + K::OFF_P);
  bf16* dSs = reinterpret_cast<bf16*>(smem + K::OFF_DS);
  float* dks = reinterpret_cast<float*>(smem + K::OFF_DK);
  const uint32_t w_s = smem_u32(smem), zc_s = smem_u32(zc), qs_s = smem_u32(qs),
                 ks_s = smem_u32(ks), vs_s = smem_u32(vs), P_s = smem_u32(Ps),
                 dS_s = smem_u32(dSs);

  // the weight (in flight while zc is formed) and the rel-pos tables
  for (int i = tid; i < C * (3 * C / 8); i += NT) {
    const int row = i / (3 * C / 8), v = i % (3 * C / 8);
    cp_async16(w_s + (row * WLD + v * 8) * 2, f.w + (size_t)row * 3 * C + v * 8, 16);
  }
  cp_async_commit();
  for (int i = tid; i < 2 * 10 * C2; i += NT)
    rel[i] = i < 10 * C2 ? f.relh[i] : f.relw[i - 10 * C2];

  // 1. zc of the 112 window slots (pad slots and pixels off the frame zero)
  if (tid < NKP) {
    bool inside = false;
    int cr = 0, cc = 0;
    if (tid < NK) {
      int wr, wc;
      win_coord(tid, wr, wc);
      cr = bi * BLOCK - 1 + wr;
      cc = bj * BLOCK - 1 + wc;
      inside = cr >= 0 && cr < Hc && cc >= 0 && cc < Wc;
    }
    form_row<L, true>(f, f.x, f.x_sb, f.x_sh, f.x_sw, b, cr, cc, inside,
                      zc + tid * LD);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. projection. This warp's 16 query rows of q stay in registers as A
  // fragments and go to shared memory for dk; of k and v it takes the row
  // tiles gw and gw + 4.
  uint32_t qf[C / 16][4];
  {
    uint32_t zf[C / 16][4];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      ldmatrix_x4(zf[kk], zc_s + ((gw * 16 + lrow) * LD + kk * 16 + lcol) * 2);
    float acc[C / 8][4];
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < C / 16; ++n2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, w_s + ((kk * 16 + lrow) * WLD + n2 * 16 + lcol) * 2);
        mma_bf16(acc[2 * n2], zf[kk], fb[0], fb[1]);
        mma_bf16(acc[2 * n2 + 1], zf[kk], fb[2], fb[3]);
      }
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t v = pack_bf16(acc[2 * kk + h][2 * hr] * sc,
                                       acc[2 * kk + h][2 * hr + 1] * sc);
          qf[kk][2 * h + hr] = v;
          *reinterpret_cast<uint32_t*>(qs + (gw * 16 + g8 + 8 * hr) * LD +
                                       (2 * kk + h) * 8 + 2 * t4) = v;
        }
  }
#pragma unroll 1
  for (int mt = gw; mt < NKP / 16; mt += 4) {
    float kacc[C / 8][4], vacc[C / 8][4];
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) kacc[nt][e] = vacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t fa[4];
      ldmatrix_x4(fa, zc_s + ((mt * 16 + lrow) * LD + kk * 16 + lcol) * 2);
#pragma unroll
      for (int n2 = 0; n2 < C / 16; ++n2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, w_s + ((kk * 16 + lrow) * WLD + C + n2 * 16 + lcol) * 2);
        mma_bf16(kacc[2 * n2], fa, fb[0], fb[1]);
        mma_bf16(kacc[2 * n2 + 1], fa, fb[2], fb[3]);
        ldmatrix_x4_trans(fb, w_s + ((kk * 16 + lrow) * WLD + 2 * C + n2 * 16 + lcol) * 2);
        mma_bf16(vacc[2 * n2], fa, fb[0], fb[1]);
        mma_bf16(vacc[2 * n2 + 1], fa, fb[2], fb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int ch = nt * 8 + 2 * t4;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = mt * 16 + g8 + 8 * hr;
        float k0 = kacc[nt][2 * hr], k1 = kacc[nt][2 * hr + 1];
        if (row < NK) {
          const float2 rp = rel_pair<C>(rel, row, ch);
          k0 += rp.x;
          k1 += rp.y;
        }
        *reinterpret_cast<uint32_t*>(ks + row * LD + ch) = pack_bf16(k0, k1);
        *reinterpret_cast<uint32_t*>(vs + row * LD + ch) =
            pack_bf16(vacc[nt][2 * hr], vacc[nt][2 * hr + 1]);
      }
    }
  }
  __syncthreads();  // q, k, v complete; zc is consumed

  // 3. dO = DWT^L(gout) of the 64 query pixels, into zc's rows 0..63
  if (tid < NQ && !M2T_K1B_DONE(2))
    form_row<L, false>(f, a.gout, (long long)f.H * f.W * 16, (long long)f.W * 16, 16,
                       b, bi * BLOCK + tid / BLOCK, bj * BLOCK + tid % BLOCK, true,
                       zc + tid * LD);

  // 4. logits of this warp's 16 query rows and their softmax, in registers
  float s[NKP / 8][4];
#pragma unroll
  for (int nt = 0; nt < NKP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NKP / 16; ++kt)
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t fb[4];
      ldmatrix_x4(fb, ks_s + ((kt * 16 + krow) * LD + kk * 16 + kcol) * 2);
      mma_bf16(s[2 * kt], qf[kk], fb[0], fb[1]);
      mma_bf16(s[2 * kt + 1], qf[kk], fb[2], fb[3]);
    }
  {
    float inv[2];
    softmax_exp(s, t4, inv);
#pragma unroll
    for (int nt = 0; nt < NKP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];  // P, f32
  }
  // bf16(P) to shared memory, for dv = P^T dO
#pragma unroll
  for (int nt = 0; nt < NKP / 8; ++nt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(Ps + (gw * 16 + g8 + 8 * hr) * PLD + nt * 8 + 2 * t4) =
          pack_bf16(s[nt][2 * hr], s[nt][2 * hr + 1]);
  __syncthreads();  // dO and P complete
  if (M2T_K1B_DONE(3)) return;

  // 5. dP = dO v^T, in P's layout
  float dp[NKP / 8][4];
#pragma unroll
  for (int nt = 0; nt < NKP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t fa[4];
    ldmatrix_x4(fa, zc_s + ((gw * 16 + lrow) * LD + kk * 16 + lcol) * 2);
#pragma unroll
    for (int kt = 0; kt < NKP / 16; ++kt) {
      uint32_t fb[4];
      ldmatrix_x4(fb, vs_s + ((kt * 16 + krow) * LD + kk * 16 + kcol) * 2);
      mma_bf16(dp[2 * kt], fa, fb[0], fb[1]);
      mma_bf16(dp[2 * kt + 1], fa, fb[2], fb[3]);
    }
  }
  // 6. dS = P * (dP - rowsum(dP * P)); pad slots have P = 0
  {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NKP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += s[nt][e] * dp[nt][e];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
    }
#pragma unroll
    for (int nt = 0; nt < NKP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - rs[e >> 1]);
  }
  if (M2T_K1B_DONE(4)) {
    float sink = 0.f;
#pragma unroll
    for (int nt = 0; nt < NKP / 8; ++nt) sink += dp[nt][0] + dp[nt][3];
    if (f.B < 0) a.dq[0] = sink;
    return;
  }
  uint32_t dsf[NKP / 16][4];  // bf16(dS) as the A fragments of dS k
#pragma unroll
  for (int kk = 0; kk < NKP / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const uint32_t v = pack_bf16(dp[2 * kk + h][2 * hr], dp[2 * kk + h][2 * hr + 1]);
        dsf[kk][2 * h + hr] = v;
        *reinterpret_cast<uint32_t*>(dSs + (gw * 16 + g8 + 8 * hr) * PLD +
                                     (2 * kk + h) * 8 + 2 * t4) = v;
      }
  if (M2T_K1B_DONE(5)) return;

  // 7. dq = dS k (16 x C), times C^-0.5, to the window's scratch
  {
    float acc[C / 8][4];
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKP / 16; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < C / 16; ++n2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, ks_s + ((kk * 16 + lrow) * LD + n2 * 16 + lcol) * 2);
        mma_bf16(acc[2 * n2], dsf[kk], fb[0], fb[1]);
        mma_bf16(acc[2 * n2 + 1], dsf[kk], fb[2], fb[3]);
      }
    float* dq = a.dq + (size_t)win * NQ * C;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(dq + (gw * 16 + g8 + 8 * hr) * C + nt * 8 + 2 * t4) =
            make_float2(acc[nt][2 * hr] * sc, acc[nt][2 * hr + 1] * sc);
  }
  __syncthreads();  // every warp's rows of P and dS are in shared memory
  if (M2T_K1B_DONE(6)) return;

  // 8. dv = P^T dO and dk = dS^T q, key row tiles gw and gw + 4
#pragma unroll 1
  for (int mt = gw; mt < NKP / 16; mt += 4) {
    float dvacc[C / 8][4], dkacc[C / 8][4];
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dvacc[nt][e] = dkacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk) {
      uint32_t fp[4], fs[4];
      ldmatrix_x4_trans(fp, P_s + ((kk * 16 + krow) * PLD + mt * 16 + kcol) * 2);
      ldmatrix_x4_trans(fs, dS_s + ((kk * 16 + krow) * PLD + mt * 16 + kcol) * 2);
#pragma unroll
      for (int n2 = 0; n2 < C / 16; ++n2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, zc_s + ((kk * 16 + lrow) * LD + n2 * 16 + lcol) * 2);
        mma_bf16(dvacc[2 * n2], fp, fb[0], fb[1]);
        mma_bf16(dvacc[2 * n2 + 1], fp, fb[2], fb[3]);
        ldmatrix_x4_trans(fb, qs_s + ((kk * 16 + lrow) * LD + n2 * 16 + lcol) * 2);
        mma_bf16(dkacc[2 * n2], fs, fb[0], fb[1]);
        mma_bf16(dkacc[2 * n2 + 1], fs, fb[2], fb[3]);
      }
    }
    float* dk = a.dk + (size_t)win * NKP * C;
    float* dv = a.dv + (size_t)win * NKP * C;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = mt * 16 + g8 + 8 * hr, ch = nt * 8 + 2 * t4;
        const float2 kv = make_float2(dkacc[nt][2 * hr], dkacc[nt][2 * hr + 1]);
        *reinterpret_cast<float2*>(dks + row * KLD + ch) = kv;
        if (row < NK) {
          *reinterpret_cast<float2*>(dk + row * C + ch) = kv;
          *reinterpret_cast<float2*>(dv + row * C + ch) =
              make_float2(dvacc[nt][2 * hr], dvacc[nt][2 * hr + 1]);
        }
      }
  }
  __syncthreads();

  // 9. rel-pos partials of this window from dk on the chip: rel_h by window
  // row, rel_w by window column, ten slots each in order
  float* dr = a.drel_part + (size_t)win * 10 * C;
  for (int item = tid; item < 10 * C; item += NT) {
    const int r = item / C, ch = item % C;
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < 10; ++u)
      sum += dks[win_slot(ch < C2 ? r : u, ch < C2 ? u : r) * KLD + ch];
    dr[ch < C2 ? r * C2 + ch : 10 * C2 + r * C2 + ch - C2] = sum;
  }
}

}  // namespace bwin

// ---- (a) at C = 256: a window to a cluster of four CTAs -------------------

namespace bc256 {

using namespace m2t_cftm_c256;

constexpr int KLDF = CL + 4;                      // dk slice rows, f32
constexpr int OFF_DO = SMEM;                      // dO slice, bf16, NQ x QLD
constexpr int OFF_DS = OFF_DO + NQ * QLD * 2;     // dS, bf16, NQ x PLD
constexpr int OFF_DK = OFF_DS + NQ * PLD * 2;     // dk slice, f32, NKP x KLDF
constexpr int BSMEM = OFF_DK + NKP * KLDF * 4;
static_assert(OFF_DO % 16 == 0 && OFF_DS % 16 == 0 && OFF_DK % 16 == 0,
              "16-byte alignment");
static_assert(BSMEM <= 232448, "fits a block");

__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(NT, 1)
cftm_bwd_attn_c256_kernel(BwdArgs a) {
  if (M2T_K1B_DONE(1)) return;
  const BranchArgs& f = a.f;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nbw = f.W / 4 / BLOCK;
  const int wimg = blockIdx.x / SPLIT;
  const int b = blockIdx.y, bi = wimg / nbw, bj = wimg % nbw;
  const size_t win = (size_t)b * (gridDim.x / SPLIT) + wimg;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  extern __shared__ __align__(128) unsigned char smem[];
  float* sp = reinterpret_cast<float*>(smem + OFF_S);
  bf16* dOs = reinterpret_cast<bf16*>(smem + OFF_DO);
  bf16* dSs = reinterpret_cast<bf16*>(smem + OFF_DS);
  float* dks = reinterpret_cast<float*>(smem + OFF_DK);
  const uint32_t sm0 = smem_u32(smem);

  // the forward's steps 0-4: q, k + rel, v slices at OFF_Q / OFF_K / OFF_V,
  // bf16 P of all 64 rows at OFF_P, f32 P of this warp's rows in pk
  if (project_and_partial_logits(f, cluster, rank, b, bi, bj, smem)) return;
  float pk[2][4];
  softmax_own_rows(cluster, rank, smem, pk);

  // dO slice: channel 64*rank + gl*16 + c is subband 4*rank + gl of base
  // channel c. A thread per (query pixel, 4 base channels).
  if (!M2T_K1B_DONE(2)) {
    const int slot = tid / 4, qt = tid % 4;
    float o[4][16];
    dwt2_quarter<false>(f, a.gout, (long long)f.H * f.W * 16, (long long)f.W * 16, 16,
                        b, bi * BLOCK + slot / BLOCK, bj * BLOCK + slot % BLOCK, qt, o);
#pragma unroll
    for (int g = 0; g < 16; ++g)
      if ((g >> 2) == rank)
        *reinterpret_cast<uint2*>(dOs + slot * QLD + (g & 3) * 16 + qt * 4) =
            make_uint2(pack_bf16(o[0][g], o[1][g]), pack_bf16(o[2][g], o[3][g]));
  }
  __syncthreads();
  cluster.sync();  // P has arrived everywhere; every CTA is done with its sp
  if (M2T_K1B_DONE(3)) return;

  // partial dP = dO v^T over this CTA's 64 channels: row tile mt goes to
  // slab `rank` of CTA mt's sp, as the partial logits did
  for (int unit = warp; unit < (NQ / 16) * (NKP / 16); unit += NW) {
    const int mt = unit / (NKP / 16), kt = unit % (NKP / 16);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < CL / 16; ++kk) {
      uint32_t fa[4], fb[4];
      ldmatrix_x4(fa, sm0 + OFF_DO + ((mt * 16 + lrow) * QLD + kk * 16 + lcol) * 2);
      ldmatrix_x4(fb, sm0 + OFF_V + ((kt * 16 + krow) * QLD + kk * 16 + kcol) * 2);
      mma_bf16(acc[0], fa, fb[0], fb[1]);
      mma_bf16(acc[1], fa, fb[2], fb[3]);
    }
    float* slab = cluster.map_shared_rank(sp, mt) + rank * 16 * SLDF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(slab + (g8 + hr * 8) * SLDF + kt * 16 + nt * 8 +
                                   2 * t4) =
            make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
  }
  cluster.sync();  // the four partials of this CTA's 16 rows have arrived

  // dS of this CTA's 16 rows = P * (dP - rowsum(dP * P)), the partials summed
  // in rank order, a lane per 4 keys as in the softmax; bf16 dS to all four
  {
    bf16* ddst[SPLIT];
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) ddst[r] = cluster.map_shared_rank(dSs, r);
#pragma unroll
    for (int it = 0; it < NQ / SPLIT / NW; ++it) {
      const int rl = warp + it * NW;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (lane < NK / 4) {
        float4 s4 = *reinterpret_cast<const float4*>(sp + rl * SLDF + 4 * lane);
#pragma unroll
        for (int r = 1; r < SPLIT; ++r) {
          const float4 o4 = *reinterpret_cast<const float4*>(
              sp + (r * 16 + rl) * SLDF + 4 * lane);
          s4.x += o4.x; s4.y += o4.y; s4.z += o4.z; s4.w += o4.w;
        }
        d[0] = s4.x; d[1] = s4.y; d[2] = s4.z; d[3] = s4.w;
      }
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += pk[it][j] * d[j];
      for (int off = 16; off > 0; off /= 2)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane < NKP / 4) {
        const uint2 dv = make_uint2(
            pack_bf16(pk[it][0] * (d[0] - rs), pk[it][1] * (d[1] - rs)),
            pack_bf16(pk[it][2] * (d[2] - rs), pk[it][3] * (d[3] - rs)));
        const int row = rank * (NQ / SPLIT) + rl;
#pragma unroll
        for (int r = 0; r < SPLIT; ++r)
          *reinterpret_cast<uint2*>(ddst[r] + row * PLD + 4 * lane) = dv;
      }
    }
  }
  cluster.sync();  // every CTA's rows of dS have arrived; no remote access after
  if (M2T_K1B_DONE(5)) return;

  // the products of this CTA's 64 columns, in 16 x 16 units: dq = dS k (16
  // units), then dv = P^T dO and dk = dS^T q (28 each); 9 units a warp
  const float scale = 0.0625f;  // 256^-0.5
  float* dq = a.dq + win * NQ * C + CL * rank;
  float* dk = a.dk + win * NKP * C + CL * rank;
  float* dv = a.dv + win * NKP * C + CL * rank;
  constexpr int NDQ = (NQ / 16) * (CL / 16), NKV = (NKP / 16) * (CL / 16);
  for (int unit = warp; unit < NDQ + (M2T_K1B_DONE(6) ? 0 : 2 * NKV); unit += NW) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (unit < NDQ) {
      const int mt = unit / (CL / 16), ct = unit % (CL / 16);
#pragma unroll
      for (int kk = 0; kk < NKP / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldmatrix_x4(fa, sm0 + OFF_DS + ((mt * 16 + lrow) * PLD + kk * 16 + lcol) * 2);
        ldmatrix_x4_trans(fb, sm0 + OFF_K + ((kk * 16 + lrow) * QLD + ct * 16 + lcol) * 2);
        mma_bf16(acc[0], fa, fb[0], fb[1]);
        mma_bf16(acc[1], fa, fb[2], fb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(dq + (mt * 16 + g8 + hr * 8) * C + ct * 16 +
                                     nt * 8 + 2 * t4) =
              make_float2(acc[nt][2 * hr] * scale, acc[nt][2 * hr + 1] * scale);
    } else {
      const int v = unit - NDQ, which = v / NKV;  // 0 dv, 1 dk
      const int mt = (v % NKV) / (CL / 16), ct = v % (CL / 16);
      const uint32_t a_off = which ? OFF_DS : OFF_P, b_off = which ? OFF_Q : OFF_DO;
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldmatrix_x4_trans(fa, sm0 + a_off + ((kk * 16 + krow) * PLD + mt * 16 + kcol) * 2);
        ldmatrix_x4_trans(fb, sm0 + b_off + ((kk * 16 + lrow) * QLD + ct * 16 + lcol) * 2);
        mma_bf16(acc[0], fa, fb[0], fb[1]);
        mma_bf16(acc[1], fa, fb[2], fb[3]);
      }
      float* dst = which ? dk : dv;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = mt * 16 + g8 + hr * 8, lc = ct * 16 + nt * 8 + 2 * t4;
          const float2 val = make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
          if (which) *reinterpret_cast<float2*>(dks + row * KLDF + lc) = val;
          if (row < NK) *reinterpret_cast<float2*>(dst + row * C + lc) = val;
        }
    }
  }
  __syncthreads();
  if (M2T_K1B_DONE(6)) return;

  // rel-pos partials of this CTA's channels (rel_h for ranks 0, 1, rel_w for
  // ranks 2, 3) from its dk slice, ten slots each in order
  float* dr = a.drel_part + win * 10 * C;
  for (int item = tid; item < 10 * CL; item += NT) {
    const int r = item / CL, lc = item % CL, ch = CL * rank + lc;
    const bool by_row = ch < C / 2;
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < 10; ++u)
      sum += dks[win_slot(by_row ? r : u, by_row ? u : r) * KLDF + lc];
    dr[by_row ? r * (C / 2) + ch : 10 * (C / 2) + r * (C / 2) + ch - C / 2] = sum;
  }
}

}  // namespace bc256

template <int C>
cudaError_t launch_win(const BwdArgs& a, int nblk, cudaStream_t st) {
  using K = bwin::Cfg<C>;
  cudaError_t err = set_smem(bwin::cftm_bwd_attn_win_kernel<C>, K::SMEM);
  if (err != cudaSuccess) return err;
  bwin::cftm_bwd_attn_win_kernel<C><<<nblk * a.f.B, bwin::NT, K::SMEM, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_c256(const BwdArgs& a, int nblk, cudaStream_t st) {
  cudaError_t err = set_smem(bc256::cftm_bwd_attn_c256_kernel, bc256::BSMEM);
  if (err != cudaSuccess) return err;
  bc256::cftm_bwd_attn_c256_kernel<<<dim3(bc256::SPLIT * nblk, a.f.B), bc256::NT,
                                     bc256::BSMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_attn_b16(const BwdArgs& a, int levels, int nblk, cudaStream_t st) {
  switch (levels) {
    case 0: return launch_win<16>(a, nblk, st);
    case 1: return launch_win<64>(a, nblk, st);
    case 2: return launch_c256(a, nblk, st);
    default: return cudaErrorInvalidValue;
  }
}

int attn_b16_smem(int levels) {
  return levels == 0 ? bwin::Cfg<16>::SMEM : levels == 1 ? bwin::Cfg<64>::SMEM
                                                           : bc256::BSMEM;
}

}  // namespace m2t_cftm_bwd
