// K1: the fused CFTM wavelet branch, forward, for sm_90a.
//
// Replaces the TPU kernels of m2trans_tpu/ops/pallas/halo_attn.py
// (_cascade_kernel / _cascade_tile_kernel, reached through
// cftm_branch_fused) and m2trans_tpu/ops/pallas/halo_attn_packed.py
// (_packed_cascade_kernel, _packed_front_kernel): one function, whose
// row bands, column slabs and lane packing were TPU choices.
//
//   z   = bf16((x*s + t) [+ r*x_add])              zero outside the frame
//   zc  = bf16(DWT^L(z))                            Haar, [LL, HL, LH, HH]
//   q   = bf16(zc Wq * C^-0.5)   k = bf16(zc Wk + rel)   v = bf16(zc Wv)
//   o   = softmax_f32(q k^T) v over the 10x10 zero-padded key window of
//         each 8x8 query block (padded keys are 0 + rel, values 0)
//   out = bf16(IWT^L(o) + z)
//
// K1n, the bare wavelet branch (halo_attention_qkv_fused of halo_attn.py:
// _kernel, _tile_kernel, _multiband_kernel), is the same kernel entered
// through m2t_halo_attn_qkv with no affine, no cascade add and no residual:
//   out = bf16(IWT^L(o)),  z = x.
//
// At L=2 the coarse channel index is sb2*4Cb + sb1*Cb + c, the order of two
// stacked haar_dwt calls.
//
// Four bodies, taken by shape alone (m2t_cftm_branch_variant names them).
//
// Cb = 16 at L = 0 (C = 16) and at L = 1 (C = 64), the first two branches of
// the flagship CFTM: cftm_branch_w16_kernel and cftm_branch_w64_kernel in
// cftm_window.cuh, a window to a warp and to a group of four warps, softmax
// on the accumulator registers; that header says what bounds them and what
// the design does about it.
//
// C = Cb * 4^L = 256 with Cb = 16 and L = 2 (the third and fourth branch
// of the flagship CFTM): cftm_branch_c256_kernel. What bounds it on the
// card: operations and the room for them. One window's projection is
// 112 x 256 x 768 MACs, its 256x768 weight is 384 KB against the 227 KB a
// block may hold, and a frame batch has fewer windows than the card has
// SMs (72 at 8 x 96 x 96). Design: a window is split over a thread-block
// cluster of four CTAs of 8 warps, two CTAs to an SM. The CTA of rank r
// projects the whole zc onto the columns [64r, 64r + 64) of q, of k and of v
// (with channel index g*Cb + c these are the subbands g in [4r, 4r + 4) of
// every base channel), and writes the output pixels' channels 4r..4r+3.
// Each CTA
//   1. forms z = bf16(x*s + t [+ r*x_add]) and the whole zc (112 x 256) in
//      one step: a thread per (window slot, 4 base channels) has its 4x4
//      pixels in flight as 8-byte loads, takes the two Haar levels in
//      registers and writes its 16 x 4 values of the slot's zc row; z of
//      the CTA's own 4 channels of the 32x32 query pixels is kept in shared
//      memory for the residual;
//   2. projects zc onto its 256x192 weight slice on mma.sync.m16n8k16, the
//      slice streamed through a ring of three 32-row chunks in shared
//      memory filled by 16-byte cp.async (the first three are in flight
//      while step 1 runs; one block barrier a chunk), operands loaded with
//      ldmatrix; the work is 72 units of 16 rows x 16 columns, 9 a warp,
//      9 ldmatrix for 18 products a k step;
//   3. forms the partial logits q k^T over its 64 channels (64 x 112, f32)
//      and stores row tile m into CTA m's shared memory (distributed shared
//      memory), slab `rank`;
//   4. after a cluster barrier, sums the four partials of its 16 query rows
//      in rank order, takes their softmax and stores the bf16 rows of P
//      into all four CTAs;
//   5. after a cluster barrier, P v over its 64 columns, each value stored
//      into the CTA that owns its base channel;
//   6. after a cluster barrier, the IWT of its 4 base channels, the residual
//      from the kept z, and the output through shared memory as 8-byte
//      vectors (4 channels of a pixel).
// Shared memory is 112,384 bytes a CTA, so that two share an SM: what the
// projection reads gives its room to what follows (zc to q, k, v and the
// incoming P v; the weight ring to the incoming partial logits and P), and
// one more cluster barrier keeps the other CTAs' stores out of a ring that
// is still read.
// Waves: 62 clusters are resident on the card's 132 SMs (measured,
// m2t_cftm_branch_resident), so the 72 windows of 8 x 96 x 96 run in 2
// rounds (1.16), the second of 10 clusters, and the 256 windows of
// 1 x 512 x 512 in 5 (4.13).
// mma.sync with ldmatrix and not wgmma: the products of one CTA are 112
// (not a multiple of 64) x 192 x 256 behind a chain of barriers and take a
// third of a launch by the ablation (PERF.md); what this body had to win
// is the latency of the weight's way from L2 and the idle SMs, which the
// ring and the split answer.
//
// Every other shape (base widths other than 16, none of them on a model
// path): cftm_branch_kernel, one thread block per (image, coarse 8x8 query
// block). It recomputes the q/k/v projection of its 10x10 window (the 100/64
// halo overlap) so that nothing but x, x_add and the output crosses device
// memory. What bounds it on the card: the latency of the weight's WMMA
// fragments from L2 and its six phases between block barriers. The
// projection, q k^T and P v run on the tensor cores through WMMA (bf16 in,
// f32 accumulate), with the weight streamed from L2 tile by tile; the
// window's zc/q/k/v live in shared memory in bf16, with the f32 logits and
// the f32 output overlaid on buffers already consumed; rows padded by 16
// bytes against bank conflicts in the fragment loads. K1b's general body
// recomputes through the same steps (cftm_common.cuh); its bodies of base
// width 16 through the pieces of cftm_window.cuh and the C = 256 steps of
// cftm_c256.cuh, which this file's cluster kernel runs too.
// Softmax, the wavelets and the affine stay on the CUDA cores in f32.

#include <cooperative_groups.h>

#include <stdint.h>

#include "cftm_common.cuh"
#include "mma_ptx.cuh"

// Timing ablation of every body (tools/kernel_ablation.py builds it;
// results are wrong by design): with M2T_K1_STOP = n a window's work ends
// after step n (1 nothing but the launch, 2 zc, 3 projection, 4 (partial)
// logits, 5 softmax, 6 P v).
#ifndef M2T_K1_STOP
#define M2T_K1_STOP 0
#endif

#include "cftm_window.cuh"
#include "cftm_c256.cuh"

#define M2T_K1_RETURN_AT(n)  \
  if (M2T_K1_STOP == (n)) {  \
    cp_async_wait<0>();      \
    return;                  \
  }

namespace {

using namespace m2t_cftm;
using namespace m2t_ptx;
namespace cg = cooperative_groups;

template <int L>
__global__ void __launch_bounds__(THREADS)
cftm_branch_kernel(BranchArgs a) {
  constexpr int S = 1 << L;  // full-res pixels per coarse pixel side
  constexpr int G = S * S;   // subband channels per base channel
  const int Cb = a.Cb, C = Cb * G;
  const int LO = ld_o(C);
  const int Wc = a.W / S;
  const int nbw = Wc / BLOCK;
  const int b = blockIdx.y;
  const int bi = blockIdx.x / nbw, bj = blockIdx.x % nbw;
  const int tid = threadIdx.x, warp = tid / 32;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(C);
  bf16* zc = reinterpret_cast<bf16*>(smem);
  float* sim = reinterpret_cast<float*>(smem);
  bf16* P = reinterpret_cast<bf16*>(smem + lay.p);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.v);
  float* O = reinterpret_cast<float*>(smem + lay.q);
  float* stage = reinterpret_cast<float*>(smem + lay.stage) + warp * 16 * SLD;
  if (M2T_K1_STOP == 1) return;

  // 1. affine + mask + cascade add, DWT^L -> zc (rows >= NK are zero)
  load_zc<L>(a, b, bi, bj, NKP, zc);
  __syncthreads();
  if (M2T_K1_STOP == 2) return;

  // 2. qkv projection on the tensor cores
  project_qkv(a, C, zc, qs, ks, vs, stage);
  __syncthreads();
  if (M2T_K1_STOP == 3) return;

  // 3. logits q k^T (f32) over the padded key slots
  logits(C, qs, ks, sim);
  __syncthreads();
  if (M2T_K1_STOP == 4) return;

  // 4. softmax over the 100 real keys, f32; P in bf16, zero on pad slots
  softmax_rows(sim, P, false);
  __syncthreads();
  if (M2T_K1_STOP == 5) return;

  // 5. O = P v (f32), over q and k which are consumed
  {
    const int LD = ld_bf(C);
    const int qct = C / 16;
    for (int tile = warp; tile < (NQ / 16) * qct; tile += WARPS) {
      const int rt = tile / qct, ct = tile % qct;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < NKP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, P + rt * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, vs + kk * 16 * LD + ct * 16, LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(O + rt * 16 * LO + ct * 16, acc, LO,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  if (M2T_K1_STOP == 6) return;

  // 6. IWT^L + residual z (none for the bare branch), bf16 out
  for (int item = tid; item < NQ * Cb; item += THREADS) {
    const int p = item / Cb, c = item % Cb;
    const int cr = bi * BLOCK + p / BLOCK, cc = bj * BLOCK + p % BLOCK;
    float o[G];
    for (int g = 0; g < G; ++g) o[g] = O[p * LO + g * Cb + c];
    float px[S][S];
    iwt<L>(o, px);
    float sv, tv;
    affine_coef(a, b, c, sv, tv);
    for (int dy = 0; dy < S; ++dy)
      for (int dx = 0; dx < S; ++dx) {
        const int y = cr * S + dy, xx = cc * S + dx;
        const float res = a.s ? affine_z(a, b, y, xx, c, sv, tv) : 0.f;
        a.out[(((size_t)b * a.H + y) * a.W + xx) * Cb + c] =
            __float2bfloat16(px[dy][dx] + res);
      }
  }
}

// ---- the C = 256 body: one window per cluster of four CTAs --------------

namespace c256 {

using namespace m2t_cftm_c256;  // constants, layout and steps 0-4

__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(NT, 2)
cftm_branch_c256_kernel(BranchArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nbw = a.W / 4 / BLOCK;
  const int win = blockIdx.x / SPLIT;
  const int b = blockIdx.y, bi = win / nbw, bj = win % nbw;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);

  extern __shared__ __align__(128) unsigned char smem[];
  float* Oin = reinterpret_cast<float*>(smem + OFF_O);
  bf16* zres = reinterpret_cast<bf16*>(smem + OFF_ZRES);
  const uint32_t sm0 = smem_u32(smem);

  // 0-3. weight ring, z and zc, projection, partial logits (cftm_c256.cuh)
  if (project_and_partial_logits(a, cluster, rank, b, bi, bj, smem)) return;

  // 4. softmax of this CTA's 16 rows, P to all four CTAs
  {
    float pkeep[2][4];
    softmax_own_rows(cluster, rank, smem, pkeep);
  }
  cluster.sync();  // every CTA's rows of P have arrived
  M2T_K1_RETURN_AT(5)

  // 5. O = P v over this CTA's 64 channels (its 4 subbands of all 16 base
  // channels), f32. Column lc is subband 4*rank + lc/16 of base channel
  // lc%16, whose IWT CTA (lc%16)/4 takes: each value goes to that CTA's
  // Oin[query][g*4 + cc] (zc's space) through distributed shared memory.
  {
    for (int unit = warp; unit < (NQ / 16) * (CL / 16); unit += NW) {
      const int mt = unit / (CL / 16), ct = unit % (CL / 16);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < NKP / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldmatrix_x4(fa, sm0 + OFF_P + ((mt * 16 + lrow) * PLD + kk * 16 + lcol) * 2);
        ldmatrix_x4_trans(
            fb, sm0 + OFF_V + ((kk * 16 + lrow) * QLD + ct * 16 + lcol) * 2);
        mma_bf16(acc[0], fa, fb[0], fb[1]);
        mma_bf16(acc[1], fa, fb[2], fb[3]);
      }
      const int g = SUB * rank + ct;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = nt * 8 + 2 * t4;  // base channel of the pair c, c+1
        float* dst = cluster.map_shared_rank(Oin, c / CBL) + g * CBL + c % CBL;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(dst + (mt * 16 + g8 + hr * 8) * OLD) =
              make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
      }
    }
  }
  cluster.sync();  // all 16 subbands of this CTA's channels have arrived
  M2T_K1_RETURN_AT(6)

  // 6. IWT^2 + residual z (none for the bare branch) -> bf16, in place over
  // the kept z; a thread per (coarse query pixel, own base channel)
  for (int item = tid; item < NQ * CBL; item += NT) {
    const int p = item / CBL, cc = item % CBL;
    float o[G], px[4][4];
#pragma unroll
    for (int g = 0; g < G; ++g) o[g] = Oin[p * OLD + g * CBL + cc];
    iwt<2>(o, px);
#pragma unroll
    for (int dy = 0; dy < 4; ++dy)
#pragma unroll
      for (int dx = 0; dx < 4; ++dx) {
        bf16* e = zres + (((p / BLOCK) * 4 + dy) * QPIX + (p % BLOCK) * 4 + dx) *
                             CBL + cc;
        const float res = a.s ? __bfloat162float(*e) : 0.f;
        *e = __float2bfloat16(px[dy][dx] + res);
      }
  }
  __syncthreads();

  // the 32x32 output pixels' channels 4*rank..4*rank+3, 8 bytes each
  for (int pix = tid; pix < QPIX * QPIX; pix += NT) {
    const int y = bi * BLOCK * 4 + pix / QPIX, xx = bj * BLOCK * 4 + pix % QPIX;
    *reinterpret_cast<uint2*>(
        a.out + (((size_t)b * a.H + y) * a.W + xx) * CB + CBL * rank) =
        *reinterpret_cast<const uint2*>(zres + pix * CBL);
  }
}

// Operands the body's vector accesses need beyond the wrapper's checks.
inline bool aligned(const BranchArgs& a) {
  auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool ok = a16(a.x) && a16(a.w) && a16(a.out) && a.x_sb % 8 == 0 &&
            a.x_sh % 8 == 0 && a.x_sw % 8 == 0;
  if (a.xadd)
    ok = ok && a16(a.xadd) && a.a_sb % 8 == 0 && a.a_sh % 8 == 0 &&
         a.a_sw % 8 == 0;
  return ok;
}

// Room for two CTAs of SMEM bytes on an SM.
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      cftm_branch_c256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(cftm_branch_c256_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Clusters of the body that the card holds at once, or minus a CUDA error.
int resident_clusters() {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLIT * 1024, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = SPLIT;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, cftm_branch_c256_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

cudaError_t launch(const BranchArgs& a, cudaStream_t stream) {
  if (!aligned(a)) return cudaErrorMisalignedAddress;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  dim3 grid(SPLIT * (a.H / 4 / BLOCK) * (a.W / 4 / BLOCK), a.B);
  cftm_branch_c256_kernel<<<grid, NT, SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace c256

// ---- the window-per-warp(-group) bodies of cftm_window.cuh ----------------

namespace win = m2t_cftm_win;

template <typename K>
cudaError_t blocks_per_sm(K kernel, int threads, int smem, int& blocks, int& sms) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
}

// Windows of the body for `levels` (0: w16, 1: w64) that the card holds at
// once, or minus a CUDA error.
int resident_windows(int levels) {
  int blocks = 0, sms = 0;
  const cudaError_t err =
      levels == 0 ? blocks_per_sm(win::w16::cftm_branch_w16_kernel, win::w16::NT,
                                  win::w16::SMEM, blocks, sms)
                  : blocks_per_sm(win::w64::cftm_branch_w64_kernel, win::w64::NT,
                                  win::w64::SMEM, blocks, sms);
  if (err != cudaSuccess) return -(int)err;
  return blocks * sms * (levels == 0 ? win::w16::NWARP : win::w64::NG);
}

cudaError_t launch_w16(const BranchArgs& a, cudaStream_t stream) {
  if (!c256::aligned(a)) return cudaErrorMisalignedAddress;
  int blocks = 0, sms = 0;
  cudaError_t err = blocks_per_sm(win::w16::cftm_branch_w16_kernel, win::w16::NT,
                                  win::w16::SMEM, blocks, sms);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorLaunchOutOfResources;
  const long long nwin = (long long)a.B * (a.H / BLOCK) * (a.W / BLOCK);
  const long long want = (nwin + win::w16::NWARP - 1) / win::w16::NWARP;
  const int grid = (int)(want < (long long)blocks * sms ? want : (long long)blocks * sms);
  win::w16::cftm_branch_w16_kernel<<<grid, win::w16::NT, win::w16::SMEM, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_w64(const BranchArgs& a, cudaStream_t stream) {
  if (!c256::aligned(a)) return cudaErrorMisalignedAddress;
  int blocks = 0, sms = 0;
  cudaError_t err = blocks_per_sm(win::w64::cftm_branch_w64_kernel, win::w64::NT,
                                  win::w64::SMEM, blocks, sms);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorLaunchOutOfResources;
  const long long nwin = (long long)a.B * (a.H / 2 / BLOCK) * (a.W / 2 / BLOCK);
  const int grid = (int)(nwin < sms ? nwin : sms);
  win::w64::cftm_branch_w64_kernel<<<grid, win::w64::NT, win::w64::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// Which body a shape takes: 0 the general one, 1 the cluster body (C = 256),
// 2 a window to a warp (C = 16), 3 a window to four warps (C = 64).
inline int variant_of(int Cb, int levels) {
  if (Cb != c256::CB) return 0;
  return levels == 2 ? 1 : levels == 0 ? 2 : levels == 1 ? 3 : 0;
}

template <int L>
cudaError_t launch(const BranchArgs& a, cudaStream_t stream) {
  const int variant = variant_of(a.Cb, L);
  if (variant == 1) return c256::launch(a, stream);
  if (variant == 2) return launch_w16(a, stream);
  if (variant == 3) return launch_w64(a, stream);
  const int S = 1 << L;
  const int C = a.Cb * S * S;
  const size_t smem = layout(C).total;
  cudaError_t err = cudaFuncSetAttribute(
      cftm_branch_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.H / S / BLOCK) * (a.W / S / BLOCK), a.B);
  cftm_branch_kernel<L><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block of the general body at width C.
extern "C" int m2t_cftm_branch_smem(int C) { return (int)layout(C).total; }

// The body K1 / K1n launch for (Cb, levels): 0 the general one, 1 the
// C = 256 cluster body, 2 a window to a warp (C = 16), 3 a window to a group
// of four warps (C = 64).
extern "C" int m2t_cftm_branch_variant(int Cb, int levels) {
  return variant_of(Cb, levels);
}

// Windows that the card holds at once at base width 16: of the w16 body
// (levels 0), of the w64 body (levels 1), clusters of the C = 256 body
// (levels 2); or minus a CUDA error.
extern "C" int m2t_cftm_branch_resident(int levels) {
  return levels == 2 ? c256::resident_clusters() : resident_windows(levels);
}

extern "C" int m2t_cftm_branch(const void* x, const void* xadd, const void* s,
                               const void* t, const void* w, const void* relh,
                               const void* relw, void* out, int B, int H,
                               int W, int Cb, int levels, long long x_sb,
                               long long x_sh, long long x_sw, long long a_sb,
                               long long a_sh, long long a_sw, float r,
                               void* stream) {
  BranchArgs a;
  a.x = static_cast<const bf16*>(x);
  a.xadd = static_cast<const bf16*>(xadd);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.w = static_cast<const bf16*>(w);
  a.relh = static_cast<const float*>(relh);
  a.relw = static_cast<const float*>(relw);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.W = W; a.Cb = Cb;
  a.x_sb = x_sb; a.x_sh = x_sh; a.x_sw = x_sw;
  a.a_sb = a_sb; a.a_sh = a_sh; a.a_sw = a_sw;
  a.r = r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (levels) {
    case 0: return (int)launch<0>(a, st);
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1n: the branch without affine, cascade add and residual (s = t = null).
extern "C" int m2t_halo_attn_qkv(const void* x, const void* w, const void* relh,
                                 const void* relw, void* out, int B, int H,
                                 int W, int Cb, int levels, long long x_sb,
                                 long long x_sh, long long x_sw, void* stream) {
  return m2t_cftm_branch(x, nullptr, nullptr, nullptr, w, relh, relw, out, B,
                         H, W, Cb, levels, x_sb, x_sh, x_sw, x_sb, x_sh, x_sw,
                         0.f, stream);
}
