// K1b: the VJP of the fused CFTM wavelet branch (K1), for sm_90a.
//
// Replaces the TPU backward kernels behind cftm_branch_fused's custom_vjp:
// m2trans_tpu/ops/pallas/halo_attn.py _cascade_bwd_kernel (via
// _cascade_bwd_impl) and _cascade_bwd_tile_kernel (via
// _cascade_bwd_tiled_impl); m2trans_tpu/ops/pallas/halo_attn_packed.py
// _packed_bwd_kernel, _packed_bwd_tile_kernel and _packed_front_bwd_kernel.
// All five compute one function; their bands, slabs and lane packing were
// TPU choices.
//
// Given gout = d out (B, H, W, Cb), with the forward of cftm_branch.cu
// recomputed (nothing but its inputs is saved; the same bf16 roundings of
// z, zc, q, k+rel, v and P):
//   dO   = DWT^L(gout)                     (the adjoint of IWT^L)
//   dv   = P^T dO,   dP = dO v^T,   dS = P * (dP - rowsum(dP * P))
//   dq   = dS k,     dk = dS^T q            (q carries C^-0.5)
//   drel_h[r] += dk[slots of window row r, :C/2], drel_w likewise by column
//   dqkv = the per-pixel sum of the <= 4 window contributions (a halo
//          pixel is a key of up to 3 neighbouring windows); pad keys
//          outside the frame are dropped (zc is 0 there)
//   dW   = zc^T dqkv,   dzc = dqkv W^T,   dz = IWT^L(dzc) + gout
//   dx = bf16(dz*s), dx_add = bf16(r*dz), ds = sum dz*x, dt = sum dz
//
// A launch group is three kernels, whatever the body:
//   (a) the attention VJP, a window at a time: the forward recompute up to
//       P, then dP, dS, dq, dv, dk and the window's rel-pos partials. dq
//       (times C^-0.5), dk, dv leave per window in f32: a halo pixel is a
//       key of up to 4 windows, and blocks cannot exchange otherwise;
//   (b) the projection VJP, an 8x8 coarse pixel block at a time: gathers
//       dqkv of its 64 pixels from the windows in a fixed order, then
//       dW's partial zc^T dqkv and dzc = dqkv W^T on the tensor cores, the
//       IWT^L, the residual and the affine's gradients (dx, dx_add, and the
//       block's partial sums of ds and dt);
//   (c) reduce_tree_kernel: every partial (dW over blocks, drel over windows,
//       ds | dt over an image's blocks) summed in one launch in a fixed tree
//       order, many threads a column.
// No atomics on floats anywhere: two runs give the same bits.
//
// What bounded the first version on the card (PERF.md has its ablation): at
// 2 x 96 x 96 a level has 288 / 72 / 18 windows for 132 SMs, one block a
// window; the recompute ran on the general WMMA body; dO and dP went
// through global scratch; (b) gathered element by element with a
// 9-neighbour test each and read W^T as fragments from L2. Bodies, taken by
// shape alone as the forward's (m2t_cftm_branch_bwd_variant names them);
// kernel (a) of base width 16 is in cftm_branch_bwd_attn.cu, the body of
// other widths in cftm_branch_bwd_general.cu (one nvcc each, side by side),
// kernel (b), the reduction and the entry points here:
//
// Base width 16 at L = 0 (C = 16) and L = 1 (C = 64): cftm_bwd_attn_win_kernel,
// a window to a block of four warps, 3 blocks an SM at C = 16. The warp owns
// 16 query rows: its q stays in registers as the A fragments of q k^T (as in
// cftm_window.cuh, whose pieces it shares), the logits, the softmax, dP =
// dO v^T and dS stay on the accumulator registers (row sums by two quad
// shuffles), dq = dS k takes dS from registers; P and dS cross shared
// memory once in bf16 for the transposed products dv = P^T dO and dk = dS^T
// q (ldmatrix.trans), dO = DWT^L(gout) is formed from gout into the room zc
// left, and the rel-pos partials are summed from dk while it is on the chip.
//
// Base width 16 at L = 2 (C = 256): cftm_bwd_attn_c256_kernel, a window to
// a cluster of four CTAs as in the forward, whose steps up to P it runs as
// they are (cftm_c256.cuh). The CTA of rank r owns the coarse channels
// [64r, 64r + 64): it forms its slice of dO, its partial dP = dO v^T over
// those channels goes to the CTA that owns the 16 query rows (distributed
// shared memory, summed in rank order, as the partial logits), which forms
// dS from the f32 P it kept in registers and stores bf16 dS into all four;
// dq, dv, dk of its 64 columns and the rel-pos partials are then local.
//
// (b) at base width 16: cftm_bwd_proj_kernel on mma.sync + ldmatrix, the
// neighbour set of a pixel worked out once (a table in shared memory), the
// gather in 16-byte loads, W through shared memory (cp.async, in flight
// during the gather). At C = 256 an 8x8 block is split over four thread
// blocks by base channel (4 each, all 16 subbands: 64 rows of W and of dW,
// 64 columns of dzc), so 18 windows give 72 blocks and the 96 KB slice of W
// fits beside dqkv.
//
// Every other base width (none on a model path): the first version's two
// kernels, one block a window on WMMA through the steps of cftm_common.cuh,
// with dO and dP in shared memory.
//
// wgmma was not taken: its 64-row tiles fit only the C = 256 projections,
// which the cluster split cuts to 112 x 256 x 192 a CTA behind a chain of
// barriers; what this kernel had to win was idle SMs and round trips
// through global memory, not the tensor cores' rate.

#include "cftm_bwd_common.cuh"

namespace m2t_cftm_bwd {

namespace {

// ---- (c) the reduction ----------------------------------------------------

// out[batch][j] = sum over i < n of part[batch][i][j], as a fixed tree:
// lane sums s_l = sum of the rows i = l (mod 8) in ascending order, then
// ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)).
struct ReduceJob {
  const float* part;
  void* out;
  int nbatch, n, bf16_out;
  long long len;
};
constexpr int RED_COLS = 32, RED_LANES = 8, MAX_JOBS = 3;
struct ReduceJobs {
  ReduceJob j[MAX_JOBS];
  int first_block[MAX_JOBS + 1];
};

inline int reduce_blocks(const ReduceJob& j) {
  return j.nbatch * (int)((j.len + RED_COLS - 1) / RED_COLS);
}

__global__ void __launch_bounds__(RED_COLS * RED_LANES)
reduce_tree_kernel(ReduceJobs js) {
  __shared__ float red[RED_LANES][RED_COLS];
  int k = 0;
  while (k + 1 < MAX_JOBS && (int)blockIdx.x >= js.first_block[k + 1]) ++k;
  const ReduceJob& j = js.j[k];
  const int lb = blockIdx.x - js.first_block[k];
  const int bpb = (int)((j.len + RED_COLS - 1) / RED_COLS);
  const int batch = lb / bpb;
  const long long col = (long long)(lb % bpb) * RED_COLS + threadIdx.x % RED_COLS;
  const int lane = threadIdx.x / RED_COLS;
  float s = 0.f;
  if (col < j.len) {
    const float* p = j.part + (size_t)batch * j.n * j.len + col;
#pragma unroll 8
    for (int i = lane; i < j.n; i += RED_LANES) s += p[(size_t)i * j.len];
  }
  red[lane][threadIdx.x % RED_COLS] = s;
  __syncthreads();
  if (lane == 0 && col < j.len) {
    const int c = threadIdx.x;
    const float v = ((red[0][c] + red[1][c]) + (red[2][c] + red[3][c])) +
                    ((red[4][c] + red[5][c]) + (red[6][c] + red[7][c]));
    const size_t o = (size_t)batch * j.len + col;
    if (j.bf16_out) static_cast<bf16*>(j.out)[o] = __float2bfloat16(v);
    else static_cast<float*>(j.out)[o] = v;
  }
}

cudaError_t launch_reduce(const ReduceJob* jobs, int njobs, cudaStream_t st) {
  ReduceJobs js;
  int total = 0;
  for (int k = 0; k < MAX_JOBS; ++k) {
    js.j[k] = jobs[k < njobs ? k : njobs - 1];
    js.first_block[k] = total;
    if (k < njobs) total += reduce_blocks(jobs[k]);
  }
  js.first_block[MAX_JOBS] = total;
  for (int k = njobs; k < MAX_JOBS; ++k) js.first_block[k] = total;
  if (total == 0) return cudaSuccess;
  reduce_tree_kernel<<<total, RED_COLS * RED_LANES, 0, st>>>(js);
  return cudaGetLastError();
}

// ---- (b) at base width 16 ---------------------------------------------------

namespace bproj {

constexpr int CB = 16;
constexpr int MAXNB = 4;  // windows that hold one pixel as a key

// C coarse channels; the 8x8 block is split over NS thread blocks by base
// channel: block r takes the base channels [r*CBS, (r+1)*CBS) with all their
// subbands, local channel lc = g*CBS + cc <-> coarse channel g*16 + r*CBS + cc.
template <int C, int NS>
struct Cfg {
  static constexpr int L = C == 16 ? 0 : C == 64 ? 1 : 2;
  // threads: at C = 256 the gather is 48 float4 items a thread of 256 and a
  // chain of L2 latencies; twice the threads halve the chain
  static constexpr int NT = C == 256 ? 512 : 256;
  static constexpr int G = C / CB;
  static constexpr int CBS = CB / NS;
  static constexpr int CS = C / NS;
  static constexpr int QL = 3 * C + 8;   // dqkv and W rows, bf16
  static constexpr int ZL = CS + 8;      // zc rows, bf16
  static constexpr int DL = CS + 4;      // dzc rows, f32
  static constexpr int OFF_W = NQ * QL * 2;
  static constexpr int OFF_ZC = OFF_W + CS * QL * 2;
  static constexpr int OFF_DZ = OFF_ZC + NQ * ZL * 2;
  static constexpr int OFF_NB = OFF_DZ + NQ * DL * 4;
  static constexpr int OFF_RED = OFF_NB + NQ * (2 * MAXNB + 1) * 4;
  static constexpr int SMEM = OFF_RED + NQ * CBS * 2 * 4;
  static_assert(OFF_W % 16 == 0 && OFF_ZC % 16 == 0 && OFF_DZ % 16 == 0 &&
                OFF_NB % 16 == 0 && OFF_RED % 16 == 0, "16-byte alignment");
  static_assert(SMEM <= 232448, "fits a block");
  __device__ static __forceinline__ int chan(int lc, int r) {
    return (lc / CBS) * CB + r * CBS + lc % CBS;
  }
};

template <int C, int NS>
__global__ void __launch_bounds__(Cfg<C, NS>::NT) cftm_bwd_proj_kernel(BwdArgs a) {
  using K = Cfg<C, NS>;
  constexpr int NT = K::NT, NW = NT / 32;
  constexpr int L = K::L, S = 1 << L, G = K::G, CBS = K::CBS, CS = K::CS,
                QL = K::QL, ZL = K::ZL, DL = K::DL, C3 = 3 * C;
  if (M2T_K1B_DONE(7)) return;
  const BranchArgs& f = a.f;
  const int nbh = f.H / S / BLOCK, nbw = f.W / S / BLOCK, nblk = nbh * nbw;
  const int b = blockIdx.y, blk = blockIdx.x / NS, r = blockIdx.x % NS;
  const int bi = blk / nbw, bj = blk % nbw;
  const size_t win = (size_t)b * nblk + blk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int lrow = ldm_row(lane), lcol = ldm_col(lane);
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* dqkv = reinterpret_cast<bf16*>(smem);
  bf16* zcs = reinterpret_cast<bf16*>(smem + K::OFF_ZC);
  float* dzc = reinterpret_cast<float*>(smem + K::OFF_DZ);
  int* nb = reinterpret_cast<int*>(smem + K::OFF_NB);
  float* red = reinterpret_cast<float*>(smem + K::OFF_RED);
  const uint32_t q_s = smem_u32(dqkv), w_s = smem_u32(smem + K::OFF_W),
                 z_s = smem_u32(zcs);

  // the block's rows of W, in flight during the gather
  for (int i = tid; i < CS * (C3 / 8); i += NT) {
    const int lc = i / (C3 / 8), v = i % (C3 / 8);
    cp_async16(w_s + (lc * QL + v * 8) * 2,
               f.w + (size_t)K::chan(lc, r) * C3 + v * 8, 16);
  }
  cp_async_commit();

  // per pixel, once: the windows that hold it as a key and its slot there,
  // in the fixed order dy = -1..1, dx = -1..1 (its own window among them)
  if (tid < NQ) {
    const int li = tid / BLOCK, lj = tid % BLOCK;
    int n = 0;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const int nbi = bi + dy, nbj = bj + dx;
        const int wr = 1 + li - BLOCK * dy, wc = 1 + lj - BLOCK * dx;
        if (nbi < 0 || nbi >= nbh || nbj < 0 || nbj >= nbw || wr < 0 || wr > 9 ||
            wc < 0 || wc > 9)
          continue;
        nb[tid * (2 * MAXNB + 1) + 1 + 2 * n] = (b * nblk + nbi * nbw + nbj);
        nb[tid * (2 * MAXNB + 1) + 2 + 2 * n] = win_slot(wr, wc);
        ++n;
      }
    nb[tid * (2 * MAXNB + 1)] = n;
  }

  // zc of the block's 64 pixels, this block's channels, as the forward
  if constexpr (L < 2) {
    if (tid < NQ)
      form_row<L, true>(f, f.x, f.x_sb, f.x_sh, f.x_sw, b, bi * BLOCK + tid / BLOCK,
                        bj * BLOCK + tid % BLOCK, true, zcs + tid * ZL);
  } else {
    static_assert(L < 2 || CBS == 4, "a quarter of the base channels a block");
    if (tid < NQ) {
      float o[4][16];
      dwt2_quarter<true>(f, f.x, f.x_sb, f.x_sh, f.x_sw, b, bi * BLOCK + tid / BLOCK,
                         bj * BLOCK + tid % BLOCK, r, o);
#pragma unroll
      for (int g = 0; g < 16; ++g)
        *reinterpret_cast<uint2*>(zcs + tid * ZL + g * 4) =
            make_uint2(pack_bf16(o[0][g], o[1][g]), pack_bf16(o[2][g], o[3][g]));
    }
  }
  __syncthreads();

  // dqkv: the pixel's dq from its own window, dk | dv summed over its
  // windows in the table's order; 16 bytes a load
  // (a fixed four loads an item, the absent ones predicated off, and four
  // items unrolled: sixteen loads in flight a thread)
#pragma unroll 4
  for (int item = tid; item < NQ * (C3 / 4); item += NT) {
    const int p = item / (C3 / 4), col = (item % (C3 / 4)) * 4;
    const bool own = col < C;
    const float* src = own ? a.dq : col < 2 * C ? a.dk : a.dv;
    const int c = own ? col : col < 2 * C ? col - C : col - 2 * C;
    const int* e = nb + p * (2 * MAXNB + 1);
    const int n = own ? 1 : e[0];
    float4 t[MAXNB];
#pragma unroll
    for (int k = 0; k < MAXNB; ++k) {
      const size_t row = own ? win * NQ + p : (size_t)e[1 + 2 * k] * NKP + e[2 + 2 * k];
      t[k] = k < n ? *reinterpret_cast<const float4*>(src + row * C + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 v = t[0];
#pragma unroll
    for (int k = 1; k < MAXNB; ++k) {
      v.x += t[k].x; v.y += t[k].y; v.z += t[k].z; v.w += t[k].w;
    }
    *reinterpret_cast<uint2*>(dqkv + p * QL + col) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  cp_async_wait<0>();
  __syncthreads();
  if (M2T_K1B_DONE(8)) return;

  // dzc = dqkv W^T over this block's channels (64 x CS, K = 3C), then this
  // block's rows of the dW partial = zc^T dqkv (CS x 3C, K = 64), in 16 x 16
  // units over the warps
  constexpr int NDZ = (NQ / 16) * (CS / 16), NDW = (CS / 16) * (C3 / 16);
  float* dwp = a.dw_part + win * C * C3;
  for (int unit = warp; unit < NDZ + NDW; unit += NW) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (unit < NDZ) {
      const int mt = unit / (CS / 16), ct = unit % (CS / 16);
#pragma unroll 4
      for (int kk = 0; kk < C3 / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldmatrix_x4(fa, q_s + ((mt * 16 + lrow) * QL + kk * 16 + lcol) * 2);
        ldmatrix_x4(fb, w_s + ((ct * 16 + krow) * QL + kk * 16 + kcol) * 2);
        mma_bf16(acc[0], fa, fb[0], fb[1]);
        mma_bf16(acc[1], fa, fb[2], fb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(dzc + (mt * 16 + g8 + hr * 8) * DL + ct * 16 +
                                     nt * 8 + 2 * t4) =
              make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
    } else {
      const int u = unit - NDZ, mt = u / (C3 / 16), ct = u % (C3 / 16);
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        uint32_t fa[4], fb[4];
        ldmatrix_x4_trans(fa, z_s + ((kk * 16 + krow) * ZL + mt * 16 + kcol) * 2);
        ldmatrix_x4_trans(fb, q_s + ((kk * 16 + lrow) * QL + ct * 16 + lcol) * 2);
        mma_bf16(acc[0], fa, fb[0], fb[1]);
        mma_bf16(acc[1], fa, fb[2], fb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(
              dwp + (size_t)K::chan(mt * 16 + g8 + hr * 8, r) * C3 + ct * 16 + nt * 8 +
              2 * t4) = make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
    }
  }
  __syncthreads();

  // dz = IWT^L(dzc) + gout; dx, dx_add and the block's shares of ds and dt,
  // summed over its 64 coarse pixels in order
  for (int item = tid; item < NQ * CBS; item += NT) {
    const int p = item / CBS, cc = item % CBS;
    float o[G];
#pragma unroll
    for (int g = 0; g < G; ++g) o[g] = dzc[p * DL + g * CBS + cc];
    affine_vjp<L>(a, b, bi * BLOCK + p / BLOCK, bj * BLOCK + p % BLOCK, r * CBS + cc,
                  o, red[item * 2], red[item * 2 + 1]);
  }
  __syncthreads();
  if (tid < 2 * CBS) {
    const int which = tid / CBS, cc = tid % CBS;
    float sum = 0.f;
    for (int p = 0; p < NQ; ++p) sum += red[(p * CBS + cc) * 2 + which];
    a.st_part[(win * 2 + which) * CB + r * CBS + cc] = sum;
  }
}

}  // namespace bproj

// ---- launchers ---------------------------------------------------------------

// Which body a shape takes, as the forward: 0 the general one, 1 the cluster
// body (C = 256), 2 and 3 a window to a block of four warps (C = 16, C = 64).
inline int variant_of(int Cb, int levels) {
  if (Cb != 16) return 0;
  return levels == 2 ? 1 : levels == 0 ? 2 : levels == 1 ? 3 : 0;
}

inline bool aligned16(const BwdArgs& a) {
  auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const BranchArgs& f = a.f;
  bool ok = a16(f.x) && a16(f.w) && a16(a.gout) && f.x_sb % 8 == 0 &&
            f.x_sh % 8 == 0 && f.x_sw % 8 == 0 && a16(a.dq) && a16(a.dk) &&
            a16(a.dv) && a16(a.dw_part);
  if (f.xadd)
    ok = ok && a16(f.xadd) && f.a_sb % 8 == 0 && f.a_sh % 8 == 0 && f.a_sw % 8 == 0;
  return ok;
}

template <int C, int NS>
cudaError_t launch_proj(const BwdArgs& a, int nblk, cudaStream_t st) {
  using K = bproj::Cfg<C, NS>;
  cudaError_t err = set_smem(bproj::cftm_bwd_proj_kernel<C, NS>, K::SMEM);
  if (err != cudaSuccess) return err;
  bproj::cftm_bwd_proj_kernel<C, NS><<<dim3(nblk * NS, a.f.B), K::NT, K::SMEM, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const BwdArgs& a, int levels, void* dw, void* drel,
                       void* st_out, cudaStream_t st) {
  if (levels < 0 || levels > 2) return cudaErrorInvalidValue;
  const int S = 1 << levels, Cb = a.f.Cb, C = Cb * S * S;
  const int nblk = (a.f.H / S / BLOCK) * (a.f.W / S / BLOCK);
  cudaError_t err;
  if (variant_of(Cb, levels) == 0) {
    err = launch_general(a, levels, nblk, st);
  } else {
    if (!aligned16(a)) return cudaErrorMisalignedAddress;
    if ((err = launch_attn_b16(a, levels, nblk, st)) != cudaSuccess) return err;
    err = levels == 0   ? launch_proj<16, 1>(a, nblk, st)
          : levels == 1 ? launch_proj<64, 1>(a, nblk, st)
                        : launch_proj<256, 4>(a, nblk, st);
  }
  if (err != cudaSuccess || M2T_K1B_STOP) return err;
  const ReduceJob jobs[3] = {
      {a.dw_part, dw, 1, nblk * a.f.B, 1, (long long)C * 3 * C},
      {a.drel_part, drel, 1, nblk * a.f.B, 0, 10LL * C},
      {a.st_part, st_out, a.f.B, nblk, 0, 2LL * Cb}};
  return launch_reduce(jobs, 3, st);
}

}  // namespace

}  // namespace m2t_cftm_bwd

using namespace m2t_cftm_bwd;

// out[b][j] = sum over i < n of part[(b * n + i) * len + j] (f32), in the
// fixed tree order of reduce_tree_kernel, for nbatch independent sums in one
// launch; K2b's reduction (tail_band_bwd.cu).
extern "C" int m2t_reduce_batched(const void* part, int nbatch, int n,
                                  long long len, void* out, void* stream) {
  const ReduceJob job = {static_cast<const float*>(part), out, nbatch, n, 0, len};
  return (int)launch_reduce(&job, 1, static_cast<cudaStream_t>(stream));
}

// The body K1b launches for (Cb, levels): 0 the general one, 1 the C = 256
// cluster body, 2 / 3 a window to a block of four warps at C = 16 / C = 64.
extern "C" int m2t_cftm_branch_bwd_variant(int Cb, int levels) {
  return variant_of(Cb, levels);
}

// Shared memory of kernel (a) (which = 0) and (b) (which = 1) for (Cb, levels).
extern "C" int m2t_cftm_branch_bwd_smem(int Cb, int levels, int which) {
  switch (variant_of(Cb, levels)) {
    case 0: return general_smem(Cb << (2 * levels), Cb, which);
    case 1: return which == 0 ? attn_b16_smem(levels) : bproj::Cfg<256, 4>::SMEM;
    case 2: return which == 0 ? attn_b16_smem(levels) : bproj::Cfg<16, 1>::SMEM;
    default: return which == 0 ? attn_b16_smem(levels) : bproj::Cfg<64, 1>::SMEM;
  }
}

extern "C" int m2t_cftm_branch_bwd(
    const void* x, const void* xadd, const void* s, const void* t,
    const void* w, const void* relh, const void* relw, const void* gout,
    void* dq, void* dk, void* dv, void* drel_part, void* dw_part, void* st_part,
    void* dx, void* dxadd, void* dw, void* drel, void* st_out, int B, int H,
    int W, int Cb, int levels, long long x_sb, long long x_sh, long long x_sw,
    long long a_sb, long long a_sh, long long a_sw, float r, void* stream) {
  BwdArgs a;
  a.f.x = static_cast<const bf16*>(x);
  a.f.xadd = static_cast<const bf16*>(xadd);
  a.f.s = static_cast<const float*>(s);
  a.f.t = static_cast<const float*>(t);
  a.f.w = static_cast<const bf16*>(w);
  a.f.relh = static_cast<const float*>(relh);
  a.f.relw = static_cast<const float*>(relw);
  a.f.out = nullptr;
  a.f.B = B; a.f.H = H; a.f.W = W; a.f.Cb = Cb;
  a.f.x_sb = x_sb; a.f.x_sh = x_sh; a.f.x_sw = x_sw;
  a.f.a_sb = a_sb; a.f.a_sh = a_sh; a.f.a_sw = a_sw;
  a.f.r = r;
  a.gout = static_cast<const bf16*>(gout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.drel_part = static_cast<float*>(drel_part);
  a.dw_part = static_cast<float*>(dw_part);
  a.st_part = static_cast<float*>(st_part);
  a.dx = static_cast<bf16*>(dx);
  a.dxadd = static_cast<bf16*>(dxadd);
  return (int)launch_bwd(a, levels, dw, drel, st_out,
                         static_cast<cudaStream_t>(stream));
}
