// K4: the lane relayouts, for sm_90a.
//
// Replaces the TPU kernels of m2trans_tpu/ops/pallas/halo_attn_packed.py:
// pack_batch_dma -> _pack_kernel, pack_body_dma -> _pack_body_kernel,
// unpack_body_dma -> _unpack_body_kernel, unpack_batch_dma ->
// _unpack_kernel. They lay g images side by side on the channel axis:
//
//   packed[bp, h, w, k*g*cb + s*cb + c] = image[bp*g + s, h, w, k*cb + c]
//
// for branch k of nb, slot s of g, channel c of cb (pack_batch is nb = 1,
// pack_body nb = 4); unpack is the inverse. bf16, cb a multiple of 8.
//
// What bounds it on the card: bytes, each read once and written once. One
// templated copy kernel: a thread moves one 16-byte vector (8 channels of
// one cb-run) and is indexed by the side it writes, so the writes of a
// warp are contiguous and the reads are contiguous within each cb-run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct RelayoutArgs {
  const uint4* src;
  uint4* dst;
  long long hw;  // pixels per image
  int g, nb, cv; // slots, branches, 16-byte vectors per cb-run
  long long total;  // vectors in the tensor
};

template <bool PACK>
__global__ void __launch_bounds__(256) relayout_kernel(RelayoutArgs a) {
  const long long lanes = (long long)a.nb * a.g * a.cv;  // vectors per packed pixel
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < a.total;
       i += gridDim.x * 256LL) {
    long long bp, pix;
    int k, s, v;
    if (PACK) {  // i walks the packed tensor
      const int lane = (int)(i % lanes);
      const long long pp = i / lanes;
      v = lane % a.cv;
      s = (lane / a.cv) % a.g;
      k = lane / (a.cv * a.g);
      pix = pp % a.hw;
      bp = pp / a.hw;
    } else {     // i walks the image-major tensor
      const int per = a.nb * a.cv;
      const int ch = (int)(i % per);
      const long long pp = i / per;
      v = ch % a.cv;
      k = ch / a.cv;
      pix = pp % a.hw;
      const long long b = pp / a.hw;
      s = (int)(b % a.g);
      bp = b / a.g;
    }
    const long long packed = (bp * a.hw + pix) * lanes +
                             ((long long)k * a.g + s) * a.cv + v;
    const long long image = ((bp * a.g + s) * a.hw + pix) * (a.nb * a.cv) +
                            (long long)k * a.cv + v;
    if (PACK) a.dst[packed] = a.src[image];
    else a.dst[image] = a.src[packed];
  }
}

}  // namespace

// src, dst: bf16 tensors of B*H*W*nb*cb elements; pack != 0 packs
// (B, H, W, nb*cb) -> (B/g, H, W, g*nb*cb), pack == 0 is the inverse.
extern "C" int m2t_relayout(const void* src, void* dst, int B, int H, int W,
                            int g, int nb, int cb, int pack, void* stream) {
  if (g < 1 || nb < 1 || cb < 8 || cb % 8 != 0 || B % g != 0)
    return (int)cudaErrorInvalidValue;
  RelayoutArgs a;
  a.src = static_cast<const uint4*>(src);
  a.dst = static_cast<uint4*>(dst);
  a.hw = (long long)H * W;
  a.g = g; a.nb = nb; a.cv = cb / 8;
  a.total = (long long)B * a.hw * nb * a.cv;
  if (a.total == 0) return 0;
  long long blocks = (a.total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pack) relayout_kernel<true><<<(unsigned)blocks, 256, 0, st>>>(a);
  else relayout_kernel<false><<<(unsigned)blocks, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}
