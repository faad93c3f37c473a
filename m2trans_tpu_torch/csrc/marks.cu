// Device marks: empty kernels whose names say where the train step is.
//
// A CUDA graph's replay runs its kernels in capture order on one stream, and
// the host cannot see inside it. A mark launched between two stages is
// captured with them, so every replay shows it in a profiler trace under its
// own name (extern "C": the name is not mangled), and the kernels between a
// `_begin` mark and its `_end` mark are that stage's. A mark does nothing: one
// thread, no memory.
//
// m2t_mark(which, stream) launches mark `which`, in the order of
// ops/kernels/marks.py's MARKS.

#include <cuda_runtime.h>

extern "C" __global__ void m2t_mark_semantic_fwd_begin() {}
extern "C" __global__ void m2t_mark_semantic_fwd_end() {}
extern "C" __global__ void m2t_mark_semantic_bwd_begin() {}
extern "C" __global__ void m2t_mark_semantic_bwd_end() {}
extern "C" __global__ void m2t_mark_optimizer_begin() {}
extern "C" __global__ void m2t_mark_optimizer_end() {}

extern "C" int m2t_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: m2t_mark_semantic_fwd_begin<<<1, 1, 0, s>>>(); break;
    case 1: m2t_mark_semantic_fwd_end<<<1, 1, 0, s>>>(); break;
    case 2: m2t_mark_semantic_bwd_begin<<<1, 1, 0, s>>>(); break;
    case 3: m2t_mark_semantic_bwd_end<<<1, 1, 0, s>>>(); break;
    case 4: m2t_mark_optimizer_begin<<<1, 1, 0, s>>>(); break;
    case 5: m2t_mark_optimizer_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
