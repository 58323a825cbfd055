// Ordered track sum for NVIDIA Hopper (sm_90a), written by hand: the
// finishers' sum of the tracks' post-gain signals in track order.
//
// Replaces, on the card, the eager torch loop of
// whitebox_tpu_torch/ops/mix.py::_ordered_sum (`total = total + y[t]` from
// zeros, one launch a track: 128 launches a chunk of a 128-track session,
// which left the card waiting on the host in the generic finisher's
// 2^18-frame chunks). It is not a TPU kernel: the JAX package's finishers
// sum the tracks inside their XLA programs
// (whitebox_tpu/render/effects_pipeline.py::finish_mix).
//
// What it computes, for a [T, n] f32 input with rows `row_stride` floats
// apart: out[i] = ((0 + y[0][i]) + y[1][i]) + ... + y[T-1][i], one thread a
// column, the rows in order. Every add is __fadd_rn (the build also passes
// --fmad=false), so the result is bit-equal to the torch loop, -0.0, Inf
// and NaN included. Reads are coalesced along the row; the loop loads
// eight rows ahead of the adds to keep loads in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kThreads) ordered_sum_kernel(const float* __restrict__ y, float* __restrict__ out,
                                                               long long T, long long n, long long row_stride) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* p = y + i;
  float acc = 0.0f;
  long long t = 0;
  for (; t + kAhead <= T; t += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) v[k] = __ldg(p + (t + k) * row_stride);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; t < T; ++t) acc = __fadd_rn(acc, __ldg(p + t * row_stride));
  out[i] = acc;
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns cudaErrorInvalidValue
// without launching when an argument is out of range (null pointers; T, n
// >= 1; row_stride >= n; a grid within 2^31 - 1 blocks), else launches on
// `stream` and returns cudaGetLastError(). Does not synchronise and
// allocates nothing.
extern "C" int wb_ordered_sum(const float* y, float* out, long long T, long long n, long long row_stride,
                              void* stream) {
  if (y == nullptr || out == nullptr || T < 1 || n < 1 || row_stride < n) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ordered_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(y, out, T, n, row_stride);
  return (int)cudaGetLastError();
}
