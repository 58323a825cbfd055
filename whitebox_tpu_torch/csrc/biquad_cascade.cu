// Biquad cascade for NVIDIA Hopper (sm_90a), written by hand: the effect
// finisher's per-row section cascade in "scan" mode.
//
// Replaces, on the card, the eager torch ops of
// whitebox_tpu_torch/render/effects_pipeline.py::_finish_chunk: one
// ops/biquad.py::biquad_scan_batched per section, each a Hillis-Steele
// prefix scan of the affine maps z -> M z + Bv x (16 doubling steps over six
// [B, F] tensors per 65,536-frame chunk). It is not a TPU kernel: the JAX
// package runs that scan as an XLA program (whitebox_tpu/ops/biquad.py
// ::_biquad_scan_eig under render/effects_pipeline.py::finish_mix).
//
// What it computes, for B rows of F frames, each row with its own S sections
// in the eigenbasis form of ops/biquad.py::eig_section_params (params m11,
// m12, m21, m22, bv1, bv2, p11, p12, b0; [9][S][B] row-major), per frame n
// and section s (the input of section s is the output of section s-1):
//   y  = b0*x + (p11*z1 + p12*z2)          z = the section's state after n-1
//   z1 = (m11*z1 + m12*z2) + bv1*x
//   z2 = (m21*z1 + m22*z2) + bv2*x
// from the states state_in [S][B][2], in the eigen coordinates the plain
// scan carries, so the two can hand a stream to each other; state_out gets
// the states after the last frame.
//
// Numerics: every operation is __fmul_rn / __fadd_rn (the build also passes
// --fmad=false), so no FMA contraction. The sums run in another order than
// the Hillis scan's, so the kernel is not bit-equal to its plain version
// (relative RMS ~1e-7 per row, below the 5e-6 the tests hold it to). Each
// section's M is normal in the eigenbasis (a scaled rotation, or diagonal),
// so the f32 recurrence stays well conditioned near the unit circle; the
// companion-form sections (FIR, gain, identity, nearly defective) are
// nilpotent or short-memory. An identity row gives exactly its input.
//
// What bounds it on an H100: bytes. At 128 tracks x 60 s stereo (B = 256,
// F = 2.88 M, S = 3) the function reads 2.95 GB and writes 2.95 GB (1.76 ms
// at 3.35 TB/s); its 15 f32 operations per section and frame are 33 GFLOP
// (0.5 ms at 67 TFLOP/s). A recurrence is sequential in n, so the design
// is a blocked one with a carried state (three launches, one call):
// 1. cascade_blocks<S, false>: one thread per (row, block of L frames) runs
//    the whole cascade from a zero state over its block and keeps only the
//    end state e_b (2S floats). The last block of a row is skipped.
// 2. cascade_carry<S>: one warp per row walks its blocks in order,
//    s_{b+1} = Phi_L s_b + e_b in f64 from s_0 = state_in, where Phi_L is the
//    cascade's 2S x 2S transition over L frames with zero input (computed by
//    the wrapper in f64 from the same f32 parameters, ops/biquad_cuda.py
//    ::cascade_transition), and stores each block's start state in f32.
// 3. cascade_blocks<S, true>: each (row, block) runs again from its true
//    start state and writes y; the last block writes state_out.
// x is read twice and y written once. A thread's frames are a strided
// stream for the memory system (its neighbours run other blocks), so each
// warp moves its 32 sequences through shared memory 32 frames at a time: one
// coalesced 128-byte row per sequence in, each lane walks its own row of
// the 32 x 33 tile (no bank conflicts), and the outputs leave the same way.
// The next tile's 32 loads are issued before the current tile is walked,
// so their latency hides behind the walk even where few warps run (the
// master chain's 2 rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSections = 4;   // sections per launch; the wrapper runs longer chains in groups
constexpr int kParams = 9;        // eig_section_params
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kTile = 32;         // frames a warp stages per sequence and step

// One frame through sections 0..S-1 (the order of the comment at the top).
template <int S>
__device__ __forceinline__ float cascade_frame(const float (&p)[S][kParams], float (&z)[S][2],
                                               float v) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float z1 = z[s][0], z2 = z[s][1];
    const float y = __fadd_rn(__fmul_rn(p[s][8], v), __fadd_rn(__fmul_rn(p[s][6], z1), __fmul_rn(p[s][7], z2)));
    z[s][0] = __fadd_rn(__fadd_rn(__fmul_rn(p[s][0], z1), __fmul_rn(p[s][1], z2)), __fmul_rn(p[s][4], v));
    z[s][1] = __fadd_rn(__fadd_rn(__fmul_rn(p[s][2], z1), __fmul_rn(p[s][3], z2)), __fmul_rn(p[s][5], v));
    v = y;
  }
  return v;
}

// Phases 1 (kWrite false) and 3 (kWrite true). Sequence q = row * per_row +
// b covers frames [b*L, min((b+1)*L, F)) of its row; per_row is nb - 1 in
// phase 1 (the last block's end state is not needed) and nb in phase 3.
template <int S, bool kWrite>
__global__ void __launch_bounds__(kThreads)
cascade_blocks(const float* __restrict__ x, int64_t x_stride, float* __restrict__ y, int B,
               int F, int L, int nb, int per_row, const float* __restrict__ coeffs,
               const float* __restrict__ state_in, const float* __restrict__ starts,
               float* __restrict__ ends, float* __restrict__ state_out) {
  __shared__ float tile[kWarpsPerBlock][kTile][kTile + 1];
  __shared__ int64_t x_at[kWarpsPerBlock][kTile];
  __shared__ int64_t y_at[kWarpsPerBlock][kTile];
  __shared__ int len[kWarpsPerBlock][kTile];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * kTile + lane;
  const bool valid = q < (int64_t)B * per_row;
  const int row = valid ? (int)(q / per_row) : 0;
  const int b = valid ? (int)(q % per_row) : 0;
  const int n = valid ? min(L, F - b * L) : 0;
  x_at[warp][lane] = (int64_t)row * x_stride + (int64_t)b * L;
  y_at[warp][lane] = (int64_t)row * F + (int64_t)b * L;
  len[warp][lane] = n;

  float p[S][kParams];
  float z[S][2];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int j = 0; j < kParams; ++j) p[s][j] = valid ? __ldg(coeffs + ((int64_t)j * S + s) * B + row) : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float z0 = 0.0f;
      if (kWrite && valid)
        z0 = b == 0 ? __ldg(state_in + ((int64_t)s * B + row) * 2 + i)
                    : __ldg(starts + ((int64_t)row * nb + b) * 2 * S + 2 * s + i);
      z[s][i] = z0;
    }
  }
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  __syncwarp();

  float(*t)[kTile + 1] = tile[warp];
  // the next tile's 32 loads are in flight while this tile is walked
  float ahead[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) ahead[j] = lane < len[warp][j] ? x[x_at[warp][j] + lane] : 0.0f;
  for (int n0 = 0; n0 < n_max; n0 += kTile) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) t[j][lane] = ahead[j];
    __syncwarp();
    const int n1 = n0 + kTile;
    if (n1 < n_max) {
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        ahead[j] = n1 + lane < len[warp][j] ? x[x_at[warp][j] + n1 + lane] : 0.0f;
    }
    // the lane's 32 frames into registers, walked there, written back: a
    // walk that reads and writes the tile in place waits on each frame's
    // shared-memory load behind the store before it
    float v[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) v[k] = t[lane][k];
    const int m = n - n0;  // frames of this lane's sequence in the tile (may be <= 0)
    if (m >= kTile) {
#pragma unroll
      for (int k = 0; k < kTile; ++k) v[k] = cascade_frame<S>(p, z, v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        if (k < m) v[k] = cascade_frame<S>(p, z, v[k]);
    }
    if (kWrite) {
#pragma unroll
      for (int k = 0; k < kTile; ++k) t[lane][k] = v[k];
    }
    __syncwarp();
    if (kWrite) {
      for (int j = 0; j < kTile; ++j)
        if (n0 + lane < len[warp][j]) __stcs(y + y_at[warp][j] + n0 + lane, t[j][lane]);
    }
    __syncwarp();
  }
  if (!valid) return;
  if (!kWrite) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ends[((int64_t)row * nb + b) * 2 * S + 2 * s] = z[s][0];
      ends[((int64_t)row * nb + b) * 2 * S + 2 * s + 1] = z[s][1];
    }
  } else if (b == nb - 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      state_out[((int64_t)s * B + row) * 2] = z[s][0];
      state_out[((int64_t)s * B + row) * 2 + 1] = z[s][1];
    }
  }
}

// Phase 2: per row, s_{b+1} = Phi_L s_b + e_b in f64 from s_0 = state_in;
// starts[row][b] = (float) s_b for b = 1..nb-1. Each component sums its
// 2S products in index order, then adds e_b (mirrored by the host model).
// A warp per row: its lanes move 32 blocks' end states at a time through
// shared memory (coalesced both ways) and lane 0 walks them there. With one
// thread per row reading its own end states from device memory, each step
// waited on a load: 1.2 us a step, 0.31 ms a chunk (torch.profiler, H100).
template <int S>
__global__ void __launch_bounds__(kThreads)
cascade_carry(int B, int nb, const double* __restrict__ phi, const float* __restrict__ state_in,
              const float* __restrict__ ends, float* __restrict__ starts) {
  constexpr int D = 2 * S;
  __shared__ float pass[kWarpsPerBlock][kTile * D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= B) return;  // the whole warp: row is the warp's
  float* sh = pass[warp];
  double m[D][D], s[D];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) m[i][j] = phi[((int64_t)row * D + i) * D + j];
      s[i] = (double)state_in[((int64_t)(i >> 1) * B + row) * 2 + (i & 1)];
    }
  }
  const float* e = ends + (int64_t)row * nb * D;
  float* out = starts + (int64_t)row * nb * D;
  for (int b0 = 0; b0 + 1 < nb; b0 += kTile) {
    const int n = min(kTile, nb - 1 - b0) * D;  // floats of the end states carried in this pass
    for (int i = lane; i < n; i += 32) sh[i] = e[(int64_t)b0 * D + i];
    __syncwarp();
    if (lane == 0) {
      for (int k = 0; k < n; k += D) {  // block b0 + k/D: its end state in, the next start out
        double r[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          double acc = __dmul_rn(m[i][0], s[0]);
#pragma unroll
          for (int j = 1; j < D; ++j) acc = __dadd_rn(acc, __dmul_rn(m[i][j], s[j]));
          r[i] = __dadd_rn(acc, (double)sh[k + i]);
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {
          s[i] = r[i];
          sh[k + i] = (float)r[i];
        }
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) out[(int64_t)(b0 + 1) * D + i] = sh[i];
    __syncwarp();
  }
}

template <int S>
int launch(const float* x, int64_t x_stride, float* y, int B, int F, int L, const float* coeffs,
           const double* phi, const float* state_in, float* state_out, float* ends, float* starts,
           cudaStream_t stream) {
  const int nb = (F + L - 1) / L;
  auto grid = [](int64_t seqs) { return (unsigned)((seqs + kThreads - 1) / kThreads); };
  if (nb > 1) {
    cascade_blocks<S, false><<<grid((int64_t)B * (nb - 1)), kThreads, 0, stream>>>(
        x, x_stride, y, B, F, L, nb, nb - 1, coeffs, state_in, starts, ends, state_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cascade_carry<S><<<(B + kWarpsPerBlock - 1) / kWarpsPerBlock, kThreads, 0, stream>>>(
        B, nb, phi, state_in, ends, starts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cascade_blocks<S, true><<<grid((int64_t)B * nb), kThreads, 0, stream>>>(
      x, x_stride, y, B, F, L, nb, nb, coeffs, state_in, starts, ends, state_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x [B, F] f32 with row stride
// x_stride (frames contiguous), y [B, F] f32 contiguous (not x), coeffs [9][S][B] f32, phi [B][2S][2S] f64 (the transition
// over L frames), state_in / state_out [S][B][2] f32, ends / starts scratch
// [B][ceil(F/L)][2S] f32. 1 <= S <= 4, L a positive multiple of 32, F >= 1.
// Launches on `stream` (three kernels), does not synchronise, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue without
// launching for arguments out of range).
extern "C" int wb_biquad_cascade(const float* x, long long x_stride, float* y, int B, int F, int L,
                                 const float* coeffs, int S, const double* phi,
                                 const float* state_in, float* state_out, float* ends,
                                 float* starts, void* stream) {
  if (B < 1 || F < 1 || S < 1 || S > kMaxSections || L < kTile || L % kTile != 0 || x_stride < F)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return launch<1>(x, x_stride, y, B, F, L, coeffs, phi, state_in, state_out, ends, starts, st);
    case 2: return launch<2>(x, x_stride, y, B, F, L, coeffs, phi, state_in, state_out, ends, starts, st);
    case 3: return launch<3>(x, x_stride, y, B, F, L, coeffs, phi, state_in, state_out, ends, starts, st);
    case 4: return launch<4>(x, x_stride, y, B, F, L, coeffs, phi, state_in, state_out, ends, starts, st);
  }
  return (int)cudaErrorInvalidValue;
}
