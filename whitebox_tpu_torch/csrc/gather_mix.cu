// Gather mix kernel for NVIDIA Hopper (sm_90a), written by hand.
//
// Renders one chunk of the port's gather mix (whitebox_tpu_torch/ops/mix.py,
// the counterpart of the JAX package's XLA path whitebox_tpu/ops/mix.py:
// 171-305) in one launch, where the plain version is ~100 torch ops. Not a
// TPU kernel: the JAX package runs this mix as an XLA program. It reads the
// padded per-track segment tables of ops/mix.py::pack_device_tables and,
// for each track t and global frame g = chunk_start + f, f in [0, frames):
//
//   idx   = the last row with dst_start[t, idx] <= g (-1 before the first;
//           the INT32_MAX padding is never <= g)
//   valid = idx >= 0 && g >= ds0 && g < ds0 + length
//   j     = valid ? g - ds0 : 0
//   ix,fx = fast row: j, 0; else the double-single phase (ds_phase.cuh)
//   env   = clip01(f32(g - fin_start) * fin_inv) * clip01(f32(fout_end - g) * fout_inv)
//   src   = clamp(src_base[t, idx, c] + ix, 0, P - 2)            (int64)
//   s     = fast row: pool[src] (clamped to +-1 on clamp rows); else the
//           interpolation of the caller's mode: linear, Catmull-Rom,
//           polynomial taps over an oversampled pool, or the direct
//           windowed-sinc bank with its phase lerp
//   contrib[t, c, f] = valid ? (s * gain) * env : +0.0
//
// in one of three forms (kForm):
//   kPerTrack   out[t, c, f] = contrib                       (render_chunk_per_track)
//   kSum        out[c, f] = hard clip of the track sum        (render_chunk)
//   kSumNoClip  out[c, f] = the track sum, no clip            (the sharded mix's partial)
// with the track sum acc = +0.0; acc = acc + contrib[t] * track_gain[t, c]
// for t = 0, 1, ... in index order, every track added (an invalid frame adds
// 0 * track_gain, as the plain version does). Every product and sum is
// __fmul_rn/__fadd_rn/__fsub_rn (the build also passes --fmad=false), no
// atomics, and the operations come in the plain version's order, so each
// form is the plain torch ops bit for bit on the card.
//
// Design (a simple kernel that is right; fast is later work):
// - A block covers kFrames contiguous frames, one a thread. Its frames pick
//   rows of a track in [lo, hi]: lo is the row of its first frame, hi that
//   of its last, each found once per (block, track) by a bisection over the
//   track's S rows (block_rows) and kept in shared memory. A thread then
//   bisects only inside [lo, hi], which is one row (no step at all) unless a
//   row starts inside the block. ops/gather_cuda.py::block_rows_model is the
//   host model of this search.
// - kPerTrack: a block per (frame block, track); the phase, the envelope
//   and the row's fields are computed once per (track, frame) and the
//   channels looped over.
// - kSum, kSumNoClip: a block per (frame block, channel pair); each thread
//   walks every track in order for its frame and keeps one accumulator per
//   channel of its pair. The tracks' [lo, hi] are staged kFrames tracks at a
//   time, one a thread.
// - Nothing is read for a frame no row covers but the row's start and
//   length; a covered frame reads its row's fields from global memory
//   (threads of a block mostly share one row, so these are broadcasts from
//   L1) and the pool taps.
// - Frames past the end of the timeline (the ragged last chunk, the master
//   latency's extra chunk) find no valid row and come out +0.0 (summed: the
//   sum of zeros, +0.0); they read no sample.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ds_phase.cuh"

namespace {

constexpr int kFrames = 256;  // frames, and threads, of a block
constexpr int kChanPair = 2;  // channels a thread of the summed forms accumulates

// interpolation of resampled rows (ops/gather_cuda.py INTERP)
constexpr int kLinear = 0;
constexpr int kCatmull = 1;
constexpr int kPoly = 2;
constexpr int kSinc = 3;
constexpr int kMaxPolyTaps = 8;
constexpr int kMaxPolyCoeffs = 8;

// output forms (ops/gather_cuda.py FORMS)
constexpr int kPerTrack = 0;
constexpr int kSum = 1;
constexpr int kSumNoClip = 2;

}  // namespace

// The arguments of one call (bound with ctypes: ops/gather_cuda.py::WbGatherArgs).
// Tables are [T, S] row-major, src_base [T, S, C], track_gain [T, C].
struct WbGatherArgs {
  const float* pool;
  long long P;  // samples in the pool
  const int* dst_start;
  const int* length;
  const long long* src_base;
  const float* frac_hi;
  const float* frac_lo;
  const float* speed_hi;
  const float* speed_lo;
  const float* gain;
  const unsigned char* fast;
  const unsigned char* clamp;
  const int* fin_start;
  const float* fin_inv;
  const int* fout_end;
  const float* fout_inv;
  const float* track_gain;
  const float* sinc_bank;  // kSinc: [phases + 1, taps] on the card
  float* out;
  int T;
  int S;
  int C;
  int frames;
  int chunk_start;
  int form;
  int interp;
  int phases;  // kSinc
  int taps;    // kSinc: the bank's taps; kPoly: the polynomial taps
  int ncoef;   // kPoly: coefficients a tap
  float poly[64];  // kPoly: [taps][ncoef] row-major, taps * ncoef <= 64
};

namespace {

// The number of rows r in (lo, lo + n] with ds[r] <= g, added to lo: the
// last row <= g when ds[lo] <= g (or lo == -1) and ds[lo + n + 1] > g.
__device__ __forceinline__ int bisect(const int* ds, int lo, int n, int g) {
  int idx = lo;
  while (n > 0) {
    const int half = n >> 1;
    const int m = idx + 1 + half;
    if (__ldg(ds + m) <= g) {
      idx = m;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return idx;
}

// The rows a block's frames [g0, g1] pick from track t: [lo, hi].
__device__ __forceinline__ int2 block_rows(const WbGatherArgs& A, int t, int g0, int g1) {
  const int* ds = A.dst_start + (long long)t * A.S;
  const int lo = bisect(ds, -1, A.S, g0);
  return make_int2(lo, bisect(ds, lo, A.S - 1 - lo, g1));
}

// A (track, frame)'s row: what the channels share.
struct Row {
  long long r;  // t * S + idx
  bool fast, clampf;
  int ix;
  float fx, gain, env;
};

// -> false where no row covers g (the contribution is +0.0)
__device__ __forceinline__ bool find_row(const WbGatherArgs& A, int t, int2 range, int g, Row* row) {
  const int* ds = A.dst_start + (long long)t * A.S;
  const int idx = bisect(ds, range.x, range.y - range.x, g);
  if (idx < 0) return false;
  const long long r = (long long)t * A.S + idx;
  const int ds0 = __ldg(A.dst_start + r);
  if (g < ds0 || g >= ds0 + __ldg(A.length + r)) return false;
  const int j = g - ds0;
  row->r = r;
  row->fast = __ldg(A.fast + r) != 0;
  row->clampf = __ldg(A.clamp + r) != 0;
  if (row->fast) {
    row->ix = j;
    row->fx = 0.0f;
  } else {
    phase_eval(j, __ldg(A.frac_hi + r), __ldg(A.frac_lo + r), __ldg(A.speed_hi + r), __ldg(A.speed_lo + r),
               &row->ix, &row->fx);
  }
  row->gain = __ldg(A.gain + r);
  row->env = __fmul_rn(clip01(__fmul_rn(__int2float_rn(sub_wrap(g, __ldg(A.fin_start + r))), __ldg(A.fin_inv + r))),
                       clip01(__fmul_rn(__int2float_rn(sub_wrap(__ldg(A.fout_end + r), g)), __ldg(A.fout_inv + r))));
  return true;
}

__device__ __forceinline__ float tap(const WbGatherArgs& A, long long src, int off) {
  long long i = src + off;
  i = i < 0 ? 0 : i;
  i = i > A.P - 2 ? A.P - 2 : i;
  return __ldg(A.pool + i);
}

// (s * gain) * env of channel c at a covered (track, frame), in the plain
// version's order of operations (ops/mix.py::track_contrib_plain).
template <int kInterp>
__device__ __forceinline__ float contrib(const WbGatherArgs& A, const Row& row, int c) {
  long long src = __ldg(A.src_base + row.r * A.C + c) + row.ix;
  src = src < 0 ? 0 : src;
  src = src > A.P - 2 ? A.P - 2 : src;
  const float a = __ldg(A.pool + src);
  float s;
  if (row.fast) {
    s = a;
    if (row.clampf) {
      s = s < -1.0f ? -1.0f : s;
      s = s > 1.0f ? 1.0f : s;
    }
  } else if constexpr (kInterp == kCatmull) {
    const float pm1 = tap(A, src, -1);
    const float b = __ldg(A.pool + src + 1);
    const float p2 = tap(A, src, 2);
    const float c1 = __fmul_rn(0.5f, __fsub_rn(b, pm1));
    const float c2 =
        __fsub_rn(__fadd_rn(__fsub_rn(pm1, __fmul_rn(2.5f, a)), __fmul_rn(2.0f, b)), __fmul_rn(0.5f, p2));
    const float c3 = __fadd_rn(__fmul_rn(0.5f, __fsub_rn(p2, pm1)), __fmul_rn(1.5f, __fsub_rn(a, b)));
    const float fx = row.fx;
    s = __fadd_rn(a, __fmul_rn(fx, __fadd_rn(c1, __fmul_rn(fx, __fadd_rn(c2, __fmul_rn(fx, c3))))));
  } else if constexpr (kInterp == kPoly) {
    // per tap, Horner in fx from the highest coefficient down; the taps'
    // weighted sum from +0.0 in tap order
    const int first = -(A.taps / 2 - 1);
    s = 0.0f;
    for (int k = 0; k < A.taps; ++k) {
      const float* ck = A.poly + k * A.ncoef;
      float w = ck[A.ncoef - 1];
      for (int m = A.ncoef - 2; m >= 0; --m) w = __fadd_rn(__fmul_rn(w, row.fx), ck[m]);
      s = __fadd_rn(s, __fmul_rn(w, tap(A, src, first + k)));
    }
  } else if constexpr (kInterp == kSinc) {
    // the bank's two phase rows around fx * phases, lerped per tap
    const float pf = __fmul_rn(row.fx, __int2float_rn(A.phases));
    int p0 = __float2int_rz(pf);
    p0 = p0 < 0 ? 0 : p0;
    p0 = p0 > A.phases - 1 ? A.phases - 1 : p0;
    const float pl = __fsub_rn(pf, __int2float_rn(p0));
    const float* w0row = A.sinc_bank + (long long)p0 * A.taps;
    const float* w1row = w0row + A.taps;
    const int first = -(A.taps / 2) + 1;
    s = 0.0f;
    for (int k = 0; k < A.taps; ++k) {
      const float w0 = __ldg(w0row + k);
      const float w = __fadd_rn(w0, __fmul_rn(pl, __fsub_rn(__ldg(w1row + k), w0)));
      s = __fadd_rn(s, __fmul_rn(w, tap(A, src, first + k)));
    }
  } else {
    const float b = __ldg(A.pool + src + 1);
    s = __fadd_rn(a, __fmul_rn(row.fx, __fsub_rn(b, a)));  // sampler.cpp:55
  }
  return __fmul_rn(__fmul_rn(s, row.gain), row.env);
}

// kPerTrack: block (frame block, track t).
template <int kInterp>
__global__ void __launch_bounds__(kFrames) gather_per_track(const WbGatherArgs A) {
  __shared__ int2 range;
  const int t = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int f = f0 + threadIdx.x;
  if (threadIdx.x == 0) {
    const int last = min(A.frames, f0 + kFrames) - 1;
    range = block_rows(A, t, A.chunk_start + f0, A.chunk_start + last);
  }
  __syncthreads();
  if (f >= A.frames) return;
  const int g = A.chunk_start + f;
  Row row;
  const bool covered = find_row(A, t, range, g, &row);
  float* out = A.out + (long long)t * A.C * A.frames + f;
  for (int c = 0; c < A.C; ++c) out[(long long)c * A.frames] = covered ? contrib<kInterp>(A, row, c) : 0.0f;
}

// kSum, kSumNoClip: block (frame block, channel pair).
template <int kInterp, bool kClip>
__global__ void __launch_bounds__(kFrames) gather_sum(const WbGatherArgs A) {
  __shared__ int2 ranges[kFrames];
  const int f0 = blockIdx.x * kFrames;
  const int f = f0 + threadIdx.x;
  const int g = A.chunk_start + f;
  const int g0 = A.chunk_start + f0;
  const int g1 = A.chunk_start + min(A.frames, f0 + kFrames) - 1;
  const int c0 = blockIdx.y * kChanPair;
  const int nc = min(kChanPair, A.C - c0);
  float acc[kChanPair] = {0.0f, 0.0f};
  for (int tb = 0; tb < A.T; tb += kFrames) {
    const int nt = min(kFrames, A.T - tb);
    __syncthreads();  // the previous pass's ranges are read
    if (threadIdx.x < nt) ranges[threadIdx.x] = block_rows(A, tb + threadIdx.x, g0, g1);
    __syncthreads();
    if (f >= A.frames) continue;
    for (int i = 0; i < nt; ++i) {
      const int t = tb + i;
      Row row;
      const bool covered = find_row(A, t, ranges[i], g, &row);
#pragma unroll
      for (int k = 0; k < kChanPair; ++k) {
        if (k < nc) {
          const float v = covered ? contrib<kInterp>(A, row, c0 + k) : 0.0f;
          acc[k] = __fadd_rn(acc[k], __fmul_rn(v, __ldg(A.track_gain + (long long)t * A.C + c0 + k)));
        }
      }
    }
  }
  if (f >= A.frames) return;
#pragma unroll
  for (int k = 0; k < kChanPair; ++k) {
    if (k < nc) {
      float x = acc[k];
      if (kClip) {
        x = x > 1.0f ? 1.0f : x;
        x = x < -1.0f ? -1.0f : x;
      }
      A.out[(long long)(c0 + k) * A.frames + f] = x;
    }
  }
}

template <int kInterp>
int launch(const WbGatherArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.frames + kFrames - 1) / kFrames);
  if (a.form == kPerTrack) {
    gather_per_track<kInterp><<<dim3(blocks, a.T), kFrames, 0, stream>>>(a);
  } else {
    const dim3 grid(blocks, (a.C + kChanPair - 1) / kChanPair);
    if (a.form == kSum)
      gather_sum<kInterp, true><<<grid, kFrames, 0, stream>>>(a);
    else
      gather_sum<kInterp, false><<<grid, kFrames, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launch (0 == cudaSuccess); malformed arguments return
// cudaErrorInvalidValue without launching.
extern "C" int wb_gather_mix(const WbGatherArgs* args, void* stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const WbGatherArgs& a = *args;
  if (a.pool == nullptr || a.out == nullptr || a.P < 2 || a.T < 1 || a.T > 65535 || a.S < 1 || a.C < 1 ||
      a.frames < 1 || a.form < kPerTrack || a.form > kSumNoClip)
    return (int)cudaErrorInvalidValue;
  if (a.interp == kPoly && (a.taps < 1 || a.ncoef < 1 || a.taps > kMaxPolyTaps || a.ncoef > kMaxPolyCoeffs))
    return (int)cudaErrorInvalidValue;
  if (a.interp == kSinc && (a.sinc_bank == nullptr || a.phases < 1 || a.taps < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.interp) {
    case kLinear: return launch<kLinear>(a, s);
    case kCatmull: return launch<kCatmull>(a, s);
    case kPoly: return launch<kPoly>(a, s);
    case kSinc: return launch<kSinc>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
