// Dynamics ballistics for NVIDIA Hopper (sm_90a), written by hand: the
// release and attack recurrences of the compressor, limiter and gate, and
// the RMS detector's one-pole average.
//
// Replaces, on the card, the torch ops of whitebox_tpu_torch/ops/dynamics.py
// ::maxdecay_scan and ::onepole_scan (Hillis-Steele prefix scans:
// ceil(log2 F) doubling steps, each a concatenation of a filled tensor and
// the combine's ops over [B, F] tensors), as compressor_process,
// limiter_process, gate_process and detector_level call them. Not a TPU
// kernel: the JAX package runs the same scans as XLA programs
// (whitebox_tpu/ops/dynamics.py:53 onepole_scan_t, :79 maxdecay_scan_t).
//
// What it computes, per row r of B and frame n of F (kMax true):
//   e[n] = max(v[n], rho[n] * e[n-1])          the release (max-decay)
//   h[n] = max(e[n], floor[n])                 the gate's closed floor (optional)
//   y[n] = a[n] * y[n-1] + (1 - a[n]) * h[n]   the attack (one-pole)
// from e[-1] = e0[r], y[-1] = y0[r]; it writes y, e_last = e[F-1] and
// y_last = y[F-1]. With kMax false it is the one-pole alone over h = v.
// rho, a and floor hold one value per row or one per frame (automation
// lanes). v >= 0 (gain reductions in dB, gate targets), which the plain
// scan's max identity assumes too: a block's max runs from 0.
//
// Numerics: (1 - a) * h is formed in f32 as the plain scan forms it
// (__fsub_rn, __fmul_rn, with h = max(e rounded to f32, floor)); the
// states e and y run in f64 (__dmul_rn / __dadd_rn; the build also passes
// --fmad=false), and y leaves rounded to f32. An f32 walk would stall: in
// a steady state the rounding of a * y outweighs (1 - a) * (h - y) once
// |h - y| < 2^-24 |y| / (1 - a), a bias of 3e-4 at a 100 ms attack, where
// the Hillis scan's tree of products stays within ~1e-6. The frames of a
// block are walked in order, the Hillis scan groups them otherwise, so the
// two agree to a tolerance (relative RMS 5e-6 per row), not to the bit.
// The carries between blocks and the block starts are f64 as well.
//
// What bounds it on an H100: bytes. A row reads v (4 B a frame, 4 B more
// per frame-wise coefficient) and writes y (4 B) for about 8 f32
// operations a frame; the Hillis scans moved about 20 [B, F] temporaries
// through memory per doubling step. A recurrence is sequential in n, so
// the design is a blocked one with carried states, five launches a call:
//  1. dyn_walk<kMax, 1>: one thread per (row, block of L frames) runs e
//     from 0 over its block -> the block's max M_b and its decay product
//     D_b = prod rho;
//  2. dyn_carry<0>: a warp per row, e_start[b+1] = max(M_b, D_b * e_start[b])
//     in f64 from e0;
//  3. dyn_walk<kMax, 2>: e from its true start, y from 0 -> the block's end
//     Y_b and A_b = prod a;
//  4. dyn_carry<1>: y_start[b+1] = A_b * y_start[b] + Y_b in f64 from y0;
//  5. dyn_walk<kMax, 3>: e and y from their true starts, y written; the
//     row's last block writes the states out.
// (kMax false: launches 3-5 only.) v and the frame-wise coefficients are
// read three times and y written once; by bytes the stage is small, and
// each launch replaces ~18 doubling steps of torch ops. A thread's frames
// are a strided stream for the memory system (its neighbours run other
// blocks), so a warp stages its 32 sequences 32 frames at a time in shared
// memory: each lane copies one frame of each sequence with cp.async (one
// coalesced 128-byte row per sequence), double buffered so that the next
// tile's copies are in flight while the lanes walk this one (lane j walks
// row j of the 32 x 33 tile: no bank conflicts). The carries' products
// are summed per row into `totals` when it is given (the frame-sharded
// stages need a shard's coefficient product).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;        // frames a warp stages per sequence and step
constexpr int kStreams = 4;      // v, rho, a, floor
constexpr int kTileFloats = kTile * (kTile + 1);

struct Coef {                    // value at (row, n): p[row * rs + n * fs]
  const float* p;
  long long rs;
  int fs;                        // 0: one value per row; 1: one per frame
};

struct Args {
  const float* v;
  long long v_stride;
  Coef c[kStreams];              // c[0] unused (v); rho, a, floor (p null: no floor)
  const float* e0;
  const float* y0;
  float* y;
  float* e_last;
  float* y_last;
  int B, F, L, nb;
  double* sum_e;                 // [B][nb] the blocks' max from 0
  double* start_e;               // [B][nb]
  double* sum_y;                 // [B][nb] the blocks' one-pole from 0
  double* start_y;               // [B][nb]
  double* prod_e;                // [B][nb] prod rho over the block
  double* prod_y;                // [B][nb] prod a over the block
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Phase 1 (e's block summaries), 2 (y's, e from its true start) and 3 (the
// output). Sequence q = row * nb + b covers frames [b*L, min((b+1)*L, F)).
// Shared memory: [kWarps][2 buffers][streams staged][32][33] floats; the
// streams staged are v and the frame-wise coefficients the phase reads.
template <bool kMax, int kPhase>
__global__ void __launch_bounds__(kThreads) dyn_walk(Args A) {
  extern __shared__ float smem[];
  __shared__ long long off[kWarps][kStreams][kTile];
  __shared__ int len[kWarps][kTile];
  __shared__ long long y_at[kWarps][kTile];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q = ((long long)blockIdx.x * kWarps + warp) * kTile + lane;
  const bool valid = q < (long long)A.B * A.nb;
  const int row = valid ? (int)(q / A.nb) : 0;
  const int b = valid ? (int)(q % A.nb) : 0;
  const int n = valid ? min(A.L, A.F - b * A.L) : 0;
  const long long n0b = (long long)b * A.L;

  // which streams this phase reads, and where each frame-wise one is staged
  const bool use[kStreams] = {true, kMax, kPhase >= 2, kMax && kPhase >= 2 && A.c[3].p != nullptr};
  const float* base[kStreams] = {A.v, A.c[1].p, A.c[2].p, A.c[3].p};
  int slot[kStreams];
  int staged = 0;
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    const bool framewise = use[s] && (s == 0 || A.c[s].fs == 1);
    slot[s] = framewise ? staged++ : -1;
  }
  off[warp][0][lane] = (long long)row * A.v_stride + n0b;
#pragma unroll
  for (int s = 1; s < kStreams; ++s) off[warp][s][lane] = (long long)row * A.c[s].rs + n0b;
  len[warp][lane] = n;
  y_at[warp][lane] = (long long)row * A.F + n0b;
  // one value per row: read once
  float cst[kStreams] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 1; s < kStreams; ++s)
    if (use[s] && slot[s] < 0 && valid) cst[s] = __ldg(A.c[s].p + (long long)row * A.c[s].rs);

  double e = 0.0, y = 0.0;
  if (valid) {
    if (kMax && kPhase >= 2) e = A.start_e[q];
    if (kPhase == 3) y = A.start_y[q];
  }
  double prod = 1.0;
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  __syncwarp();

  float* tiles = smem + (size_t)warp * 2 * staged * kTileFloats;
  auto tile = [&](int buf, int s) { return tiles + (size_t)(buf * staged + slot[s]) * kTileFloats; };
  auto load = [&](int buf, int t0) {
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      if (slot[s] < 0) continue;
      float* t = tile(buf, s);
      for (int j = 0; j < kTile; ++j)
        if (t0 + lane < len[warp][j]) cp_async4(t + j * (kTile + 1) + lane, base[s] + off[warp][s][j] + t0 + lane);
    }
    cp_commit();
  };

  if (n_max > 0) load(0, 0);
  for (int t0 = 0, it = 0; t0 < n_max; t0 += kTile, ++it) {
    const int buf = it & 1;
    if (t0 + kTile < n_max) {
      load(buf ^ 1, t0 + kTile);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    const int m = n - t0;  // frames of this lane's sequence in the tile (may be <= 0)
    float* tv = tile(buf, 0) + lane * (kTile + 1);
    const float* tr = slot[1] >= 0 ? tile(buf, 1) + lane * (kTile + 1) : nullptr;
    const float* ta = slot[2] >= 0 ? tile(buf, 2) + lane * (kTile + 1) : nullptr;
    const float* tf = slot[3] >= 0 ? tile(buf, 3) + lane * (kTile + 1) : nullptr;
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      if (k >= m) break;
      float h = tv[k];
      if (kMax) {
        const float r = tr ? tr[k] : cst[1];
        e = fmax(__dmul_rn((double)r, e), (double)h);
        if (kPhase == 1) prod = __dmul_rn(prod, (double)r);
        h = (float)e;
        if (use[3]) h = fmaxf(h, tf ? tf[k] : cst[3]);
      }
      if (kPhase >= 2) {
        const float a = ta ? ta[k] : cst[2];
        y = __dadd_rn(__dmul_rn((double)a, y), (double)__fmul_rn(__fsub_rn(1.0f, a), h));
        if (kPhase == 2) prod = __dmul_rn(prod, (double)a);
        if (kPhase == 3) tv[k] = (float)y;
      }
    }
    __syncwarp();
    if (kPhase == 3) {
      const float* t = tile(buf, 0);
      for (int j = 0; j < kTile; ++j)
        if (t0 + lane < len[warp][j]) __stcs(A.y + y_at[warp][j] + t0 + lane, t[j * (kTile + 1) + lane]);
    }
    __syncwarp();
  }
  if (!valid) return;
  if (kPhase == 1) {
    A.sum_e[q] = e;
    A.prod_e[q] = prod;
  } else if (kPhase == 2) {
    A.sum_y[q] = y;
    A.prod_y[q] = prod;
  } else if (b == A.nb - 1) {
    if (kMax) A.e_last[row] = (float)e;
    A.y_last[row] = (float)y;
  }
}

// The carry over a row's blocks (kKind 0: max-decay, 1: one-pole), in f64
// from the state in: start[b] = s_b, then
//   kKind 0: s_{b+1} = max(M_b, D_b * s_b);   kKind 1: s_{b+1} = A_b * s_b + Y_b;
// total[row] = the product of the blocks' products (when total is given).
// A warp per row: its lanes move 32 blocks' summaries at a time through
// shared memory (coalesced both ways) and lane 0 walks them there.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
dyn_carry(int B, int nb, const float* __restrict__ init, const double* __restrict__ sum,
          const double* __restrict__ prod, double* __restrict__ start, double* __restrict__ total) {
  __shared__ double ssum[kWarps][kTile];
  __shared__ double sprod[kWarps][kTile];
  __shared__ double sstart[kWarps][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;  // the whole warp: row is the warp's
  double s = (double)init[row], p = 1.0;
  const long long at = (long long)row * nb;
  for (int b0 = 0; b0 < nb; b0 += kTile) {
    const int k = min(kTile, nb - b0);
    if (lane < k) {
      ssum[warp][lane] = sum[at + b0 + lane];
      sprod[warp][lane] = prod[at + b0 + lane];
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < k; ++i) {
        sstart[warp][i] = s;
        const double d = sprod[warp][i], m = ssum[warp][i];
        s = kKind == 0 ? fmax(m, __dmul_rn(d, s)) : __dadd_rn(__dmul_rn(d, s), m);
        p = __dmul_rn(p, d);
      }
    }
    __syncwarp();
    if (lane < k) start[at + b0 + lane] = sstart[warp][lane];
    __syncwarp();
  }
  if (lane == 0 && total != nullptr) total[row] = p;
}

template <bool kMax, int kPhase>
cudaError_t walk(const Args& a, cudaStream_t stream) {
  int staged = 1;
  if (kMax && a.c[1].fs == 1) ++staged;
  if (kPhase >= 2 && a.c[2].fs == 1) ++staged;
  if (kMax && kPhase >= 2 && a.c[3].p != nullptr && a.c[3].fs == 1) ++staged;
  const size_t bytes = (size_t)kWarps * 2 * staged * kTileFloats * sizeof(float);
  static bool opted = false;  // above 48 KB only after the opt-in (4 streams: 135 KB)
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(dyn_walk<kMax, kPhase>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)((size_t)kWarps * 2 * kStreams * kTileFloats * sizeof(float)));
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const long long seqs = (long long)a.B * a.nb;
  dyn_walk<kMax, kPhase><<<(unsigned)((seqs + kThreads - 1) / kThreads), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int kKind>
cudaError_t carry(const Args& a, double* total, cudaStream_t stream) {
  const float* init = kKind == 0 ? a.e0 : a.y0;
  const double* sum = kKind == 0 ? a.sum_e : a.sum_y;
  const double* prod = kKind == 0 ? a.prod_e : a.prod_y;
  double* start = kKind == 0 ? a.start_e : a.start_y;
  dyn_carry<kKind><<<(a.B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(a.B, a.nb, init, sum, prod, start, total);
  return cudaGetLastError();
}

template <bool kMax>
int launch(const Args& a, double* totals, cudaStream_t stream) {
  cudaError_t err;
  if (kMax) {
    if ((err = walk<true, 1>(a, stream)) != cudaSuccess) return (int)err;
    if ((err = carry<0>(a, totals, stream)) != cudaSuccess) return (int)err;
  }
  if ((err = walk<kMax, 2>(a, stream)) != cudaSuccess) return (int)err;
  if ((err = carry<1>(a, totals ? totals + a.B : nullptr, stream)) != cudaSuccess) return (int)err;
  return (int)walk<kMax, 3>(a, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). mode 1: the ballistics (max-decay,
// optional floor, one-pole); mode 0: the one-pole alone (rho and floor
// unused). v [B, F] f32 with row stride v_stride (frames contiguous); each
// coefficient a pointer with its row stride and frame stride (0: one value
// a row, 1: one a frame); floor null for none; e0, y0 [B] f32 (e0 unused in
// mode 0); y [B, F] f32 contiguous (not v); e_last, y_last [B] f32 (e_last
// unused in mode 0); totals [2][B] f64 (prod rho, prod a per row) or null;
// scratch [6][B][ceil(F/L)] f64.
// L a positive multiple of 32, F >= 1. Launches on `stream` (five kernels,
// three in mode 0), does not synchronise, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue without launching for
// arguments out of range).
extern "C" int wb_dynamics_scan(int mode, const float* v, long long v_stride, int B, int F, int L,
                                const float* rho, long long rho_rs, int rho_fs, const float* a,
                                long long a_rs, int a_fs, const float* floor_, long long fl_rs, int fl_fs,
                                const float* e0, const float* y0, float* y, float* e_last, float* y_last,
                                double* totals, double* scratch, void* stream) {
  if ((mode != 0 && mode != 1) || B < 1 || F < 1 || L < kTile || L % kTile != 0 || v_stride < F ||
      a == nullptr || y0 == nullptr || y == nullptr || y_last == nullptr || (a_fs != 0 && a_fs != 1) ||
      a_rs < 0 || (mode == 1 && (rho == nullptr || e0 == nullptr || e_last == nullptr ||
                                 (rho_fs != 0 && rho_fs != 1) || rho_rs < 0 ||
                                 (floor_ != nullptr && ((fl_fs != 0 && fl_fs != 1) || fl_rs < 0)))))
    return (int)cudaErrorInvalidValue;
  Args A;
  const long long nb = (F + L - 1) / L, cells = (long long)B * nb;
  A.v = v;
  A.v_stride = v_stride;
  A.c[0] = {nullptr, 0, 0};
  A.c[1] = {mode == 1 ? rho : nullptr, rho_rs, rho_fs};
  A.c[2] = {a, a_rs, a_fs};
  A.c[3] = {mode == 1 ? floor_ : nullptr, fl_rs, fl_fs};
  A.e0 = e0;
  A.y0 = y0;
  A.y = y;
  A.e_last = e_last;
  A.y_last = y_last;
  A.B = B;
  A.F = F;
  A.L = L;
  A.nb = (int)nb;
  A.sum_e = scratch;
  A.start_e = scratch + cells;
  A.sum_y = scratch + 2 * cells;
  A.start_y = scratch + 3 * cells;
  A.prod_e = scratch + 4 * cells;
  A.prod_y = scratch + 5 * cells;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1) return launch<true>(A, totals, st);
  return launch<false>(A, totals, st);
}
