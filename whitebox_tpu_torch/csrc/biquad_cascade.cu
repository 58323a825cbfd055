// Biquad cascade for NVIDIA Hopper (sm_90a), written by hand: the effect
// finisher's per-row section cascade in "scan" mode.
//
// Replaces, on the card, the eager torch ops of
// whitebox_tpu_torch/render/effects_pipeline.py::ScanFinisher.step: one
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
// Numerics: every f32 operation is __fmul_rn / __fadd_rn, every f64 one
// __dmul_rn / __dadd_rn (the build also passes --fmad=false), so no FMA
// contraction. The sums run in another order than the Hillis scan's, so the
// kernel is not bit-equal to its plain version (relative RMS ~1e-7 per row,
// below the 5e-6 the tests hold it to). Each section's M is normal in the
// eigenbasis, so the f32 recurrence stays well conditioned near the unit
// circle; the companion-form sections (FIR, gain, identity, nearly
// defective) are nilpotent or short-memory. An identity row gives exactly
// its input.
//
// What bounds it on an H100: bytes. At 128 stereo tracks (B = 256) a
// 2^20-frame chunk is 1.07 GB in and 1.07 GB out (0.641 ms at 3.35 TB/s);
// its 15 f32 operations per section and frame are 12.1 GFLOP at S = 3
// (0.18 ms at 67 TFLOP/s). A recurrence is sequential in n, so each row is
// cut into sub-blocks of l frames (l = 128, or 256 for few rows), one per
// thread, 32 consecutive sub-blocks per warp (a tile of W = 32 l frames).
// One launch, each x read once and each y written once:
// 1. a block takes four consecutive tiles of one row by an atomic ticket
//    (not by blockIdx), in block-major order (ticket g: row g % B, tiles
//    4 (g / B) .. + 3, one a warp), so every tile a warp may wait on
//    belongs to a warp that is already running; the block stages the
//    row's Phi_l powers and response table (below) in shared memory once
//    for its four warps;
// 2. it stages the tile's W contiguous frames in shared memory with
//    cp.async (16-byte copies where the view is aligned, else 4-byte), each
//    sub-block padded by 4 floats so that the lanes' 16-byte reads of their
//    own sub-blocks fall in distinct banks;
// 3. each lane walks its sub-block from a zero state, writing the zero-state
//    output y0 over x in place, and keeps its end state e_j (2S floats);
// 4. a Kogge-Stone scan over the 32 lanes in f64 with the powers
//    Phi_l^(2^i) (the zero-input transition over l frames, per row) gives
//    each lane the zero-start state after its sub-block: the tile's
//    aggregate E is lane 31's;
// 5. decoupled look-back (CUB's single-pass scan): the warp publishes E
//    (flag 1), finds the nearest predecessor tile of its row that has
//    published its inclusive prefix P (flag 2), and folds the aggregates in
//    between, s = Phi_W s + E_q in f64 (Phi_W = Phi_l^32), into its start
//    s_w; then publishes its own P = Phi_W s_w + E. Every P is the same
//    sequential f64 recurrence whichever path found it, so the result does
//    not depend on timing. Tile 0 of a row starts from state_in;
// 6. each lane's start is Phi_l^j s_w (by the bits of j) plus the scan's
//    exclusive value; the output is y = y0 + sum_d R[n][d] * start_d, R the
//    cascade's zero-input response to each unit state over l frames (per
//    row, f32), 2S multiply-adds a frame instead of a second walk. The lane
//    that holds the row's last frame walks its frames from its start
//    instead (it skipped step 3) and writes state_out;
// 7. the tile leaves shared memory in coalesced streaming stores.
// Phi_l's powers and R are the wrapper's (ops/biquad_cuda.py
// ::cascade_tables, computed once per coefficient tensor, in f64 from the
// same f32 parameters).
//
// Measured on an H100 80GB HBM3 at 700 W (tools/ab_cascade.py, PERF.md):
// ~1.5 ms per [256, 2^20] chunk, 2.3x the byte bound, against 2.6 ms for
// the three-launch design it replaces; 0.1-0.2 ms on 2 rows (1.1-1.5 ms
// before). Timing variants put the rest on the staging against the walk
// (45 f32 operations a frame at S = 3, three blocks of four warps an SM,
// which shared memory caps: 73 KB a block at l = 128); the scans and the
// correction cost ~0.17 ms each once the tables sit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSections = 4;   // sections per launch; the wrapper runs longer chains in groups
constexpr int kParams = 9;        // eig_section_params
constexpr int kWarps = 4;         // warps of a block, each with its own tile
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 32;        // sub-blocks of a tile
constexpr int kPowers = 6;        // Phi_l^(2^i), i = 0..5 (the last is Phi_W)
constexpr int kPad = 4;           // floats after each sub-block in shared memory
constexpr int kMaxBlock = 256;    // frames of a sub-block at most
constexpr long long kSpinLimit = 1LL << 24;  // look-back polls before the kernel traps

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

// r = M v (M row-major D x D, in shared memory), each component's products
// summed in index order.
template <int D>
__device__ __forceinline__ void matvec(const double* __restrict__ M, const double (&v)[D], double (&r)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    double t = __dmul_rn(M[i * D], v[0]);
#pragma unroll
    for (int j = 1; j < D; ++j) t = __dadd_rn(t, __dmul_rn(M[i * D + j], v[j]));
    r[i] = t;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

struct Params {
  const float* x;
  long long x_stride;
  float* y;
  int B, F, l, nk, n_groups;  // nk tiles a row; n_groups = B * ceil(nk / kWarps) tickets
  const float* coeffs;      // [9][S][B]
  const double* phis;       // [B][kPowers][D][D]
  const float* resp;        // [B][l][DP]
  const float* state_in;    // [S][B][2]
  float* state_out;         // [S][B][2]
  int* counter;             // the ticket, then flags[B * nk] (0 none, 1 aggregate, 2 prefix)
  double* agg;              // [B * nk][D], tile k of row r at k * B + r
  double* incl;             // [B * nk][D]
};

template <int S>
__global__ void __launch_bounds__(kThreads) cascade_kernel(Params P) {
  constexpr int D = 2 * S;
  constexpr int DP = D <= 4 ? 4 : 8;
  constexpr unsigned kAll = 0xffffffffu;
  // shared memory: the four tiles, then the row's response [l][DP] f32,
  // then its powers [kPowers][D][D] f64
  extern __shared__ float4 smem[];
  __shared__ int group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = P.l, l4 = l / 4, stride4 = l4 + kPad / 4;
  float4* tile = smem + (size_t)warp * kLanes * stride4;
  float* tile_f = reinterpret_cast<float*>(tile);
  float4* resp_s = smem + (size_t)kWarps * kLanes * stride4;
  double* phis = reinterpret_cast<double*>(resp_s + l * DP / 4);

  if (threadIdx.x == 0) group = atomicAdd(P.counter, 1);
  __syncthreads();
  const int g = group;
  if (g >= P.n_groups) return;  // the whole block
  const int row = g % P.B, k = (g / P.B) * kWarps + warp;
  {
    const float4* rg = reinterpret_cast<const float4*>(P.resp + (size_t)row * l * DP);
    for (int i = threadIdx.x; i < l * DP / 4; i += kThreads) cp_async16(resp_s + i, rg + i);
    const double* pg = P.phis + (size_t)row * kPowers * D * D;
    for (int i = threadIdx.x; i < kPowers * D * D / 2; i += kThreads) cp_async16(phis + 2 * i, pg + 2 * i);
  }
  if (k >= P.nk) {  // past the row's last tile: only the shared tables to wait for
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    return;
  }
  const int ticket = k * P.B + row;
  const long long f0 = (long long)k * kLanes * l;
  const int len = (int)min((long long)kLanes * l, (long long)P.F - f0);
  const bool last_tile = f0 + (long long)kLanes * l >= P.F;
  const int nj = max(0, min(l, len - lane * l));     // frames of this lane's sub-block
  const bool row_last = last_tile && lane == (len - 1) / l;
  int* flags = P.counter + 1;

  // 2. stage the tile's frames: frame f at sub-block f / l, offset f % l
  const float* xs = P.x + (long long)row * P.x_stride + f0;
  const int n4 = len / 4;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(xs) & 15) == 0) {
    for (int c = lane; c < n4; c += 32) cp_async16(tile + (c / l4) * stride4 + c % l4, xs + 4 * c);
    done = n4 * 4;
  }
  for (int f = done + lane; f < len; f += 32) cp_async4(tile_f + (f / l) * (l + kPad) + f % l, xs + f);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the tables, copied by the whole block; the last barrier

  float p[S][kParams];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < kParams; ++j) p[s][j] = __ldg(P.coeffs + ((long long)j * S + s) * P.B + row);
  __syncwarp();

  // 3. the lane's sub-block from zero: y0 in place, its end state
  float4* mine = tile + lane * stride4;
  double acc[D];
  {
    float z[S][2];
#pragma unroll
    for (int s = 0; s < S; ++s) z[s][0] = z[s][1] = 0.0f;
    if (nj == l && !row_last) {
      for (int i = 0; i < l4; ++i) {
        float4 v = mine[i];
        v.x = cascade_frame<S>(p, z, v.x);
        v.y = cascade_frame<S>(p, z, v.y);
        v.z = cascade_frame<S>(p, z, v.z);
        v.w = cascade_frame<S>(p, z, v.w);
        mine[i] = v;
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc[2 * s] = (double)z[s][0];
      acc[2 * s + 1] = (double)z[s][1];
    }
  }

  // 4. Kogge-Stone over the lanes: acc_j = sum_{i <= j} Phi_l^(j-i) e_i
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const int off = 1 << b;
    double o[D], r[D];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = __shfl_up_sync(kAll, acc[d], off);
    if (lane >= off) {
      matvec<D>(phis + b * D * D, o, r);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = __dadd_rn(acc[d], r[d]);
    }
  }
  double E[D], ex[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    E[d] = __shfl_sync(kAll, acc[d], 31);
    ex[d] = __shfl_up_sync(kAll, acc[d], 1);
    if (lane == 0) ex[d] = 0.0;
  }

  // 5. the tile's start: state_in, or the decoupled look-back
  double sw[D];
  if (k == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) sw[d] = (double)P.state_in[((long long)(d >> 1) * P.B + row) * 2 + (d & 1)];
  } else {
    if (!last_tile && lane == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) __stcg(P.agg + (long long)ticket * D + d, E[d]);
      __threadfence();
      store_release(flags + ticket, 1);
    }
    int base = k - 1, m;
    long long spins = 0;
    while (true) {
      const int kb = base - lane;
      const int f = kb >= 0 ? load_acquire(flags + (long long)kb * P.B + row) : 2;
      const unsigned two = __ballot_sync(kAll, f == 2), zero = __ballot_sync(kAll, f == 0);
      const int first2 = two ? __ffs(two) - 1 : 32;
      const unsigned before = first2 == 32 ? kAll : ((1u << first2) - 1u);
      if (zero & before) {
        if (++spins > kSpinLimit) __trap();  // a predecessor that never publishes: fail, do not hang
        __nanosleep(64);
        continue;
      }
      if (first2 < 32) {
        m = base - first2;
        break;
      }
      base -= 32;
    }
    __syncwarp();
    const double* phiw = phis + 5 * D * D;
#pragma unroll
    for (int d = 0; d < D; ++d) sw[d] = __ldcg(P.incl + ((long long)m * P.B + row) * D + d);
    for (int q = m + 1; q < k; ++q) {
      double r[D];
      matvec<D>(phiw, sw, r);
#pragma unroll
      for (int d = 0; d < D; ++d) sw[d] = __dadd_rn(r[d], __ldcg(P.agg + ((long long)q * P.B + row) * D + d));
    }
  }
  if (!last_tile) {  // the inclusive prefix for the row's next tile
    double r[D];
    matvec<D>(phis + 5 * D * D, sw, r);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) __stcg(P.incl + (long long)ticket * D + d, __dadd_rn(r[d], E[d]));
      __threadfence();
      store_release(flags + ticket, 2);
    }
  }

  // 6. the lane's start: Phi_l^lane s_w + the exclusive scan
  float st[D];
  {
    double w[D];
#pragma unroll
    for (int d = 0; d < D; ++d) w[d] = sw[d];
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      if ((lane >> b) & 1) {
        double r[D];
        matvec<D>(phis + b * D * D, w, r);
#pragma unroll
        for (int d = 0; d < D; ++d) w[d] = r[d];
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) st[d] = (float)__dadd_rn(w[d], ex[d]);
  }
  if (row_last) {
    float z[S][2];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z[s][0] = st[2 * s];
      z[s][1] = st[2 * s + 1];
    }
    float* t = tile_f + lane * (l + kPad);
    for (int n = 0; n < nj; ++n) t[n] = cascade_frame<S>(p, z, t[n]);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      P.state_out[((long long)s * P.B + row) * 2] = z[s][0];
      P.state_out[((long long)s * P.B + row) * 2 + 1] = z[s][1];
    }
  } else if (nj == l) {
    const float4* R = resp_s;
    for (int i = 0; i < l4; ++i) {
      float4 v = mine[i];
      float* vv = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * i + c;
        float r[DP];
#pragma unroll
        for (int h = 0; h < DP / 4; ++h) {
          const float4 q = R[n * (DP / 4) + h];
          r[4 * h] = q.x;
          r[4 * h + 1] = q.y;
          r[4 * h + 2] = q.z;
          r[4 * h + 3] = q.w;
        }
        float corr = __fmul_rn(r[0], st[0]);
#pragma unroll
        for (int d = 1; d < D; ++d) corr = __fadd_rn(corr, __fmul_rn(r[d], st[d]));
        vv[c] = __fadd_rn(vv[c], corr);
      }
      mine[i] = v;
    }
  }
  __syncwarp();

  // 7. out, coalesced
  float* ys = P.y + (long long)row * P.F + f0;
  done = 0;
  if ((reinterpret_cast<uintptr_t>(ys) & 15) == 0) {
    for (int c = lane; c < n4; c += 32) __stcs(reinterpret_cast<float4*>(ys) + c, tile[(c / l4) * stride4 + c % l4]);
    done = n4 * 4;
  }
  for (int f = done + lane; f < len; f += 32) __stcs(ys + f, tile_f[(f / l) * (l + kPad) + f % l]);
}

template <int S>
size_t shared_bytes(int l) {  // the tiles, the response, the powers
  constexpr int D = 2 * S, DP = D <= 4 ? 4 : 8;
  return (size_t)kWarps * kLanes * (l + kPad) * sizeof(float) + (size_t)l * DP * sizeof(float) +
         (size_t)kPowers * D * D * sizeof(double);
}

template <int S>
int launch(const Params& P, cudaStream_t stream) {
  static bool opted = false;  // shared memory above 48 KB only after the opt-in
  const size_t most = shared_bytes<S>(kMaxBlock);
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(cascade_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)most);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  cudaError_t err = cudaMemsetAsync(P.counter, 0, sizeof(int) * (1 + (size_t)P.B * P.nk), stream);
  if (err != cudaSuccess) return (int)err;
  cascade_kernel<S><<<(unsigned)P.n_groups, kThreads, shared_bytes<S>(P.l), stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x [B, F] f32 with row stride
// x_stride (frames contiguous), y [B, F] f32 contiguous (not x), coeffs
// [9][S][B] f32, phis [B][6][2S][2S] f64 (Phi_l^(2^i)), resp [B][l][DP] f32
// (DP = 4 for S <= 2, else 8; the zero-input response), state_in /
// state_out [S][B][2] f32, scratch: ints [1 + n_tiles] and doubles
// [2][n_tiles][2S], n_tiles = B * ceil(F / (32 l)). 1 <= S <= 4, l in
// {32, 64, 128, 256}, F >= 1. Launches on `stream` (a memset of the ticket
// and flags, then one kernel), does not synchronise, allocates nothing,
// returns cudaGetLastError() (cudaErrorInvalidValue without launching for
// arguments out of range).
extern "C" int wb_biquad_cascade(const float* x, long long x_stride, float* y, int B, int F, int l,
                                 const float* coeffs, int S, const double* phis, const float* resp,
                                 const float* state_in, float* state_out, int* ints, double* doubles,
                                 void* stream) {
  if (B < 1 || F < 1 || S < 1 || S > kMaxSections || (l != 32 && l != 64 && l != 128 && l != kMaxBlock) ||
      x_stride < F)
    return (int)cudaErrorInvalidValue;
  const long long nk = (F + (long long)kLanes * l - 1) / ((long long)kLanes * l);
  const long long tiles = (long long)B * nk;
  if (tiles > (1LL << 30)) return (int)cudaErrorInvalidValue;
  Params P;
  P.x = x;
  P.x_stride = x_stride;
  P.y = y;
  P.B = B;
  P.F = F;
  P.l = l;
  P.nk = (int)nk;
  P.n_groups = (int)((long long)B * ((nk + kWarps - 1) / kWarps));
  P.coeffs = coeffs;
  P.phis = phis;
  P.resp = resp;
  P.state_in = state_in;
  P.state_out = state_out;
  P.counter = ints;
  P.agg = doubles;
  P.incl = doubles + tiles * 2 * S;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return launch<1>(P, st);
    case 2: return launch<2>(P, st);
    case 3: return launch<3>(P, st);
    case 4: return launch<4>(P, st);
  }
  return (int)cudaErrorInvalidValue;
}
