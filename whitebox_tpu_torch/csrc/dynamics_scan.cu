// Dynamics for NVIDIA Hopper (sm_90a), written by hand: the compressor,
// limiter and gate of the effect finishers as one fused pass per call
// (detector, gain computer, release and attack, gain), and the same
// recurrences alone (the ballistics, the one-pole) for the frame-sharded
// stages.
//
// Replaces, on the card, the torch ops of whitebox_tpu_torch/ops/dynamics.py
// ::compressor_process, ::limiter_process and ::gate_process: their
// detector, soft-knee / ceiling / gate curves and gains (about twenty
// passes over [B, C, F] or [B, F] tensors a call) and their release and
// attack, which the plain version runs as Hillis-Steele prefix scans
// (::maxdecay_scan, ::onepole_scan). Not a TPU kernel: the JAX package runs
// those processors as XLA programs (whitebox_tpu/ops/dynamics.py:167
// compressor, :190 limiter, :229 gate; the scans at :53 and :79).
//
// What it computes, per row r of B and frame n of F, x [B][C][F]:
//   level    peak: max_c |s[c][n]|; RMS: sqrt(max(avg[n], 0)) with
//            avg[n] = d[n] avg[n-1] + (1 - d[n]) (sum_c s[c][n]^2 / C),
//            s the key, x, or silence (a sidechain with nothing routed)
//   v[n]     compressor: the soft-knee reduction of 20 log10(level) in dB;
//            limiter: max(dB - ceiling, 0), with a lookahead L the max of
//            that over frames n-L..n (the frames before the call from the
//            state `look`); gate: the target gain, floor + (1 - floor) t
//            with t the hysteresis ramp or the step at the threshold
//   e[n]     = max(v[n], rho[n] e[n-1])                  the release
//   h[n]     = max(f32(e[n]), floor[n])                   the gate's floor
//   y[n]     = a[n] y[n-1] + (1 - a[n]) h[n]              the attack
//   out      compressor x exp((makeup - y) / c), limiter x[n-L] exp(-y / c)
//            (x before the call from the state `xdelay`), gate x y,
//            c = 20 / ln 10, for every channel
// from the states in, and writes the states out (the compressor's
// red/att/det, the limiter's red/att/look/xdelay, the gate's open/att).
// Every parameter is one value a row or one a frame (automation lanes).
// The unfused kinds take v (the ballistics: release, optional floor,
// attack) or the one-pole's input alone and write y, with the products of
// rho and a over the row when asked (a frame shard's summary).
//
// Numerics: the elementwise prologue and epilogue are the plain version's
// f32 operations in its order (__fmul_rn / __fadd_rn / __fdiv_rn, accurate
// logf / expf / sqrtf; the build passes --fmad=false; a division by a
// constant is the multiply by its reciprocal that torch makes of it on the
// card); (1 - a) h is formed in f32 as the plain scan forms it; the states
// e, y and the RMS average run in f64 (__dmul_rn / __dadd_rn) and leave
// rounded to f32. An f32 walk would stall: in a steady state the rounding
// of a y outweighs (1 - a)(h - y) once |h - y| < 2^-24 |y| / (1 - a), a
// bias of 3e-4 at a 100 ms attack, where the Hillis scan's tree of products
// stays within ~1e-5. The two group the frames differently, so they agree
// to a tolerance (relative RMS 5e-6 per row plus the scan's own distance
// from the exact recurrence), not to the bit.
//
// What bounds it on an H100: bytes. A compressor call on [64, 2, 2^18]
// reads x once and writes the output once (268 MB, 0.080 ms at 3.35 TB/s)
// for ~60 f32 operations a frame. A recurrence is sequential in n, so the
// design is the cascade's single pass (csrc/biquad_cascade.cu): a warp
// takes a tile of 32 l frames of one row, lane j its sub-block of l:
// 1. the tile is taken by an atomic ticket (not by blockIdx) in
//    row-interleaved order (ticket t: row t % B, tile t / B), so every
//    tile a warp may wait on belongs to a warp that is already running;
//    the warps of a block never wait for each other (no block barrier);
// 2. the tile's x (its L frames before it for the limiter: from x or the
//    state) and its frame-wise walk coefficients are staged in shared
//    memory with cp.async, 16-byte copies where the rows are aligned;
//    x and v never go back to device memory between the steps;
// 3. prologue, frame-parallel (4 frames a lane, 16-byte shared-memory
//    accesses, a row's constants hoisted): the level, the curve, v; the
//    RMS detector first stages (1 - d) p, and the curve follows its
//    average; the lookahead's window max over L + 1 frames by doubling in
//    shared memory (floor(log2(L + 1)) max passes and one more max);
// 4. each recurrence in turn (RMS average, release, attack): each lane
//    walks its sub-block from zero (max-decay: (M, D = prod rho);
//    one-pole: (Y, A = prod a)); a Kogge-Stone scan over the warp's 32
//    summaries in f64 gives the tile's aggregate; a decoupled look-back
//    (CUB's single-pass scan) over the row's tiles gives the tile's
//    incoming state; each lane's start is its exclusive prefix applied to
//    it. The attack's walk from zero runs the release from its true start
//    and leaves b = (1 - a) h in place of v, the last walk y in place of b;
// 5. epilogue, 4 frames a lane: the gain, times every channel of x, stored
//    with 16-byte streaming stores; the row's last lane writes the states.
// A look-back fetches the aggregates it applies 32 at a time, one a lane.
// Every tile publishes its inclusive prefix as its own aggregate applied to
// its predecessor's inclusive prefix (s_t = max(M_t, D_t s_{t-1}) or
// A_t s_{t-1} + Y_t, products P_t = P_{t-1} D_t), and a look-back that stops
// at an earlier inclusive prefix applies the aggregates between one at a
// time: the same numbers whichever predecessor it stops at. So two runs
// are bit-equal, and the kernel equals its host model
// (ops/dynamics_cuda.py::ballistics_model) bit for bit where they share
// the elementwise math. A look-back polls with a spin limit that traps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;        // sub-blocks of a tile
constexpr int kWarps = 4;         // warps of a block at most, each its own tile
constexpr int kParams = 11;       // the parameter slots below
constexpr int kStages = 3;        // the recurrences: RMS average, release, attack
constexpr int kStreams = 4;       // frame-wise walk coefficients: release, attack, floor, RMS average
constexpr int kPad = 4;           // floats after each sub-block in shared memory
constexpr int kSmemBytes = 232448;  // shared memory a block may use (after the opt-in)
constexpr long long kSpinLimit = 1LL << 24;  // look-back polls before the kernel traps
constexpr unsigned kAll = 0xffffffffu;
constexpr float kLog10_20 = 8.685889638065035f;  // 20 / ln 10
// x / c as the plain version forms it on the card: torch divides a tensor by
// a Python number as a multiply by the number's f32 reciprocal
constexpr float kInvLog10_20 = 1.0f / kLog10_20;
constexpr float kEps = 1e-10f;                   // the detector's -200 dBFS floor

enum { kOnePole = 0, kBallistics = 1, kCompressor = 2, kLimiter = 3, kGate = 4 };
enum { pRelease, pAttack, pFloor, pDetAvg, pThreshold, pRatio, pKnee, pMakeup, pCeiling, pRange, pHyst };
enum { sRms = 0, sRelease = 1, sAttack = 2 };  // scratch slots of the recurrences
enum { kMaxDecay = 0, kAffine = 1 };

}  // namespace

// One parameter: p[row * rs + n * fs] (fs 0: one value a row, 1: one a
// frame), or val where p is null.
struct WbParam {
  const float* p;
  long long rs;
  int fs;
  float val;
};

// The arguments of one call (bound with ctypes: ops/dynamics_cuda.py::WbDynArgs).
struct WbDynArgs {
  int kind;        // kOnePole .. kGate
  int detector;    // compressor: 0 peak, 1 RMS
  int key_mode;    // compressor, gate: 0 the detector hears x, 1 key, 2 silence
  int floor_on;    // ballistics: a floor is given
  int B;           // rows
  int C;           // channels (fused kinds)
  int F;           // frames
  int l;           // frames of a sub-block: 32, 64 or 128
  int look;        // the limiter's lookahead L, frames
  const float* x;  // fused: x [B][C][F] at row stride x_rs, channel stride x_cs; else v [B][F]
  long long x_rs;
  long long x_cs;
  const float* key;  // key_mode 1: [B][C][F] at its strides
  long long key_rs;
  long long key_cs;
  float* y;          // [B][C][F] (fused) or [B][F], contiguous
  WbParam prm[11];   // release, attack, floor, det_avg, threshold, ratio, knee, makeup, ceiling, range, hyst
  const float* e0;   // [B] release state in (red / open)
  const float* y0;   // [B] attack state in (att)
  const float* d0;   // [B] RMS average in (det)
  float* e_out;
  float* y_out;
  float* d_out;
  const float* look_in;  // [B][L] the levels' reductions of the L frames before the call
  float* look_out;
  const float* xdel_in;  // [B][C][L] the audio of the L frames before the call
  float* xdel_out;
  double* totals;  // [2][B]: prod rho, prod a over the row (unfused kinds), or null
  int* ints;       // [1 + 3 n_tiles]: the ticket, then the flags (0 none, 1 aggregate, 2 prefix)
  double* doubles;  // [3][n_tiles][4]: aggregate (value, product), inclusive prefix (value, product)
};

namespace {

// Where a warp's buffers sit in its part of shared memory (floats).
struct Layout {
  int nk, n_tiles, H, warp_floats;
  int off_s[kStreams];  // -1: one value a row
  int off_x, off_r;
};

__host__ __device__ inline bool per_frame(const WbParam& q) { return q.p != nullptr && q.fs == 1; }

Layout layout(const WbDynArgs& a) {
  Layout L;
  const int T = kLanes * a.l, sub = kLanes * (a.l + kPad);
  L.nk = (int)(((long long)a.F + T - 1) / T);
  L.n_tiles = a.B * L.nk;
  L.H = a.kind == kLimiter ? (a.look + 3) / 4 * 4 : 0;
  const bool staged[kStreams] = {
      a.kind >= kBallistics && per_frame(a.prm[pRelease]), per_frame(a.prm[pAttack]),
      (a.kind == kBallistics && a.floor_on && per_frame(a.prm[pFloor])) ||
          (a.kind == kGate && per_frame(a.prm[pRange])),
      a.kind == kCompressor && a.detector == 1 && per_frame(a.prm[pDetAvg])};
  int off = sub;  // the values, first
  for (int s = 0; s < kStreams; ++s) {
    L.off_s[s] = staged[s] ? off : -1;
    if (staged[s]) off += sub;
  }
  L.off_x = L.off_r = -1;
  if (a.kind >= kCompressor) {
    L.off_x = off;
    off += a.C * (L.H + T);
  }
  if (a.kind == kLimiter && a.look > 0) {
    L.off_r = off;
    off += L.H + T;
  }
  L.warp_floats = off;
  return L;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void fence_acquire() { asm volatile("fence.acq_rel.gpu;\n" ::: "memory"); }
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// frames [0, n) of src into dst in the sub-block layout (frame f at
// (f / l) * (l + kPad) + f % l)
__device__ __forceinline__ void stage_sub(float* dst, const float* src, int n, int l, int lane) {
  const int l4 = l / 4, st4 = l4 + kPad / 4;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n / 4;
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < n4; c += kLanes) cp_async16(d4 + (c / l4) * st4 + c % l4, src + 4 * c);
    done = n4 * 4;
  }
  for (int f = done + lane; f < n; f += kLanes) cp_async4(dst + (f / l) * (l + kPad) + f % l, src + f);
}

// frames [0, n) of src into dst in order (dst 16-byte aligned)
__device__ __forceinline__ void stage_lin(float* dst, const float* src, int n, int lane) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n / 4;
    for (int c = lane; c < n4; c += kLanes) cp_async16(dst + 4 * c, src + 4 * c);
    done = n4 * 4;
  }
  for (int f = done + lane; f < n; f += kLanes) cp_async4(dst + f, src + f);
}

// ---- the plain version's elementwise math, in its f32 order

__device__ __forceinline__ float level_db(float lvl) { return __fmul_rn(kLog10_20, logf(fmaxf(lvl, kEps))); }

// the soft knee's constants of one ratio and knee width (a row's, or a frame's)
struct Knee {
  float slope, hw, nhw, w2;  // 1 - 1/ratio, 0.5 w, -0.5 w, 2 w; w = max(knee, 1e-6)
};
__device__ __forceinline__ Knee knee_of(float ratio, float knee) {
  const float w = fmaxf(knee, 1e-6f);
  return {__fsub_rn(1.0f, __fdiv_rn(1.0f, ratio)), __fmul_rn(0.5f, w), __fmul_rn(-0.5f, w), __fmul_rn(2.0f, w)};
}

// ops/dynamics.py::compressor_reduction_db
__device__ __forceinline__ float compressor_db(float ldb, float thr, const Knee& k) {
  const float over = __fsub_rn(ldb, thr);
  float r;
  if (over <= k.nhw) {
    r = 0.0f;
  } else if (over >= k.hw) {
    r = __fmul_rn(k.slope, over);
  } else {
    const float t = __fadd_rn(over, k.hw);
    r = __fdiv_rn(__fmul_rn(k.slope, __fmul_rn(t, t)), k.w2);
  }
  return fmaxf(r, 0.0f);
}

// ops/dynamics.py::limiter_reduction_db
__device__ __forceinline__ float limiter_db(float ldb, float ceiling) { return fmaxf(__fsub_rn(ldb, ceiling), 0.0f); }

// the closed gate's gain, exp(-|range| / c)
__device__ __forceinline__ float gate_floor(float range) { return expf(__fmul_rn(-fabsf(range), kInvLog10_20)); }

// ops/dynamics.py::gate_open_gain
__device__ __forceinline__ float gate_target(float ldb, float thr, float floor, float hyst) {
  float t;
  if (hyst > 0.0f)
    t = fminf(fmaxf(__fdiv_rn(__fsub_rn(ldb, __fsub_rn(thr, hyst)), fmaxf(hyst, 1e-6f)), 0.0f), 1.0f);
  else
    t = ldb >= thr ? 1.0f : 0.0f;
  return __fadd_rn(floor, __fmul_rn(__fsub_rn(1.0f, floor), t));
}

// a parameter's value for one row (0 where it has one a frame)
__device__ __forceinline__ float row_value(const WbParam& q, int row) {
  return q.p == nullptr ? q.val : (q.fs == 1 ? 0.0f : __ldg(q.p + (long long)row * q.rs));
}
// a parameter of one row: its frames (one a frame) or its value
struct Row {
  const float* p;
  float c;
};
__device__ __forceinline__ Row row_of(const WbParam& q, int row, float value) {
  return {q.p != nullptr && q.fs == 1 ? q.p + (long long)row * q.rs : nullptr, value};
}
// the value at frame n of the row (0 past the row's end)
__device__ __forceinline__ float at(const Row& r, long long n, long long F) {
  return r.p == nullptr ? r.c : (n < F ? __ldg(r.p + n) : 0.0f);
}

// ---- the recurrences

// the state after a span with summary (val, prod), entered with state s
template <int kOp>
__device__ __forceinline__ double apply(double val, double prod, double s) {
  return kOp == kMaxDecay ? fmax(__dmul_rn(prod, s), val) : __dadd_rn(__dmul_rn(prod, s), val);
}

struct TileInfo {
  int row, k, lane;
  bool last_tile;
};

// From this lane's summary of its sub-block walked from zero (val, prod):
// the warp's Kogge-Stone scan, the tile's aggregate, the look-back over the
// row's tiles (slot `stage`), the tile's inclusive prefix -> this lane's
// start state. `init` is the row's state before frame 0; the row's last
// tile writes the product over the row to *total (lane 0) when given.
// A flag is stored with release semantics after the record it guards (by
// the same thread); the poll reads flags relaxed, then one acquire fence
// orders the records' loads after them; the predecessor's inclusive prefix
// and the aggregates after it are fetched in one round trip.
template <int kOp>
__device__ __forceinline__ double resolve(const WbDynArgs& A, const Layout& Lo, int stage, const TileInfo& ti,
                                          double val, double prod, double init, double* total) {
  const int lane = ti.lane;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const int off = 1 << b;
    const double ov = __shfl_up_sync(kAll, val, off), op = __shfl_up_sync(kAll, prod, off);
    if (lane >= off) {
      val = apply<kOp>(val, prod, ov);
      prod = __dmul_rn(op, prod);
    }
  }
  const double agg_v = __shfl_sync(kAll, val, 31), agg_p = __shfl_sync(kAll, prod, 31);
  const double ex_v = __shfl_up_sync(kAll, val, 1), ex_p = __shfl_up_sync(kAll, prod, 1);
  int* flags = A.ints + 1 + (long long)stage * Lo.n_tiles;
  double* dd = A.doubles + (long long)stage * Lo.n_tiles * 4;
  const long long me = (long long)ti.k * A.B + ti.row;
  double s = init, P = 1.0;
  if (ti.k > 0) {
    if (!ti.last_tile && lane == 0) {
      __stcg(dd + me * 4, agg_v);
      __stcg(dd + me * 4 + 1, agg_p);
      store_release(flags + me, 1);
    }
    int base = ti.k - 1, m;
    long long spins = 0;
    while (true) {
      const int kb = base - lane;
      const int f = kb >= 0 ? load_relaxed(flags + (long long)kb * A.B + ti.row) : 2;
      const unsigned two = __ballot_sync(kAll, f == 2), zero = __ballot_sync(kAll, f == 0);
      const int first2 = two ? __ffs(two) - 1 : 32;
      const unsigned before = first2 == 32 ? kAll : ((1u << first2) - 1u);
      if (zero & before) {
        if (++spins > kSpinLimit) __trap();  // a predecessor that never publishes: fail, do not hang
        __nanosleep(64);
        continue;
      }
      if (first2 < 32) {
        m = base - first2;  // tile 0 always publishes its prefix, so m >= 0
        break;
      }
      base -= 32;
    }
    fence_acquire();
    __syncwarp();
    // the prefix of tile m and the aggregates after it, 32 fetched at once,
    // applied one at a time in order
    const long long at_m = ((long long)m * A.B + ti.row) * 4;
    for (int q0 = m + 1; q0 < ti.k || q0 == m + 1; q0 += kLanes) {
      const int q = q0 + lane;
      double qv = 0.0, qp = 1.0;
      if (q < ti.k) {
        const long long aq = ((long long)q * A.B + ti.row) * 4;
        qv = __ldcg(dd + aq);
        qp = __ldcg(dd + aq + 1);
      }
      if (q0 == m + 1) {
        s = __ldcg(dd + at_m + 2);
        P = __ldcg(dd + at_m + 3);
      }
      const int n = min(kLanes, ti.k - q0);
      for (int i = 0; i < n; ++i) {
        const double v = __shfl_sync(kAll, qv, i), p = __shfl_sync(kAll, qp, i);
        s = apply<kOp>(v, p, s);
        P = __dmul_rn(P, p);
      }
    }
  }
  const double incl_s = apply<kOp>(agg_v, agg_p, s), incl_p = __dmul_rn(P, agg_p);
  if (lane == 0) {
    if (!ti.last_tile) {
      __stcg(dd + me * 4 + 2, incl_s);
      __stcg(dd + me * 4 + 3, incl_p);
      store_release(flags + me, 2);
    } else if (total != nullptr) {
      *total = incl_p;
    }
  }
  return lane == 0 ? s : apply<kOp>(ex_v, ex_p, s);
}

// a walk coefficient at frames 4i..4i+3 of this lane's sub-block: from its
// stream, or the row's value
__device__ __forceinline__ float4 coef4(const float* stream, int i, float c) {
  return stream != nullptr ? reinterpret_cast<const float4*>(stream)[i] : make_float4(c, c, c, c);
}

__device__ __forceinline__ float at4(const float4& q, int c) {
  return c == 0 ? q.x : (c == 1 ? q.y : (c == 2 ? q.z : q.w));
}
__device__ __forceinline__ void set4(float4& q, int c, float v) {
  if (c == 0) q.x = v;
  else if (c == 1) q.y = v;
  else if (c == 2) q.z = v;
  else q.w = v;
}

// kFw: some walk coefficient is one a frame (a stream in shared memory);
// without, the walks take the row's values, converted to f64 once
template <int kKind, bool kFw>
__global__ void __launch_bounds__(kLanes * kWarps) dyn_kernel(const WbDynArgs A, const Layout Lo) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int t = 0;
  if (lane == 0) t = atomicAdd(A.ints, 1);
  t = __shfl_sync(kAll, t, 0);
  if (t >= Lo.n_tiles) return;  // the whole warp
  const int row = t % A.B, k = t / A.B;
  const int l = A.l, ls = __ffs(l) - 1, T = kLanes * l, st = l + kPad, l4 = l / 4, st4 = st / 4;
  const long long f0 = (long long)k * T, F = A.F;
  const int len = (int)min((long long)T, F - f0), n4 = (len + 3) / 4;
  const TileInfo ti{row, k, lane, k == Lo.nk - 1};
  const int nj = max(0, min(l, len - lane * l));  // frames of this lane's sub-block
  const bool row_last = ti.last_tile && lane == (len - 1) / l;
  float* base = reinterpret_cast<float*>(smem4) + (size_t)warp * Lo.warp_floats;
  float* V = base;  // [32][l + kPad]: v, then (1 - a) h, then y
  float4* V4 = reinterpret_cast<float4*>(V);
  float4* mine = V4 + lane * st4;
  auto sb = [&](int f) { return (f >> ls) * st + (f & (l - 1)); };       // frame f in the sub-block layout
  auto sb4 = [&](int c) { return (c >> (ls - 2)) * st4 + (c & (l4 - 1)); };  // frames 4c..4c+3
  float* streams[kStreams];
  const float* lane_s[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    streams[s] = Lo.off_s[s] >= 0 ? base + Lo.off_s[s] : nullptr;
    lane_s[s] = streams[s] != nullptr ? streams[s] + lane * st : nullptr;
  }
  const int H = Lo.H, W = H + T;
  float* xs = base + (Lo.off_x >= 0 ? Lo.off_x : 0);  // channel c's frame f at xs[c * W + H + f]
  // the row's parameters and states in, fetched while the tile stages
  float rv[kParams];
#pragma unroll
  for (int i = 0; i < kParams; ++i) rv[i] = row_value(A.prm[i], row);
  const bool rms = kKind == kCompressor && A.detector == 1;
  const float e_in = kKind >= kBallistics ? __ldg(A.e0 + row) : 0.0f, y_in = __ldg(A.y0 + row),
              d_in = rms ? __ldg(A.d0 + row) : 0.0f;
  auto prm_row = [&](int i) { return row_of(A.prm[i], row, rv[i]); };

  // 2. stage x (or v) and the frame-wise walk coefficients
  if (kKind <= kBallistics) {
    stage_sub(V, A.x + (long long)row * A.x_rs + f0, len, l, lane);
  } else {
    for (int c = 0; c < A.C; ++c) {
      const float* src = A.x + (long long)row * A.x_rs + (long long)c * A.x_cs;
      stage_lin(xs + c * W + H, src + f0, len, lane);
      if (kKind == kLimiter) {
        for (int j = lane; j < A.look; j += kLanes) {
          const long long m = f0 - A.look + j;
          const float* from = m >= 0 ? src + m : A.xdel_in + ((long long)row * A.C + c) * A.look + (m + A.look);
          cp_async4(xs + c * W + H - A.look + j, from);
        }
      }
    }
  }
  const int copied[kStreams] = {pRelease, pAttack, pFloor, pDetAvg};
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    if (streams[s] == nullptr || (kKind == kGate && s == 2)) continue;  // the gate's floor is computed
    const WbParam& q = A.prm[copied[s]];
    stage_sub(streams[s], q.p + (long long)row * q.rs + f0, len, l, lane);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // 3. prologue, 4 frames a lane: the level, the curve -> v (the RMS
  // detector: (1 - d) p)
  if (kKind >= kCompressor) {
    const int kmode = kKind == kLimiter ? 0 : A.key_mode;
    const float* key = A.key + (long long)row * A.key_rs;
    // the detector's input, channel ch, frames 4c..4c+3 of the tile
    auto source4 = [&](int ch, int c, float (&v)[4]) {
      if (kmode == 1) {
        const float* kp = key + (long long)ch * A.key_cs + f0 + 4 * c;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = 4 * c + j < len ? __ldg(kp + j) : 0.0f;
      } else {
        const float4 q = reinterpret_cast<const float4*>(xs + ch * W + H)[c];
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      }
    };
    auto peak4 = [&](int c, float (&m)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = 0.0f;
      if (kmode == 2) return;
      for (int ch = 0; ch < A.C; ++ch) {
        float v[4];
        source4(ch, c, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j] = ch == 0 ? fabsf(v[j]) : fmaxf(m[j], fabsf(v[j]));
      }
    };
    if (kKind == kCompressor) {
      const Row thr = prm_row(pThreshold), ratio = prm_row(pRatio), knee = prm_row(pKnee);
      const bool knee_fw = ratio.p != nullptr || knee.p != nullptr;
      const Knee kc = knee_of(ratio.c, knee.c);
      if (rms) {
        const Row d = prm_row(pDetAvg);
        for (int c = lane; c < n4; c += kLanes) {
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (kmode != 2) {
            for (int ch = 0; ch < A.C; ++ch) {
              float v[4];
              source4(ch, c, v);
#pragma unroll
              for (int j = 0; j < 4; ++j) p[j] = ch == 0 ? __fmul_rn(v[j], v[j]) : __fadd_rn(p[j], __fmul_rn(v[j], v[j]));
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) p[j] = __fdiv_rn(p[j], (float)A.C);
          }
          float4 o;
#pragma unroll
          for (int j = 0; j < 4; ++j) set4(o, j, __fmul_rn(__fsub_rn(1.0f, at(d, f0 + 4 * c + j, F)), p[j]));
          V4[sb4(c)] = o;
        }
      } else {
        for (int c = lane; c < n4; c += kLanes) {
          float m[4];
          peak4(c, m);
          float4 o;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long long n = f0 + 4 * c + j;
            const Knee kj = knee_fw ? knee_of(at(ratio, n, F), at(knee, n, F)) : kc;
            set4(o, j, compressor_db(level_db(m[j]), at(thr, n, F), kj));
          }
          V4[sb4(c)] = o;
        }
      }
    } else if (kKind == kLimiter) {
      const Row ceil_ = prm_row(pCeiling);
      const int L = A.look;
      if (L == 0) {
        for (int c = lane; c < n4; c += kLanes) {
          float m[4];
          peak4(c, m);
          float4 o;
#pragma unroll
          for (int j = 0; j < 4; ++j) set4(o, j, limiter_db(level_db(m[j]), at(ceil_, f0 + 4 * c + j, F)));
          V4[sb4(c)] = o;
        }
      } else {
        // R[j]: the reduction at frame f0 - L + j, j < L + len; the last L
        // frames of the row (and, from tile 0, what of the state in is kept)
        // go to the states out
        float* R = base + Lo.off_r + (H - L);
        const int n = L + len;
        const long long keep = F - L;  // frames >= keep are in the states out
        for (int j = lane; j < n; j += kLanes) {
          const long long m = f0 - L + j;
          float r;
          if (m < 0) {
            r = __ldg(A.look_in + (long long)row * L + (m + L));
          } else {
            float pk = fabsf(xs[H - L + j]);
            for (int ch = 1; ch < A.C; ++ch) pk = fmaxf(pk, fabsf(xs[ch * W + H - L + j]));
            r = limiter_db(level_db(pk), at(ceil_, m, F));
          }
          R[j] = r;
          if (m >= keep && (m >= f0 || k == 0)) {
            A.look_out[(long long)row * L + (m - keep)] = r;
            for (int ch = 0; ch < A.C; ++ch)
              A.xdel_out[((long long)row * A.C + ch) * L + (m - keep)] = xs[ch * W + H - L + j];
          }
        }
        __syncwarp();
        // max over windows of 2^p frames, in place: R[i] = max(R[i..i+2^p-1])
        const int p_top = 31 - __clz(L + 1);
        for (int p = 0; p < p_top; ++p) {
          const int s = 1 << p, lim = n - s;
          for (int i0 = 0; i0 < lim; i0 += kLanes) {
            const int i = i0 + lane;
            float a = 0.0f, b = 0.0f;
            if (i < lim) {
              a = R[i];
              b = R[i + s];
            }
            __syncwarp();
            if (i < lim) R[i] = fmaxf(a, b);
          }
          __syncwarp();
        }
        const int o = L + 1 - (1 << p_top);
        for (int f = lane; f < len; f += kLanes) V[sb(f)] = fmaxf(R[f], R[f + o]);
      }
    } else {  // kGate
      const Row thr = prm_row(pThreshold), range = prm_row(pRange), hyst = prm_row(pHyst);
      const float floor_c = gate_floor(range.c);
      for (int c = lane; c < n4; c += kLanes) {
        float m[4];
        peak4(c, m);
        float4 o, fl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long n = f0 + 4 * c + j;
          const float floor = range.p != nullptr ? gate_floor(at(range, n, F)) : floor_c;
          set4(fl, j, floor);
          set4(o, j, gate_target(level_db(m[j]), at(thr, n, F), floor, at(hyst, n, F)));
        }
        V4[sb4(c)] = o;
        if (streams[2] != nullptr) reinterpret_cast<float4*>(streams[2])[sb4(c)] = fl;
      }
    }
    __syncwarp();
  }

  // 4a. the RMS detector's average, then the curve on its level
  if (rms) {
    const float cd = rv[pDetAvg];
    const double dd = (double)cd;
    double y = 0.0, P = 1.0;
    for (int i = 0; 4 * i < nj; ++i) {
      const float4 b = mine[i], d = coef4(kFw ? lane_s[3] : nullptr, i, cd);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (4 * i + c < nj) {
          const double dc = kFw ? (double)at4(d, c) : dd;
          y = __dadd_rn(__dmul_rn(dc, y), (double)at4(b, c));
          P = __dmul_rn(P, dc);
        }
      }
    }
    y = resolve<kAffine>(A, Lo, sRms, ti, y, P, (double)d_in, nullptr);
    for (int i = 0; 4 * i < nj; ++i) {
      float4 b = mine[i];
      const float4 d = coef4(kFw ? lane_s[3] : nullptr, i, cd);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (4 * i + c < nj) {
          y = __dadd_rn(__dmul_rn(kFw ? (double)at4(d, c) : dd, y), (double)at4(b, c));
          set4(b, c, (float)y);
        }
      }
      mine[i] = b;
    }
    if (row_last) A.d_out[row] = (float)y;
    __syncwarp();
    const Row thr = prm_row(pThreshold), ratio = prm_row(pRatio), knee = prm_row(pKnee);
    const bool knee_fw = ratio.p != nullptr || knee.p != nullptr;
    const Knee kc = knee_of(ratio.c, knee.c);
    for (int c = lane; c < n4; c += kLanes) {
      float4 o = V4[sb4(c)];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long n = f0 + 4 * c + j;
        const Knee kj = knee_fw ? knee_of(at(ratio, n, F), at(knee, n, F)) : kc;
        set4(o, j, compressor_db(level_db(sqrtf(fmaxf(at4(o, j), 0.0f))), at(thr, n, F), kj));
      }
      V4[sb4(c)] = o;
    }
    __syncwarp();
  }

  // 4b. the release from zero; its start
  const float c_rel = kKind >= kBallistics ? rv[pRelease] : 0.0f;
  const float c_att = rv[pAttack];
  const bool has_floor = kKind == kGate || (kKind == kBallistics && A.floor_on);
  float c_floor = 0.0f;
  if (kKind == kGate && streams[2] == nullptr) c_floor = gate_floor(rv[pRange]);
  if (kKind == kBallistics && has_floor) c_floor = rv[pFloor];
  const double d_rel = (double)c_rel, d_att = (double)c_att;
  double e = 0.0;
  if (kKind >= kBallistics) {
    double D = 1.0;
    for (int i = 0; 4 * i < nj; ++i) {
      const float4 v = mine[i], r = coef4(kFw ? lane_s[0] : nullptr, i, c_rel);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (4 * i + c < nj) {
          const double rc = kFw ? (double)at4(r, c) : d_rel;
          e = fmax(__dmul_rn(rc, e), (double)at4(v, c));
          D = __dmul_rn(D, rc);
        }
      }
    }
    e = resolve<kMaxDecay>(A, Lo, sRelease, ti, e, D, (double)e_in, A.totals != nullptr ? A.totals + row : nullptr);
  }

  // 4c. the release from its start, b = (1 - a) h in place of v, the
  // attack from zero; its start
  double y = 0.0;
  {
    double P = 1.0;
    const float one_a = __fsub_rn(1.0f, c_att);
    for (int i = 0; 4 * i < nj; ++i) {
      float4 v = mine[i];
      const float4 r = coef4(kFw ? lane_s[0] : nullptr, i, c_rel), a = coef4(kFw ? lane_s[1] : nullptr, i, c_att),
                   fl = coef4(kFw ? lane_s[2] : nullptr, i, c_floor);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (4 * i + c < nj) {
          float h = at4(v, c);
          if (kKind >= kBallistics) {
            e = fmax(__dmul_rn(kFw ? (double)at4(r, c) : d_rel, e), (double)h);
            h = (float)e;
            if (has_floor) h = fmaxf(h, at4(fl, c));
          }
          const double ad = kFw ? (double)at4(a, c) : d_att;
          const float b = __fmul_rn(kFw ? __fsub_rn(1.0f, at4(a, c)) : one_a, h);
          set4(v, c, b);
          y = __dadd_rn(__dmul_rn(ad, y), (double)b);
          P = __dmul_rn(P, ad);
        }
      }
      mine[i] = v;
    }
    if (kKind >= kBallistics && row_last) A.e_out[row] = (float)e;
    y = resolve<kAffine>(A, Lo, sAttack, ti, y, P, (double)y_in,
                         A.totals != nullptr ? A.totals + A.B + row : nullptr);
  }

  // 4d. the attack from its start: y in place of b
  for (int i = 0; 4 * i < nj; ++i) {
    float4 b = mine[i];
    const float4 a = coef4(kFw ? lane_s[1] : nullptr, i, c_att);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (4 * i + c < nj) {
        y = __dadd_rn(__dmul_rn(kFw ? (double)at4(a, c) : d_att, y), (double)at4(b, c));
        set4(b, c, (float)y);
      }
    }
    mine[i] = b;
  }
  if (row_last) A.y_out[row] = (float)y;
  __syncwarp();

  // 5. epilogue, 4 frames a lane
  if (kKind <= kBallistics) {
    float* yo = A.y + (long long)row * F + f0;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(yo) & 15) == 0) {
      for (int c = lane; c < len / 4; c += kLanes) __stcs(reinterpret_cast<float4*>(yo) + c, V4[sb4(c)]);
      done = len / 4 * 4;
    }
    for (int f = done + lane; f < len; f += kLanes) __stcs(yo + f, V[sb(f)]);
  } else {
    const int shift = kKind == kLimiter ? A.look : 0;  // the limiter's output is x delayed by L
    const Row makeup = prm_row(pMakeup);
    const bool x_al = (shift & 3) == 0, y_al = (F & 3) == 0;
    for (int c = lane; c < n4; c += kLanes) {
      const float4 s = V4[sb4(c)];
      float g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sj = at4(s, j);
        if (kKind == kCompressor) g[j] = expf(__fmul_rn(__fsub_rn(at(makeup, f0 + 4 * c + j, F), sj), kInvLog10_20));
        else if (kKind == kLimiter) g[j] = expf(__fmul_rn(-sj, kInvLog10_20));
        else g[j] = sj;
      }
      const int nv = min(4, len - 4 * c);
      for (int ch = 0; ch < A.C; ++ch) {
        const float* xp = xs + ch * W + H - shift + 4 * c;
        float xv[4];
        if (x_al) {
          const float4 q = *reinterpret_cast<const float4*>(xp);
          xv[0] = q.x, xv[1] = q.y, xv[2] = q.z, xv[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xp[j];
        }
        float* yp = A.y + ((long long)row * A.C + ch) * F + f0 + 4 * c;
        if (y_al && nv == 4) {
          __stcs(reinterpret_cast<float4*>(yp), make_float4(__fmul_rn(xv[0], g[0]), __fmul_rn(xv[1], g[1]),
                                                            __fmul_rn(xv[2], g[2]), __fmul_rn(xv[3], g[3])));
        } else {
          for (int j = 0; j < nv; ++j) __stcs(yp + j, __fmul_rn(xv[j], g[j]));
        }
      }
    }
  }
}

template <int kKind, bool kFw>
int launch(const WbDynArgs& a, const Layout& Lo, cudaStream_t stream) {
  static bool opted = false;  // shared memory above 48 KB only after the opt-in
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(dyn_kernel<kKind, kFw>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const size_t warp_bytes = (size_t)Lo.warp_floats * sizeof(float);
  const int wpb = (int)(kSmemBytes / warp_bytes < (size_t)kWarps ? kSmemBytes / warp_bytes : kWarps);
  cudaError_t err = cudaMemsetAsync(a.ints, 0, sizeof(int) * (1 + (size_t)kStages * Lo.n_tiles), stream);
  if (err != cudaSuccess) return (int)err;
  dyn_kernel<kKind, kFw><<<(unsigned)((Lo.n_tiles + wpb - 1) / wpb), kLanes * wpb, wpb * warp_bytes, stream>>>(a, Lo);
  return (int)cudaGetLastError();
}

template <int kKind>
int launch(const WbDynArgs& a, const Layout& Lo, cudaStream_t stream) {
  for (int s = 0; s < kStreams; ++s)
    if (Lo.off_s[s] >= 0) return launch<kKind, true>(a, Lo, stream);
  return launch<kKind, false>(a, Lo, stream);
}

bool param_ok(const WbParam& q) { return q.p == nullptr || ((q.fs == 0 || q.fs == 1) && q.rs >= 0); }

}  // namespace

// Plain C entry point (bound with ctypes). Checks the arguments (returns
// cudaErrorInvalidValue without launching when one is out of range: B, F
// >= 1; l 32, 64 or 128; C >= 1 for the fused kinds; a tile's buffers
// within kSmemBytes), zeroes the ticket and flags (a memset on `stream`),
// launches the kernel on `stream` and returns cudaGetLastError(). Does not
// synchronise and allocates nothing.
extern "C" int wb_dynamics(const WbDynArgs* args, void* stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const WbDynArgs& a = *args;
  if (a.kind < kOnePole || a.kind > kGate || a.B < 1 || a.F < 1 || (a.l != 32 && a.l != 64 && a.l != 128) ||
      a.x == nullptr || a.y == nullptr || a.y0 == nullptr || a.y_out == nullptr || a.ints == nullptr ||
      a.doubles == nullptr || a.look < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kParams; ++i)
    if (!param_ok(a.prm[i])) return (int)cudaErrorInvalidValue;
  if (a.kind >= kBallistics && (a.e0 == nullptr || a.e_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.kind >= kCompressor && (a.C < 1 || a.x_rs < 0 || a.x_cs < 0)) return (int)cudaErrorInvalidValue;
  if ((a.kind == kCompressor || a.kind == kGate) && a.key_mode == 1 && a.key == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a.kind == kCompressor && a.detector == 1 && (a.d0 == nullptr || a.d_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.kind == kLimiter && a.look > 0 &&
      (a.look_in == nullptr || a.look_out == nullptr || a.xdel_in == nullptr || a.xdel_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)a.B * (((long long)a.F + kLanes * a.l - 1) / (kLanes * a.l)) > (1LL << 29))
    return (int)cudaErrorInvalidValue;
  const Layout Lo = layout(a);
  if ((size_t)Lo.warp_floats * sizeof(float) > (size_t)kSmemBytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.kind) {
    case kOnePole: return launch<kOnePole>(a, Lo, st);
    case kBallistics: return launch<kBallistics>(a, Lo, st);
    case kCompressor: return launch<kCompressor>(a, Lo, st);
    case kLimiter: return launch<kLimiter>(a, Lo, st);
    default: return launch<kGate>(a, Lo, st);
  }
}
