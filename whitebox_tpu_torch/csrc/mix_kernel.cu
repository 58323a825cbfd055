// Timeline mix kernel for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel whitebox_tpu/ops/mix_pallas.py::_mix_kernel
// (launched by _mix_call) in every specialisation the bounce runs: the
// fast slots (speed-1 copies, kernel K1), the resampled slots, forward and
// reverse, in the three interpolation modes of mix_pallas.py:514-566
// (K2-linear, K2-catmull, K2-poly; the compile-time parameter kInterp), in
// the kAuto variant the in-kernel automation lanes (K3: _lane_eval_kernel,
// mix_pallas.py:384-404, and the gain block :443-460), and, in
// mix_per_track_kernel, the per-track mode (K4, per_track=True:
// :431-436, :581-593, :608-610), which writes each track's pre-gain sum
// [T, C, F] for the effect finishers (see the note above that kernel).
// The fused sinc prerender (timeline/prerender.py:737-752 there) has no
// device function of its own: it is this kernel launched over a pool that
// torch ops extended on the card (whitebox_tpu_torch/timeline/prerender.py).
//
// What it computes, per output frame `pos` of tile `ti` and channel `ch`:
//   acc = 0
//   for t in 0..T-1, for k in 0..K-1 (slot s = (ti*T + t)*K + k), if active:
//     v   = fast: pool[src_start + pos] (optionally clamped to +-1)
//           slow: ix, fx = phase(pos - ms); p[j] = pool[src_start+ix+j];
//                 linear:  v = p[0] + fx*(p[1]-p[0])
//                 catmull: the uniform Catmull-Rom cubic through p[-1..2]
//                 poly:    v = sum_k w_k(fx) * p[k - (taps/2-1)], each w_k a
//                          polynomial in fx by Horner (see slot_sample)
//     env = clip((pos-fis)*fii, 0, 1) * clip((foe-pos)*foi, 0, 1)
//     acc += (ms <= pos < me) ? ((v*gain)*env)*g[t,ch] : 0
//   out = hard clip of acc to +-1
// with g[t,ch] = tg[t,ch], the constant fader gain, or, in the kAuto
// variant for a track with use[t]:
//   vol = lane(volume, frame), pan = lane(pan, frame), px = 0.5*(pan+1)
//   g   = (vol * sin(pi/2 * (ch even ? 1-px : px)) * sqrt2) * mute[t]
// at the global frame ti*tile + pos. Every slot of every track is added in
// that order (engine.cpp:1616), so without lanes the result is
// bit-identical to the JAX kernel and, at speed 1, to the NumPy oracle.
//
// Numerics: every multiply, add and divide is written with __fmul_rn/
// __fadd_rn/__fsub_rn/__fdiv_rn, which nvcc never contracts into an FMA
// (the build also passes --fmad=false). Denormals are kept (no fast math);
// sinf/expf/exp2f/powf are the accurate library functions, never the
// __sinf-style intrinsics. Clamp and clip use the select form of the
// reference, so a NaN passes through as it does there.
//
// What bounds it on an H100: at the headline size (128 tracks x 60 s,
// 48 kHz stereo) the sample pool is 4.9 MB and sits in the 50 MB L2, so
// pool reads are L2 traffic; the one stream that has to reach HBM is the
// 23 MB output write. Bytes and f32 operations both bound it far below a
// millisecond (0.05 ms at the headline size), so what it spends is
// instruction throughput: per frame ~118 slots cover it, of the T*K = 256 its
// tile holds (640 in the 4x oversampled form), and everything a thread
// does per slot that is not a sample's arithmetic is overhead.
//
// What the design does about it (the summing kernels, K1-K3):
// - One thread per frame for all channels of a channel group (two
//   channels, or a last odd one; a launch per group, no grid dimension
//   over channels). Per covering slot the cover test, the fade envelope,
//   the double-single phase and, with polynomial taps, each tap's Horner
//   weight are computed once; per channel only the tap loads, the taps'
//   arithmetic, v*gain, *env, *g[t,ch] and the add. Each (frame, channel)
//   gets the operations it got before, in the same order.
// - A compacted slot list per block, staged in shared memory. A block
//   covers kFramesPerBlock frames of one tile. Its threads look at the
//   tile's T*K raw slots kStageSlots at a time, one slot per thread
//   (coalesced reads of ms/me), keep a slot iff it is active and meets the
//   block's frames, and write the kept slots in (track, slot) order (warp
//   ballots + a prefix sum over the warps' counts) as 64-byte entries with
//   all a covering thread needs (stage_slots). Threads then walk only the
//   kept list, each entry three or four 16-byte broadcast reads from shared
//   memory. Skipping a slot that misses a frame is bit-safe: the
//   accumulator starts at +0.0 and a round-to-nearest sum never yields
//   -0.0, so the +0.0 the reference adds there changes nothing, and a NaN
//   or infinite sample still only enters where its slot covers the frame.
// - Fixed shared memory, double-buffered with cp.async. The staging works
//   in passes of kStageSlots raw slots (kStageSlots / K tracks) into one of
//   two buffers of kStageSlots entries, 2 x 16 KB whatever T and K are, so
//   the blocks resident per SM do not depend on the session (dynamic shared
//   memory sized to T*K would: 128 tracks x 16 slots x 64 B is 128 KB). The
//   metadata of pass n+1 travels by cp.async (4-byte copies gathered from
//   the struct-of-arrays tables: a bulk copy has nothing contiguous to
//   take) while the threads walk pass n; the wait and one barrier come
//   before the walk, one barrier after it frees the buffer.
// - K3: one thread per track finds, once per block, the range of lane
//   segments the block's frames can pick (lane_range), so a frame's lane
//   evaluation starts there and usually has nothing to search; a lane that
//   holds one value over the whole block (before its first point, after its
//   last, or a track without that lane) is evaluated there once, the pan
//   sines with it (track_block_rows). A thread evaluates a track's lanes at
//   the first slot of the track that covers its frame, once for both
//   channels, and not at all when none does; only the held values are
//   computed for tracks no slot covers, and they are used nowhere then.
// - Polynomial taps: a 6 x 6 table, the only shape the port designs, takes
//   an instantiation with both counts known to the compiler (kPoly6): the
//   six Horner chains unroll and interleave and each coefficient is an
//   instruction operand. With the counts read at run time the same kernel
//   took 2.3x as long (4.20 against 1.82 ms); other shapes keep that path.
// - Block geometry, from measurements on the card: 256 frames per block and
//   one frame per thread. 128 frames per block timed within +-5 % of it on
//   every row, two frames per thread (512 per block) within +-2 % without
//   lanes and 4-6 % slower with them, and asking for the largest
//   shared-memory carve-out 2-5 % slower than the default one.
// Registers and occupancy (nvcc 12.9 --resource-usage, sm_90a; 256 threads,
// 32,832 B of static shared memory): kLinear, kCatmull, kPoly and kPoly6
// without lanes 40 registers, 6 blocks per SM (75 % of 2,048 threads; the
// registers and the shared memory both allow 6); with lanes (kAuto) 48
// registers, 5 blocks (62 %), plus 32 B per track of dynamic shared memory;
// no spills but 24 bytes in the one-channel kAuto kPoly6 instantiation.
// Measured on an H100 80GB HBM3 (700 W limit) at 128 tracks x 60 s by
// chip_smoke.py, the earlier design (one thread per (frame, channel)
// walking all T*K slots in device memory) beside it: speed-1 slots 0.83 ms
// (3.36), half the clips linear-resampled 0.99 (3.94), two thirds of the
// clips Catmull-Rom 1.31 (4.33) or six taps over the 4x pool 1.83 (10.8),
// 128 tracks with a volume lane 2.49 (10.4), 32 tracks with volume and pan
// lanes 1.08 (2.72), speed-1 slots over a 1.9 GB prerendered pool 1.08
// (3.44); every variant equal to its plain version to 0 ulp. That is 16x
// the bound at speed 1, 19x with lanes and 2.8x with six taps. At the full
// instruction rate of 132 SMs these times come to ~80 instructions per covered
// (frame, slot) of a copied sample and ~300 per (frame, track) whose two
// lanes both ramp (an IEEE divide and an accurate sine each).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFramesPerBlock = 256;           // frames, and threads, of a block
constexpr int kWarps = kFramesPerBlock / 32;
constexpr int kStageSlots = kFramesPerBlock;   // raw slots a staging pass looks at, one per thread
constexpr int32_t kSentinel = 0x7fffffff;      // ops/automation.py _SENTINEL
constexpr float kHalfPi = 1.5707963705062866f;  // np.float32(0.5 * pi)
constexpr float kSqrt2 = 1.4142135381698608f;   // np.float32(sqrt(2))

// Automation lane tables (K3), each lane [T, P] row-major; mute, use [T].
struct Lanes {
  const int32_t* vxs;
  const float* vys;
  const int32_t* vcv;
  const float* vtn;
  const int32_t* pxs;
  const float* pys;
  const int32_t* pcv;
  const float* ptn;
  const float* mute;
  const int32_t* use;
  int P;
};

// Interpolation of resampled slots (mix_pallas.py:514-566).
constexpr int kLinear = 0;
constexpr int kCatmull = 1;
constexpr int kPoly = 2;
// kPoly for a table of exactly 6 taps x 6 coefficients (the shape
// ops/resample.py::design_poly_interp designs by default): the same
// arithmetic with both counts known to the compiler, which unrolls the
// Horner chains and reads each coefficient as an instruction operand
constexpr int kPoly6 = 3;
constexpr int kPoly6Taps = 6;
constexpr int kPoly6Coeffs = 6;
constexpr int kMaxPolyTaps = 8;
constexpr int kMaxPolyCoeffs = 8;

// ("poly", coeffs): tap k weighs pool[ix + k - (taps/2 - 1)] with
// w_k(fx) = sum_m c[k][m] * fx^m (ops/resample.py::design_poly_interp).
struct PolyCoeffs {
  int taps;
  int ncoef;
  float c[kMaxPolyTaps][kMaxPolyCoeffs];
};

// Dekker split with the f32 constant 2^12 + 1.
__device__ __forceinline__ void dekker_split(float a, float* hi, float* lo) {
  float c = __fmul_rn(4097.0f, a);
  *hi = __fsub_rn(c, __fsub_rn(c, a));
  *lo = __fsub_rn(a, *hi);
}

// x = (fh + fl) + j * (sh + sl) in double-single; returns floor and
// fraction. Mirrors whitebox_tpu/ops/dsarith.py::phase_eval op for op.
__device__ __forceinline__ void phase_eval(int j, float fh, float fl, float sh,
                                           float sl, int* ix, float* fx) {
  float jf = __int2float_rn(j);
  // two_prod(jf, sh)
  float p = __fmul_rn(jf, sh);
  float ah, al, bh, bl;
  dekker_split(jf, &ah, &al);
  dekker_split(sh, &bh, &bl);
  float pe = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p), __fmul_rn(ah, bl)),
                __fmul_rn(al, bh)),
      __fmul_rn(al, bl));
  float lo_term = __fadd_rn(pe, __fmul_rn(jf, sl));
  // two_sum(fh, p)
  float s = __fadd_rn(fh, p);
  float bb = __fsub_rn(s, fh);
  float se = __fadd_rn(__fsub_rn(fh, __fsub_rn(s, bb)), __fsub_rn(p, bb));
  float lo = __fadd_rn(se, __fadd_rn(fl, lo_term));
  // renormalize: two_sum(s, lo)
  float hi = __fadd_rn(s, lo);
  bb = __fsub_rn(hi, s);
  float lo2 = __fadd_rn(__fsub_rn(s, __fsub_rn(hi, bb)), __fsub_rn(lo, bb));

  float ixf = floorf(hi);
  float r = __fadd_rn(__fsub_rn(hi, ixf), lo2);
  // boundary adjustments: r can land just outside [0, 1)
  if (r < 0.0f) {
    ixf = __fsub_rn(ixf, 1.0f);
    r = __fadd_rn(r, 1.0f);
  } else if (r >= 1.0f) {
    ixf = __fadd_rn(ixf, 1.0f);
    r = __fsub_rn(r, 1.0f);
  }
  *ix = (int)ixf;
  *fx = r;
}

__device__ __forceinline__ float clip01(float x) {
  x = x < 0.0f ? 0.0f : x;
  return x > 1.0f ? 1.0f : x;
}

// a - b in int32 with wrap-around, as JAX computes it (a negative breakpoint
// against the sentinel overflows; through uint32_t that is defined in C++)
__device__ __forceinline__ int sub_wrap(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

// exponential_ease: (exp(x*ts) - 1) / (exp(ts) - 1), linear near t == 0
__device__ __forceinline__ float ease_exp(float x, float t, float ts) {
  if (fabsf(t) < 1e-2f) return x;
  return __fdiv_rn(__fsub_rn(expf(__fmul_rn(x, ts)), 1.0f), __fsub_rn(expf(ts), 1.0f));
}

// exponential_ease2: (x - ta*x) / (ta - 2*ta*|x| + 1)
__device__ __forceinline__ float ease_alt(float x, float ta) {
  return __fdiv_rn(__fsub_rn(x, __fmul_rn(ta, x)),
                   __fadd_rn(__fsub_rn(ta, __fmul_rn(__fmul_rn(2.0f, ta), fabsf(x))), 1.0f));
}

// the symmetric S-curve of a single form: f at 2u below the middle, the
// mirror of f at 2(1-u) above it
__device__ __forceinline__ float dual(float u, float f_u, float f_mirror) {
  return u < 0.5f ? __fmul_rn(0.5f, f_u) : __fsub_rn(1.0f, __fmul_rn(0.5f, f_mirror));
}

// ops/automation.py::_apply_curve for one segment: only its own branch
__device__ float apply_curve(float u, int curve, float t) {
  const float ts = fabsf(t) < 1e-2f ? 1e-2f : t;
  float ta = t < -0.95f ? -0.95f : t;
  ta = ta > 0.95f ? 0.95f : ta;
  const float u2 = clip01(__fmul_rn(2.0f, u));
  const float um = clip01(__fmul_rn(2.0f, __fsub_rn(1.0f, u)));
  switch (curve) {
    case 0:  // HOLD
      return 0.0f;
    case 2:  // EXP_SINGLE
      return ease_exp(u, t, ts);
    case 3:  // EXP_DUAL
      return dual(u, ease_exp(u2, t, ts), ease_exp(um, t, ts));
    case 4:  // EXP_ALT_SINGLE
      return ease_alt(u, ta);
    case 5:  // EXP_ALT_DUAL
      return dual(u, ease_alt(u2, ta), ease_alt(um, ta));
    case 6:  // POW_SINGLE
      return powf(u, exp2f(t));
    case 7: {  // POW_DUAL
      const float p = exp2f(t);
      return dual(u, powf(u2, p), powf(um, p));
    }
    case 8:  // STEP
      return u >= 1.0f ? 1.0f : 0.0f;
    default:  // LINEAR (and any unknown code, as the reference's select)
      return u;
  }
}

// The lane segments a block's global frames [g0, g1] can pick from a lane
// row: for any g in that range, the last i in 0..P-2 with g >= xs[i] lies in
// [*lo, *hi] (-1: none), whatever the order of the breakpoints, because
// *lo is that index at g0 and no i above *hi passes the test at g1.
__device__ __forceinline__ void lane_range(const int32_t* xs, int P, int g0, int g1, int* lo,
                                           int* hi) {
  int l = -1, h = -1;
  for (int i = 0; i < P - 1; ++i) {
    const int x = __ldg(xs + i);
    if (g0 >= x) l = i;
    if (g1 >= x) h = i;
  }
  *lo = l;
  *hi = h;
}

// A lane row holds one value over the whole block: its frames pick one
// segment (lo == hi) that lies before the first point (none, -1) or after
// the last (the next breakpoint is the sentinel, so u is forced to 0). Then
// eval_lane does not depend on g.
__device__ __forceinline__ bool lane_held(const int32_t* xs, int lo, int hi) {
  return lo == hi && (lo < 0 || __ldg(xs + lo + 1) == kSentinel);
}

// One lane row at global frame g: the value of the last segment i in
// 0..P-2 with g >= xs[i] (the sweep's last select), else ys[0]. [lo, hi] is
// the block's lane_range, so the search starts at lo and usually ends there.
__device__ float eval_lane(const int32_t* xs, const float* ys, const int32_t* cv,
                           const float* tn, int g, int lo, int hi) {
  int seg = lo;
  for (int i = lo + 1; i <= hi; ++i) {
    if (g >= __ldg(xs + i)) seg = i;
  }
  if (seg < 0) return __ldg(ys);
  const int x0 = __ldg(xs + seg);
  const int x1 = __ldg(xs + seg + 1);
  int span = sub_wrap(x1, x0);
  span = span < 1 ? 1 : span;
  float u = clip01(__fdiv_rn(__int2float_rn(sub_wrap(g, x0)), __int2float_rn(span)));
  if (x1 == kSentinel) u = 0.0f;  // hold after the last point
  u = apply_curve(u, __ldg(cv + seg), __ldg(tn + seg));
  const float y0 = __ldg(ys + seg);
  return __fadd_rn(y0, __fmul_rn(u, __fsub_rn(__ldg(ys + seg + 1), y0)));
}

// The plan's per-slot tables, each indexed by slot s = (ti*T + t)*K + k
// (src_start by s*C + ch).
struct Slots {
  const float* pool;
  const int32_t* src_start;
  const int32_t* clampf;
  const float* gain;
  const int32_t* fin_start;
  const float* fin_inv;
  const int32_t* fout_end;
  const float* fout_inv;
  const int32_t* is_slow;
  const float* sfrac_hi;
  const float* sfrac_lo;
  const float* sspeed_hi;
  const float* sspeed_lo;
};

// A slot's metadata where every kernel reads it: a staged entry of four
// 16-byte words in shared memory (layout: see stage_slots), the first three
// already in registers, the phase read only by a resampled slot.
struct StagedSlot {
  int4 a, b, c;
  const int4* d;
  __device__ __forceinline__ int base(int ch) const { return ch == 0 ? a.w : b.x; }
  __device__ __forceinline__ bool is_slow() const { return (a.z & 1) != 0; }
  __device__ __forceinline__ bool clampf() const { return (a.z & 2) != 0; }
  __device__ __forceinline__ float gain() const { return __int_as_float(b.y); }
  __device__ __forceinline__ int fin_start() const { return b.z; }
  __device__ __forceinline__ float fin_inv() const { return __int_as_float(b.w); }
  __device__ __forceinline__ int fout_end() const { return c.x; }
  __device__ __forceinline__ float fout_inv() const { return __int_as_float(c.y); }
  __device__ __forceinline__ float4 phase() const {
    const int4 q = *d;
    return make_float4(__int_as_float(q.x), __int_as_float(q.y), __int_as_float(q.z),
                       __int_as_float(q.w));
  }
};

// A resampled slot's samples, one per channel, from the taps around
// p[c] = pool + src_start[c] + ix, each operation rounded on its own, in the
// order of mix_pallas.py:549-566. What does not depend on the channel (in
// kPoly each tap's Horner weight) is computed once.
template <int kInterp, int kCh>
__device__ __forceinline__ void interpolate(const float* (&p)[kCh], float fx,
                                            const PolyCoeffs& poly, float (&v)[kCh]) {
  if constexpr (kInterp == kCatmull) {
    // uniform Catmull-Rom through p[-1], p[0], p[1], p[2]
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float pm1 = __ldg(p[c] - 1);
      const float a = __ldg(p[c]);
      const float b = __ldg(p[c] + 1);
      const float p2 = __ldg(p[c] + 2);
      const float c1 = __fmul_rn(0.5f, __fsub_rn(b, pm1));
      const float c2 = __fsub_rn(
          __fadd_rn(__fsub_rn(pm1, __fmul_rn(2.5f, a)), __fmul_rn(2.0f, b)), __fmul_rn(0.5f, p2));
      const float c3 =
          __fadd_rn(__fmul_rn(0.5f, __fsub_rn(p2, pm1)), __fmul_rn(1.5f, __fsub_rn(a, b)));
      v[c] = __fadd_rn(
          a, __fmul_rn(fx, __fadd_rn(c1, __fmul_rn(fx, __fadd_rn(c2, __fmul_rn(fx, c3))))));
    }
  } else if constexpr (kInterp == kPoly || kInterp == kPoly6) {
    // per tap, Horner in fx from the highest coefficient down, then
    // res += w_k * v_k in tap order from 0
    const int taps = kInterp == kPoly6 ? kPoly6Taps : poly.taps;
    const int ncoef = kInterp == kPoly6 ? kPoly6Coeffs : poly.ncoef;
    const int first = -(taps / 2 - 1);
#pragma unroll
    for (int c = 0; c < kCh; ++c) v[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < taps; ++k) {
      float wk = poly.c[k][ncoef - 1];
#pragma unroll
      for (int m = ncoef - 2; m >= 0; --m) wk = __fadd_rn(__fmul_rn(wk, fx), poly.c[k][m]);
#pragma unroll
      for (int c = 0; c < kCh; ++c) v[c] = __fadd_rn(v[c], __fmul_rn(wk, __ldg(p[c] + first + k)));
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float a = __ldg(p[c]);
      const float b = __ldg(p[c] + 1);
      v[c] = __fadd_rn(a, __fmul_rn(fx, __fsub_rn(b, a)));  // sampler.cpp:55
    }
  }
}

// (v*gain)*env of a slot at tile-relative frame pos, per channel, for a slot
// whose span [m0, m1) covers pos: the sample (copied, optionally clamped, or
// resampled in mode kInterp), the clip gain and the fade envelope, in the
// reference's order. The phase and the envelope are computed once for all
// kCh channels.
template <int kInterp, int kCh>
__device__ __forceinline__ void slot_sample(const float* pool, const PolyCoeffs& poly,
                                            const StagedSlot& sl, int pos, int m0,
                                            float (&out)[kCh]) {
  float v[kCh];
  if (sl.is_slow()) {
    int ix;
    float fx;
    const float4 ph = sl.phase();
    phase_eval(pos - m0, ph.x, ph.y, ph.z, ph.w, &ix, &fx);
    const float* p[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) p[c] = pool + sl.base(c) + ix;
    interpolate<kInterp, kCh>(p, fx, poly, v);
  } else {
#pragma unroll
    for (int c = 0; c < kCh; ++c) v[c] = __ldg(pool + sl.base(c) + pos);
    if (sl.clampf()) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        v[c] = v[c] < -1.0f ? -1.0f : v[c];
        v[c] = v[c] > 1.0f ? 1.0f : v[c];
      }
    }
  }
  const float env =
      __fmul_rn(clip01(__fmul_rn(__int2float_rn(pos - sl.fin_start()), sl.fin_inv())),
                clip01(__fmul_rn(__int2float_rn(sl.fout_end() - pos), sl.fout_inv())));
  const float gain = sl.gain();
#pragma unroll
  for (int c = 0; c < kCh; ++c) out[c] = __fmul_rn(__fmul_rn(v[c], gain), env);
}

// The pan law's coefficient of one channel (mix_pallas.py:453-458)
__device__ __forceinline__ float pan_coef(float px, bool odd) {
  const float arg = odd ? px : __fsub_rn(1.0f, px);
  return __fmul_rn(sinf(__fmul_rn(kHalfPi, arg)), kSqrt2);
}

// What a block knows of an automated track, two 16-byte words per track in
// shared memory, found once per (block, track) by one thread:
//   0: flags, volume lane_range lo, hi, the held volume (f32 bits)
//   1: pan lane_range lo, hi, the held pan coefficients of the even and the
//      odd channels (f32 bits)
// A held lane's value is the same function of the same inputs as a frame's
// own evaluation would be, so its bits are too.
constexpr int kTrackLanes = 1;  // use[t]: per-frame gains, else the constant track_gain
constexpr int kVolHeld = 2;
constexpr int kPanHeld = 4;

__device__ void track_block_rows(const Lanes& L, int t, int g0, int g1, int4* rows) {
  int4 a = {0, 0, 0, 0}, b = {0, 0, 0, 0};
  if (__ldg(L.use + t)) {
    const int o = t * L.P;
    a.x = kTrackLanes;
    lane_range(L.vxs + o, L.P, g0, g1, &a.y, &a.z);
    lane_range(L.pxs + o, L.P, g0, g1, &b.x, &b.y);
    if (lane_held(L.vxs + o, a.y, a.z)) {
      a.x |= kVolHeld;
      a.w = __float_as_int(eval_lane(L.vxs + o, L.vys + o, L.vcv + o, L.vtn + o, g0, a.y, a.z));
    }
    if (lane_held(L.pxs + o, b.x, b.y)) {
      a.x |= kPanHeld;
      const float pan = eval_lane(L.pxs + o, L.pys + o, L.pcv + o, L.ptn + o, g0, b.x, b.y);
      const float px = __fmul_rn(0.5f, __fadd_rn(pan, 1.0f));
      b.z = __float_as_int(pan_coef(px, false));
      b.w = __float_as_int(pan_coef(px, true));
    }
  }
  rows[2 * t] = a;
  rows[2 * t + 1] = b;
}

// Track t's gains on the channels c0..c0+kCh-1 at global frame g
// (mix_pallas.py:448-460): each lane once for all channels, or its held
// value from the block's rows a, b; then per channel the pan sine.
template <int kCh>
__device__ void lane_gains(const Lanes& L, int t, int g, int c0, int4 a, int4 b, float (&tg)[kCh]) {
  const int o = t * L.P;
  const float vol = (a.x & kVolHeld)
                        ? __int_as_float(a.w)
                        : eval_lane(L.vxs + o, L.vys + o, L.vcv + o, L.vtn + o, g, a.y, a.z);
  float px = 0.0f;
  if (!(a.x & kPanHeld)) {
    const float pan = eval_lane(L.pxs + o, L.pys + o, L.pcv + o, L.ptn + o, g, b.x, b.y);
    px = __fmul_rn(0.5f, __fadd_rn(pan, 1.0f));
  }
  const float mute = __ldg(L.mute + t);
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const bool odd = (c0 + c) % 2 != 0;
    const float coef =
        (a.x & kPanHeld) ? __int_as_float(odd ? b.w : b.z) : pan_coef(px, odd);
    tg[c] = __fmul_rn(__fmul_rn(vol, coef), mute);
  }
}

// One pass of the staged walk: the block's threads look at the raw slots
// [r0, r0 + kStageSlots) of their tile, one each (consecutive threads read
// consecutive words of ms/me), keep a slot iff it is active and its span
// meets the block's frames [b0, b1), and copy the kept slots' metadata into
// `buf` in slot order (warp ballots + a prefix sum over the warps' counts),
// so the list keeps the (track, slot) order of the sum. Returns the number
// kept. A staged entry is four 16-byte words:
//   0: ms, me, meta = track << 2 | clampf << 1 | is_slow, src_start[c0]
//   1: src_start[c0 + 1], gain, fin_start, fin_inv
//   2: fout_end, fout_inv, track_gain[c0], track_gain[c0 + 1]
//   3: sfrac_hi, sfrac_lo, sspeed_hi, sspeed_lo
// ms, me and meta are stored by the thread; the other words travel by
// cp.async (4 bytes each, gathered from the struct-of-arrays tables) and are
// complete only after the caller's __pipeline_wait_prior and __syncthreads.
// Contains one __syncthreads: every thread of the block must call it.
template <int kCh>
__device__ __forceinline__ int stage_slots(const Slots& S, const int32_t* __restrict__ ms,
                                           const int32_t* __restrict__ me,
                                           const float* __restrict__ track_gain, int slot0, int r0,
                                           int n_raw, int K, int C, int c0, int b0, int b1,
                                           int4 (*buf)[4], int* warp_counts) {
  const int r = r0 + (int)threadIdx.x;
  const int s = slot0 + r;
  int m0 = 0, m1 = 0;
  bool keep = false;
  if (r < n_raw) {
    m0 = __ldg(ms + s);
    m1 = __ldg(me + s);
    keep = m1 > m0 && m0 < b1 && m1 > b0;
  }
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(kept);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = warp_counts[w];
    before += w < warp ? n : 0;
    total += n;
  }
  if (keep) {
    int* e = reinterpret_cast<int*>(buf[before + __popc(kept & ((1u << lane) - 1u))]);
    const int t = r / K;
    const int slow = __ldg(S.is_slow + s), clamp = __ldg(S.clampf + s);
    const int32_t* src = S.src_start + (int64_t)s * C + c0;
    __pipeline_memcpy_async(e + 3, src, 4);
    __pipeline_memcpy_async(e + 5, S.gain + s, 4);
    __pipeline_memcpy_async(e + 6, S.fin_start + s, 4);
    __pipeline_memcpy_async(e + 7, S.fin_inv + s, 4);
    __pipeline_memcpy_async(e + 8, S.fout_end + s, 4);
    __pipeline_memcpy_async(e + 9, S.fout_inv + s, 4);
    __pipeline_memcpy_async(e + 10, track_gain + t * C + c0, 4);
    if constexpr (kCh > 1) {
      __pipeline_memcpy_async(e + 4, src + 1, 4);
      __pipeline_memcpy_async(e + 11, track_gain + t * C + c0 + 1, 4);
    }
    __pipeline_memcpy_async(e + 12, S.sfrac_hi + s, 4);
    __pipeline_memcpy_async(e + 13, S.sfrac_lo + s, 4);
    __pipeline_memcpy_async(e + 14, S.sspeed_hi + s, 4);
    __pipeline_memcpy_async(e + 15, S.sspeed_lo + s, 4);
    e[0] = m0;
    e[1] = m1;
    e[2] = t << 2 | (clamp != 0) << 1 | (slow != 0);
  }
  __pipeline_commit();
  return total;
}

// The summing kernel (K1-K3): out[c0 + c, ti*tile + pos] for the kCh channels
// of a channel group, one thread per frame. See the note at the top.
template <bool kAuto, int kInterp, int kCh>
__global__ void __launch_bounds__(kFramesPerBlock)
mix_kernel(const Slots S, const int32_t* __restrict__ ms,  // [n_tiles, T, K]
           const int32_t* __restrict__ me,
           const float* __restrict__ track_gain,            // [T, C]
           float* __restrict__ out,                         // [C, n_tiles * tile]
           int n_tiles, int T, int K, int C, int c0, int tile,
           const Lanes lanes,                               // read when kAuto
           const __grid_constant__ PolyCoeffs poly) {       // read with polynomial taps
  // two buffers of staged entries: one is walked while cp.async fills the other
  __shared__ int4 staged[2][kStageSlots][4];
  __shared__ int warp_counts[2][kWarps];  // by the parity of the pass, like the buffers
  // kAuto: what the block knows of each track (track_block_rows), [T][2]
  extern __shared__ int4 track_rows[];

  // grid.x walks (tile, frame block) pairs
  const int blocks_per_tile = (tile + kFramesPerBlock - 1) / kFramesPerBlock;
  const int ti = blockIdx.x / blocks_per_tile;
  const int b0 = (blockIdx.x % blocks_per_tile) * kFramesPerBlock;
  const int b1 = min(b0 + kFramesPerBlock, tile);  // a ragged tile end
  const int pos = b0 + (int)threadIdx.x;           // tile-relative frame
  const int g = ti * tile + pos;                   // global frame (the carve keeps it < 2^31)
  const int n_raw = T * K;
  const int slot0 = ti * n_raw;

  if constexpr (kAuto) {
    // one thread per track; visible after the first stage_slots' barrier
    for (int t = threadIdx.x; t < T; t += kFramesPerBlock)
      track_block_rows(lanes, t, ti * tile + b0, ti * tile + b1 - 1, track_rows);
  }

  float acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.0f;
  // kAuto: the track whose gains tg holds (evaluated at the first slot of
  // the track that covers this frame, and not at all when none does)
  int cur_t = -1;
  float tg[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) tg[c] = 0.0f;

  int n = stage_slots<kCh>(S, ms, me, track_gain, slot0, 0, n_raw, K, C, c0, b0, b1, staged[0],
                           warp_counts[0]);
  for (int r0 = 0, cur = 0; r0 < n_raw; r0 += kStageSlots, cur ^= 1) {
    // the next pass starts its copies, then this pass's must have landed
    int n_next = 0;
    if (r0 + kStageSlots < n_raw) {
      n_next = stage_slots<kCh>(S, ms, me, track_gain, slot0, r0 + kStageSlots, n_raw, K, C, c0,
                                b0, b1, staged[cur ^ 1], warp_counts[cur ^ 1]);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    int4(*list)[4] = staged[cur];
    for (int e = 0; e < n; ++e) {
      const int4 a = list[e][0];
      if (pos < a.x || pos >= a.y) continue;  // the slot misses this frame: it adds +0.0
      const StagedSlot sl = {a, list[e][1], list[e][2], &list[e][3]};
      // the sample's loads start before the lane evaluation
      float sv[kCh];
      slot_sample<kInterp, kCh>(S.pool, poly, sl, pos, a.x, sv);
      if constexpr (kAuto) {
        const int t = a.z >> 2;
        if (t != cur_t) {
          cur_t = t;
          const int4 row = track_rows[2 * t];
          if (row.x & kTrackLanes) {
            lane_gains<kCh>(lanes, t, g, c0, row, track_rows[2 * t + 1], tg);
          } else {
            tg[0] = __int_as_float(sl.c.z);
            if constexpr (kCh > 1) tg[1] = __int_as_float(sl.c.w);
          }
        }
      } else {
        tg[0] = __int_as_float(sl.c.z);
        if constexpr (kCh > 1) tg[1] = __int_as_float(sl.c.w);
      }
#pragma unroll
      for (int c = 0; c < kCh; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(sv[c], tg[c]));
    }
    __syncthreads();  // the walked buffer is free for the pass after next
    n = n_next;
  }
  if (pos >= tile) return;  // past a ragged tile end
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    float y = acc[c] > 1.0f ? 1.0f : acc[c];
    y = y < -1.0f ? -1.0f : y;
    out[(int64_t)(c0 + c) * n_tiles * tile + (int64_t)ti * tile + pos] = y;
  }
}

// K4: per-track pre-gain buffers, out[t, ch, ti*tile + pos] (mix_pallas.py
// :431-436 zeroes each (tile, track) block, :581-593 leaves the gain and
// :595-600 the clip to the finisher): per (track, channel, frame) the sum
// from +0.0, in slot order, of (v*gain)*env over the track's slots that
// cover the frame. Skipping a slot that misses the frame equals adding the
// +0.0 the reference adds there (the accumulator is never -0.0), so the
// result is bit-equal to the JAX kernel's `out_ref[0, ch] += contrib`.
//
// What bounds it on an H100: the [T, C, F] f32 write, 2.95 GB for 128
// tracks x 60 s stereo, 0.88 ms at 3.35 TB/s; the pool (4.9 MB) sits in the
// L2 and the per-frame arithmetic is a few operations per covering slot.
// The earlier design (one thread per (frame, channel, track), 256 frames a
// block, each thread walking its track's K slots in device memory and
// storing one word) turned over 2.9 M blocks of 1 KB and ran 5.2x the bound.
// What this design does about it:
// - A block owns kPerTrackFrames = 1024 frames of one track in one tile, for
//   all channels of a channel group (a launch per pair, then a last odd
//   channel, as the summing kernel); the grid is 1-D, track-major, so
//   consecutive blocks write consecutive stretches of one output row.
// - Its first warp stages, once, the slots of the (tile, track) cell that
//   are active and meet the block's frames, in slot order, as the summing
//   kernel's 64-byte entries (StagedSlot), 32 raw slots a pass (one pass for
//   K <= 32; a K above runs more passes, each after the one before).
// - A thread owns kFrameGroup = 4 consecutive frames: per staged entry it
//   reads the entry from shared memory once and, per covered frame, computes
//   the cover test, envelope, phase and tap weights once for the channels
//   (slot_sample with kCh channels, as mix_kernel does).
// - Each channel's 4 frames leave as one 16-byte streaming store
//   (st.global.cs): the 2.95 GB stream does not fit the 50 MB L2 and is read
//   by the finisher's next pass, not from the L2. A tile that is not a
//   multiple of 4 frames, and the group a ragged tile end cuts, store word by
//   word.
// - A block whose cell has no staged entry (the track is silent in its
//   frames) stores zeros and walks nothing.
// Measured on an H100 80GB HBM3 (700 W limit) at that size: see PERF.md
// (chip_smoke.py, effects_eq_128trk; tools/ab_mix.py against the parent).
constexpr int kFrameGroup = 4;                                  // frames per thread, a multiple of 4
constexpr int kPerTrackFrames = kFramesPerBlock * kFrameGroup;  // frames per block
constexpr int kCellPass = 32;                                   // raw slots a staging pass looks at

// Warp 0 stages the slots [r0, r0 + kCellPass) of the cell whose first raw
// slot is s0 that are active and meet frames [b0, b1), in slot order, into
// buf (entry layout: stage_slots); returns the number staged to warp 0.
template <int kCh>
__device__ __forceinline__ int stage_cell(const Slots& S, const int32_t* __restrict__ ms,
                                          const int32_t* __restrict__ me, int s0, int r0, int K,
                                          int C, int c0, int b0, int b1, int4 (*buf)[4]) {
  const int lane = threadIdx.x & 31;
  const int s = s0 + r0 + lane;
  int m0 = 0, m1 = 0;
  bool keep = false;
  if (r0 + lane < K) {
    m0 = __ldg(ms + s);
    m1 = __ldg(me + s);
    keep = m1 > m0 && m0 < b1 && m1 > b0;
  }
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  if (keep) {
    const int32_t* src = S.src_start + (int64_t)s * C + c0;
    const int flags = (__ldg(S.clampf + s) != 0) << 1 | (__ldg(S.is_slow + s) != 0);
    int4* e = buf[__popc(kept & ((1u << lane) - 1u))];
    e[0] = make_int4(m0, m1, flags, __ldg(src));
    e[1] = make_int4(kCh > 1 ? __ldg(src + 1) : 0, __float_as_int(__ldg(S.gain + s)),
                     __ldg(S.fin_start + s), __float_as_int(__ldg(S.fin_inv + s)));
    e[2] = make_int4(__ldg(S.fout_end + s), __float_as_int(__ldg(S.fout_inv + s)), 0, 0);
    e[3] = make_int4(__float_as_int(__ldg(S.sfrac_hi + s)), __float_as_int(__ldg(S.sfrac_lo + s)),
                     __float_as_int(__ldg(S.sspeed_hi + s)), __float_as_int(__ldg(S.sspeed_lo + s)));
  }
  return __popc(kept);
}

template <int kInterp, int kCh>
__global__ void __launch_bounds__(kFramesPerBlock)
mix_per_track_kernel(const Slots S, const int32_t* __restrict__ ms,
                     const int32_t* __restrict__ me, float* __restrict__ out, int n_tiles,
                     int T, int K, int C, int c0, int tile,
                     const __grid_constant__ PolyCoeffs poly) {
  __shared__ int4 staged[kCellPass][4];
  __shared__ int n_staged;

  // blockIdx.x = t * (n_tiles * blocks_per_tile) + ti * blocks_per_tile + fb
  const int blocks_per_tile = (tile + kPerTrackFrames - 1) / kPerTrackFrames;
  const int64_t per_track = (int64_t)n_tiles * blocks_per_tile;
  const int t = (int)(blockIdx.x / per_track);
  const int rest = (int)(blockIdx.x % per_track);
  const int ti = rest / blocks_per_tile;
  const int b0 = (rest % blocks_per_tile) * kPerTrackFrames;
  const int b1 = min(b0 + kPerTrackFrames, tile);  // a ragged tile end
  const int pos0 = b0 + (int)threadIdx.x * kFrameGroup;
  const int s0 = (ti * T + t) * K;

  float acc[kFrameGroup][kCh];
#pragma unroll
  for (int j = 0; j < kFrameGroup; ++j)
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[j][c] = 0.0f;

  for (int r0 = 0; r0 < K; r0 += kCellPass) {
    if (threadIdx.x < 32) {
      const int n = stage_cell<kCh>(S, ms, me, s0, r0, K, C, c0, b0, b1, staged);
      if (threadIdx.x == 0) n_staged = n;
    }
    __syncthreads();
    const int n = n_staged;
    for (int e = 0; e < n; ++e) {
      const int4 a = staged[e][0];
      if (pos0 + kFrameGroup <= a.x || pos0 >= a.y) continue;  // covers none of the group
      const StagedSlot sl = {a, staged[e][1], staged[e][2], &staged[e][3]};
#pragma unroll
      for (int j = 0; j < kFrameGroup; ++j) {
        const int pos = pos0 + j;
        if (pos < a.x || pos >= a.y) continue;  // the slot adds +0.0 here
        float sv[kCh];
        slot_sample<kInterp, kCh>(S.pool, poly, sl, pos, a.x, sv);
#pragma unroll
        for (int c = 0; c < kCh; ++c) acc[j][c] = __fadd_rn(acc[j][c], sv[c]);
      }
    }
    __syncthreads();  // the staged entries are free for the next pass
  }
  if (pos0 >= b1) return;
  const int64_t F = (int64_t)n_tiles * tile;
  const bool whole = pos0 + kFrameGroup <= b1 && tile % 4 == 0;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    float* row = out + ((int64_t)t * C + c0 + c) * F + (int64_t)ti * tile + pos0;
    if (whole) {
#pragma unroll
      for (int j = 0; j < kFrameGroup; j += 4)
        __stcs(reinterpret_cast<float4*>(row + j),
               make_float4(acc[j][c], acc[j + 1][c], acc[j + 2][c], acc[j + 3][c]));
    } else {
#pragma unroll
      for (int j = 0; j < kFrameGroup; ++j)
        if (pos0 + j < b1) __stcs(row + j, acc[j][c]);
    }
  }
}

// One mix's arguments on the host: the tables, the geometry, the stream.
struct MixArgs {
  Slots S;
  const int32_t* ms;
  const int32_t* me;
  const float* track_gain;
  float* out;
  int n_tiles, T, K, C, tile;
  void* stream;
};

// One launch per channel group: pairs of channels from 0, then a last odd
// channel alone. The automation variant takes 32 bytes per track of dynamic
// shared memory for its per-track rows.
template <bool kAuto, int kInterp, int kCh>
int launch_group(const MixArgs& a, const Lanes& lanes, const PolyCoeffs& poly, int c0) {
  const int blocks_per_tile = (a.tile + kFramesPerBlock - 1) / kFramesPerBlock;
  const size_t dyn = kAuto ? 2 * sizeof(int4) * (size_t)a.T : 0;
  auto kernel = mix_kernel<kAuto, kInterp, kCh>;
  if (dyn > 8 * 1024) {  // beyond what fits beside the static buffers by default
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.n_tiles * blocks_per_tile, kFramesPerBlock, dyn, (cudaStream_t)a.stream>>>(
      a.S, a.ms, a.me, a.track_gain, a.out, a.n_tiles, a.T, a.K, a.C, c0, a.tile, lanes, poly);
  return (int)cudaGetLastError();
}

template <bool kAuto, int kInterp>
int launch(const MixArgs& a, const Lanes& lanes, const PolyCoeffs& poly) {
  int c0 = 0;
  for (; c0 + 2 <= a.C; c0 += 2) {
    const int rc = launch_group<kAuto, kInterp, 2>(a, lanes, poly, c0);
    if (rc != 0) return rc;
  }
  return c0 < a.C ? launch_group<kAuto, kInterp, 1>(a, lanes, poly, c0) : 0;
}

template <int kInterp, int kCh>
int launch_per_track_group(const MixArgs& a, const PolyCoeffs& poly, int c0) {
  const int64_t blocks = (int64_t)a.T * a.n_tiles * ((a.tile + kPerTrackFrames - 1) / kPerTrackFrames);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  mix_per_track_kernel<kInterp, kCh><<<(unsigned)blocks, kFramesPerBlock, 0, (cudaStream_t)a.stream>>>(
      a.S, a.ms, a.me, a.out, a.n_tiles, a.T, a.K, a.C, c0, a.tile, poly);
  return (int)cudaGetLastError();
}

// One launch per channel group, as launch().
template <int kInterp>
int launch_per_track(const MixArgs& a, const PolyCoeffs& poly) {
  int c0 = 0;
  for (; c0 + 2 <= a.C; c0 += 2) {
    const int rc = launch_per_track_group<kInterp, 2>(a, poly, c0);
    if (rc != 0) return rc;
  }
  return c0 < a.C ? launch_per_track_group<kInterp, 1>(a, poly, c0) : 0;
}

// The host's coefficient table [taps][ncoef] (row-major, read now) into
// the by-value argument; false for a table the kernel cannot hold.
bool load_poly(int interp, const float* coeffs, int taps, int ncoef, PolyCoeffs* poly) {
  *poly = PolyCoeffs{};
  if (interp != kPoly) return interp == kLinear || interp == kCatmull;
  if (coeffs == nullptr || taps < 2 || taps > kMaxPolyTaps || ncoef < 1 || ncoef > kMaxPolyCoeffs)
    return false;
  poly->taps = taps;
  poly->ncoef = ncoef;
  for (int k = 0; k < taps; ++k)
    for (int m = 0; m < ncoef; ++m) poly->c[k][m] = coeffs[k * ncoef + m];
  return true;
}

enum Variant { kSum, kSumAuto, kPerTrack };

// The variant x interpolation table of instantiations.
int dispatch(Variant variant, int interp, const MixArgs& a, const Lanes& lanes,
             const float* coeffs, int taps, int ncoef) {
  PolyCoeffs poly;
  if (!load_poly(interp, coeffs, taps, ncoef, &poly)) return (int)cudaErrorInvalidValue;
  if (interp == kPoly && taps == kPoly6Taps && ncoef == kPoly6Coeffs) interp = kPoly6;
  switch (variant * 4 + interp) {
    case kSum * 4 + kLinear: return launch<false, kLinear>(a, lanes, poly);
    case kSum * 4 + kCatmull: return launch<false, kCatmull>(a, lanes, poly);
    case kSum * 4 + kPoly: return launch<false, kPoly>(a, lanes, poly);
    case kSum * 4 + kPoly6: return launch<false, kPoly6>(a, lanes, poly);
    case kSumAuto * 4 + kLinear: return launch<true, kLinear>(a, lanes, poly);
    case kSumAuto * 4 + kCatmull: return launch<true, kCatmull>(a, lanes, poly);
    case kSumAuto * 4 + kPoly: return launch<true, kPoly>(a, lanes, poly);
    case kSumAuto * 4 + kPoly6: return launch<true, kPoly6>(a, lanes, poly);
    case kPerTrack * 4 + kLinear: return launch_per_track<kLinear>(a, poly);
    case kPerTrack * 4 + kCatmull: return launch_per_track<kCatmull>(a, poly);
    case kPerTrack * 4 + kPoly: return launch_per_track<kPoly>(a, poly);
    case kPerTrack * 4 + kPoly6: return launch_per_track<kPoly6>(a, poly);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (0 == cudaSuccess). `interp` is 0 linear, 1 Catmull-Rom,
// 2 polynomial taps; `coeffs` is then a host array [taps][ncoef] f32, read
// before the call returns (null otherwise). A table larger than 8 x 8 or
// an unknown code returns cudaErrorInvalidValue without launching.

#define WB_TABLE_PARAMS                                                                      \
  const float *pool, const int32_t *src_start, const int32_t *ms, const int32_t *me,         \
      const float *gain, const int32_t *clampf, const int32_t *fin_start,                    \
      const float *fin_inv, const int32_t *fout_end, const float *fout_inv,                  \
      const int32_t *is_slow, const float *sfrac_hi, const float *sfrac_lo,                  \
      const float *sspeed_hi, const float *sspeed_lo, const float *track_gain, float *out,   \
      int n_tiles, int T, int K, int C, int tile
#define WB_MIX_ARGS                                                                          \
  MixArgs {                                                                                  \
    Slots{pool,     src_start, clampf,   gain,     fin_start, fin_inv,  fout_end,            \
          fout_inv, is_slow,   sfrac_hi, sfrac_lo, sspeed_hi, sspeed_lo},                    \
        ms, me, track_gain, out, n_tiles, T, K, C, tile, stream                              \
  }

// K1 + K2: constant track gains.
extern "C" int wb_mix(WB_TABLE_PARAMS, int interp, const float* coeffs, int taps,
                             int ncoef, void* stream) {
  return dispatch(kSum, interp, WB_MIX_ARGS, Lanes{}, coeffs, taps, ncoef);
}

// + K3: per-frame volume/pan from the lane tables for tracks with use[t].
extern "C" int wb_mix_auto(WB_TABLE_PARAMS, const int32_t* vxs, const float* vys,
                           const int32_t* vcv, const float* vtn, const int32_t* pxs,
                           const float* pys, const int32_t* pcv, const float* ptn,
                           const float* mute, const int32_t* use, int P, int interp,
                           const float* coeffs, int taps, int ncoef, void* stream) {
  const Lanes lanes = {vxs, vys, vcv, vtn, pxs, pys, pcv, ptn, mute, use, P};
  return dispatch(kSumAuto, interp, WB_MIX_ARGS, lanes, coeffs, taps, ncoef);
}

// K4: per-track pre-gain buffers out [T, C, n_tiles*tile]; the same
// arguments as wb_mix (track_gain is not read).
extern "C" int wb_mix_per_track(WB_TABLE_PARAMS, int interp, const float* coeffs, int taps,
                                int ncoef, void* stream) {
  return dispatch(kPerTrack, interp, WB_MIX_ARGS, Lanes{}, coeffs, taps, ncoef);
}
