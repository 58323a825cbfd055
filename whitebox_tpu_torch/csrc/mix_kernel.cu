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
// 23 MB output write. Slot metadata is ~60 bytes per slot, read by every
// thread of a block at the same address (a broadcast from L1); so are the
// lane tables (P points x 16 bytes per lane and track).
// What this first design does about it: nothing yet. One thread owns one
// (frame, channel) accumulator in a register and walks all T*K slots; no
// shared-memory staging of the slot tables, no TMA, no vector loads.
// Nothing is carried between blocks and there are no atomics. Measured on
// an H100 80GB HBM3 (700 W limit) at the headline size: 3.37 ms, i.e. the
// output leaves at 6.8 GB/s; the bound is instruction issue on the slot
// walk (~256 slots x 2 loads per thread before any sample is read), not
// memory. The automation variant evaluates a track's two lanes and its
// pan sine at most once per (thread, track), and only when a slot of the
// track covers the thread's frame: a scan of the P breakpoints for the
// segment, then one divide and the segment's own curve (a switch, where
// the TPU kernel computed all nine shapes and selected). Measured on the
// same card: 10.4 ms for 128 automated tracks x 60 s against 3.4 ms for
// the slot walk alone, i.e. ~350 instructions per (frame, channel, track)
// lane evaluation; both channels' threads evaluate the same lanes.
// The Catmull-Rom and polynomial modes change only what a resampled slot
// computes from its taps: one thread reads its four or six taps straight
// from the pool (no window, no row groups: the TPU kernel's in-window
// shuffles have no counterpart here) and spends 13 or, for six taps of
// degree 5, 72 more operations per sample than the lerp. The polynomial
// coefficients (at most 8 taps x 8) travel by value as a kernel argument,
// so two tables can never share a launch. The linear instantiations are
// the code they were before these modes existed. Measured on the same
// card at 128 tracks x 60 s with two thirds of the clips resampled
// (chip_smoke.py): Catmull-Rom 4.33 ms, six polynomial taps over a 4x
// oversampled pool 10.6 ms (twice the slots per (tile, track), so twice
// the slot walk, and 89 operations per resampled sample), both equal to
// their plain versions to 0 ulp; the same kernel over a 1.9 GB pool that
// a sinc prerender extended, speed-1 slots only, 3.39 ms: the pool has
// left the L2, and the slot walk still is the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFramesPerBlock = 256;
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

// One lane row (P points) at global frame g: the value of the last
// segment i in 0..P-2 with g >= xs[i] (the sweep's last select), else ys[0]
__device__ float eval_lane(const int32_t* xs, const float* ys, const int32_t* cv,
                           const float* tn, int P, int g) {
  int seg = -1;
  for (int i = 0; i < P - 1; ++i) {
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

// A resampled slot's sample from its taps around p = pool + src_start + ix,
// each operation rounded on its own, in the order of mix_pallas.py:549-566.
template <int kInterp>
__device__ __forceinline__ float interpolate(const float* p, float fx, const PolyCoeffs& poly) {
  if constexpr (kInterp == kCatmull) {
    // uniform Catmull-Rom through p[-1], p[0], p[1], p[2]
    const float pm1 = __ldg(p - 1);
    const float a = __ldg(p);
    const float b = __ldg(p + 1);
    const float p2 = __ldg(p + 2);
    const float c1 = __fmul_rn(0.5f, __fsub_rn(b, pm1));
    const float c2 = __fsub_rn(
        __fadd_rn(__fsub_rn(pm1, __fmul_rn(2.5f, a)), __fmul_rn(2.0f, b)), __fmul_rn(0.5f, p2));
    const float c3 =
        __fadd_rn(__fmul_rn(0.5f, __fsub_rn(p2, pm1)), __fmul_rn(1.5f, __fsub_rn(a, b)));
    return __fadd_rn(
        a, __fmul_rn(fx, __fadd_rn(c1, __fmul_rn(fx, __fadd_rn(c2, __fmul_rn(fx, c3))))));
  } else if constexpr (kInterp == kPoly) {
    // per tap, Horner in fx from the highest coefficient down, then
    // res += w_k * v_k in tap order from 0
    const int first = -(poly.taps / 2 - 1);
    float res = 0.0f;
    for (int k = 0; k < poly.taps; ++k) {
      float wk = poly.c[k][poly.ncoef - 1];
      for (int m = poly.ncoef - 2; m >= 0; --m) wk = __fadd_rn(__fmul_rn(wk, fx), poly.c[k][m]);
      res = __fadd_rn(res, __fmul_rn(wk, __ldg(p + first + k)));
    }
    return res;
  } else {
    const float a = __ldg(p);
    const float b = __ldg(p + 1);
    return __fadd_rn(a, __fmul_rn(fx, __fsub_rn(b, a)));  // sampler.cpp:55
  }
}

// (v*gain)*env of slot s at tile-relative frame pos, for a slot whose span
// [m0, m1) covers pos: the sample (copied, optionally clamped, or
// resampled in mode kInterp), the clip gain and the fade envelope, in the
// reference's order
template <int kInterp>
__device__ __forceinline__ float slot_sample(const Slots& S, const PolyCoeffs& poly, int s,
                                             int pos, int m0, int ch, int C) {
  const int base = __ldg(S.src_start + (int64_t)s * C + ch);
  float v;
  if (__ldg(S.is_slow + s)) {
    int ix;
    float fx;
    phase_eval(pos - m0, __ldg(S.sfrac_hi + s), __ldg(S.sfrac_lo + s),
               __ldg(S.sspeed_hi + s), __ldg(S.sspeed_lo + s), &ix, &fx);
    v = interpolate<kInterp>(S.pool + base + ix, fx, poly);
  } else {
    v = __ldg(S.pool + base + pos);
    if (__ldg(S.clampf + s)) {
      v = v < -1.0f ? -1.0f : v;
      v = v > 1.0f ? 1.0f : v;
    }
  }
  const float env = __fmul_rn(
      clip01(__fmul_rn(__int2float_rn(pos - __ldg(S.fin_start + s)), __ldg(S.fin_inv + s))),
      clip01(__fmul_rn(__int2float_rn(__ldg(S.fout_end + s) - pos), __ldg(S.fout_inv + s))));
  return __fmul_rn(__fmul_rn(v, __ldg(S.gain + s)), env);
}

// Track t's gain on channel ch at global frame g (mix_pallas.py:448-460)
__device__ float lane_gain(const Lanes& L, int t, int g, int ch) {
  const int o = t * L.P;
  const float vol = eval_lane(L.vxs + o, L.vys + o, L.vcv + o, L.vtn + o, L.P, g);
  const float pan = eval_lane(L.pxs + o, L.pys + o, L.pcv + o, L.ptn + o, L.P, g);
  const float px = __fmul_rn(0.5f, __fadd_rn(pan, 1.0f));
  const float arg = (ch % 2 == 0) ? __fsub_rn(1.0f, px) : px;
  const float coef = __fmul_rn(sinf(__fmul_rn(kHalfPi, arg)), kSqrt2);
  return __fmul_rn(__fmul_rn(vol, coef), __ldg(L.mute + t));
}

template <bool kAuto, int kInterp>
__global__ void __launch_bounds__(kFramesPerBlock)
mix_kernel(const float* __restrict__ pool,
           const int32_t* __restrict__ src_start,  // [n_tiles, T, K, C]
           const int32_t* __restrict__ ms,         // [n_tiles, T, K]
           const int32_t* __restrict__ me,
           const float* __restrict__ gain,
           const int32_t* __restrict__ clampf,
           const int32_t* __restrict__ fin_start,
           const float* __restrict__ fin_inv,
           const int32_t* __restrict__ fout_end,
           const float* __restrict__ fout_inv,
           const int32_t* __restrict__ is_slow,
           const float* __restrict__ sfrac_hi,
           const float* __restrict__ sfrac_lo,
           const float* __restrict__ sspeed_hi,
           const float* __restrict__ sspeed_lo,
           const float* __restrict__ track_gain,   // [T, C]
           float* __restrict__ out,                // [C, n_tiles * tile]
           int n_tiles, int T, int K, int C, int tile,
           const Lanes lanes,                      // read when kAuto
           const __grid_constant__ PolyCoeffs poly) {  // read when kInterp == kPoly
  // grid.x walks (tile, frame block) pairs, grid.y the channels
  const int blocks_per_tile = (tile + kFramesPerBlock - 1) / kFramesPerBlock;
  const int ti = blockIdx.x / blocks_per_tile;
  const int pos = (blockIdx.x % blocks_per_tile) * kFramesPerBlock + threadIdx.x;
  const int ch = blockIdx.y;
  if (pos >= tile) return;  // tile-relative frame past a ragged tile end
  const int g = ti * tile + pos;  // global frame (the carve keeps it < 2^31)
  const Slots S = {pool,     src_start, clampf,   gain,     fin_start, fin_inv,  fout_end,
                   fout_inv, is_slow,   sfrac_hi, sfrac_lo, sspeed_hi, sspeed_lo};

  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    // kAuto: a track with lanes evaluates its gain at the first slot that
    // covers this frame, and not at all when none does
    bool lanes_due = false;
    if constexpr (kAuto) lanes_due = __ldg(lanes.use + t) != 0;
    float tg = lanes_due ? 0.0f : __ldg(track_gain + t * C + ch);
    const int s0 = (ti * T + t) * K;
    for (int k = 0; k < K; ++k) {
      const int s = s0 + k;
      const int m0 = __ldg(ms + s);
      const int m1 = __ldg(me + s);
      if (m1 <= m0) continue;  // inactive slot: the reference adds nothing
      float contrib = 0.0f;    // masked frames add +0.0, as the reference does
      if (pos >= m0 && pos < m1) {
        // the sample's loads are issued before the lane evaluation
        const float sv = slot_sample<kInterp>(S, poly, s, pos, m0, ch, C);
        if constexpr (kAuto) {
          if (lanes_due) {
            tg = lane_gain(lanes, t, g, ch);
            lanes_due = false;
          }
        }
        contrib = __fmul_rn(sv, tg);
      }
      acc = __fadd_rn(acc, contrib);
    }
  }
  acc = acc > 1.0f ? 1.0f : acc;
  acc = acc < -1.0f ? -1.0f : acc;
  out[(int64_t)ch * n_tiles * tile + (int64_t)ti * tile + pos] = acc;
}

// K4: per-track pre-gain buffers, out[t, ch, ti*tile + pos] (mix_pallas.py
// :431-436 zeroes each (tile, track) block, :581-593 leaves the gain and
// :595-600 the clip to the finisher). The tracks' sums are independent,
// so the grid spans them too: grid = (tile blocks, C, T), one thread per
// (frame, channel, track) walking that track's K slots in slot order from
// +0.0. The accumulator is never -0.0 (it starts at +0.0 and only grows by
// adds), so skipping a slot that misses the frame equals adding the +0.0
// the reference adds; the result is bit-equal to the JAX kernel's
// `out_ref[0, ch] += contrib`. No atomics, nothing shared between blocks.
// What bounds it on an H100: the [T, C, F] f32 write, 2.95 GB for 128
// tracks x 60 s stereo, i.e. 0.88 ms at 3.35 TB/s; each thread walks only
// its own track's K slots, so the slot walk that bounds the summing
// variants shrinks T-fold per thread. The design does nothing more for
// the write than one coalesced 4-byte store per thread. Measured on an
// H100 80GB HBM3 (700 W limit) at that size: 4.71 ms, 627 GB/s of output,
// 5.3x the bound (chip_smoke.py, effects_eq_128trk).
template <int kInterp>
__global__ void __launch_bounds__(kFramesPerBlock)
mix_per_track_kernel(const Slots S, const int32_t* __restrict__ ms,
                     const int32_t* __restrict__ me, float* __restrict__ out, int n_tiles,
                     int T, int K, int C, int tile, const __grid_constant__ PolyCoeffs poly) {
  const int blocks_per_tile = (tile + kFramesPerBlock - 1) / kFramesPerBlock;
  const int ti = blockIdx.x / blocks_per_tile;
  const int pos = (blockIdx.x % blocks_per_tile) * kFramesPerBlock + threadIdx.x;
  const int ch = blockIdx.y;
  const int t = blockIdx.z;
  if (pos >= tile) return;

  float acc = 0.0f;
  const int s0 = (ti * T + t) * K;
  for (int k = 0; k < K; ++k) {
    const int s = s0 + k;
    const int m0 = __ldg(ms + s);
    const int m1 = __ldg(me + s);
    if (pos >= m0 && pos < m1)
      acc = __fadd_rn(acc, slot_sample<kInterp>(S, poly, s, pos, m0, ch, C));
  }
  const int64_t F = (int64_t)n_tiles * tile;
  out[((int64_t)t * C + ch) * F + (int64_t)ti * tile + pos] = acc;
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

template <bool kAuto, int kInterp>
int launch(const MixArgs& a, const Lanes& lanes, const PolyCoeffs& poly) {
  const int blocks_per_tile = (a.tile + kFramesPerBlock - 1) / kFramesPerBlock;
  dim3 grid(a.n_tiles * blocks_per_tile, a.C);
  const Slots& S = a.S;
  mix_kernel<kAuto, kInterp><<<grid, kFramesPerBlock, 0, (cudaStream_t)a.stream>>>(
      S.pool, S.src_start, a.ms, a.me, S.gain, S.clampf, S.fin_start, S.fin_inv, S.fout_end,
      S.fout_inv, S.is_slow, S.sfrac_hi, S.sfrac_lo, S.sspeed_hi, S.sspeed_lo, a.track_gain,
      a.out, a.n_tiles, a.T, a.K, a.C, a.tile, lanes, poly);
  return (int)cudaGetLastError();
}

template <int kInterp>
int launch_per_track(const MixArgs& a, const PolyCoeffs& poly) {
  const int blocks_per_tile = (a.tile + kFramesPerBlock - 1) / kFramesPerBlock;
  if (a.T > 65535 || a.C > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(a.n_tiles * blocks_per_tile, a.C, a.T);
  mix_per_track_kernel<kInterp><<<grid, kFramesPerBlock, 0, (cudaStream_t)a.stream>>>(
      a.S, a.ms, a.me, a.out, a.n_tiles, a.T, a.K, a.C, a.tile, poly);
  return (int)cudaGetLastError();
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
  switch (variant * 3 + interp) {
    case kSum * 3 + kLinear: return launch<false, kLinear>(a, lanes, poly);
    case kSum * 3 + kCatmull: return launch<false, kCatmull>(a, lanes, poly);
    case kSum * 3 + kPoly: return launch<false, kPoly>(a, lanes, poly);
    case kSumAuto * 3 + kLinear: return launch<true, kLinear>(a, lanes, poly);
    case kSumAuto * 3 + kCatmull: return launch<true, kCatmull>(a, lanes, poly);
    case kSumAuto * 3 + kPoly: return launch<true, kPoly>(a, lanes, poly);
    case kPerTrack * 3 + kLinear: return launch_per_track<kLinear>(a, poly);
    case kPerTrack * 3 + kCatmull: return launch_per_track<kCatmull>(a, poly);
    case kPerTrack * 3 + kPoly: return launch_per_track<kPoly>(a, poly);
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
