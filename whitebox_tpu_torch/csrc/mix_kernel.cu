// Timeline mix kernel for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel whitebox_tpu/ops/mix_pallas.py::_mix_kernel
// (launched by _mix_call) in the specialisations the bounce runs with
// interp="linear": the fast slots (speed-1 copies, kernel K1), the linear
// resampled slots, forward and reverse (K2-linear), in the kAuto variant
// the in-kernel automation lanes (K3: _lane_eval_kernel,
// mix_pallas.py:384-404, and the gain block :443-460), and, in
// mix_per_track_kernel, the per-track mode (K4, per_track=True:
// :431-436, :581-593, :608-610), which writes each track's pre-gain sum
// [T, C, F] for the effect finishers (see the note above that kernel).
//
// What it computes, per output frame `pos` of tile `ti` and channel `ch`:
//   acc = 0
//   for t in 0..T-1, for k in 0..K-1 (slot s = (ti*T + t)*K + k), if active:
//     v   = fast: pool[src_start + pos] (optionally clamped to +-1)
//           slow: ix, fx = phase(pos - ms); a = pool[src_start+ix];
//                 b = pool[src_start+ix+1]; v = a + fx*(b-a)
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

// (v*gain)*env of slot s at tile-relative frame pos, for a slot whose span
// [m0, m1) covers pos: the sample (copied, optionally clamped, or linear
// resampled), the clip gain and the fade envelope, in the reference's order
__device__ __forceinline__ float slot_sample(const Slots& S, int s, int pos, int m0, int ch,
                                             int C) {
  const int base = __ldg(S.src_start + (int64_t)s * C + ch);
  float v;
  if (__ldg(S.is_slow + s)) {
    int ix;
    float fx;
    phase_eval(pos - m0, __ldg(S.sfrac_hi + s), __ldg(S.sfrac_lo + s),
               __ldg(S.sspeed_hi + s), __ldg(S.sspeed_lo + s), &ix, &fx);
    const float a = __ldg(S.pool + base + ix);
    const float b = __ldg(S.pool + base + ix + 1);
    v = __fadd_rn(a, __fmul_rn(fx, __fsub_rn(b, a)));  // sampler.cpp:55
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

template <bool kAuto>
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
           const Lanes lanes) {                    // read when kAuto
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
        const float sv = slot_sample(S, s, pos, m0, ch, C);
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

template <bool kAuto>
int launch(const float* pool, const int32_t* src_start, const int32_t* ms,
           const int32_t* me, const float* gain, const int32_t* clampf,
           const int32_t* fin_start, const float* fin_inv,
           const int32_t* fout_end, const float* fout_inv,
           const int32_t* is_slow, const float* sfrac_hi, const float* sfrac_lo,
           const float* sspeed_hi, const float* sspeed_lo,
           const float* track_gain, float* out, int n_tiles, int T, int K,
           int C, int tile, const Lanes& lanes, void* stream) {
  const int blocks_per_tile = (tile + kFramesPerBlock - 1) / kFramesPerBlock;
  dim3 grid(n_tiles * blocks_per_tile, C);
  mix_kernel<kAuto><<<grid, kFramesPerBlock, 0, (cudaStream_t)stream>>>(
      pool, src_start, ms, me, gain, clampf, fin_start, fin_inv, fout_end,
      fout_inv, is_slow, sfrac_hi, sfrac_lo, sspeed_hi, sspeed_lo, track_gain,
      out, n_tiles, T, K, C, tile, lanes);
  return (int)cudaGetLastError();
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
__global__ void __launch_bounds__(kFramesPerBlock)
mix_per_track_kernel(const Slots S, const int32_t* __restrict__ ms,
                     const int32_t* __restrict__ me, float* __restrict__ out, int n_tiles,
                     int T, int K, int C, int tile) {
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
    if (pos >= m0 && pos < m1) acc = __fadd_rn(acc, slot_sample(S, s, pos, m0, ch, C));
  }
  const int64_t F = (int64_t)n_tiles * tile;
  out[((int64_t)t * C + ch) * F + (int64_t)ti * tile + pos] = acc;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (0 == cudaSuccess).

// K1 + K2-linear: constant track gains.
extern "C" int wb_mix_linear(const float* pool, const int32_t* src_start,
                             const int32_t* ms, const int32_t* me,
                             const float* gain, const int32_t* clampf,
                             const int32_t* fin_start, const float* fin_inv,
                             const int32_t* fout_end, const float* fout_inv,
                             const int32_t* is_slow, const float* sfrac_hi,
                             const float* sfrac_lo, const float* sspeed_hi,
                             const float* sspeed_lo, const float* track_gain,
                             float* out, int n_tiles, int T, int K, int C,
                             int tile, void* stream) {
  const Lanes none = {};
  return launch<false>(pool, src_start, ms, me, gain, clampf, fin_start, fin_inv,
                       fout_end, fout_inv, is_slow, sfrac_hi, sfrac_lo, sspeed_hi,
                       sspeed_lo, track_gain, out, n_tiles, T, K, C, tile, none,
                       stream);
}

// + K3: per-frame volume/pan from the lane tables for tracks with use[t].
extern "C" int wb_mix_auto(const float* pool, const int32_t* src_start,
                           const int32_t* ms, const int32_t* me,
                           const float* gain, const int32_t* clampf,
                           const int32_t* fin_start, const float* fin_inv,
                           const int32_t* fout_end, const float* fout_inv,
                           const int32_t* is_slow, const float* sfrac_hi,
                           const float* sfrac_lo, const float* sspeed_hi,
                           const float* sspeed_lo, const float* track_gain,
                           float* out, int n_tiles, int T, int K, int C,
                           int tile, const int32_t* vxs, const float* vys,
                           const int32_t* vcv, const float* vtn,
                           const int32_t* pxs, const float* pys,
                           const int32_t* pcv, const float* ptn,
                           const float* mute, const int32_t* use, int P,
                           void* stream) {
  const Lanes lanes = {vxs, vys, vcv, vtn, pxs, pys, pcv, ptn, mute, use, P};
  return launch<true>(pool, src_start, ms, me, gain, clampf, fin_start, fin_inv,
                      fout_end, fout_inv, is_slow, sfrac_hi, sfrac_lo, sspeed_hi,
                      sspeed_lo, track_gain, out, n_tiles, T, K, C, tile, lanes,
                      stream);
}

// K4: per-track pre-gain buffers out [T, C, n_tiles*tile]; the same
// arguments as wb_mix_linear (track_gain is not read).
extern "C" int wb_mix_per_track(const float* pool, const int32_t* src_start,
                                const int32_t* ms, const int32_t* me,
                                const float* gain, const int32_t* clampf,
                                const int32_t* fin_start, const float* fin_inv,
                                const int32_t* fout_end, const float* fout_inv,
                                const int32_t* is_slow, const float* sfrac_hi,
                                const float* sfrac_lo, const float* sspeed_hi,
                                const float* sspeed_lo, const float* track_gain,
                                float* out, int n_tiles, int T, int K, int C,
                                int tile, void* stream) {
  (void)track_gain;
  const Slots S = {pool,     src_start, clampf,   gain,     fin_start, fin_inv,  fout_end,
                   fout_inv, is_slow,   sfrac_hi, sfrac_lo, sspeed_hi, sspeed_lo};
  const int blocks_per_tile = (tile + kFramesPerBlock - 1) / kFramesPerBlock;
  if (T > 65535 || C > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(n_tiles * blocks_per_tile, C, T);
  mix_per_track_kernel<<<grid, kFramesPerBlock, 0, (cudaStream_t)stream>>>(
      S, ms, me, out, n_tiles, T, K, C, tile);
  return (int)cudaGetLastError();
}
