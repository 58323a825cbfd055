// Timeline mix kernel for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel whitebox_tpu/ops/mix_pallas.py::_mix_kernel
// (launched by _mix_call) in the specialisation the plain bounce runs:
// per_track=False, no automation lanes, interp="linear". That covers the
// fast slots (speed-1 copies, kernel K1) and the linear resampled slots,
// forward and reverse (kernel K2-linear).
//
// What it computes, per output frame `pos` of tile `ti` and channel `ch`:
//   acc = 0
//   for t in 0..T-1, for k in 0..K-1 (slot s = (ti*T + t)*K + k), if active:
//     v   = fast: pool[src_start + pos] (optionally clamped to +-1)
//           slow: ix, fx = phase(pos - ms); a = pool[src_start+ix];
//                 b = pool[src_start+ix+1]; v = a + fx*(b-a)
//     env = clip((pos-fis)*fii, 0, 1) * clip((foe-pos)*foi, 0, 1)
//     acc += (ms <= pos < me) ? ((v*gain)*env)*tg[t,ch] : 0
//   out = hard clip of acc to +-1
// Every slot of every track is added in that order (engine.cpp:1616), so
// the result is bit-identical to the JAX kernel and, at speed 1, to the
// NumPy oracle.
//
// Numerics: every multiply and add is written with __fmul_rn/__fadd_rn/
// __fsub_rn, which nvcc never contracts into an FMA (the build also passes
// --fmad=false). Denormals are kept (no fast math). Clamp and clip use the
// select form of the reference, so a NaN passes through as it does there.
//
// What bounds it on an H100: at the headline size (128 tracks x 60 s,
// 48 kHz stereo) the sample pool is 4.9 MB and sits in the 50 MB L2, so
// pool reads are L2 traffic; the one stream that has to reach HBM is the
// 23 MB output write. Slot metadata is ~60 bytes per slot, read by every
// thread of a block at the same address (a broadcast from L1).
// What this first design does about it: nothing yet. One thread owns one
// (frame, channel) accumulator in a register and walks all T*K slots; no
// shared-memory staging of the slot tables, no TMA, no vector loads.
// Nothing is carried between blocks and there are no atomics. Measured on
// an H100 80GB HBM3 (700 W limit) at the headline size: 3.37 ms, i.e. the
// output leaves at 6.8 GB/s; the bound is instruction issue on the slot
// walk (~256 slots x 2 loads per thread before any sample is read), not
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFramesPerBlock = 256;

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

__global__ void __launch_bounds__(kFramesPerBlock)
mix_linear_kernel(const float* __restrict__ pool,
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
                  int n_tiles, int T, int K, int C, int tile) {
  // grid.x walks (tile, frame block) pairs, grid.y the channels
  const int blocks_per_tile = (tile + kFramesPerBlock - 1) / kFramesPerBlock;
  const int ti = blockIdx.x / blocks_per_tile;
  const int pos = (blockIdx.x % blocks_per_tile) * kFramesPerBlock + threadIdx.x;
  const int ch = blockIdx.y;
  if (pos >= tile) return;  // tile-relative frame past a ragged tile end

  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float tg = __ldg(track_gain + t * C + ch);
    const int s0 = (ti * T + t) * K;
    for (int k = 0; k < K; ++k) {
      const int s = s0 + k;
      const int m0 = __ldg(ms + s);
      const int m1 = __ldg(me + s);
      if (m1 <= m0) continue;  // inactive slot: the reference adds nothing
      float contrib = 0.0f;    // masked frames add +0.0, as the reference does
      if (pos >= m0 && pos < m1) {
        const int base = __ldg(src_start + (int64_t)s * C + ch);
        float v;
        if (__ldg(is_slow + s)) {
          int ix;
          float fx;
          phase_eval(pos - m0, __ldg(sfrac_hi + s), __ldg(sfrac_lo + s),
                     __ldg(sspeed_hi + s), __ldg(sspeed_lo + s), &ix, &fx);
          const float a = __ldg(pool + base + ix);
          const float b = __ldg(pool + base + ix + 1);
          v = __fadd_rn(a, __fmul_rn(fx, __fsub_rn(b, a)));  // sampler.cpp:55
        } else {
          v = __ldg(pool + base + pos);
          if (__ldg(clampf + s)) {
            v = v < -1.0f ? -1.0f : v;
            v = v > 1.0f ? 1.0f : v;
          }
        }
        const float env = __fmul_rn(
            clip01(__fmul_rn(__int2float_rn(pos - __ldg(fin_start + s)), __ldg(fin_inv + s))),
            clip01(__fmul_rn(__int2float_rn(__ldg(fout_end + s) - pos), __ldg(fout_inv + s))));
        contrib = __fmul_rn(__fmul_rn(__fmul_rn(v, __ldg(gain + s)), env), tg);
      }
      acc = __fadd_rn(acc, contrib);
    }
  }
  acc = acc > 1.0f ? 1.0f : acc;
  acc = acc < -1.0f ? -1.0f : acc;
  out[(int64_t)ch * n_tiles * tile + (int64_t)ti * tile + pos] = acc;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the
// launch (0 == cudaSuccess).
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
  const int blocks_per_tile = (tile + kFramesPerBlock - 1) / kFramesPerBlock;
  dim3 grid(n_tiles * blocks_per_tile, C);
  mix_linear_kernel<<<grid, kFramesPerBlock, 0, (cudaStream_t)stream>>>(
      pool, src_start, ms, me, gain, clampf, fin_start, fin_inv, fout_end,
      fout_inv, is_slow, sfrac_hi, sfrac_lo, sspeed_hi, sspeed_lo, track_gain,
      out, n_tiles, T, K, C, tile);
  return (int)cudaGetLastError();
}
