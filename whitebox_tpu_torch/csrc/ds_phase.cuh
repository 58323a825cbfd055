// Device helpers shared by the port's mix kernels (csrc/mix_kernel.cu and
// csrc/gather_mix.cu): the double-single resampler phase, the [0, 1] clip
// of the fade envelope and int32 subtraction with wrap-around.
//
// Every multiply and add is __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never
// contracts into an FMA, so phase_eval is ops/dsarith.py::phase_eval (the
// plain PyTorch twin) bit for bit.

#pragma once

#include <stdint.h>

namespace {

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

}  // namespace
