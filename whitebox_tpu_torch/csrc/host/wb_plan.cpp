// Mix-plan row expansion for whitebox_tpu_torch/ops/mix_plan.py::build_plan
// (the per-(tile, track) slot tables of speed-1 rows), and the version
// marker the loader checks. A copy of wb_build_mix_plan and
// wb_native_version from the JAX package's native/wbtpu_native.cpp; the
// slot's window pair (row_al, delta) is what the TPU plan stored, and the
// port folds it into one flat pool index (mix_plan._flat_start).

#include <algorithm>
#include <cstdint>

extern "C" {

// ---------------------------------------------------------------------------
// Pallas mix-plan row expansion (ops/mix_pallas.build_plan inner loops)
// ---------------------------------------------------------------------------

// Inputs: per-segment-row arrays from the carve (n rows), channel bases
// [num_samples, channels]. Outputs: flat [n_tiles, T, K, ...] arrays
// (zero/sentinel-initialized by the caller) + cursor scratch [n_tiles*T].
int32_t wb_build_mix_plan(
    int64_t n_rows,
    const int32_t* track, const int32_t* dst_start, const int32_t* length,
    const int32_t* sample_id, const int32_t* src_int, const float* gain,
    const uint8_t* clampf, const int32_t* fin_start, const float* fin_inv,
    const int32_t* fout_end, const float* fout_inv,
    const int32_t* channel_base, int32_t channels,
    int32_t tile, int32_t n_tiles, int32_t T, int32_t K,
    int32_t* row_al, int32_t* delta, int32_t* ms, int32_t* me,
    float* out_gain, int32_t* out_clamp,
    int32_t* out_fis, float* out_fii, int32_t* out_foe, float* out_foi,
    int32_t* cursor) {
  const int32_t NOFADE = 1 << 30;
  for (int64_t r = 0; r < n_rows; r++) {
    int32_t trk = track[r];
    int64_t d0 = dst_start[r];
    int64_t dend = d0 + length[r];
    int32_t t0 = (int32_t)(d0 / tile);
    int32_t t1 = (int32_t)((dend - 1) / tile);
    for (int32_t ti = t0; ti <= t1; ti++) {
      int64_t g0 = (int64_t)ti * tile;
      int64_t cell = (int64_t)ti * T + trk;
      int32_t k = cursor[cell]++;
      if (k >= K) return -1;  // slot overflow (caller falls back)
      int64_t base = ((int64_t)ti * T + trk) * K + k;
      for (int32_t ch = 0; ch < channels; ch++) {
        int64_t w = (int64_t)channel_base[(int64_t)sample_id[r] * channels + ch] + src_int[r] + (g0 - d0);
        int64_t w_al = (w / 1024) * 1024;
        if (w < 0 && w % 1024 != 0) w_al -= 1024;  // floor for negative (cannot happen with guards)
        row_al[base * channels + ch] = (int32_t)(w_al / 128);
        delta[base * channels + ch] = (int32_t)(w - w_al);
      }
      int64_t msv = std::max(d0, g0) - g0;
      int64_t mev = std::min<int64_t>(dend, g0 + tile) - g0;
      ms[base] = (int32_t)msv;
      me[base] = (int32_t)mev;
      out_gain[base] = gain[r];
      out_clamp[base] = clampf[r] ? 1 : 0;
      int64_t fis = (int64_t)fin_start[r] - g0;
      int64_t foe = (int64_t)fout_end[r] - g0;
      out_fis[base] = (int32_t)std::max<int64_t>(fis, -NOFADE);
      out_foe[base] = (int32_t)std::min<int64_t>(foe, NOFADE);
      out_fii[base] = fin_inv[r];
      out_foi[base] = fout_inv[r];
    }
  }
  return 0;
}


// Version marker for the loader (3: the carve ABI with host-precomputed
// event positions, wb_carve.cpp)
int32_t wb_native_version() { return 3; }

}  // extern "C"
