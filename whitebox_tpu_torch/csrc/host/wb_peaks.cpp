// Waveform peak summarize for whitebox_tpu_torch/io/native.py::peaks_level:
// one mip level of (min, max) pairs over int32 codes, ordered by first
// occurrence (gfx/waveform_visual.cpp:9-173's scalar loop). A copy of
// wb_peaks_level from the JAX package's native/wbtpu_native.cpp; the
// scalar oracle that ops/peaks.py::build_mipmaps is held to.

#include <algorithm>
#include <cstdint>

extern "C" {

void wb_peaks_level(const int32_t* codes, int64_t count, int32_t mip, int32_t* out, int64_t out_count) {
  const int64_t block = 1ll << (mip - 1);
  const int64_t chunk = 1ll << mip;
  for (int64_t i = 0; i < out_count; i += 2) {
    int64_t idx = i * block;
    int64_t chunk_len = std::min(chunk, count - idx);
    int32_t min_val = INT32_MAX, max_val = INT32_MIN;
    int64_t min_idx = 0, max_idx = 0;
    for (int64_t j = 0; j < chunk_len; j++) {
      int32_t v = codes[idx + j];
      if (v < min_val) { min_val = v; min_idx = j; }
      if (v > max_val) { max_val = v; max_idx = j; }
    }
    if (max_idx < min_idx) { out[i] = max_val; out[i + 1] = min_val; }
    else { out[i] = min_val; out[i + 1] = max_val; }
  }
}

}  // extern "C"
