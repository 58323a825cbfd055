// Native timeline carve — C++ port of the per-track block walk in
// whitebox_tpu_torch/timeline/carve.py (_carve_track_audio), the
// timeline-at-once inversion of the reference's Track::process_event
// (track.cpp:258-451) + event-segmented render loop (track.cpp:664-724).
// A copy of the JAX package's native/wb_carve.cpp, built by
// whitebox_tpu_torch/io/native.py with g++ -ffp-contract=off.
//
// BIT-PARITY CONTRACT with the Python implementation: every f64 operation
// here mirrors the NumPy expression order exactly (this translation unit is
// compiled with -ffp-contract=off so no FMA contraction can change results),
// int casts are C trunc-toward-zero exactly like numpy .astype / Python
// int(), and round() is rint (round-half-even, matching Python round()).
// tests/test_torch_host.py holds the port's carve against the JAX package's.
//
// The Python walk remains the reference and the path without g++; this is
// the host-runtime accelerator: at 128-track resampled scale the Python walk
// is ~0.15-0.25 s per render while this is ~milliseconds, which matters
// because carve runs per render iteration.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int32_t NOFADE = 1 << 30;

// carve.py SegmentTable row columns (struct-of-arrays)
struct Rows {
  std::vector<int32_t> track, dst, len, sid, src_int, clip_id, fin_start, fout_end;
  std::vector<double> src_frac, speed;
  std::vector<float> gain, fin_inv, fout_inv;
  std::vector<uint8_t> fast, clamp;

  void push(int32_t t, int64_t d, int64_t L, int32_t s, int64_t si, double sf,
            double sp, float g, uint8_t fa, uint8_t cl, int32_t cid,
            int32_t fis, float fii, int32_t foe, float foi) {
    track.push_back(t);
    dst.push_back((int32_t)d);
    len.push_back((int32_t)L);
    sid.push_back(s);
    src_int.push_back((int32_t)si);
    src_frac.push_back(sf);
    speed.push_back(sp);
    gain.push_back(g);
    fast.push_back(fa);
    clamp.push_back(cl);
    clip_id.push_back(cid);
    fin_start.push_back(fis);
    fin_inv.push_back(fii);
    fout_end.push_back(foe);
    fout_inv.push_back(foi);
  }
};

struct CarveOut {
  Rows fast_rows;   // rows.append(...) list in carve.py
  Rows slow_rows;   // expanded slow_cols rows in emission order
  bool error = false;
};

// carve.py _u64_trunc: (uint64_t)(double) with negative-UB clamp
inline int64_t u64_trunc(double x) { return x > 0.0 ? (int64_t)x : 0; }

struct Ctx {
  const double* P;  // [num_blocks + 1]
  const double* S;  // [num_blocks + 1]
  int64_t num_blocks;
  int64_t bs;
  double rate, bd;
  int64_t end_frame;
  bool runs;  // slow_emit == "runs"
  CarveOut* out;
};

// per-clip scalars shared by every row of a pass
struct Scal {
  int32_t trk, sid, cid;
  float gain;
  int32_t fis, foe;
  float fii, foi;
};

// carve.py emit_slow_span — forward pass; returns the wrap point
int64_t emit_slow_span(const Ctx& c, int64_t span_gs, int64_t span_ge, double span_o0,
                       double count, double speed, const Scal& s) {
  if (c.runs) {
    int64_t total = span_ge - span_gs;
    if (span_o0 + (double)(total - 1) * speed < count - 1e-6) {
      double oi = std::floor(span_o0);
      c.out->slow_rows.push(s.trk, span_gs, total, s.sid, (int64_t)oi, span_o0 - oi,
                            speed, s.gain, 0, 1, s.cid, s.fis, s.fii, s.foe, s.foi);
      return span_ge;
    }
  }
  // per-block walk with exact sequentially-rounded f64 offsets
  int64_t first_edge = std::min(span_ge, (span_gs / c.bs + 1) * c.bs);
  double off = span_o0;
  int64_t edge = span_gs;
  int64_t aligned = first_edge;
  int64_t i = 0;
  while (edge < span_ge) {
    int64_t next;
    if (i == 0) {
      next = first_edge;
    } else {
      aligned += c.bs;
      next = std::min(aligned, span_ge);
    }
    int64_t len = next - edge;
    bool live = off < count;
    int64_t num = std::min(len, (int64_t)std::ceil((count - off) / speed));
    bool exh = (!live) || (num < len);
    if (c.runs) {
      if (exh) {
        if (edge > span_gs) {  // merged prefix run [span_gs, edge)
          double oi = std::floor(span_o0);
          c.out->slow_rows.push(s.trk, span_gs, edge - span_gs, s.sid, (int64_t)oi,
                                span_o0 - oi, speed, s.gain, 0, 1, s.cid,
                                s.fis, s.fii, s.foe, s.foi);
        }
        if (live && num > 0) {
          double oi = std::floor(off);
          c.out->slow_rows.push(s.trk, edge, num, s.sid, (int64_t)oi, off - oi,
                                speed, s.gain, 0, 1, s.cid, s.fis, s.fii, s.foe, s.foi);
        }
        return live ? edge + num : edge;
      }
    } else {
      if (live && num > 0) {
        double oi = std::floor(off);
        c.out->slow_rows.push(s.trk, edge, num, s.sid, (int64_t)oi, off - oi,
                              speed, s.gain, 0, 1, s.cid, s.fis, s.fii, s.foe, s.foi);
      }
      if (exh) return live ? edge + num : edge;
    }
    off = off + (double)len * speed;  // sampler.cpp:103 accumulation
    edge = next;
    i++;
  }
  if (c.runs) {  // no exhaustion: one run covers the whole span
    double oi = std::floor(span_o0);
    c.out->slow_rows.push(s.trk, span_gs, span_ge - span_gs, s.sid, (int64_t)oi,
                          span_o0 - oi, speed, s.gain, 0, 1, s.cid,
                          s.fis, s.fii, s.foe, s.foi);
  }
  return span_ge;
}

// carve.py emit_reverse_span — x = (count-1-v) - j*speed; returns wrap point
int64_t emit_reverse_span(const Ctx& c, int64_t span_gs, int64_t span_ge, double v0,
                          double count, double speed, const Scal& s) {
  if (c.runs) {
    int64_t total = span_ge - span_gs;
    double x0 = (count - 1.0) - v0;
    if (x0 - (double)(total - 1) * speed > 1e-6) {
      double xi = std::floor(x0);
      c.out->slow_rows.push(s.trk, span_gs, total, s.sid, (int64_t)xi, x0 - xi,
                            -speed, s.gain, 0, 1, s.cid, s.fis, s.fii, s.foe, s.foi);
      return span_ge;
    }
  }
  int64_t first_edge = std::min(span_ge, (span_gs / c.bs + 1) * c.bs);
  double v = v0;
  int64_t edge = span_gs;
  int64_t aligned = first_edge;
  int64_t i = 0;
  while (edge < span_ge) {
    int64_t next;
    if (i == 0) {
      next = first_edge;
    } else {
      aligned += c.bs;
      next = std::min(aligned, span_ge);
    }
    int64_t len = next - edge;
    double x0 = (count - 1.0) - v;
    bool live = x0 >= 0.0;
    int64_t num = std::min(len, live ? (int64_t)std::floor(x0 / speed) + 1 : (int64_t)0);
    if (live && num > 0) {
      double xi = std::floor(x0);
      c.out->slow_rows.push(s.trk, edge, num, s.sid, (int64_t)xi, x0 - xi,
                            -speed, s.gain, 0, 1, s.cid, s.fis, s.fii, s.foe, s.foi);
    }
    bool exh = (!live) || (num < len);
    if (exh) return live ? edge + num : edge;
    v = v + (double)len * speed;
    edge = next;
    i++;
  }
  return span_ge;
}

// clip.h:21 ClipMode values (session/clip.py)
enum Mode : int32_t {
  ONE_SHOT = 0,
  ONE_SHOT_REVERSE = 1,
  LOOP_STRAIGHT = 2,
  LOOP_REVERSE = 3,
  LOOP_BIDIRECTIONAL = 4,
};

struct ClipCols {
  const double *min_time, *max_time, *start_offset, *clip_speed;
  const double *fade_start, *fade_end, *count, *srate;
  const float* gain;
  const int32_t *mode, *clip_id, *sid;
  const uint8_t *clampf, *skip;
  // per-clip beat->sample conversions, precomputed HOST-SIDE by
  // timeline/carve_native.py (v3 ABI): the Python front end evaluates the
  // exact expressions of the Python walk — beat_to_samples when the
  // session has one tempo, the TempoMap closed-form integrals when mapped
  // — so this walk stays pure sample-domain arithmetic and serves BOTH.
  const int64_t* ev_ka;       // searchsorted(P[1:], min_time, walk side), clamped
  const double* ev_so_start;  // S[ka] + delta_samples(P[ka] -> min_time)
  const int64_t* ev_ke;
  const double* ev_so_stop;   // S[ke] + delta_samples(P[ke] -> max_time)
  const double* pos0;         // delta_samples(min_time -> P[0]) (mid-start)
  const int64_t* elapsed0;    // rint(pos0)
  const int64_t* clip_frames; // rint(delta_samples(min_time -> max_time))
  const int64_t* fin_frames;  // fade-in span in frames (local tempo)
  const int64_t* fout_frames; // fade-out span in frames
};

// carve.py _carve_track_audio
void carve_track(const Ctx& c, const ClipCols& cc, int64_t c0, int64_t c1,
                 int64_t ci0, int32_t track_idx) {
  if (ci0 < 0) return;
  bool first = true;
  for (int64_t ci = c0 + ci0; ci < c1; ci++) {
    if (cc.skip[ci]) {
      first = false;
      continue;
    }
    const double count = cc.count[ci];
    const double clip_speed = cc.clip_speed[ci];
    const double playback_speed = (cc.srate[ci] / c.rate) * clip_speed;  // sampler.h:24

    // ---- Play event position + initial sampler offset ----
    bool first_mid_start = first && c.P[0] > cc.min_time[ci];
    int64_t play_global;
    double o0;
    if (first_mid_start) {
      double sample_pos = cc.pos0[ci];  // track.cpp:372-388 (host-exact)
      o0 = (double)(int64_t)(cc.start_offset[ci] + sample_pos * clip_speed);
      play_global = 0;
    } else {
      int64_t ka = cc.ev_ka[ci];
      if (ka >= c.num_blocks) break;  // starts after window; later clips too
      play_global = ka * c.bs + (u64_trunc(cc.ev_so_start[ci]) % c.bs);
      o0 = (double)(int64_t)cc.start_offset[ci];  // (size_t) cast, track.cpp:366
    }
    first = false;

    // ---- Stop event position ----
    int64_t ke = cc.ev_ke[ci];
    int64_t stop_global;
    if (ke >= c.num_blocks) {
      stop_global = c.end_frame;
    } else {
      stop_global = ke * c.bs + (u64_trunc(cc.ev_so_stop[ci]) % c.bs);
    }

    int64_t gs = play_global, ge = std::min(stop_global, c.end_frame);
    if (ge > gs && o0 < count && playback_speed > 0.0) {
      float gain = cc.gain[ci];
      uint8_t clampf = cc.clampf[ci];

      // fade envelope anchors (framework extension)
      int32_t fis = -NOFADE, foe = NOFADE;
      float fii = 1.0f, foi = 1.0f;
      if (cc.fade_start[ci] > 0.0 || cc.fade_end[ci] > 0.0) {
        int64_t elapsed = first_mid_start ? cc.elapsed0[ci] : 0;
        int64_t clip_begin = play_global - elapsed;
        int64_t clip_frames = cc.clip_frames[ci];
        int64_t clip_end = clip_begin + clip_frames;
        int64_t fin_frames = cc.fin_frames[ci];
        int64_t fout_frames = cc.fout_frames[ci];
        if (fin_frames > 0) {
          fis = (int32_t)clip_begin;
          fii = (float)(1.0 / (double)fin_frames);
        }
        if (fout_frames > 0) {
          foe = (int32_t)clip_end;
          foi = (float)(1.0 / (double)fout_frames);
        }
      }
      Scal s{track_idx, cc.sid[ci], cc.clip_id[ci], gain, fis, foe, fii, foi};

      int32_t mode = cc.mode[ci];
      if (mode == ONE_SHOT || mode == LOOP_STRAIGHT) {
        bool looping = mode == LOOP_STRAIGHT;
        if (playback_speed == 1.0) {
          int64_t pos = gs, o = (int64_t)o0;
          while (pos < ge) {
            int64_t length = std::min(ge - pos, (int64_t)count - o);
            if (length <= 0) break;
            c.out->fast_rows.push(track_idx, pos, length, s.sid, o, 0.0, 1.0, gain,
                                  1, clampf, s.cid, fis, fii, foe, foi);
            if (!looping) break;
            pos += length;
            o = 0;
          }
        } else {
          int64_t pos = gs;
          double o = o0;
          while (pos < ge) {
            int64_t nxt = emit_slow_span(c, pos, ge, o, count, playback_speed, s);
            if (!looping || nxt >= ge || nxt <= pos) break;
            pos = nxt;
            o = 0.0;
          }
        }
      } else if (mode == ONE_SHOT_REVERSE || mode == LOOP_REVERSE) {
        bool looping = mode == LOOP_REVERSE;
        if (playback_speed == 1.0) {
          int64_t pos = gs, v = (int64_t)o0;
          while (pos < ge) {
            int64_t x0 = (int64_t)count - 1 - v;
            if (x0 < 0) {
              if (!looping) break;
              v = 0;
              x0 = (int64_t)count - 1;
            }
            int64_t length = std::min(ge - pos, x0 + 1);
            if (length <= 0) break;
            c.out->fast_rows.push(track_idx, pos, length, s.sid, x0, 0.0, -1.0, gain,
                                  0, 0, s.cid, fis, fii, foe, foi);
            if (!looping) break;
            pos += length;
            v = 0;
          }
        } else {
          int64_t pos = gs;
          double v = o0;
          while (pos < ge) {
            int64_t nxt = emit_reverse_span(c, pos, ge, v, count, playback_speed, s);
            if (!looping || nxt >= ge || nxt <= pos) break;
            pos = nxt;
            v = 0.0;
          }
        }
      } else if (mode == LOOP_BIDIRECTIONAL) {
        bool rev = false;
        int64_t pos = gs;
        double o = o0;
        int stalls = 0;
        while (pos < ge && stalls <= 2) {
          if (playback_speed == 1.0) {
            if (!rev) {
              int64_t length = std::min(ge - pos, (int64_t)count - (int64_t)o);
              if (length <= 0) {
                rev = true;
                o = playback_speed;
                stalls++;
                continue;
              }
              c.out->fast_rows.push(track_idx, pos, length, s.sid, (int64_t)o, 0.0, 1.0,
                                    gain, 1, clampf, s.cid, fis, fii, foe, foi);
              pos += length;
              rev = true;
              o = playback_speed;
              stalls = 0;
            } else {
              int64_t x0 = (int64_t)count - 1 - (int64_t)o;
              if (x0 < 0) {
                rev = false;
                o = playback_speed;
                stalls++;
                continue;
              }
              int64_t length = std::min(ge - pos, x0 + 1);
              if (length <= 0) break;
              c.out->fast_rows.push(track_idx, pos, length, s.sid, x0, 0.0, -1.0, gain,
                                    0, 0, s.cid, fis, fii, foe, foi);
              pos += length;
              rev = false;
              o = playback_speed;
              stalls = 0;
            }
          } else {
            int64_t nxt = rev ? emit_reverse_span(c, pos, ge, o, count, playback_speed, s)
                              : emit_slow_span(c, pos, ge, o, count, playback_speed, s);
            if (nxt >= ge) break;
            if (nxt <= pos) {
              // zero-progress pass: flip direction, up to the 2-stall limit
              rev = !rev;
              o = playback_speed;
              stalls++;
              continue;
            }
            pos = nxt;
            rev = !rev;
            o = playback_speed;
            stalls = 0;
          }
        }
      } else {
        c.out->error = true;
        return;
      }
    }
  }
}

template <typename T>
void copy_out(const std::vector<T>& v, T* dst) {
  if (dst && !v.empty()) std::copy(v.begin(), v.end(), dst);
}

}  // namespace

extern "C" {

// Carve every track's audio clips into segment rows. Returns an opaque
// handle (free with wb_carve_free) and writes the fast/slow row counts;
// returns nullptr on error (unknown clip mode). clip arrays are flattened
// across tracks; clip_begin[t]..clip_begin[t+1] delimit track t's clips;
// ci0[t] is the starting clip index within the track (-1: skip track).
void* wb_carve_audio(
    const double* P, const double* S, int64_t num_blocks, int64_t bs,
    double rate, double bd, int32_t runs, int32_t n_tracks,
    const int64_t* clip_begin, const int64_t* ci0,
    const double* min_time, const double* max_time, const double* start_offset,
    const double* clip_speed, const double* fade_start, const double* fade_end,
    const double* count, const double* srate, const float* gain,
    const int32_t* mode, const int32_t* clip_id, const int32_t* sid,
    const uint8_t* clampf, const uint8_t* skip,
    const int64_t* ev_ka, const double* ev_so_start,
    const int64_t* ev_ke, const double* ev_so_stop,
    const double* pos0, const int64_t* elapsed0, const int64_t* clip_frames,
    const int64_t* fin_frames, const int64_t* fout_frames,
    int64_t* n_fast, int64_t* n_slow) {
  CarveOut* out = new CarveOut();
  Ctx c{P, S, num_blocks, bs, rate, bd, num_blocks * bs, runs != 0, out};
  ClipCols cc{min_time, max_time, start_offset, clip_speed, fade_start, fade_end,
              count,    srate,    gain,         mode,       clip_id,   sid,
              clampf,   skip,
              ev_ka,    ev_so_start, ev_ke, ev_so_stop,
              pos0,     elapsed0,    clip_frames, fin_frames, fout_frames};
  for (int32_t t = 0; t < n_tracks; t++) {
    carve_track(c, cc, clip_begin[t], clip_begin[t + 1], ci0[t], t);
    if (out->error) {
      delete out;
      return nullptr;
    }
  }
  *n_fast = (int64_t)out->fast_rows.track.size();
  *n_slow = (int64_t)out->slow_rows.track.size();
  return out;
}

void wb_carve_copy(
    void* h,
    int32_t* f_track, int32_t* f_dst, int32_t* f_len, int32_t* f_sid,
    int32_t* f_src_int, double* f_src_frac, double* f_speed, float* f_gain,
    uint8_t* f_fast, uint8_t* f_clamp, int32_t* f_cid,
    int32_t* f_fis, float* f_fii, int32_t* f_foe, float* f_foi,
    int32_t* s_track, int32_t* s_dst, int32_t* s_len, int32_t* s_sid,
    int32_t* s_src_int, double* s_src_frac, double* s_speed, float* s_gain,
    int32_t* s_cid, int32_t* s_fis, float* s_fii, int32_t* s_foe, float* s_foi) {
  CarveOut* out = (CarveOut*)h;
  const Rows& f = out->fast_rows;
  copy_out(f.track, f_track);
  copy_out(f.dst, f_dst);
  copy_out(f.len, f_len);
  copy_out(f.sid, f_sid);
  copy_out(f.src_int, f_src_int);
  copy_out(f.src_frac, f_src_frac);
  copy_out(f.speed, f_speed);
  copy_out(f.gain, f_gain);
  copy_out(f.fast, f_fast);
  copy_out(f.clamp, f_clamp);
  copy_out(f.clip_id, f_cid);
  copy_out(f.fin_start, f_fis);
  copy_out(f.fin_inv, f_fii);
  copy_out(f.fout_end, f_foe);
  copy_out(f.fout_inv, f_foi);
  const Rows& sl = out->slow_rows;
  copy_out(sl.track, s_track);
  copy_out(sl.dst, s_dst);
  copy_out(sl.len, s_len);
  copy_out(sl.sid, s_sid);
  copy_out(sl.src_int, s_src_int);
  copy_out(sl.src_frac, s_src_frac);
  copy_out(sl.speed, s_speed);
  copy_out(sl.gain, s_gain);
  copy_out(sl.clip_id, s_cid);
  copy_out(sl.fin_start, s_fis);
  copy_out(sl.fin_inv, s_fii);
  copy_out(sl.fout_end, s_foe);
  copy_out(sl.fout_inv, s_foi);
}

void wb_carve_free(void* h) { delete (CarveOut*)h; }

}  // extern "C"
