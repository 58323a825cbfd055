// Compressed-audio codec runtime: MP3 / Ogg Vorbis / FLAC (and anything else
// libavformat demuxes) decode + encode behind a minimal C ABI.
//
// Parity target: Sample::load_mp3_file / load_ogg_vorbis_file
// (the reference's src/dsp/sample.cpp:207-320), which vendor dr_mp3 and
// stb_vorbis. This framework links the system codec stack instead
// (libavformat/libavcodec), decoding to interleaved f32 exactly like the
// reference's decoders do.
//
// Built at first use by io/codec.py (g++, linked against libavformat,
// libavcodec, libavutil and libswresample) into build/host/<hash>/.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libavutil/samplefmt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

__attribute__((constructor)) void wb_codec_init() {
  av_log_set_level(AV_LOG_ERROR);  // decoder chatter isn't ours to print
}

struct DecodeBuf {
  std::vector<float> data;  // interleaved f32
  int channels = 0;
  int sample_rate = 0;
};

int decode_to_f32(const char* path, DecodeBuf& out) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
    return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -2;
  }
  int stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (stream_idx < 0) {
    avformat_close_input(&fmt);
    return -3;
  }
  AVStream* stream = fmt->streams[stream_idx];
  const AVCodec* codec = avcodec_find_decoder(stream->codecpar->codec_id);
  AVCodecContext* ctx = codec ? avcodec_alloc_context3(codec) : nullptr;
  if (!ctx || avcodec_parameters_to_context(ctx, stream->codecpar) < 0 ||
      avcodec_open2(ctx, codec, nullptr) < 0) {
    if (ctx)
      avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return -4;
  }

  SwrContext* swr = nullptr;  // lazily created once the first frame fixes the layout
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int rc = 0;

  auto push_frame = [&](AVFrame* f) -> int {
    if (!swr) {
      out.channels = f->ch_layout.nb_channels;
      out.sample_rate = f->sample_rate;
      AVChannelLayout layout;
      av_channel_layout_copy(&layout, &f->ch_layout);
      if (swr_alloc_set_opts2(&swr, &layout, AV_SAMPLE_FMT_FLT, f->sample_rate, &layout,
                              (AVSampleFormat)f->format, f->sample_rate, 0, nullptr) < 0 ||
          swr_init(swr) < 0) {
        av_channel_layout_uninit(&layout);
        return -5;
      }
      av_channel_layout_uninit(&layout);
    }
    size_t old = out.data.size();
    out.data.resize(old + (size_t)f->nb_samples * out.channels);
    uint8_t* dst = (uint8_t*)(out.data.data() + old);
    int got = swr_convert(swr, &dst, f->nb_samples, (const uint8_t**)f->extended_data, f->nb_samples);
    if (got < 0)
      return -6;
    out.data.resize(old + (size_t)got * out.channels);
    return 0;
  };

  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == stream_idx) {
      if (avcodec_send_packet(ctx, pkt) >= 0) {
        while (avcodec_receive_frame(ctx, frame) >= 0) {
          if ((rc = push_frame(frame)) != 0)
            goto done;
        }
      }
    }
    av_packet_unref(pkt);
  }
  avcodec_send_packet(ctx, nullptr);  // flush
  while (avcodec_receive_frame(ctx, frame) >= 0) {
    if ((rc = push_frame(frame)) != 0)
      break;
  }

done:
  av_frame_free(&frame);
  av_packet_free(&pkt);
  if (swr)
    swr_free(&swr);
  avcodec_free_context(&ctx);
  avformat_close_input(&fmt);
  if (rc == 0 && (out.channels == 0 || out.data.empty()))
    rc = -7;
  return rc;
}

}  // namespace

extern "C" {

// Decode any compressed audio file to interleaved f32. On success returns 0
// and sets *out (malloc'd; free with wb_codec_free), *frames, *channels,
// *sample_rate. Negative return = error stage.
int wb_codec_decode_f32(
    const char* path, float** out, int64_t* frames, int32_t* channels, int32_t* sample_rate) {
  DecodeBuf buf;
  int rc = decode_to_f32(path, buf);
  if (rc != 0)
    return rc;
  size_t n = buf.data.size();
  float* p = (float*)malloc(n * sizeof(float));
  if (!p)
    return -8;
  memcpy(p, buf.data.data(), n * sizeof(float));
  *out = p;
  *frames = (int64_t)(n / buf.channels);
  *channels = buf.channels;
  *sample_rate = buf.sample_rate;
  return 0;
}

void wb_codec_free(float* p) {
  free(p);
}

// Encoder options mirroring the reference's export model
// (the reference's src/engine/export_prop.h:8-45): bitrate modes CBR/ABR/VBR,
// per-codec quality, FLAC bit depth + compression level, and optional
// container metadata tags (export_metadata).
struct WbEncodeOpts {
  int32_t bitrate_mode;     // 0=CBR, 1=ABR, 2=VBR (ExportBitrateMode)
  int32_t bitrate_kbps;     // CBR/ABR target (mp3_bitrate / vorbis_bitrate)
  int32_t min_bitrate_kbps; // ABR floor (mp3_min_bitrate)
  int32_t max_bitrate_kbps; // ABR ceiling (mp3_max_bitrate)
  float vbr_quality;        // 0..100, 100 = best (mp3_vbr_quality)
  int32_t flac_compression_level; // 0..12 (flac_compression_level)
  int32_t bit_depth;        // 0=codec default; 16 prefers s16 (flac_bit_depth)
  const char* title;        // metadata tags; NULL = omit
  const char* artist;
  const char* comment;
};

static const AVSampleFormat* codec_sample_fmts(const AVCodec* codec) {
#if LIBAVCODEC_VERSION_MAJOR >= 61
  const AVSampleFormat* fmts = nullptr;
  int n = 0;
  if (avcodec_get_supported_config(nullptr, codec, AV_CODEC_CONFIG_SAMPLE_FORMAT, 0,
                                   (const void**)&fmts, &n) >= 0)
    return fmts;
  return nullptr;
#else
  return codec->sample_fmts;
#endif
}

// Encode interleaved f32 -> a compressed container chosen from the path's
// extension (.mp3/.ogg/.flac). Extends the reference's export stub
// (export_prop only writes WAV); also generates the decode test vectors.
int wb_codec_encode_f32_opts(
    const char* path, const float* pcm, int64_t frames, int32_t channels, int32_t sample_rate,
    const WbEncodeOpts* opts) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(fmt->oformat->audio_codec);
  if (!codec) {
    avformat_free_context(fmt);
    return -2;
  }
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  ctx->sample_rate = sample_rate;
  av_channel_layout_default(&ctx->ch_layout, channels);
  const AVSampleFormat* fmts = codec_sample_fmts(codec);
  ctx->sample_fmt = fmts ? fmts[0] : AV_SAMPLE_FMT_FLTP;
  ctx->bit_rate = 192000;
  if (opts) {
    // Bit-depth preference: scan the codec's supported formats for a match
    // (FLAC: s16 when flac_bit_depth==I16, s32 otherwise — export_prop.h:43).
    if (opts->bit_depth == 16 && fmts) {
      for (const AVSampleFormat* f = fmts; *f != AV_SAMPLE_FMT_NONE; ++f)
        if (*f == AV_SAMPLE_FMT_S16 || *f == AV_SAMPLE_FMT_S16P) {
          ctx->sample_fmt = *f;
          break;
        }
    } else if (codec->id == AV_CODEC_ID_FLAC && fmts &&
               (opts->bit_depth == 24 || opts->bit_depth == 32)) {
      // FFmpeg's FLAC fmts[0] is s16, so the deep depths need an explicit
      // scan for s32 input; 24-bit FLAC is s32 input with
      // bits_per_raw_sample=24. bit_depth==0 keeps the reference default
      // (flac_bit_depth = I16, export_prop.h:43).
      for (const AVSampleFormat* f = fmts; *f != AV_SAMPLE_FMT_NONE; ++f)
        if (*f == AV_SAMPLE_FMT_S32 || *f == AV_SAMPLE_FMT_S32P) {
          ctx->sample_fmt = *f;
          break;
        }
      if (opts->bit_depth == 24)
        ctx->bits_per_raw_sample = 24;
    }
    int64_t br = (int64_t)(opts->bitrate_kbps > 0 ? opts->bitrate_kbps : 192) * 1000;
    switch (opts->bitrate_mode) {
      case 2: {  // VBR: quality-targeted, bitrate fields ignored
        ctx->flags |= AV_CODEC_FLAG_QSCALE;
        float q01 = opts->vbr_quality / 100.0f;  // 1.0 = best
        if (q01 < 0.0f) q01 = 0.0f;
        if (q01 > 1.0f) q01 = 1.0f;
        float qscale;
        if (codec->id == AV_CODEC_ID_MP3)
          qscale = (1.0f - q01) * 9.0f;  // LAME -V: 0 best .. 9 worst
        else if (codec->id == AV_CODEC_ID_VORBIS)
          qscale = -1.0f + q01 * 11.0f;  // vorbis -q: -1 worst .. 10 best
        else
          qscale = (1.0f - q01) * 9.0f;
        ctx->global_quality = (int)(FF_QP2LAMBDA * qscale);
        break;
      }
      case 1:  // ABR: target plus min/max bounds
        ctx->bit_rate = br;
        if (opts->min_bitrate_kbps > 0)
          ctx->rc_min_rate = (int64_t)opts->min_bitrate_kbps * 1000;
        if (opts->max_bitrate_kbps > 0)
          ctx->rc_max_rate = (int64_t)opts->max_bitrate_kbps * 1000;
        if (codec->id == AV_CODEC_ID_MP3)
          av_opt_set_int(ctx->priv_data, "abr", 1, 0);
        break;
      default:  // CBR
        ctx->bit_rate = br;
        break;
    }
    if (codec->id == AV_CODEC_ID_FLAC && opts->flac_compression_level >= 0)
      ctx->compression_level = opts->flac_compression_level;
    if (opts->title)
      av_dict_set(&fmt->metadata, "title", opts->title, 0);
    if (opts->artist)
      av_dict_set(&fmt->metadata, "artist", opts->artist, 0);
    if (opts->comment)
      av_dict_set(&fmt->metadata, "comment", opts->comment, 0);
  }
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  AVStream* stream = avformat_new_stream(fmt, codec);
  int rc = 0;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  SwrContext* swr = nullptr;
  int64_t pos = 0;
  int chunk = 0;

  if (avcodec_open2(ctx, codec, nullptr) < 0) {
    rc = -3;
    goto done;
  }
  avcodec_parameters_from_context(stream->codecpar, ctx);
  stream->time_base = AVRational{ 1, sample_rate };
  if (!(fmt->oformat->flags & AVFMT_NOFILE) && avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    rc = -4;
    goto done;
  }
  if (avformat_write_header(fmt, nullptr) < 0) {
    rc = -5;
    goto done;
  }

  {
    AVChannelLayout layout;
    av_channel_layout_default(&layout, channels);
    if (swr_alloc_set_opts2(&swr, &layout, ctx->sample_fmt, sample_rate, &layout,
                            AV_SAMPLE_FMT_FLT, sample_rate, 0, nullptr) < 0 ||
        swr_init(swr) < 0) {
      av_channel_layout_uninit(&layout);
      rc = -6;
      goto done;
    }
    av_channel_layout_uninit(&layout);
  }

  chunk = ctx->frame_size > 0 ? ctx->frame_size : 4096;
  pkt = av_packet_alloc();
  while (pos < frames) {
    int n = (int)((frames - pos) < chunk ? (frames - pos) : chunk);
    frame = av_frame_alloc();
    frame->nb_samples = n;
    frame->format = ctx->sample_fmt;
    av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
    frame->sample_rate = sample_rate;
    if (av_frame_get_buffer(frame, 0) < 0) {
      rc = -7;
      goto done;
    }
    const uint8_t* src = (const uint8_t*)(pcm + pos * channels);
    if (swr_convert(swr, frame->extended_data, n, &src, n) < 0) {
      rc = -8;
      goto done;
    }
    frame->pts = pos;
    pos += n;
    if (avcodec_send_frame(ctx, frame) < 0) {
      rc = -9;
      goto done;
    }
    av_frame_free(&frame);
    while (avcodec_receive_packet(ctx, pkt) >= 0) {
      av_packet_rescale_ts(pkt, AVRational{ 1, sample_rate }, stream->time_base);
      pkt->stream_index = stream->index;
      av_interleaved_write_frame(fmt, pkt);
      av_packet_unref(pkt);
    }
  }
  avcodec_send_frame(ctx, nullptr);  // flush
  while (avcodec_receive_packet(ctx, pkt) >= 0) {
    av_packet_rescale_ts(pkt, AVRational{ 1, sample_rate }, stream->time_base);
    pkt->stream_index = stream->index;
    av_interleaved_write_frame(fmt, pkt);
    av_packet_unref(pkt);
  }
  av_write_trailer(fmt);

done:
  if (frame)
    av_frame_free(&frame);
  if (pkt)
    av_packet_free(&pkt);
  if (swr)
    swr_free(&swr);
  avcodec_free_context(&ctx);
  if (fmt && !(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
    avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}

// Legacy entry point: CBR 192 kbps, codec-default depth, no tags.
int wb_codec_encode_f32(
    const char* path, const float* pcm, int64_t frames, int32_t channels, int32_t sample_rate) {
  return wb_codec_encode_f32_opts(path, pcm, frames, channels, sample_rate, nullptr);
}

}  // extern "C"
