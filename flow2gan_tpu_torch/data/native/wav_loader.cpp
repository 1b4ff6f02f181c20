// Native WAV decode and crop for the port's data pipeline: the port's own
// copy of flow2gan_tpu/data/native/wav_loader.cpp, as far as the loader uses
// it. It decodes only the requested crop (seeking past the header), mixes to
// mono and converts to float32, the per-item hot path of a training loader.
// Exposed through a plain C ABI and loaded with ctypes
// (flow2gan_tpu_torch/data/native_audio.py), which builds it at first use;
// `make -C flow2gan_tpu_torch/data/native` builds the same library. Supports
// PCM 8/16/24/32, IEEE float32/64, any channel count, RIFF chunk walking and
// WAVE_FORMAT_EXTENSIBLE.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;      // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long long data_offset = 0;  // byte offset of sample data
  long long data_bytes = 0;
};

bool read_header(FILE* f, WavInfo* info) {
  char riff[12];
  if (fread(riff, 1, 12, f) != 12) return false;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0)
    return false;
  // walk chunks
  for (;;) {
    char head[8];
    if (fread(head, 1, 8, f) != 8) return false;
    uint32_t size;
    memcpy(&size, head + 4, 4);
    if (memcmp(head, "fmt ", 4) == 0) {
      std::vector<unsigned char> fmt(size);
      if (fread(fmt.data(), 1, size, f) != size) return false;
      memcpy(&info->format, fmt.data() + 0, 2);
      memcpy(&info->channels, fmt.data() + 2, 2);
      memcpy(&info->sample_rate, fmt.data() + 4, 4);
      memcpy(&info->bits, fmt.data() + 14, 2);
      if (info->format == 0xFFFE && size >= 26) {  // EXTENSIBLE
        memcpy(&info->format, fmt.data() + 24, 2);
      }
      if (size & 1) fseek(f, 1, SEEK_CUR);
    } else if (memcmp(head, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      return info->channels > 0 && info->bits > 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
}

inline float decode_sample(const unsigned char* p, uint16_t format,
                           uint16_t bits) {
  switch (format) {
    case 1:  // PCM
      switch (bits) {
        case 16: {
          int16_t v;
          memcpy(&v, p, 2);
          return static_cast<float>(v) / 32768.0f;
        }
        case 24: {
          int32_t v = (static_cast<int32_t>(p[0]) |
                       (static_cast<int32_t>(p[1]) << 8) |
                       (static_cast<int32_t>(static_cast<int8_t>(p[2])) << 16));
          return static_cast<float>(v) / 8388608.0f;
        }
        case 32: {
          int32_t v;
          memcpy(&v, p, 4);
          return static_cast<float>(v) / 2147483648.0f;
        }
        case 8:
          return (static_cast<float>(p[0]) - 128.0f) / 128.0f;
        default:
          return 0.0f;
      }
    case 3:  // IEEE float
      if (bits == 32) {
        float v;
        memcpy(&v, p, 4);
        return v;
      } else if (bits == 64) {
        double v;
        memcpy(&v, p, 8);
        return static_cast<float>(v);
      }
      return 0.0f;
    default:
      return 0.0f;
  }
}

}  // namespace

extern "C" {

// Decode `count` frames starting at frame `start`, mixed to MONO float32.
// Returns the number of frames written (clipped to file length), or < 0 on
// error. `out` must have room for `count` floats.
long long wav_decode_crop(const char* path, long long start, long long count,
                          float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!read_header(f, &info)) {
    fclose(f);
    return -2;
  }
  const int bytes_per_sample = info.bits / 8;
  const int frame_bytes = info.channels * bytes_per_sample;
  if (frame_bytes == 0) {
    fclose(f);
    return -3;
  }
  const long long total = info.data_bytes / frame_bytes;
  if (start < 0) start = 0;
  if (start > total) start = total;
  long long n = count;
  if (start + n > total) n = total - start;
  if (n <= 0) {
    fclose(f);
    return 0;
  }
  if (fseek(f, info.data_offset + start * frame_bytes, SEEK_SET) != 0) {
    fclose(f);
    return -4;
  }
  // stream in ~256 KiB blocks
  const long long frames_per_block = (256 * 1024) / frame_bytes + 1;
  std::vector<unsigned char> buf(frames_per_block * frame_bytes);
  const float inv_ch = 1.0f / static_cast<float>(info.channels);
  long long done = 0;
  while (done < n) {
    long long want = n - done;
    if (want > frames_per_block) want = frames_per_block;
    size_t got = fread(buf.data(), frame_bytes, want, f);
    if (got == 0) break;
    const unsigned char* p = buf.data();
    for (size_t i = 0; i < got; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < info.channels; ++c) {
        acc += decode_sample(p + c * bytes_per_sample, info.format, info.bits);
      }
      out[done + i] = acc * inv_ch;
      p += frame_bytes;
    }
    done += static_cast<long long>(got);
  }
  fclose(f);
  return done;
}

}  // extern "C"
