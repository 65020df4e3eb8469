// The WAV reader of the data pipeline: decode, channel average,
// windowed-sinc resampling and peak normalization of PCM and float WAV
// files, behind a C ABI that ``data/native.py`` loads with ctypes.
//
// This is host code, compiled with g++ at first use into
// ``build/native/`` (``data/native.py``); it is not a CUDA kernel. Its
// arithmetic is the JAX package's reader's, operation for operation, so
// both packages' ``AudioReader`` give the same bits: a channel mean as
// ``acc * (1 / channels)``, a Hann-windowed sinc of 16 taps a side, a
// peak normalization as ``x * (1 / peak)``.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libwav_reader.so wav_reader.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t size;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return false;
  if (fread(&size, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return false;
  while (fread(id, 1, 4, f) == 4 && fread(&size, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      uint16_t fmt, ch;
      uint32_t rate, byte_rate;
      uint16_t block, bits;
      if (size < 16) return false;
      fread(&fmt, 2, 1, f);
      fread(&ch, 2, 1, f);
      fread(&rate, 4, 1, f);
      fread(&byte_rate, 4, 1, f);
      fread(&block, 2, 1, f);
      fread(&bits, 2, 1, f);
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = rate;
      info->bits = bits;
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      return info->channels > 0 && info->sample_rate > 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return false;
}

// decode interleaved samples to mono float (channel average)
bool decode_mono(FILE* f, const WavInfo& info, std::vector<float>* out) {
  const uint32_t bytes_per_sample = info.bits / 8;
  const uint32_t frame_bytes = bytes_per_sample * info.channels;
  if (frame_bytes == 0) return false;
  const uint32_t n_frames = info.data_bytes / frame_bytes;
  std::vector<uint8_t> raw(info.data_bytes);
  fseek(f, info.data_offset, SEEK_SET);
  if (fread(raw.data(), 1, info.data_bytes, f) != info.data_bytes)
    return false;
  out->resize(n_frames);
  const float inv_ch = 1.0f / info.channels;
  for (uint32_t i = 0; i < n_frames; ++i) {
    float acc = 0.f;
    const uint8_t* frame = raw.data() + (size_t)i * frame_bytes;
    for (uint16_t c = 0; c < info.channels; ++c) {
      const uint8_t* p = frame + (size_t)c * bytes_per_sample;
      float v = 0.f;
      if (info.format == 1 && info.bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = s / 32768.0f;
      } else if (info.format == 1 && info.bits == 24) {
        int32_t s = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
        if (s >= (1 << 23)) s -= (1 << 24);
        v = s / 8388608.0f;
      } else if (info.format == 1 && info.bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0f;
      } else if (info.format == 1 && info.bits == 8) {
        v = ((int)p[0] - 128) / 128.0f;
      } else if (info.format == 3 && info.bits == 32) {
        float s;
        memcpy(&s, p, 4);
        v = s;
      } else {
        return false;
      }
      acc += v;
    }
    (*out)[i] = acc * inv_ch;
  }
  return true;
}

// windowed-sinc resampling (Hann window, 16 taps per side)
void resample_sinc(const std::vector<float>& in, uint32_t in_rate,
                   uint32_t out_rate, std::vector<float>* out) {
  if (in_rate == out_rate) {
    *out = in;
    return;
  }
  const double ratio = (double)out_rate / in_rate;
  const size_t n_out = (size_t)(in.size() * ratio);
  out->resize(n_out);
  const int taps = 16;
  const double cutoff = ratio < 1.0 ? ratio : 1.0;
  for (size_t j = 0; j < n_out; ++j) {
    const double center = j / ratio;
    const long i0 = (long)center;
    double acc = 0.0, wsum = 0.0;
    for (long i = i0 - taps + 1; i <= i0 + taps; ++i) {
      if (i < 0 || i >= (long)in.size()) continue;
      const double x = (center - i) * cutoff;
      double sinc = (x == 0.0) ? 1.0 : sin(M_PI * x) / (M_PI * x);
      const double wpos = (center - i) / taps;
      if (wpos <= -1.0 || wpos >= 1.0) continue;
      const double window = 0.5 + 0.5 * cos(M_PI * wpos);
      const double w = sinc * window * cutoff;
      acc += in[i] * w;
      wsum += w;
    }
    (*out)[j] = (float)(wsum != 0.0 ? acc / wsum * cutoff / cutoff : 0.0);
  }
}

}  // namespace

extern "C" {

// Returns the number of output samples written (<= max_out), or
// -1 open/parse failure, -2 unsupported encoding, -3 buffer too small.
// peak_normalize != 0 scales the output to max |x| == 1.
int pbsed_load_wav(const char* path, int target_rate, int peak_normalize,
                   float* out, long max_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -1;
  }
  std::vector<float> mono;
  const bool ok = decode_mono(f, info, &mono);
  fclose(f);
  if (!ok) return -2;
  std::vector<float> resampled;
  resample_sinc(mono, info.sample_rate, (uint32_t)target_rate,
                &resampled);
  if ((long)resampled.size() > max_out) return -3;
  if (peak_normalize) {
    float peak = 0.f;
    for (float v : resampled) peak = std::max(peak, std::fabs(v));
    if (peak > 0.f) {
      const float inv = 1.0f / peak;
      for (float& v : resampled) v *= inv;
    }
  }
  memcpy(out, resampled.data(), resampled.size() * sizeof(float));
  return (int)resampled.size();
}

// Batched parallel load: decodes n files concurrently on a worker
// pool (the host-side hot path when feeding large corpora). outs[i]
// must hold max_out floats; lens[i] receives pbsed_load_wav's result
// for file i (sample count or negative error code).
void pbsed_load_wav_batch(const char** paths, int n, int target_rate,
                          int peak_normalize, int num_threads,
                          float** outs, long max_out, long* lens) {
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      lens[i] = pbsed_load_wav(paths[i], target_rate, peak_normalize,
                               outs[i], max_out);
    }
  };
  const int k = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Duration probe: returns sample count at native rate, fills *sample_rate.
long pbsed_wav_info(const char* path, int* sample_rate, int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  *sample_rate = (int)info.sample_rate;
  *channels = (int)info.channels;
  const uint32_t frame_bytes = (info.bits / 8) * info.channels;
  return frame_bytes ? (long)(info.data_bytes / frame_bytes) : -1;
}

}  // extern "C"
