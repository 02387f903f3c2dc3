// Native training-batch sampler: random HR crops + flips + box-downsampled
// LR pairs, multi-threaded over the batch.
//
// resselt_tpu_torch/data.py builds this file with g++ at first use and
// drives it from a Python prefetch thread through ctypes, so that the
// host's sampling overlaps the GPU's train step.  A numpy sampler with the
// same contract (LR == box mean of the HR crop, HR values == source bytes /
// 255) lives beside it in data.py.  This is the JAX package's sampler
// (resselt_tpu/native/sampler.cpp), line for line: the same seed gives the
// same batches in both packages.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libsampler.so sampler.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Image {
  const uint8_t* data;  // HWC uint8, C=3
  int h, w;
};

struct Sampler {
  std::vector<Image> images;
  int crop;    // HR crop size (multiple of scale)
  int scale;   // LR = crop/scale
  uint64_t state;
};

inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

void fill_one(const Sampler* s, uint64_t seed, float* hr, float* lr) {
  uint64_t st = seed;
  const Image& im = s->images[splitmix64(st) % s->images.size()];
  const int crop = s->crop;
  const int y0 = static_cast<int>(splitmix64(st) % static_cast<uint64_t>(im.h - crop + 1));
  const int x0 = static_cast<int>(splitmix64(st) % static_cast<uint64_t>(im.w - crop + 1));
  const bool flip_x = (splitmix64(st) & 1) != 0;
  const bool flip_y = (splitmix64(st) & 1) != 0;

  // HR crop with flips, uint8 -> f32/255
  for (int y = 0; y < crop; ++y) {
    const int sy = y0 + (flip_y ? crop - 1 - y : y);
    const uint8_t* row = im.data + (static_cast<int64_t>(sy) * im.w + x0) * 3;
    float* out = hr + static_cast<int64_t>(y) * crop * 3;
    if (!flip_x) {
      for (int x = 0; x < crop * 3; ++x) out[x] = row[x] * (1.0f / 255.0f);
    } else {
      for (int x = 0; x < crop; ++x) {
        const uint8_t* px = row + (crop - 1 - x) * 3;
        out[x * 3 + 0] = px[0] * (1.0f / 255.0f);
        out[x * 3 + 1] = px[1] * (1.0f / 255.0f);
        out[x * 3 + 2] = px[2] * (1.0f / 255.0f);
      }
    }
  }

  // LR = exact box mean over scale x scale blocks of the (flipped) HR crop
  const int sc = s->scale;
  const int lsz = crop / sc;
  const float inv = 1.0f / static_cast<float>(sc * sc);
  for (int y = 0; y < lsz; ++y) {
    for (int x = 0; x < lsz; ++x) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int dy = 0; dy < sc; ++dy) {
        const float* row = hr + ((static_cast<int64_t>(y) * sc + dy) * crop + x * sc) * 3;
        for (int dx = 0; dx < sc; ++dx) {
          acc[0] += row[dx * 3 + 0];
          acc[1] += row[dx * 3 + 1];
          acc[2] += row[dx * 3 + 2];
        }
      }
      float* out = lr + (static_cast<int64_t>(y) * lsz + x) * 3;
      out[0] = acc[0] * inv;
      out[1] = acc[1] * inv;
      out[2] = acc[2] * inv;
    }
  }
}

}  // namespace

extern "C" {

Sampler* sampler_create(const uint8_t** datas, const int* hs, const int* ws, int n_images,
                        int crop, int scale, uint64_t seed) {
  if (n_images <= 0 || crop <= 0 || scale <= 0 || crop % scale != 0) return nullptr;
  auto* s = new Sampler();
  s->images.reserve(n_images);
  for (int i = 0; i < n_images; ++i) {
    if (hs[i] < crop || ws[i] < crop) continue;
    s->images.push_back(Image{datas[i], hs[i], ws[i]});
  }
  if (s->images.empty()) {
    delete s;
    return nullptr;
  }
  s->crop = crop;
  s->scale = scale;
  s->state = seed;
  return s;
}

void sampler_next(Sampler* s, int batch, float* hr_out, float* lr_out, int n_threads) {
  const int crop = s->crop;
  const int lsz = crop / s->scale;
  // draw per-item seeds up front so results are thread-count independent
  std::vector<uint64_t> seeds(batch);
  for (int i = 0; i < batch; ++i) seeds[i] = splitmix64(s->state);

  auto work = [&](int begin, int end) {
    for (int i = begin; i < end; ++i) {
      fill_one(s, seeds[i],
               hr_out + static_cast<int64_t>(i) * crop * crop * 3,
               lr_out + static_cast<int64_t>(i) * lsz * lsz * 3);
    }
  };
  if (n_threads <= 1 || batch <= 1) {
    work(0, batch);
    return;
  }
  const int nt = n_threads < batch ? n_threads : batch;
  std::vector<std::thread> threads;
  const int per = (batch + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int b = t * per;
    const int e = b + per < batch ? b + per : batch;
    if (b < e) threads.emplace_back(work, b, e);
  }
  for (auto& th : threads) th.join();
}

void sampler_destroy(Sampler* s) { delete s; }

}  // extern "C"
