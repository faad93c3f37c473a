// Native training-data loader: threaded npy patch sampler; the PyTorch
// port's own copy of m2trans_tpu/runtime/loader.cc, with the same sampling,
// so the two packages train on the same batches for one cache, seed and
// epoch.
//
// The replacement for the reference's torch DataLoader worker pool
// (reference datas/utils.py:22: num_workers=8 python processes doing
// np.load + crop + flip per sample). This library mmaps the .npy cache
// once, and a worker thread pool fills host batch buffers with randomly
// cropped/flipped/rotated LR/HR patch pairs, normalized to float32 [0,1]
// NHWC — the exact sample semantics of datas/us1k.py:16-36 (aligned random
// crop, p=0.5 hflip/vflip/rot90, /255).
//
// Exposed as a plain C ABI for ctypes (no PyTorch headers, no pybind11).
// Batches are produced in order (batch b is deterministic given the epoch
// seed) so runs are reproducible regardless of worker scheduling.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct NpyArray {
  const uint8_t* data = nullptr;  // mmapped payload (after header)
  void* map_base = nullptr;
  size_t map_len = 0;
  int64_t h = 0, w = 0, c = 0;
  bool ok = false;
};

// Minimal .npy v1/v2 parser for C-order uint8 HWC arrays.
NpyArray map_npy(const std::string& path) {
  NpyArray a;
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return a;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return a; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return a;
  const uint8_t* p = static_cast<const uint8_t*>(base);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    munmap(base, st.st_size); return a;
  }
  uint8_t major = p[6];
  size_t hlen, hoff;
  if (major == 1) { hlen = p[8] | (p[9] << 8); hoff = 10; }
  else { hlen = p[8] | (p[9] << 8) | (p[10] << 16) | (p[11] << 24); hoff = 12; }
  if (hoff + hlen > (size_t)st.st_size) { munmap(base, st.st_size); return a; }
  std::string header(reinterpret_cast<const char*>(p + hoff), hlen);
  if (header.find("'descr': '|u1'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    munmap(base, st.st_size); return a;  // only uint8 C-order supported
  }
  size_t sp = header.find("'shape': (");
  if (sp == std::string::npos) { munmap(base, st.st_size); return a; }
  long dims[3] = {0, 0, 1};
  int nd = 0;
  const char* s = header.c_str() + sp + 10;
  while (nd < 3) {
    char* end;
    long v = strtol(s, &end, 10);
    if (end == s) break;
    dims[nd++] = v;
    s = end;
    while (*s == ',' || *s == ' ') ++s;
    if (*s == ')') break;
  }
  if (nd < 2) { munmap(base, st.st_size); return a; }
  // the payload must lie inside the file: a cache caught mid-write (or cut
  // short) would otherwise be read past the end of the mapping
  const uint64_t payload = (uint64_t)dims[0] * (uint64_t)dims[1] *
                           (uint64_t)(nd == 3 ? dims[2] : 1);
  if (dims[0] <= 0 || dims[1] <= 0 || (nd == 3 && dims[2] <= 0) ||
      hoff + hlen + payload > (uint64_t)st.st_size) {
    munmap(base, st.st_size); return a;
  }
  a.map_base = base;
  a.map_len = st.st_size;
  a.data = p + hoff + hlen;
  a.h = dims[0]; a.w = dims[1]; a.c = (nd == 3 ? dims[2] : 1);
  a.ok = true;
  return a;
}

struct Loader {
  std::vector<NpyArray> hr, lr;
  int patch = 0, scale = 0, batch = 0, workers = 0;
  uint64_t seed = 0;

  // epoch state
  std::vector<int32_t> order;   // image index per sample slot
  int steps = 0;
  uint64_t epoch_seed = 0;

  // batch handoff: produced buffers keyed by batch index
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int> next_batch{0};
  std::atomic<int> consumed{0};  // next batch index the consumer needs
  std::map<int, std::pair<std::vector<float>, std::vector<float>>> ready;
  size_t max_ready = 8;
  std::vector<std::thread> threads;
  std::atomic<bool> stop{false};

  ~Loader() {
    stop.store(true);
    cv.notify_all();
    for (auto& t : threads) if (t.joinable()) t.join();
    for (auto& v : {&hr, &lr})
      for (auto& arr : *v)
        if (arr.map_base) munmap(arr.map_base, arr.map_len);
  }

  void sample(int img_idx, uint64_t sample_seed, float* lr_out,
              float* hr_out) const {
    const NpyArray& L = lr[img_idx];
    const NpyArray& H = hr[img_idx];
    const int lp = patch / scale;
    std::mt19937_64 rng(sample_seed);
    auto uni = [&](long n) { return (long)(rng() % (uint64_t)n); };
    const long lx = uni(L.w - lp + 1);
    const long ly = uni(L.h - lp + 1);
    const bool hflip = (rng() & 1) != 0;
    const bool vflip = (rng() & 1) != 0;
    const bool rot = (rng() & 1) != 0;

    auto emit = [&](const NpyArray& A, long oy, long ox, int size,
                    float* out) {
      const long c = A.c;
      for (int y = 0; y < size; ++y) {
        long sy = vflip ? (oy + size - 1 - y) : (oy + y);
        const uint8_t* row = A.data + (sy * A.w) * c;
        for (int x = 0; x < size; ++x) {
          long sx = hflip ? (ox + size - 1 - x) : (ox + x);
          const uint8_t* px = row + sx * c;
          float* dst = rot ? (out + (x * (long)size + y) * c)
                           : (out + (y * (long)size + x) * c);
          for (long ch = 0; ch < c; ++ch)
            dst[ch] = px[ch] * (1.0f / 255.0f);
        }
      }
    };
    emit(L, ly, lx, lp, lr_out);
    emit(H, ly * scale, lx * scale, patch, hr_out);
  }

  void worker() {
    const int lp = patch / scale;
    const long lr_n = (long)batch * lp * lp * lr[0].c;
    const long hr_n = (long)batch * patch * patch * hr[0].c;
    while (!stop.load()) {
      int b = next_batch.fetch_add(1);
      if (b >= steps) return;
      std::vector<float> lbuf(lr_n), hbuf(hr_n);
      for (int i = 0; i < batch; ++i) {
        int slot = b * batch + i;
        int img = order[slot];
        uint64_t s = epoch_seed * 1000003ull + (uint64_t)slot;
        sample(img, s, lbuf.data() + (long)i * lp * lp * lr[0].c,
               hbuf.data() + (long)i * patch * patch * hr[0].c);
      }
      std::unique_lock<std::mutex> lk(mu);
      // WINDOW-based backpressure, keyed on the consumer's position: a
      // size-based predicate (ready.size() < max) can deadlock — the map
      // can fill with batches AHEAD of the in-order batch the consumer is
      // waiting for, blocking the very producer that holds it.
      cv.wait(lk, [&] {
        return b < consumed.load() + (int)max_ready || stop.load();
      });
      if (stop.load()) return;
      ready.emplace(b, std::make_pair(std::move(lbuf), std::move(hbuf)));
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** hr_paths, const char** lr_paths,
                    int n_images, int patch, int scale, int batch,
                    int workers, uint64_t seed) {
  if (patch <= 0 || scale <= 0 || batch <= 0 || patch % scale != 0)
    return nullptr;
  auto* L = new Loader();
  L->patch = patch;
  L->scale = scale;
  L->batch = batch;
  L->workers = workers > 0 ? workers : 1;
  L->seed = seed;
  const long lp = patch / scale;
  for (int i = 0; i < n_images; ++i) {
    NpyArray h = map_npy(hr_paths[i]);
    NpyArray l = map_npy(lr_paths[i]);
    L->hr.push_back(h);  // push before validating: ~Loader unmaps them
    L->lr.push_back(l);
    // Validate up front so sample() can never index out of bounds:
    // the crop math (`rng() % (w - lp + 1)`) wraps a negative operand to a
    // huge modulus if an image is smaller than the patch, and the batch
    // buffers are sized with index-0 channel counts, so every image must
    // (a) fit the LR patch, (b) cover the scaled HR crop window, and
    // (c) agree on channel count across arrays and between HR and LR.
    if (!h.ok || !l.ok) { delete L; return nullptr; }
    if (l.w < lp || l.h < lp) { delete L; return nullptr; }
    if (h.w < l.w * scale || h.h < l.h * scale) { delete L; return nullptr; }
    if (h.c != l.c || h.c != L->hr[0].c || l.c != L->lr[0].c) {
      delete L; return nullptr;
    }
  }
  if (L->hr.empty()) { delete L; return nullptr; }
  return L;
}

// Begin an epoch: samples = n_images * repeat shuffled, steps full batches.
int loader_start_epoch(void* handle, int epoch, int repeat) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv.notify_all();
  for (auto& t : L->threads) if (t.joinable()) t.join();
  L->threads.clear();
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->ready.clear();
  }
  L->stop.store(false);

  const int n = (int)L->hr.size() * repeat;
  L->order.resize(n);
  for (int i = 0; i < n; ++i) L->order[i] = i % (int)L->hr.size();
  L->epoch_seed = L->seed * 2654435761ull + (uint64_t)epoch;
  std::mt19937_64 rng(L->epoch_seed);
  for (int i = n - 1; i > 0; --i) {
    int j = (int)(rng() % (uint64_t)(i + 1));
    std::swap(L->order[i], L->order[j]);
  }
  L->steps = n / L->batch;
  L->next_batch.store(0);
  L->consumed.store(0);
  for (int w = 0; w < L->workers; ++w)
    L->threads.emplace_back(&Loader::worker, L);
  return L->steps;
}

// Blocking fetch of batch b (in order). Returns 0 on success, -1 if the
// loader was stopped, -2 on timeout (5 min without the batch appearing —
// surfaces worker failures instead of hanging the training loop).
int loader_next(void* handle, int b, float* lr_out, float* hr_out) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  bool ok = L->cv.wait_for(lk, std::chrono::minutes(5), [&] {
    return L->ready.count(b) || L->stop.load();
  });
  if (!ok) return -2;
  auto it = L->ready.find(b);
  if (it == L->ready.end()) return -1;
  auto buf = std::move(it->second);
  L->ready.erase(it);
  L->consumed.store(b + 1);
  L->cv.notify_all();
  lk.unlock();
  memcpy(lr_out, buf.first.data(), buf.first.size() * sizeof(float));
  memcpy(hr_out, buf.second.data(), buf.second.size() * sizeof(float));
  return 0;
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int loader_channels(void* handle) {
  return (int)static_cast<Loader*>(handle)->hr[0].c;
}

}  // extern "C"
