// Native host-side data loader: a threaded triplet prefetcher (the port's
// own copy of the JAX package's `voicesplit_tpu/native/loader.cc`).
//
// Replaces the hot host path of the reference's
// `torch.utils.data.DataLoader(num_workers=14)` (reference
// `utils/dataset.py:60-68`) with a C++ thread pool and a batch ring buffer:
// RIFF wav decode (PCM16/24/32 and float32, mono downmix), .npy embedding
// parse, fixed-length crop/zero-pad, and deterministic epoch scheduling
// that matches the Python BatchIterator contract (the shuffle permutation
// is supplied by Python, so the resume state is the same for both loaders).
//
// C ABI (used from Python through ctypes):
//   vsl_create(...)        -> handle
//   vsl_start(handle, order, n_order)   // begin prefetching one epoch slice
//   vsl_next(handle, emb*, target*, mixed*, wavlen*)  // blocking batch fetch
//   vsl_destroy(handle)
//
// Build (`voicesplit_tpu_torch/data/native_loader.py` does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -o libvsloader.so loader.cc -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal RIFF/WAVE reader -> float32 mono
// ---------------------------------------------------------------------------

bool read_wav(const std::string& path, std::vector<float>* out,
              uint32_t* rate_out = nullptr) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  auto rd_u32 = [&](uint32_t* v) { return fread(v, 4, 1, f) == 1; };
  auto rd_u16 = [&](uint16_t* v) { return fread(v, 2, 1, f) == 1; };

  char tag[4];
  uint32_t riff_size;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0 ||
      !rd_u32(&riff_size) || fread(tag, 1, 4, f) != 4 ||
      memcmp(tag, "WAVE", 4) != 0) {
    fclose(f);
    return false;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  bool got_fmt = false;
  while (fread(tag, 1, 4, f) == 4) {
    uint32_t size;
    if (!rd_u32(&size)) break;
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint32_t rate, byterate;
      uint16_t align;
      if (!rd_u16(&fmt) || !rd_u16(&channels) || !rd_u32(&rate) ||
          !rd_u32(&byterate) || !rd_u16(&align) || !rd_u16(&bits)) {
        fclose(f);
        return false;
      }
      got_fmt = true;
      if (rate_out) *rate_out = rate;
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (memcmp(tag, "data", 4) == 0) {
      if (!got_fmt || channels == 0) {
        fclose(f);
        return false;
      }
      size_t bytes_per = bits / 8;
      size_t n_frames = size / (bytes_per * channels);
      std::vector<uint8_t> raw(size);
      if (fread(raw.data(), 1, size, f) != size) {
        fclose(f);
        return false;
      }
      out->resize(n_frames);
      const float inv16 = 1.0f / 32768.0f;
      const float inv24 = 1.0f / 8388608.0f;
      const double inv32 = 1.0 / 2147483648.0;
      for (size_t i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        for (uint16_t ch = 0; ch < channels; ++ch) {
          const uint8_t* p = raw.data() + (i * channels + ch) * bytes_per;
          if (fmt == 3 && bits == 32) {  // IEEE float
            float v;
            memcpy(&v, p, 4);
            acc += v;
          } else if (bits == 16) {
            int16_t v;
            memcpy(&v, p, 2);
            acc += v * inv16;
          } else if (bits == 24) {
            int32_t v = (p[0] << 8) | (p[1] << 16) | (int32_t)((int8_t)p[2]) << 24;
            acc += (v >> 8) * inv24;
          } else if (bits == 32) {
            int32_t v;
            memcpy(&v, p, 4);
            acc += v * inv32;
          }
        }
        (*out)[i] = (float)(acc / channels);
      }
      fclose(f);
      return true;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  return false;
}

// ---------------------------------------------------------------------------
// Minimal .npy reader (float32/float64 1-D)
// ---------------------------------------------------------------------------

bool read_npy_vec(const std::string& path, std::vector<float>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    return false;
  }
  uint32_t header_len = 0;
  if (magic[6] == 1) {
    uint16_t h;
    if (fread(&h, 2, 1, f) != 1) { fclose(f); return false; }
    header_len = h;
  } else {
    if (fread(&header_len, 4, 1, f) != 1) { fclose(f); return false; }
  }
  std::string header(header_len, '\0');
  if (fread(header.data(), 1, header_len, f) != header_len) {
    fclose(f);
    return false;
  }
  bool f8 = header.find("<f8") != std::string::npos;
  bool f4 = header.find("<f4") != std::string::npos;
  if (!f4 && !f8) {
    fclose(f);
    return false;
  }
  // element count = remaining bytes / width (1-D contiguous assumed)
  long pos = ftell(f);
  fseek(f, 0, SEEK_END);
  long n_bytes = ftell(f) - pos;
  fseek(f, pos, SEEK_SET);
  size_t width = f8 ? 8 : 4;
  size_t n = n_bytes / width;
  out->resize(n);
  if (f4) {
    if (fread(out->data(), 4, n, f) != n) { fclose(f); return false; }
  } else {
    std::vector<double> tmp(n);
    if (fread(tmp.data(), 8, n, f) != n) { fclose(f); return false; }
    for (size_t i = 0; i < n; ++i) (*out)[i] = (float)tmp[i];
  }
  fclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// Loader: thread pool filling a bounded batch queue
// ---------------------------------------------------------------------------

struct Sample {
  std::string emb, target, mixed;
};

struct Batch {
  std::vector<float> emb;      // [B, emb_dim]
  std::vector<float> target;   // [B, L]
  std::vector<float> mixed;    // [B, L]
  std::vector<int32_t> wavlen; // [B]
};

struct Loader {
  std::vector<Sample> samples;
  int batch = 0, emb_dim = 0;
  int64_t wav_len = 0;
  int n_threads = 0, queue_cap = 0;
  uint32_t expected_rate = 0;  // 0 = don't check

  // Data errors are NEVER silent: load_one records them here (shapes are
  // kept valid with zero-fill so the pipeline stays consistent), and the
  // Python wrapper raises on the next batch fetch.
  std::atomic<int64_t> n_errors{0};
  std::mutex err_mu;
  std::string first_error;

  void record_error(const std::string& msg) {
    if (n_errors.fetch_add(1) == 0) {
      std::lock_guard<std::mutex> l(err_mu);
      first_error = msg;
    }
  }

  std::vector<int64_t> order;       // item schedule for the current run
  std::atomic<size_t> next_batch{0};
  size_t n_batches = 0;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::queue<Batch*> ready;  // in-order completed batches
  size_t push_next = 0;      // next batch index allowed to enter `ready`
  size_t emitted = 0;        // batches handed to Python
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  ~Loader() { shutdown(); }

  void shutdown() {
    {
      // Hold the queue mutex while setting stop: a worker that has
      // evaluated its wait predicate but not yet suspended would
      // otherwise miss the notify and sleep forever (lost wakeup).
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers) if (t.joinable()) t.join();
    workers.clear();
    std::lock_guard<std::mutex> l(mu);
    while (!ready.empty()) { delete ready.front(); ready.pop(); }
  }

  void load_one(int64_t item, float* emb_out, float* tgt_out, float* mix_out,
                int32_t* len_out) {
    const Sample& s = samples[item];
    std::vector<float> v;
    if (read_npy_vec(s.emb, &v) && (int)v.size() == emb_dim) {
      memcpy(emb_out, v.data(), emb_dim * sizeof(float));
    } else {
      memset(emb_out, 0, emb_dim * sizeof(float));
      record_error("unreadable or wrong-size .npy embedding: " + s.emb);
    }
    auto fixed = [&](const std::string& path, float* dst) -> int32_t {
      std::vector<float> w;
      uint32_t rate = 0;
      if (!read_wav(path, &w, &rate)) {
        memset(dst, 0, wav_len * sizeof(float));
        record_error("unreadable wav: " + path);
        return 0;
      }
      if (expected_rate != 0 && rate != expected_rate) {
        memset(dst, 0, wav_len * sizeof(float));
        record_error("wav sample rate " + std::to_string(rate) +
                     " != configured " + std::to_string(expected_rate) +
                     " (native loader does not resample): " + path);
        return 0;
      }
      int64_t n = std::min<int64_t>((int64_t)w.size(), wav_len);
      memcpy(dst, w.data(), n * sizeof(float));
      if (n < wav_len) memset(dst + n, 0, (wav_len - n) * sizeof(float));
      return (int32_t)n;
    };
    fixed(s.target, tgt_out);
    *len_out = fixed(s.mixed, mix_out);
  }

  void worker() {
    while (!stop) {
      size_t b = next_batch.fetch_add(1);
      if (b >= n_batches) return;
      Batch* out = new Batch;
      out->emb.resize((size_t)batch * emb_dim);
      out->target.resize((size_t)batch * wav_len);
      out->mixed.resize((size_t)batch * wav_len);
      out->wavlen.resize(batch);
      for (int i = 0; i < batch; ++i) {
        int64_t item = order[b * batch + i];
        load_one(item, out->emb.data() + (size_t)i * emb_dim,
                 out->target.data() + (size_t)i * wav_len,
                 out->mixed.data() + (size_t)i * wav_len, &out->wavlen[i]);
      }
      // in-order, bounded handoff: wait for this batch's turn + free space
      std::unique_lock<std::mutex> l(mu);
      cv_push.wait(l, [&] {
        return stop || (b == push_next && (int)ready.size() < queue_cap);
      });
      if (stop) { delete out; return; }
      ready.push(out);
      ++push_next;
      cv_pop.notify_all();
      cv_push.notify_all();
    }
  }

  bool next(float* emb_out, float* tgt_out, float* mix_out, int32_t* len_out) {
    std::unique_lock<std::mutex> l(mu);
    cv_pop.wait(l, [&] {
      return stop || !ready.empty() || emitted >= n_batches;
    });
    if (ready.empty()) return false;
    Batch* b = ready.front();
    ready.pop();
    ++emitted;
    cv_push.notify_all();
    l.unlock();
    memcpy(emb_out, b->emb.data(), b->emb.size() * sizeof(float));
    memcpy(tgt_out, b->target.data(), b->target.size() * sizeof(float));
    memcpy(mix_out, b->mixed.data(), b->mixed.size() * sizeof(float));
    memcpy(len_out, b->wavlen.data(), b->wavlen.size() * sizeof(int32_t));
    delete b;
    return true;
  }
};

}  // namespace

extern "C" {

void* vsl_create(const char** emb_paths, const char** target_paths,
                 const char** mixed_paths, int64_t n_samples, int batch,
                 int emb_dim, int64_t wav_len, int n_threads, int queue_cap,
                 int expected_rate) {
  auto* L = new Loader;
  L->samples.resize(n_samples);
  for (int64_t i = 0; i < n_samples; ++i) {
    L->samples[i] = {emb_paths[i], target_paths[i], mixed_paths[i]};
  }
  L->batch = batch;
  L->emb_dim = emb_dim;
  L->wav_len = wav_len;
  L->n_threads = n_threads > 0 ? n_threads : 4;
  L->queue_cap = queue_cap > 0 ? queue_cap : 8;
  L->expected_rate = expected_rate > 0 ? (uint32_t)expected_rate : 0;
  return L;
}

int64_t vsl_error_count(void* handle) {
  return ((Loader*)handle)->n_errors.load();
}

void vsl_last_error(void* handle, char* buf, int cap) {
  auto* L = (Loader*)handle;
  std::lock_guard<std::mutex> l(L->err_mu);
  snprintf(buf, cap, "%s", L->first_error.c_str());
}

// Begin prefetching `n_order` scheduled item indices (must be a multiple of
// batch). Any previous run is torn down first.
void vsl_start(void* handle, const int64_t* order, int64_t n_order) {
  auto* L = (Loader*)handle;
  L->shutdown();
  L->stop = false;
  L->order.assign(order, order + n_order);
  L->n_batches = n_order / L->batch;
  L->next_batch = 0;
  L->push_next = 0;
  L->emitted = 0;
  for (int i = 0; i < L->n_threads; ++i)
    L->workers.emplace_back(&Loader::worker, L);
}

int vsl_next(void* handle, float* emb, float* target, float* mixed,
             int32_t* wavlen) {
  return ((Loader*)handle)->next(emb, target, mixed, wavlen) ? 1 : 0;
}

void vsl_destroy(void* handle) { delete (Loader*)handle; }

int vsl_read_wav(const char* path, float* out, int64_t cap, int64_t* n_out,
                 int64_t* rate_out) {
  std::vector<float> w;
  uint32_t rate = 0;
  if (!read_wav(path, &w, &rate)) return 0;
  int64_t n = std::min<int64_t>((int64_t)w.size(), cap);
  memcpy(out, w.data(), n * sizeof(float));
  *n_out = (int64_t)w.size();
  if (rate_out) *rate_out = (int64_t)rate;
  return 1;
}

}  // extern "C"
