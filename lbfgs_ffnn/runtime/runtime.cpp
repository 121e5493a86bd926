// Native runtime for lbfgs_ffnn: IDX dataset parsing, one-hot encoding,
// CSV history writing, and a threaded prefetching batch streamer, exposed
// through a plain C ABI consumed via ctypes.
//
// This is the framework's counterpart of the reference's native data
// loader (reference: tests/mnist/mnist_loader.hpp — big-endian IDX parse,
// /255 normalization, one-hot labels) and CSV history writers (reference:
// src/unified_optimization.hpp:66-85). Host-side work stays native C++;
// device compute is XLA.
//
// All functions return 0 on success, negative error codes otherwise.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

// Big-endian 32-bit read (IDX files are big-endian).
inline uint32_t read_be32(const unsigned char *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct File {
  std::FILE *f = nullptr;
  explicit File(const char *path) : f(std::fopen(path, "rb")) {}
  ~File() {
    if (f) std::fclose(f);
  }
};

constexpr int kErrOpen = -1;
constexpr int kErrMagic = -2;
constexpr int kErrRead = -3;
constexpr int kErrArgs = -4;

}  // namespace

extern "C" {

// Query an IDX file: item count and per-item element count.
// dtype byte must be 0x08 (unsigned byte) — the MNIST family.
int idx_query(const char *path, int64_t *n_items, int64_t *item_elems) {
  File file(path);
  if (!file.f) return kErrOpen;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, file.f) != 4) return kErrRead;
  if (hdr[0] != 0 || hdr[1] != 0 || hdr[2] != 0x08) return kErrMagic;
  const int ndim = hdr[3];
  if (ndim < 1 || ndim > 4) return kErrMagic;
  int64_t dims[4] = {0, 0, 0, 0};
  for (int i = 0; i < ndim; ++i) {
    unsigned char d[4];
    if (std::fread(d, 1, 4, file.f) != 4) return kErrRead;
    dims[i] = read_be32(d);
  }
  *n_items = dims[0];
  int64_t elems = 1;
  for (int i = 1; i < ndim; ++i) elems *= dims[i];
  *item_elems = elems;
  return 0;
}

// Load up to max_items images as float32 scaled by 1/255, row-major
// (n, item_elems). `out` must hold max_items*item_elems floats.
int idx_load_images_f32(const char *path, int64_t max_items, float *out,
                        int64_t *n_loaded) {
  int64_t n_items = 0, elems = 0;
  int rc = idx_query(path, &n_items, &elems);
  if (rc != 0) return rc;
  File file(path);
  if (!file.f) return kErrOpen;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, file.f) != 4) return kErrRead;
  const int ndim = hdr[3];
  if (std::fseek(file.f, 4 + 4 * ndim, SEEK_SET) != 0) return kErrRead;

  const int64_t n = max_items > 0 && max_items < n_items ? max_items : n_items;
  std::vector<unsigned char> buf(static_cast<size_t>(elems));
  constexpr float kInv255 = 1.0f / 255.0f;
  for (int64_t i = 0; i < n; ++i) {
    if (std::fread(buf.data(), 1, buf.size(), file.f) != buf.size())
      return kErrRead;
    float *row = out + i * elems;
    for (int64_t j = 0; j < elems; ++j) row[j] = buf[j] * kInv255;
  }
  *n_loaded = n;
  return 0;
}

// Load up to max_items labels one-hot encoded into (n, num_classes) float32.
int idx_load_labels_onehot_f32(const char *path, int64_t max_items,
                               int num_classes, float *out,
                               int64_t *n_loaded) {
  if (num_classes <= 0) return kErrArgs;
  int64_t n_items = 0, elems = 0;
  int rc = idx_query(path, &n_items, &elems);
  if (rc != 0) return rc;
  if (elems != 1) return kErrMagic;
  File file(path);
  if (!file.f) return kErrOpen;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, file.f) != 4) return kErrRead;
  const int ndim = hdr[3];
  if (std::fseek(file.f, 4 + 4 * ndim, SEEK_SET) != 0) return kErrRead;

  const int64_t n = max_items > 0 && max_items < n_items ? max_items : n_items;
  std::vector<unsigned char> labels(static_cast<size_t>(n));
  if (std::fread(labels.data(), 1, labels.size(), file.f) != labels.size())
    return kErrRead;
  std::memset(out, 0, sizeof(float) * n * num_classes);
  for (int64_t i = 0; i < n; ++i) {
    const int c = labels[i];
    if (c < num_classes) out[i * num_classes + c] = 1.0f;
  }
  *n_loaded = n;
  return 0;
}

// Load raw uint8 labels (n,).
int idx_load_labels_u8(const char *path, int64_t max_items, uint8_t *out,
                       int64_t *n_loaded) {
  int64_t n_items = 0, elems = 0;
  int rc = idx_query(path, &n_items, &elems);
  if (rc != 0) return rc;
  if (elems != 1) return kErrMagic;
  File file(path);
  if (!file.f) return kErrOpen;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, file.f) != 4) return kErrRead;
  const int ndim = hdr[3];
  if (std::fseek(file.f, 4 + 4 * ndim, SEEK_SET) != 0) return kErrRead;
  const int64_t n = max_items > 0 && max_items < n_items ? max_items : n_items;
  if (std::fread(out, 1, static_cast<size_t>(n), file.f) !=
      static_cast<size_t>(n))
    return kErrRead;
  *n_loaded = n;
  return 0;
}

// Write an IDX file of unsigned bytes with the given dims (ndim <= 4).
int idx_write_u8(const char *path, const uint8_t *data, const int64_t *dims,
                 int ndim) {
  if (ndim < 1 || ndim > 4) return kErrArgs;
  std::FILE *f = std::fopen(path, "wb");
  if (!f) return kErrOpen;
  unsigned char hdr[4] = {0, 0, 0x08, static_cast<unsigned char>(ndim)};
  std::fwrite(hdr, 1, 4, f);
  int64_t total = 1;
  for (int i = 0; i < ndim; ++i) {
    uint32_t d = static_cast<uint32_t>(dims[i]);
    unsigned char b[4] = {static_cast<unsigned char>(d >> 24),
                          static_cast<unsigned char>(d >> 16),
                          static_cast<unsigned char>(d >> 8),
                          static_cast<unsigned char>(d)};
    std::fwrite(b, 1, 4, f);
    total *= dims[i];
  }
  size_t written = std::fwrite(data, 1, static_cast<size_t>(total), f);
  std::fclose(f);
  return written == static_cast<size_t>(total) ? 0 : kErrRead;
}

// Write a training-history CSV with the reference's exact format:
// header "Iteration,Loss,GradNorm,TimeMs", rows strided by log_interval
// (reference: src/unified_optimization.hpp:66-85).
int csv_write_history(const char *path, const double *loss,
                      const double *gnorm, const double *time_ms, int64_t n,
                      int log_interval) {
  if (log_interval <= 0) return kErrArgs;
  std::FILE *f = std::fopen(path, "w");
  if (!f) return kErrOpen;
  std::fputs("Iteration,Loss,GradNorm,TimeMs\n", f);
  for (int64_t i = 0; i < n; i += log_interval) {
    std::fprintf(f, "%lld,%.17g,%.17g,%.17g\n", static_cast<long long>(i),
                 loss[i], gnorm ? gnorm[i] : 0.0, time_ms ? time_ms[i] : 0.0);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded prefetching batch streamer.
//
// A producer thread runs ahead of the consumer: per epoch it draws a seeded
// Fisher-Yates permutation of the sample indices (the reference's SGD
// sampling primitive, src/minimizer/s_gd.hpp:146-170, lifted from per-step
// partial shuffles to epoch granularity for streaming), gathers (x, y)
// minibatches into a bounded ring of host staging buffers, and blocks when
// the ring is full. The consumer pops batches ready for device upload — the
// gather/shuffle cost overlaps the previous step's device work. Epochs
// stream back-to-back with a fresh permutation (seed folded with the epoch
// index), so the consumer decides when to stop.
// ---------------------------------------------------------------------------

namespace {

struct Streamer {
  const float *x = nullptr;  // (n, xdim) row-major, caller-owned
  const float *y = nullptr;  // (n, ydim)
  int64_t n = 0, xdim = 0, ydim = 0, batch = 0;
  uint64_t seed = 0;
  bool drop_last = false;

  struct Slot {
    std::vector<float> xb, yb;
    int64_t count = 0;    // samples in this batch (< batch for a trailing one)
    int64_t epoch = 0;    // epoch the batch came from
    bool busy = false;    // a consumer is mid-copy on this slot (set/cleared
                          // under mu); the producer must not reuse it even
                          // after `filled` drops (out-of-order releases)
  };
  std::vector<Slot> ring;
  // producer writes head, consumers read tail. `filled` gates the producer
  // (slots occupied, including ones a consumer is mid-copy on); `ready`
  // gates consumers (slots available to claim). The split makes pops
  // multi-consumer safe: a consumer claims a slot (advance tail, --ready)
  // under the mutex, copies it unlocked, and only then releases it to the
  // producer (--filled), so two concurrent streamer_next calls can never
  // claim the same slot and the producer can never overwrite an in-copy one.
  size_t head = 0, tail = 0, filled = 0, ready = 0;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  bool stop = false;
  std::atomic<int> readers{0};  // consumers currently inside streamer_next
  std::thread worker;

  ~Streamer() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_produce.notify_all();
    cv_consume.notify_all();
    if (worker.joinable()) worker.join();
  }

  void run() {
    std::vector<int64_t> perm(static_cast<size_t>(n));
    for (int64_t e = 0;; ++e) {
      // Seeded per-epoch Fisher-Yates (seed folded with the epoch index so
      // every epoch's order is independent yet reproducible).
      for (int64_t i = 0; i < n; ++i) perm[i] = i;
      std::mt19937_64 rng(seed ^ (0x9e3779b97f4a7c15ULL * (e + 1)));
      for (int64_t i = n - 1; i > 0; --i) {
        std::uniform_int_distribution<int64_t> d(0, i);
        std::swap(perm[i], perm[d(rng)]);
      }
      for (int64_t off = 0; off < n; off += batch) {
        const int64_t count = std::min(batch, n - off);
        if (count < batch && drop_last) break;
        std::unique_lock<std::mutex> lk(mu);
        // Wait for a free head slot. `filled < size` alone is not enough:
        // with concurrent consumers releasing out of order, `filled` can
        // drop while the OLDEST claimed slot (== head when the ring was
        // full) is still being copied — `busy` pins it until the copy ends.
        cv_produce.wait(lk, [&] {
          return stop || (filled < ring.size() && !ring[head].busy);
        });
        if (stop) return;
        Slot &s = ring[head];
        lk.unlock();
        // Gather outside the lock: the slot is owned by the producer until
        // `filled` is bumped below.
        for (int64_t i = 0; i < count; ++i) {
          const int64_t src = perm[off + i];
          std::memcpy(s.xb.data() + i * xdim, x + src * xdim,
                      sizeof(float) * xdim);
          std::memcpy(s.yb.data() + i * ydim, y + src * ydim,
                      sizeof(float) * ydim);
        }
        s.count = count;
        s.epoch = e;
        lk.lock();
        head = (head + 1) % ring.size();
        ++filled;
        ++ready;
        lk.unlock();
        cv_consume.notify_one();
      }
    }
  }
};

std::mutex g_streamers_mu;
std::map<int64_t, std::unique_ptr<Streamer>> g_streamers;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

// Create a streamer over caller-owned row-major float32 arrays. `depth` is
// the prefetch ring size (>=1). Returns a positive handle, or a negative
// error code.
int64_t streamer_create(const float *x, const float *y, int64_t n,
                        int64_t xdim, int64_t ydim, int64_t batch,
                        uint64_t seed, int depth, int drop_last) {
  if (!x || !y || n <= 0 || xdim <= 0 || ydim <= 0 || batch <= 0 || depth < 1)
    return kErrArgs;
  auto s = std::make_unique<Streamer>();
  s->x = x;
  s->y = y;
  s->n = n;
  s->xdim = xdim;
  s->ydim = ydim;
  s->batch = batch < n ? batch : n;
  s->seed = seed;
  s->drop_last = drop_last != 0;
  s->ring.resize(static_cast<size_t>(depth));
  for (auto &slot : s->ring) {
    slot.xb.resize(static_cast<size_t>(s->batch * xdim));
    slot.yb.resize(static_cast<size_t>(s->batch * ydim));
  }
  Streamer *raw = s.get();
  raw->worker = std::thread([raw] { raw->run(); });
  std::lock_guard<std::mutex> lk(g_streamers_mu);
  const int64_t h = g_next_handle++;
  g_streamers[h] = std::move(s);
  return h;
}

// Blocking pop of the next prefetched batch into caller buffers sized
// (batch, xdim) / (batch, ydim). Writes the actual sample count (< batch
// only for a trailing partial batch) and the source epoch index. Rows past
// `count` are zero-filled by the Python wrapper.
int streamer_next(int64_t handle, float *xout, float *yout, int64_t *count,
                  int64_t *epoch) {
  Streamer *s;
  {
    // Register as an in-flight reader UNDER the registry lock, so
    // streamer_destroy (which waits for readers to drain before freeing)
    // cannot destruct the mutex/CV this call is about to block on.
    std::lock_guard<std::mutex> lk(g_streamers_mu);
    auto it = g_streamers.find(handle);
    if (it == g_streamers.end()) return kErrArgs;
    s = it->second.get();
    s->readers.fetch_add(1);
  }
  struct ReaderGuard {
    Streamer *s;
    ~ReaderGuard() { s->readers.fetch_sub(1); }
  } guard{s};
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_consume.wait(lk, [&] { return s->stop || s->ready > 0; });
  if (s->stop) return kErrArgs;
  // Claim the slot under the mutex (advance tail, --ready, mark busy)
  // BEFORE the unlocked copy: a concurrent streamer_next claims the next
  // slot, never this one, and the producer skips busy slots even after
  // out-of-order releases drop `filled` below capacity.
  Streamer::Slot &slot = s->ring[s->tail];
  slot.busy = true;
  s->tail = (s->tail + 1) % s->ring.size();
  --s->ready;
  lk.unlock();
  std::memcpy(xout, slot.xb.data(), sizeof(float) * slot.count * s->xdim);
  std::memcpy(yout, slot.yb.data(), sizeof(float) * slot.count * s->ydim);
  *count = slot.count;
  *epoch = slot.epoch;
  lk.lock();
  slot.busy = false;
  --s->filled;
  lk.unlock();
  s->cv_produce.notify_one();
  return 0;
}

int streamer_destroy(int64_t handle) {
  std::unique_ptr<Streamer> owned;
  {
    std::lock_guard<std::mutex> lk(g_streamers_mu);
    auto it = g_streamers.find(handle);
    if (it == g_streamers.end()) return kErrArgs;
    owned = std::move(it->second);
    g_streamers.erase(it);
  }
  // Wake any consumer blocked in streamer_next and wait for in-flight
  // readers to drain before ~Streamer destroys the mutex/CV under them.
  {
    std::lock_guard<std::mutex> lk(owned->mu);
    owned->stop = true;
  }
  owned->cv_consume.notify_all();
  owned->cv_produce.notify_all();
  while (owned->readers.load() != 0) {
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
    owned->cv_consume.notify_all();
  }
  return 0;  // owned destructs here: joins the worker, frees the ring
}

}  // extern "C"
