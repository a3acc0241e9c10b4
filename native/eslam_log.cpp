// Binary sensor/trajectory log runtime for slam_eslam_tpu.
//
// Native-equivalent of the Rock/orogen logging infrastructure the
// reference ecosystem relies on for replaying robot traverses (the
// reference library itself is fed by orogen tasks outside the repo;
// its test harness synthesises data in-process).  This runtime provides:
//
//   * a compact, versioned, append-only binary log of typed records
//     (contact states, orientations, laser scans, ground-truth poses),
//   * an mmap-backed reader with an in-memory record index for O(1)
//     random access,
//   * an asynchronous double-buffered prefetcher (pthread worker) that
//     stages decoded frames into host buffers so the device feed path
//     never blocks on disk IO.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (slam_eslam_tpu/io/logio.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x474c5345;  // "ESLG"
constexpr uint32_t kVersion = 1;

#pragma pack(push, 1)
struct FileHeader {
  uint32_t magic;
  uint32_t version;
};

struct RecordHeader {
  uint32_t type;
  uint32_t size;       // payload bytes
  uint64_t timestamp;  // nanoseconds
};
#pragma pack(pop)

enum RecordType : uint32_t {
  kContactState = 1,
  kOrientation = 2,
  kLaserScan = 3,
  kPose = 4,
  kDistanceImage = 5,
};

struct Writer {
  FILE* f = nullptr;
};

struct Record {
  RecordHeader hdr;
  const uint8_t* payload;
};

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  std::vector<Record> index;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- writer

void* eslam_log_writer_open(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  FileHeader h{kMagic, kVersion};
  if (std::fwrite(&h, sizeof h, 1, f) != 1) {
    std::fclose(f);
    return nullptr;
  }
  auto* w = new Writer();
  w->f = f;
  return w;
}

int eslam_log_writer_append(void* handle, uint32_t type, uint64_t timestamp,
                            const void* payload, uint32_t size) {
  auto* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return -1;
  RecordHeader rh{type, size, timestamp};
  if (std::fwrite(&rh, sizeof rh, 1, w->f) != 1) return -1;
  if (size && std::fwrite(payload, 1, size, w->f) != size) return -1;
  return 0;
}

void eslam_log_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return;
  if (w->f) std::fclose(w->f);
  delete w;
}

// ---------------------------------------------------------------- reader

void* eslam_log_reader_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(FileHeader)) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const auto* data = static_cast<const uint8_t*>(map);
  const auto* fh = reinterpret_cast<const FileHeader*>(data);
  if (fh->magic != kMagic || fh->version != kVersion) {
    ::munmap(map, st.st_size);
    ::close(fd);
    return nullptr;
  }

  auto* r = new Reader();
  r->fd = fd;
  r->data = data;
  r->size = st.st_size;

  size_t off = sizeof(FileHeader);
  while (off + sizeof(RecordHeader) <= r->size) {
    const auto* rh = reinterpret_cast<const RecordHeader*>(data + off);
    size_t end = off + sizeof(RecordHeader) + rh->size;
    if (end > r->size) break;  // truncated tail: ignore
    r->index.push_back(Record{*rh, data + off + sizeof(RecordHeader)});
    off = end;
  }
  return r;
}

int64_t eslam_log_reader_count(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  return r ? static_cast<int64_t>(r->index.size()) : -1;
}

// Fills type/timestamp/size for record i; returns payload pointer (valid
// until reader close) or null.
const void* eslam_log_reader_get(void* handle, int64_t i, uint32_t* type,
                                 uint64_t* timestamp, uint32_t* size) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || i < 0 || i >= static_cast<int64_t>(r->index.size())) return nullptr;
  const Record& rec = r->index[i];
  if (type) *type = rec.hdr.type;
  if (timestamp) *timestamp = rec.hdr.timestamp;
  if (size) *size = rec.hdr.size;
  return rec.payload;
}

// --------------------------------------------------- batched access
//
// The streaming runner consumes whole trajectories as stacked arrays;
// per-record Python decode loops would dominate. These entry points do
// the per-record work natively: type filtering, index selection, and a
// strided gather of fixed-size payloads into one caller-owned buffer
// (a single numpy allocation -> a single device transfer).

int64_t eslam_log_reader_count_type(void* handle, uint32_t type) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  int64_t n = 0;
  for (const Record& rec : r->index) n += (rec.hdr.type == type);
  return n;
}

// Fills up to `cap` record indices (and timestamps when `ts` is
// non-null) of the given type; returns the number written.
int64_t eslam_log_reader_select(void* handle, uint32_t type, int64_t* out,
                                uint64_t* ts, int64_t cap) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || !out) return -1;
  int64_t n = 0;
  for (int64_t i = 0; i < static_cast<int64_t>(r->index.size()); ++i) {
    if (r->index[i].hdr.type != type) continue;
    if (n >= cap) break;
    out[n] = i;
    if (ts) ts[n] = r->index[i].hdr.timestamp;
    ++n;
  }
  return n;
}

// Gathers n payloads (record indices in `idx`) into `out`, each record
// occupying `record_bytes`; payloads shorter than `record_bytes` are
// zero-padded, longer ones truncated (callers pass the exact fixed
// payload size in the common case). Returns 0, or -1 on a bad index.
int eslam_log_reader_gather(void* handle, const int64_t* idx, int64_t n,
                            uint32_t record_bytes, uint8_t* out) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || !idx || !out) return -1;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = idx[k];
    if (i < 0 || i >= static_cast<int64_t>(r->index.size())) return -1;
    const Record& rec = r->index[i];
    const uint32_t m =
        rec.hdr.size < record_bytes ? rec.hdr.size : record_bytes;
    uint8_t* dst = out + static_cast<size_t>(k) * record_bytes;
    std::memcpy(dst, rec.payload, m);
    if (m < record_bytes) std::memset(dst + m, 0, record_bytes - m);
  }
  return 0;
}

// ------------------------------------------------------- compaction
//
// Rewrites `src` keeping only records whose type is in `types`
// (n_types == 0 keeps all) and, per type, every `stride`-th occurrence
// (stride <= 1 keeps all). Returns the number of records written, -1
// on IO/format errors.
void eslam_log_reader_close(void* handle);  // defined below

int64_t eslam_log_compact(const char* src, const char* dst,
                          const uint32_t* types, int32_t n_types,
                          int64_t stride) {
  void* rh = eslam_log_reader_open(src);
  if (!rh) return -1;
  auto* r = static_cast<Reader*>(rh);
  void* wh = eslam_log_writer_open(dst);
  if (!wh) {
    eslam_log_reader_close(rh);
    return -1;
  }
  if (stride < 1) stride = 1;
  // per-type occurrence counters (small fixed set of types)
  std::vector<std::pair<uint32_t, int64_t>> seen;
  int64_t written = 0;
  for (const Record& rec : r->index) {
    bool keep = (n_types == 0);
    for (int32_t t = 0; t < n_types; ++t) {
      if (types[t] == rec.hdr.type) {
        keep = true;
        break;
      }
    }
    if (!keep) continue;
    int64_t* cnt = nullptr;
    for (auto& kv : seen) {
      if (kv.first == rec.hdr.type) cnt = &kv.second;
    }
    if (!cnt) {
      seen.emplace_back(rec.hdr.type, 0);
      cnt = &seen.back().second;
    }
    const bool take = (*cnt % stride) == 0;
    ++*cnt;
    if (!take) continue;
    if (eslam_log_writer_append(wh, rec.hdr.type, rec.hdr.timestamp,
                                rec.payload, rec.hdr.size) != 0) {
      eslam_log_writer_close(wh);
      eslam_log_reader_close(rh);
      return -1;
    }
    ++written;
  }
  eslam_log_writer_close(wh);
  eslam_log_reader_close(rh);
  return written;
}

void eslam_log_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->data) ::munmap(const_cast<uint8_t*>(r->data), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

// ---------------------------------------------------------- async feeder
//
// A pthread worker decodes/copies upcoming records into a ring of host
// buffers ahead of the consumer.  The consumer takes stable pointers —
// each slot stays valid until the consumer advances past it.

struct Feeder {
  Reader* reader = nullptr;
  size_t slots = 0;
  size_t slot_bytes = 0;
  std::vector<std::vector<uint8_t>> buffers;
  std::vector<RecordHeader> headers;
  // ring state
  int64_t head = 0;      // next record the worker will stage
  int64_t tail = 0;      // next record the consumer will take
  int64_t released = 0;  // records whose slots may be reused
  bool stop = false;
  pthread_t worker{};
  pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
  pthread_cond_t cv_space = PTHREAD_COND_INITIALIZER;
  pthread_cond_t cv_data = PTHREAD_COND_INITIALIZER;
};

namespace {

void* feeder_main(void* arg) {
  auto* fd = static_cast<Feeder*>(arg);
  const int64_t n = static_cast<int64_t>(fd->reader->index.size());
  pthread_mutex_lock(&fd->mu);
  while (!fd->stop && fd->head < n) {
    while (!fd->stop &&
           fd->head - fd->released >= static_cast<int64_t>(fd->slots)) {
      pthread_cond_wait(&fd->cv_space, &fd->mu);
    }
    if (fd->stop || fd->head >= n) break;
    const int64_t i = fd->head;
    const Record& rec = fd->reader->index[i];
    pthread_mutex_unlock(&fd->mu);

    // copy outside the lock (the slot is not yet published)
    const size_t slot = static_cast<size_t>(i) % fd->slots;
    auto& buf = fd->buffers[slot];
    if (buf.size() < rec.hdr.size) buf.resize(rec.hdr.size);
    std::memcpy(buf.data(), rec.payload, rec.hdr.size);
    fd->headers[slot] = rec.hdr;

    pthread_mutex_lock(&fd->mu);
    fd->head = i + 1;
    pthread_cond_signal(&fd->cv_data);
  }
  pthread_mutex_unlock(&fd->mu);
  return nullptr;
}

}  // namespace

void* eslam_feeder_create(void* reader_handle, uint32_t slots) {
  auto* r = static_cast<Reader*>(reader_handle);
  if (!r || slots < 2) return nullptr;
  auto* fd = new Feeder();
  fd->reader = r;
  fd->slots = slots;
  fd->buffers.resize(slots);
  fd->headers.resize(slots);
  if (pthread_create(&fd->worker, nullptr, feeder_main, fd) != 0) {
    delete fd;
    return nullptr;
  }
  return fd;
}

// Blocks until the next record is staged; returns payload pointer, or
// null at end of log.  The pointer stays valid until the next call
// (the slot of record i is only released for reuse when i+1 is taken).
const void* eslam_feeder_next(void* handle, uint32_t* type,
                              uint64_t* timestamp, uint32_t* size) {
  auto* fd = static_cast<Feeder*>(handle);
  if (!fd) return nullptr;
  const int64_t n = static_cast<int64_t>(fd->reader->index.size());
  pthread_mutex_lock(&fd->mu);
  // release the previously returned record's slot
  if (fd->released < fd->tail) {
    fd->released = fd->tail;
    pthread_cond_signal(&fd->cv_space);
  }
  if (fd->tail >= n) {
    pthread_mutex_unlock(&fd->mu);
    return nullptr;
  }
  while (fd->head <= fd->tail && !fd->stop) {
    pthread_cond_wait(&fd->cv_data, &fd->mu);
  }
  const int64_t i = fd->tail;
  fd->tail = i + 1;
  pthread_mutex_unlock(&fd->mu);

  const size_t slot = static_cast<size_t>(i) % fd->slots;
  const RecordHeader& rh = fd->headers[slot];
  if (type) *type = rh.type;
  if (timestamp) *timestamp = rh.timestamp;
  if (size) *size = rh.size;
  return fd->buffers[slot].data();
}

void eslam_feeder_destroy(void* handle) {
  auto* fd = static_cast<Feeder*>(handle);
  if (!fd) return;
  pthread_mutex_lock(&fd->mu);
  fd->stop = true;
  pthread_cond_broadcast(&fd->cv_space);
  pthread_cond_broadcast(&fd->cv_data);
  pthread_mutex_unlock(&fd->mu);
  pthread_join(fd->worker, nullptr);
  delete fd;
}

}  // extern "C"
