// Native sweep-log runtime: binary LiDAR/IMU log IO with background prefetch.
//
// This is the rebuild's replacement for the reference's native transport
// layer: rosbag replay + TCPROS topic plumbing + mutex-guarded std::queue
// buffers drained by polling threads (SURVEY §5.8, RGC_odometer.cpp:245,
// RGC_mapping.cpp:65).  The engine itself is jit-compiled JAX; this C++
// library keeps the host-side data path native: decode, pad to the static
// tensor capacities, and stage scans in a bounded ring ahead of the device.
//
// File format (little endian):
//   header:  magic "RGCSWEEP" (8) | u32 version | u32 n_scans | u32 n_rings
//   scan:    f64 stamp | u32 n_points | u32 n_imu
//            points: n_points * (f32 x,y,z,intensity,rel_time + u16 ring)
//            imu:    n_imu * (f32 t, ax, ay, az, gx, gy, gz)
//
// C API (ctypes-friendly), all functions return 0 on success:
//   slog_writer_open / slog_writer_add_scan / slog_writer_close
//   slog_open   -> opaque handle, reports n_scans
//   slog_start_prefetch(handle, ring_slots, pad_points, pad_imu)
//   slog_next(handle, ...)  -> blocking pop of the next padded scan
//   slog_close
//
// Async PCD sink (the OUTPUT mirror of the prefetch ring): per-frame cloud
// dumps (ref RGC_odometer.cpp:1353-1354 writes PCDs inline on its odometry
// thread) are staged into a bounded queue and written by a background
// thread, so the replay loop never stalls on disk:
//   pcd_sink_open(dir, ring_slots) / pcd_sink_push / pcd_sink_close

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

constexpr char kMagic[8] = {'R', 'G', 'C', 'S', 'W', 'E', 'E', 'P'};
constexpr uint32_t kVersion = 1;

#pragma pack(push, 1)
struct PointRec {
  float x, y, z, intensity, rel_time;
  uint16_t ring;
};
struct ImuRec {
  float t, ax, ay, az, gx, gy, gz;
};
#pragma pack(pop)

struct Scan {
  double stamp = 0.0;
  std::vector<PointRec> points;
  std::vector<ImuRec> imu;
};

struct Writer {
  FILE* f = nullptr;
  uint32_t n_scans = 0;
  uint32_t n_rings = 16;
  long count_pos = 0;
};

struct Reader {
  FILE* f = nullptr;
  uint32_t n_scans = 0;
  uint32_t n_rings = 16;
  uint32_t cursor = 0;

  // prefetch ring
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::queue<Scan> ring;
  size_t ring_cap = 4;
  std::atomic<bool> running{false};
  std::atomic<bool> done{false};
};

bool read_scan(FILE* f, Scan* out) {
  double stamp;
  uint32_t n_points, n_imu;
  if (fread(&stamp, sizeof(double), 1, f) != 1) return false;
  if (fread(&n_points, sizeof(uint32_t), 1, f) != 1) return false;
  if (fread(&n_imu, sizeof(uint32_t), 1, f) != 1) return false;
  out->stamp = stamp;
  out->points.resize(n_points);
  out->imu.resize(n_imu);
  if (n_points &&
      fread(out->points.data(), sizeof(PointRec), n_points, f) != n_points)
    return false;
  if (n_imu && fread(out->imu.data(), sizeof(ImuRec), n_imu, f) != n_imu)
    return false;
  return true;
}

void prefetch_loop(Reader* r) {
  while (r->running.load()) {
    Scan s;
    {
      if (r->cursor >= r->n_scans) break;
      if (!read_scan(r->f, &s)) break;
      r->cursor++;
    }
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_push.wait(lk, [r] { return r->ring.size() < r->ring_cap || !r->running; });
    if (!r->running) break;
    r->ring.push(std::move(s));
    r->cv_pop.notify_one();
  }
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->done = true;
    r->cv_pop.notify_all();
  }
}

}  // namespace

extern "C" {

// ----------------------------------------------------------------- writer --
void* slog_writer_open(const char* path, uint32_t n_rings) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer;
  w->f = f;
  w->n_rings = n_rings;
  fwrite(kMagic, 1, 8, f);
  fwrite(&kVersion, sizeof(uint32_t), 1, f);
  w->count_pos = ftell(f);
  uint32_t zero = 0;
  fwrite(&zero, sizeof(uint32_t), 1, f);
  fwrite(&n_rings, sizeof(uint32_t), 1, f);
  return w;
}

int slog_writer_add_scan(void* handle, double stamp, uint32_t n_points,
                         const float* xyz, const float* intensity,
                         const float* rel_time, const uint16_t* ring,
                         uint32_t n_imu, const float* imu7) {
  auto* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return 1;
  fwrite(&stamp, sizeof(double), 1, w->f);
  fwrite(&n_points, sizeof(uint32_t), 1, w->f);
  fwrite(&n_imu, sizeof(uint32_t), 1, w->f);
  std::vector<PointRec> pts(n_points);
  for (uint32_t i = 0; i < n_points; ++i) {
    pts[i] = {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2], intensity[i],
              rel_time[i], ring[i]};
  }
  if (n_points) fwrite(pts.data(), sizeof(PointRec), n_points, w->f);
  if (n_imu) fwrite(imu7, sizeof(ImuRec), n_imu, w->f);
  w->n_scans++;
  return 0;
}

int slog_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return 1;
  fseek(w->f, w->count_pos, SEEK_SET);
  fwrite(&w->n_scans, sizeof(uint32_t), 1, w->f);
  fclose(w->f);
  delete w;
  return 0;
}

// ----------------------------------------------------------------- reader --
void* slog_open(const char* path, uint32_t* n_scans, uint32_t* n_rings) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  uint32_t version;
  auto* r = new Reader;
  r->f = f;
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0 ||
      fread(&version, sizeof(uint32_t), 1, f) != 1 || version != kVersion ||
      fread(&r->n_scans, sizeof(uint32_t), 1, f) != 1 ||
      fread(&r->n_rings, sizeof(uint32_t), 1, f) != 1) {
    fclose(f);
    delete r;
    return nullptr;
  }
  if (n_scans) *n_scans = r->n_scans;
  if (n_rings) *n_rings = r->n_rings;
  return r;
}

int slog_start_prefetch(void* handle, uint32_t ring_slots) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || r->running) return 1;
  r->ring_cap = ring_slots ? ring_slots : 4;
  r->running = true;
  r->done = false;
  r->worker = std::thread(prefetch_loop, r);
  return 0;
}

// Blocking pop.  Pads/truncates to (pad_points, pad_imu).  Returns:
//   0 = scan delivered, 1 = end of log, <0 = error.
int slog_next(void* handle, uint32_t pad_points, uint32_t pad_imu,
              double* stamp, uint32_t* n_points_out, uint32_t* n_imu_out,
              float* xyz, float* intensity, float* rel_time, int32_t* ring,
              uint8_t* mask, float* imu7, uint8_t* imu_mask) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  Scan s;
  if (r->running) {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_pop.wait(lk, [r] { return !r->ring.empty() || r->done; });
    if (r->ring.empty()) return 1;
    s = std::move(r->ring.front());
    r->ring.pop();
    r->cv_push.notify_one();
  } else {
    if (r->cursor >= r->n_scans || !read_scan(r->f, &s)) return 1;
    r->cursor++;
  }
  uint32_t np = s.points.size() < pad_points
                    ? static_cast<uint32_t>(s.points.size())
                    : pad_points;
  uint32_t ni = s.imu.size() < pad_imu ? static_cast<uint32_t>(s.imu.size())
                                       : pad_imu;
  *stamp = s.stamp;
  *n_points_out = np;
  *n_imu_out = ni;
  memset(mask, 0, pad_points);
  memset(imu_mask, 0, pad_imu);
  for (uint32_t i = 0; i < np; ++i) {
    const auto& p = s.points[i];
    xyz[3 * i] = p.x;
    xyz[3 * i + 1] = p.y;
    xyz[3 * i + 2] = p.z;
    intensity[i] = p.intensity;
    rel_time[i] = p.rel_time;
    ring[i] = p.ring;
    mask[i] = 1;
  }
  for (uint32_t i = np; i < pad_points; ++i) {
    xyz[3 * i] = xyz[3 * i + 1] = xyz[3 * i + 2] = 0.f;
    intensity[i] = rel_time[i] = 0.f;
    ring[i] = 0;
  }
  if (ni) memcpy(imu7, s.imu.data(), ni * sizeof(ImuRec));
  for (uint32_t i = ni; i < pad_imu; ++i)
    memset(imu7 + 7 * i, 0, 7 * sizeof(float));
  for (uint32_t i = 0; i < ni; ++i) imu_mask[i] = 1;
  return 0;
}

int slog_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return 1;
  if (r->running) {
    r->running = false;
    r->cv_push.notify_all();
    r->cv_pop.notify_all();
    if (r->worker.joinable()) r->worker.join();
  }
  fclose(r->f);
  delete r;
  return 0;
}

}  // extern "C"

// -------------------------------------------------------- async PCD sink --
struct SinkFrame {
  uint32_t index = 0;
  std::vector<float> xyz;   // n * 3
};

struct Sink {
  std::string dir;
  std::queue<SinkFrame> q;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  uint32_t cap = 8;
  bool running = false;
  std::thread worker;
  std::atomic<int> errors{0};
};

static void sink_write_pcd(Sink* s, const SinkFrame& fr) {
  char path[4096];
  snprintf(path, sizeof(path), "%s/frame_%06u.pcd", s->dir.c_str(), fr.index);
  FILE* f = fopen(path, "wb");
  if (!f) {
    s->errors++;
    return;
  }
  const uint32_t n = static_cast<uint32_t>(fr.xyz.size() / 3);
  bool ok = fprintf(f,
                    "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
                    "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                    "WIDTH %u\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %u\n"
                    "DATA binary\n",
                    n, n) > 0;
  if (n && fwrite(fr.xyz.data(), sizeof(float) * 3, n, f) != n) ok = false;
  // fclose flushes stdio buffers — a full disk can surface only here
  if (fclose(f) != 0) ok = false;
  if (!ok) s->errors++;
}

static void sink_loop(Sink* s) {
  while (true) {
    SinkFrame fr;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv_pop.wait(lk, [s] { return !s->q.empty() || !s->running; });
      if (s->q.empty()) {
        if (!s->running) break;
        continue;
      }
      fr = std::move(s->q.front());
      s->q.pop();
      s->cv_push.notify_one();
    }
    sink_write_pcd(s, fr);
  }
}

extern "C" {

void* pcd_sink_open(const char* dir, uint32_t ring_slots) {
  auto* s = new Sink;
  s->dir = dir;
  s->cap = ring_slots ? ring_slots : 8;
  s->running = true;
  s->worker = std::thread(sink_loop, s);
  return s;
}

// Blocks only when the queue is full (disk slower than the engine) —
// bounded memory, lossless.
int pcd_sink_push(void* handle, uint32_t index, uint32_t n, const float* xyz) {
  auto* s = static_cast<Sink*>(handle);
  if (!s || !s->running) return 1;
  SinkFrame fr;
  fr.index = index;
  fr.xyz.assign(xyz, xyz + 3ull * n);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_push.wait(lk, [s] { return s->q.size() < s->cap || !s->running; });
  if (!s->running) return 1;
  s->q.push(std::move(fr));
  s->cv_pop.notify_one();
  return 0;
}

// Drains the queue, joins the writer; returns the number of write errors.
int pcd_sink_close(void* handle) {
  auto* s = static_cast<Sink*>(handle);
  if (!s) return -1;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->running = false;
  }
  s->cv_pop.notify_all();
  s->cv_push.notify_all();
  if (s->worker.joinable()) s->worker.join();
  // the worker only exits once the queue is empty AND running is false,
  // so everything pushed before close() is guaranteed on disk here
  int err = s->errors.load();
  delete s;
  return err;
}

}  // extern "C"
