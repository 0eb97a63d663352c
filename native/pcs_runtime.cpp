// Native runtime components for pointcloud_segmentation_tpu.
//
// The reference implements its runtime in C++ (ROS node, PCL filters, Hough
// submodule).  This rebuild keeps the *compute* on the XLA path, and
// implements the host runtime's hot pieces natively, exposed through a plain
// C ABI consumed via ctypes (no pybind11 in this image):
//
//   * a latest-wins depth-1 frame mailbox (mutex + condvar, drop counting) —
//     the reference node's SharedData producer/consumer design
//     (pointcloud_segmentation_node.cpp:36-39, 167-173, 268-276), GIL-free;
//   * a binary frame-log codec (the replay "data loader"): timestamped
//     poses + float32 clouds with a simple length-prefixed layout;
//   * a time-stamped pose ring buffer with interpolating lookup — the TF2
//     buffer analog (node.cpp:357-376, tfbr.cpp:18-35);
//   * CSV writers with the reference's exact schemas and C++ `%.6g`
//     number formatting (node.cpp:850-919);
//   * a paced frame feeder: a background thread that streams a frame log
//     into the mailbox + pose buffer at sensor rate — the Webots/ROS
//     spinner analog, entirely off the Python GIL.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libpcs_runtime.so pcs_runtime.cpp -lpthread
// (driven by pointcloud_segmentation_tpu/native/build.py at import time).

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- mailbox

struct PcsMailbox {
  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> buf;   // latest frame payload
  uint64_t seq = 0;           // bumped on every put
  uint64_t dropped = 0;       // puts that overwrote an unconsumed frame
  bool fresh = false;
  bool closed = false;
};

PcsMailbox* pcs_mailbox_create() { return new PcsMailbox(); }

void pcs_mailbox_destroy(PcsMailbox* m) { delete m; }

void pcs_mailbox_put(PcsMailbox* m, const uint8_t* data, uint64_t size) {
  {
    std::lock_guard<std::mutex> lock(m->mu);
    if (m->fresh) m->dropped++;
    m->buf.assign(data, data + size);
    m->fresh = true;
    m->seq++;
  }
  m->cv.notify_one();
}

// Blocks up to timeout_ms for a fresh frame.  Returns the payload size and
// copies min(size, cap) bytes into out; returns -1 on timeout/closed.
// Call with cap == 0 first to poll the size? Not needed: the caller passes a
// max-frame-size buffer (frames are bounded by the sensor resolution).
int64_t pcs_mailbox_take(PcsMailbox* m, uint8_t* out, uint64_t cap,
                         int64_t timeout_ms) {
  std::unique_lock<std::mutex> lock(m->mu);
  auto pred = [m] { return m->fresh || m->closed; };
  if (timeout_ms < 0) {
    m->cv.wait(lock, pred);
  } else if (!m->cv.wait_for(lock, std::chrono::milliseconds(timeout_ms), pred)) {
    return -1;
  }
  if (!m->fresh) return -1;  // closed with nothing pending
  m->fresh = false;
  uint64_t n = m->buf.size() < cap ? m->buf.size() : cap;
  std::memcpy(out, m->buf.data(), n);
  return static_cast<int64_t>(m->buf.size());
}

void pcs_mailbox_close(PcsMailbox* m) {
  {
    std::lock_guard<std::mutex> lock(m->mu);
    m->closed = true;
  }
  m->cv.notify_all();
}

uint64_t pcs_mailbox_dropped(PcsMailbox* m) {
  std::lock_guard<std::mutex> lock(m->mu);
  return m->dropped;
}

// ---------------------------------------------------------------- frame log
//
// Layout (little endian):
//   header: magic "PCSL" (4 bytes), uint32 version = 1
//   per frame:
//     double t
//     double pos[3]
//     double quat_wxyz[4]
//     uint32 n_points
//     float  points[n_points * 3]

static const char kMagic[4] = {'P', 'C', 'S', 'L'};

struct PcsLogWriter {
  FILE* f = nullptr;
  uint64_t frames = 0;
};

PcsLogWriter* pcs_log_open_write(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  uint32_t version = 1;
  std::fwrite(kMagic, 1, 4, f);
  std::fwrite(&version, sizeof(version), 1, f);
  auto* w = new PcsLogWriter();
  w->f = f;
  return w;
}

int pcs_log_write_frame(PcsLogWriter* w, double t, const double* pos,
                        const double* quat, const float* points,
                        uint32_t n_points) {
  if (!w || !w->f) return -1;
  if (std::fwrite(&t, sizeof(double), 1, w->f) != 1) return -1;
  if (std::fwrite(pos, sizeof(double), 3, w->f) != 3) return -1;
  if (std::fwrite(quat, sizeof(double), 4, w->f) != 4) return -1;
  if (std::fwrite(&n_points, sizeof(uint32_t), 1, w->f) != 1) return -1;
  uint64_t n = static_cast<uint64_t>(n_points) * 3;
  if (n && std::fwrite(points, sizeof(float), n, w->f) != n) return -1;
  w->frames++;
  return 0;
}

uint64_t pcs_log_close_write(PcsLogWriter* w) {
  if (!w) return 0;
  uint64_t frames = w->frames;
  if (w->f) std::fclose(w->f);
  delete w;
  return frames;
}

struct PcsLogReader {
  FILE* f = nullptr;
};

PcsLogReader* pcs_log_open_read(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[4];
  uint32_t version = 0;
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, kMagic, 4) != 0 ||
      std::fread(&version, sizeof(version), 1, f) != 1 || version != 1) {
    std::fclose(f);
    return nullptr;
  }
  auto* r = new PcsLogReader();
  r->f = f;
  return r;
}

// Reads the next frame.  points_cap is the capacity of `points` in points
// (xyz triples).  Returns n_points (clipped points are skipped, full count
// returned), or -1 on EOF/error.
int64_t pcs_log_read_frame(PcsLogReader* r, double* t, double* pos,
                           double* quat, float* points, uint32_t points_cap) {
  if (!r || !r->f) return -1;
  if (std::fread(t, sizeof(double), 1, r->f) != 1) return -1;
  if (std::fread(pos, sizeof(double), 3, r->f) != 3) return -1;
  if (std::fread(quat, sizeof(double), 4, r->f) != 4) return -1;
  uint32_t n = 0;
  if (std::fread(&n, sizeof(uint32_t), 1, r->f) != 1) return -1;
  uint32_t take = n < points_cap ? n : points_cap;
  if (take &&
      std::fread(points, sizeof(float), uint64_t(take) * 3, r->f) !=
          uint64_t(take) * 3) {
    return -1;
  }
  if (n > take) {
    std::fseek(r->f, long(uint64_t(n - take) * 3 * sizeof(float)), SEEK_CUR);
  }
  return static_cast<int64_t>(n);
}

void pcs_log_close_read(PcsLogReader* r) {
  if (!r) return;
  if (r->f) std::fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------- pose buffer
//
// Time-ordered ring buffer of (t, position, quaternion) with the lookup
// semantics of runtime/posebuffer.py (the TF2 analog): linear position
// interpolation, slerp orientation, nearest-sample extrapolation within
// `timeout` seconds of the buffered range, failure outside it.

struct PcsPoseBuffer {
  std::mutex mu;
  size_t capacity;
  double timeout;
  std::deque<double> t;                       // ascending
  std::deque<std::array<double, 3>> pos;
  std::deque<std::array<double, 4>> quat;     // (w, x, y, z), unit
};

PcsPoseBuffer* pcs_posebuf_create(uint64_t capacity, double timeout) {
  auto* b = new PcsPoseBuffer();
  b->capacity = capacity ? capacity : 1;
  b->timeout = timeout;
  return b;
}

void pcs_posebuf_destroy(PcsPoseBuffer* b) { delete b; }

void pcs_posebuf_push(PcsPoseBuffer* b, double t, const double* pos,
                      const double* quat) {
  std::array<double, 3> p{pos[0], pos[1], pos[2]};
  std::array<double, 4> q{quat[0], quat[1], quat[2], quat[3]};
  double n = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  if (n > 0) for (auto& v : q) v /= n;
  std::lock_guard<std::mutex> lock(b->mu);
  // insertion position: after any existing equal timestamps (bisect right)
  auto it = std::upper_bound(b->t.begin(), b->t.end(), t);
  size_t i = size_t(it - b->t.begin());
  b->t.insert(it, t);
  b->pos.insert(b->pos.begin() + i, p);
  b->quat.insert(b->quat.begin() + i, q);
  if (b->t.size() > b->capacity) {
    b->t.pop_front();
    b->pos.pop_front();
    b->quat.pop_front();
  }
}

static void pcs_slerp(const std::array<double, 4>& q0in,
                      const std::array<double, 4>& q1in, double u,
                      double* out) {
  std::array<double, 4> q1 = q1in;
  double d = q0in[0] * q1[0] + q0in[1] * q1[1] + q0in[2] * q1[2] +
             q0in[3] * q1[3];
  if (d < 0.0) {
    for (auto& v : q1) v = -v;
    d = -d;
  }
  if (d > 0.9995) {  // nlerp fallback, mirroring posebuffer.slerp
    double n = 0.0;
    for (int k = 0; k < 4; k++) {
      out[k] = q0in[k] + u * (q1[k] - q0in[k]);
      n += out[k] * out[k];
    }
    n = std::sqrt(n);
    for (int k = 0; k < 4; k++) out[k] /= n;
    return;
  }
  double th = std::acos(d < -1.0 ? -1.0 : (d > 1.0 ? 1.0 : d));
  double s = std::sin(th);
  double w0 = std::sin((1.0 - u) * th) / s, w1 = std::sin(u * th) / s;
  for (int k = 0; k < 4; k++) out[k] = w0 * q0in[k] + w1 * q1[k];
}

// Returns 1 and fills out_pos[3]/out_quat[4] on success, 0 on lookup failure
// (empty buffer or t outside range+timeout) — the TransformException path.
int pcs_posebuf_lookup(PcsPoseBuffer* b, double t, double* out_pos,
                       double* out_quat) {
  std::lock_guard<std::mutex> lock(b->mu);
  if (b->t.empty()) return 0;
  auto it = std::upper_bound(b->t.begin(), b->t.end(), t);
  size_t i = size_t(it - b->t.begin());
  if (i == 0) {
    if (b->t.front() - t > b->timeout) return 0;
    for (int k = 0; k < 3; k++) out_pos[k] = b->pos.front()[k];
    for (int k = 0; k < 4; k++) out_quat[k] = b->quat.front()[k];
    return 1;
  }
  if (i == b->t.size()) {
    if (t - b->t.back() > b->timeout) return 0;
    for (int k = 0; k < 3; k++) out_pos[k] = b->pos.back()[k];
    for (int k = 0; k < 4; k++) out_quat[k] = b->quat.back()[k];
    return 1;
  }
  double t0 = b->t[i - 1], t1 = b->t[i];
  double u = (t1 == t0) ? 0.0 : (t - t0) / (t1 - t0);
  for (int k = 0; k < 3; k++)
    out_pos[k] = (1.0 - u) * b->pos[i - 1][k] + u * b->pos[i][k];
  pcs_slerp(b->quat[i - 1], b->quat[i], u, out_quat);
  return 1;
}

uint64_t pcs_posebuf_size(PcsPoseBuffer* b) {
  std::lock_guard<std::mutex> lock(b->mu);
  return b->t.size();
}

// ---------------------------------------------------------------- CSV writers
//
// Exact reference schemas (node.cpp:858, 886, 912) with C++ ostream default
// double formatting — printf %.6g, which IS what `ofstream << double` prints.

static int pcs_fput_g(FILE* f, double v) {
  return std::fprintf(f, "%.6g", v) < 0 ? -1 : 0;
}

// rows: n x 8 doubles (a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max); the segment id
// column is the row index.
int pcs_csv_write_segments(const char* path, const double* rows, uint64_t n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  int rc = std::fputs("segment,a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max\n", f) < 0
               ? -1 : 0;
  for (uint64_t i = 0; i < n && rc == 0; i++) {
    rc |= std::fprintf(f, "%llu", (unsigned long long)i) < 0 ? -1 : 0;
    for (int k = 0; k < 8 && rc == 0; k++) {
      rc |= std::fputc(',', f) == EOF ? -1 : 0;
      rc |= pcs_fput_g(f, rows[i * 8 + k]);
    }
    rc |= std::fputc('\n', f) == EOF ? -1 : 0;
  }
  return std::fclose(f) != 0 ? -1 : rc;
}

// rows: n x 4 doubles (seg1, t1, seg2, t2); seg ids are written as ints.
int pcs_csv_write_intersections(const char* path, const double* rows,
                                uint64_t n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  int rc = std::fputs("seg1,t1,seg2,t2\n", f) < 0 ? -1 : 0;
  for (uint64_t i = 0; i < n && rc == 0; i++) {
    rc |= std::fprintf(f, "%lld,", (long long)rows[i * 4 + 0]) < 0 ? -1 : 0;
    rc |= pcs_fput_g(f, rows[i * 4 + 1]);
    rc |= std::fprintf(f, ",%lld,", (long long)rows[i * 4 + 2]) < 0 ? -1 : 0;
    rc |= pcs_fput_g(f, rows[i * 4 + 3]);
    rc |= std::fputc('\n', f) == EOF ? -1 : 0;
  }
  return std::fclose(f) != 0 ? -1 : rc;
}

// rows: n x 4 doubles (wall_time, processing_time, seg_vec_size, nblines);
// the two counters are written as ints.
int pcs_csv_write_processing(const char* path, const double* rows,
                             uint64_t n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  int rc = std::fputs("wall_time,processing_time,seg_vec_size,nblines\n", f) < 0
               ? -1 : 0;
  for (uint64_t i = 0; i < n && rc == 0; i++) {
    rc |= pcs_fput_g(f, rows[i * 4 + 0]);
    rc |= std::fputc(',', f) == EOF ? -1 : 0;
    rc |= pcs_fput_g(f, rows[i * 4 + 1]);
    rc |= std::fprintf(f, ",%lld,%lld\n", (long long)rows[i * 4 + 2],
                       (long long)rows[i * 4 + 3]) < 0 ? -1 : 0;
  }
  return std::fclose(f) != 0 ? -1 : rc;
}

// ---------------------------------------------------------------- feeder
//
// Background thread that replays a frame log into a mailbox (clouds) and a
// pose buffer (poses) at a fixed rate — the sensor/ROS-spinner analog.  The
// consumer (the processing engine) sees the exact production interface:
// latest-wins mailbox + time-stamped pose lookups, with frames DROPPED (not
// queued) when it falls behind, like the depth-1 /tof_pc subscription.

struct PcsFeeder {
  std::thread th;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> fed{0};
  std::atomic<int> done{0};
  PcsMailbox* mb = nullptr;
  PcsPoseBuffer* pb = nullptr;
  std::string path;
  double rate_hz = 0.0;
  int loops = 1;
  int close_on_end = 1;
};

static void pcs_feeder_run(PcsFeeder* fd) {
  std::vector<float> pts(1u << 22);  // 4M floats ~= 1.4M points cap
  std::vector<uint8_t> payload;
  auto next = std::chrono::steady_clock::now();
  // Per-loop monotonic time offset.  Replaying the log's raw timestamps
  // every loop wraps t backward; the sorted pose ring then accumulates the
  // globally-largest timestamps and evicts everything else, so once it has
  // seen capacity pushes every lookup for a fresh frame fails (measured in
  // the 10-min endurance soak: skipped_no_pose ramps without bound while
  // throughput decays 30 -> 10.5 proc/s).  A continuous sensor never
  // rewinds its clock, so neither does the feeder: each loop k replays at
  // t + k * (span + gap), keeping the stream strictly monotonic.
  double t_first = 0.0, t_last = 0.0, gap = 0.0, offset = 0.0;
  bool have_first = false;
  for (int loop = 0; loop < fd->loops && !fd->stop; loop++) {
    PcsLogReader* r = pcs_log_open_read(fd->path.c_str());
    if (!r) break;
    double t, pos[3], quat[4];
    double prev_t = 0.0;
    bool have_prev = false;
    for (;;) {
      if (fd->stop) break;
      int64_t n = pcs_log_read_frame(r, &t, pos, quat, pts.data(),
                                     uint32_t(pts.size() / 3));
      if (n < 0) break;
      if (!have_first) { t_first = t; have_first = true; }
      if (have_prev && t > prev_t) gap = t - prev_t;
      prev_t = t; have_prev = true;
      t_last = t;
      double tt = t + offset;
      uint32_t take = uint32_t(n) < uint32_t(pts.size() / 3)
                          ? uint32_t(n) : uint32_t(pts.size() / 3);
      if (fd->pb) pcs_posebuf_push(fd->pb, tt, pos, quat);
      if (fd->mb) {
        payload.resize(12 + size_t(take) * 12);
        std::memcpy(payload.data(), &tt, 8);
        std::memcpy(payload.data() + 8, &take, 4);
        std::memcpy(payload.data() + 12, pts.data(), size_t(take) * 12);
        pcs_mailbox_put(fd->mb, payload.data(), payload.size());
      }
      fd->fed++;
      if (fd->rate_hz > 0) {
        next += std::chrono::microseconds(int64_t(1e6 / fd->rate_hz));
        std::this_thread::sleep_until(next);
      }
    }
    pcs_log_close_read(r);
    // Advance the next loop past this one's last frame.  The inter-loop
    // gap mirrors the feed cadence: the paced period when rate-limited,
    // else the log's own last inter-frame gap (or 1 ms for a one-frame
    // log, which has no gap to mirror).
    double step = fd->rate_hz > 0 ? 1.0 / fd->rate_hz
                                  : (gap > 0 ? gap : 1e-3);
    offset += (t_last - t_first) + step;
  }
  if (fd->mb && fd->close_on_end) pcs_mailbox_close(fd->mb);
  fd->done = 1;
}

PcsFeeder* pcs_feeder_start(const char* log_path, PcsMailbox* mb,
                            PcsPoseBuffer* pb, double rate_hz, int loops,
                            int close_on_end) {
  auto* fd = new PcsFeeder();
  fd->mb = mb;
  fd->pb = pb;
  fd->path = log_path;
  fd->rate_hz = rate_hz;
  fd->loops = loops < 1 ? 1 : loops;
  fd->close_on_end = close_on_end;
  fd->th = std::thread(pcs_feeder_run, fd);
  return fd;
}

uint64_t pcs_feeder_fed(PcsFeeder* fd) { return fd->fed.load(); }

int pcs_feeder_done(PcsFeeder* fd) { return fd->done.load(); }

// Stops (if still running), joins, destroys; returns frames fed.
uint64_t pcs_feeder_stop(PcsFeeder* fd) {
  fd->stop = true;
  if (fd->th.joinable()) fd->th.join();
  uint64_t n = fd->fed.load();
  delete fd;
  return n;
}

}  // extern "C"
