// Native fast path: PCAP parse + Velodyne packet decode in one pass.
//
// Rebuild of the reference's ingest layer (reference:
// include/VelodyneCapture.h:413-526 — libpcap loop + per-laser decode on a
// background thread).  This decoder is branch-light and allocation-free in
// the hot loop: one sweep over the capture buffer emits flat SoA arrays
// (azimuth centidegrees, ring, distance ticks, intensity) plus sweep-start
// offsets at azimuth wrap-arounds — exactly the contract of the Python
// decoder in bshot_slam_tpu_torch/io/velodyne.py, which doubles as its oracle.
//
// Packet layout (reference: VelodyneCapture.h:89-110): 12 firings x
// (u16 block id, u16 rotational position, 32 x (u16 distance, u8
// intensity)) + u32 gps timestamp + u8 mode + u8 sensor type = 1206 bytes,
// preceded in the pcap record by a 42-byte Ethernet+IPv4+UDP header.
//
// Build: bshot_slam_tpu_torch/io/native_decoder.py compiles this file at
// first use (g++ -O3 -fno-math-errno -std=c++17 -fPIC -shared -lpthread, no
// -march) into
// build/native/libvelodyne_decoder-<hash of source and flags>.so.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kLasersPerFiring = 32;
constexpr int kFiringsPerPkt = 12;
constexpr int kPacketSize = 1206;
constexpr int kLinkHeader = 42;

#pragma pack(push, 1)
struct LaserReturn {
  uint16_t distance;
  uint8_t intensity;
};
struct FiringData {
  uint16_t block_id;
  uint16_t rotational_position;
  LaserReturn returns[kLasersPerFiring];
};
struct DataPacket {
  FiringData firings[kFiringsPerPkt];
  uint32_t gps_timestamp;
  uint8_t mode;
  uint8_t sensor_type;
};
struct PcapRecordHeader {
  uint32_t ts_sec;
  uint32_t ts_frac;
  uint32_t incl_len;
  uint32_t orig_len;
};
#pragma pack(pop)

static_assert(sizeof(DataPacket) == kPacketSize, "packet layout");

}  // namespace

extern "C" {

struct DecodedCapture {
  // Flat per-laser arrays, firing order.
  float* azimuth_deg;
  int32_t* ring;
  uint16_t* distance;
  uint8_t* intensity;
  int64_t n_lasers;
  // Sweep segmentation: offsets into the arrays where a rotation starts.
  int64_t* sweep_starts;
  int64_t n_sweeps;  // number of COMPLETE sweeps (tail dropped)
};

// Whether packets of an n_rings sensor decode here: the VLP-16 and the
// HDL-32E.  An HDL-64E's two 32-laser blocks need the unit's calibration
// file (db.xml) and would decode into wrong points without it.
static bool decodable_rings(int n_rings) { return n_rings == 16 || n_rings == 32; }

// Decode a classic-pcap Velodyne capture. n_rings is 16 (VLP-16) or 32
// (HDL-32E).  Returns nullptr on unreadable/invalid input or another
// n_rings.
DecodedCapture* vd_decode_pcap(const char* path, int n_rings) {
  if (!decodable_rings(n_rings)) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 24) {
    std::fclose(f);
    return nullptr;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  uint32_t magic;
  std::memcpy(&magic, buf.data(), 4);
  if (magic != 0xA1B2C3D4u && magic != 0xA1B23C4Du) return nullptr;  // LE only

  // First pass: count matching packets.
  size_t off = 24;
  int64_t n_pkts = 0;
  while (off + sizeof(PcapRecordHeader) <= buf.size()) {
    PcapRecordHeader rec;
    std::memcpy(&rec, buf.data() + off, sizeof(rec));
    off += sizeof(rec);
    if (off + rec.incl_len > buf.size()) break;
    if (static_cast<int>(rec.incl_len) - kLinkHeader == kPacketSize) n_pkts++;
    off += rec.incl_len;
  }

  const int64_t n_lasers =
      n_pkts * kFiringsPerPkt * kLasersPerFiring;
  auto* out = static_cast<DecodedCapture*>(std::calloc(1, sizeof(DecodedCapture)));
  out->azimuth_deg = static_cast<float*>(std::malloc(n_lasers * sizeof(float)));
  out->ring = static_cast<int32_t*>(std::malloc(n_lasers * sizeof(int32_t)));
  out->distance = static_cast<uint16_t*>(std::malloc(n_lasers * sizeof(uint16_t)));
  out->intensity = static_cast<uint8_t*>(std::malloc(n_lasers));
  // worst case: a sweep per firing
  out->sweep_starts = static_cast<int64_t*>(
      std::malloc((n_pkts * kFiringsPerPkt + 2) * sizeof(int64_t)));

  int64_t n = 0;
  int64_t n_sweeps = 0;
  double last_azimuth = -1.0;
  out->sweep_starts[0] = 0;

  off = 24;
  while (off + sizeof(PcapRecordHeader) <= buf.size()) {
    PcapRecordHeader rec;
    std::memcpy(&rec, buf.data() + off, sizeof(rec));
    off += sizeof(rec);
    if (off + rec.incl_len > buf.size()) break;
    if (static_cast<int>(rec.incl_len) - kLinkHeader != kPacketSize) {
      off += rec.incl_len;
      continue;
    }
    DataPacket pkt;
    std::memcpy(&pkt, buf.data() + off + kLinkHeader, kPacketSize);
    off += rec.incl_len;

    // Sensor-type gate (reference: VelodyneCapture.h:443): skip packets of
    // a different sensor model; 0 tolerates factory-byte-less streams.
    const uint8_t expected_sensor = (n_rings == 16) ? 0x22 : 0x21;
    if (pkt.sensor_type != 0 && pkt.sensor_type != expected_sensor) continue;

    // VLP-16 half-step interpolation between firings 0 and 1
    // (reference: VelodyneCapture.h:462-469).  Zero unless BOTH firings
    // pass the content gates — a corrupt raw azimuth must not skew the
    // packet's second-sequence lasers.
    auto firing_ok = [](const FiringData& fd) {
      return (fd.block_id == 0 || fd.block_id == 0xEEFF) &&
             fd.rotational_position < 36000;
    };
    double d01 = 0.0;
    if (firing_ok(pkt.firings[0]) && firing_ok(pkt.firings[1])) {
      d01 = static_cast<double>(pkt.firings[1].rotational_position) -
            static_cast<double>(pkt.firings[0].rotational_position);
      if (d01 < 0) d01 += 36000.0;
      d01 *= 0.5;
    }

    for (int fi = 0; fi < kFiringsPerPkt; ++fi) {
      const FiringData& fd = pkt.firings[fi];
      // Corrupt-firing gates: bad block marker or impossible azimuth
      // (mirrors bshot_slam_tpu_torch.io.velodyne.decode_packets).
      if (fd.block_id != 0 && fd.block_id != 0xEEFF) continue;
      if (fd.rotational_position >= 36000) continue;
      for (int li = 0; li < kLasersPerFiring; ++li) {
        double az = static_cast<double>(fd.rotational_position);
        if (li >= n_rings) az += d01;  // second VLP-16 firing sequence
        if (az >= 36000.0) az -= 36000.0;
        // Rotation boundary (reference: VelodyneCapture.h:500-506).
        if (last_azimuth > az) {
          out->sweep_starts[++n_sweeps] = n;
        }
        const int ring = li % n_rings;
        out->azimuth_deg[n] = static_cast<float>(az / 100.0);
        out->ring[n] = ring;
        // returns[li], not returns[ring]: a VLP-16 block's second firing
        // sequence lives in returns 16..31.
        out->distance[n] = fd.returns[li].distance;
        out->intensity[n] = fd.returns[li].intensity;
        last_azimuth = az;
        ++n;
      }
    }
  }
  out->n_lasers = n;
  out->n_sweeps = n_sweeps;  // complete sweeps = boundaries found
  return out;
}

void vd_free(DecodedCapture* c) {
  if (!c) return;
  std::free(c->azimuth_deg);
  std::free(c->ring);
  std::free(c->distance);
  std::free(c->intensity);
  std::free(c->sweep_starts);
  std::free(c);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming loader: background producer thread + bounded sweep queue +
// dense range-image binning, all native.
//
// This is the architectural equivalent of the reference's capture thread
// (reference: VelodyneCapture.h:172,212 — std::thread producer decoding
// packets into a mutex-guarded queue the main loop pops, 78-80,290-303),
// extended: the producer also BINS each rotation into the dense
// (n_rings, n_azimuth) range/azimuth tensors the device consumes
// (bshot_slam_tpu_torch/ops/rangeimage.py semantics: row = rank of the ring's
// vertical angle, col = floor(az/360*A) clamped, later firing wins, empty
// cells hold range 0 and the azimuth bin center), so the Python host loop
// receives upload-ready frames with zero per-frame Python work.

#include <condition_variable>
#include <deque>
#include <mutex>
#include <thread>

namespace {

struct SweepImage {
  std::vector<float> range_mm;
  std::vector<float> azimuth_rad;
};

constexpr double kPi = 3.14159265358979323846;

}  // namespace

struct VdStream {
  int n_rings = 0;
  int n_azimuth = 0;
  float distance_scale_mm = 2.0f;
  std::vector<int32_t> row_of_ring;
  std::vector<float> bin_centers;  // azimuth bin centers, radians
  int skip = 0;
  size_t queue_cap = 4;

  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<SweepImage*> q;
  bool done = false;
  bool closing = false;

  std::vector<uint8_t> buf;  // whole capture (mirrors vd_decode_pcap IO)

  void reset_image(SweepImage* im) const {
    im->range_mm.assign(static_cast<size_t>(n_rings) * n_azimuth, 0.0f);
    im->azimuth_rad.resize(static_cast<size_t>(n_rings) * n_azimuth);
    for (int r = 0; r < n_rings; ++r)
      std::memcpy(im->azimuth_rad.data() + static_cast<size_t>(r) * n_azimuth,
                  bin_centers.data(), n_azimuth * sizeof(float));
  }

  void emit(SweepImage*& cur) {
    SweepImage* ready = cur;
    cur = new SweepImage();
    reset_image(cur);
    if (skip > 0) {  // start-frame fast-forward (VelodyneCapture.h:491-497)
      --skip;
      delete ready;
      return;
    }
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] { return q.size() < queue_cap || closing; });
    if (closing) {
      delete ready;
      return;
    }
    q.push_back(ready);
    cv_push.notify_one();
  }

  void run() {
    SweepImage* cur = new SweepImage();
    reset_image(cur);
    double last_azimuth = -1.0;
    size_t off = 24;
    while (off + sizeof(PcapRecordHeader) <= buf.size()) {
      {
        std::lock_guard<std::mutex> lk(mu);
        if (closing) break;
      }
      PcapRecordHeader rec;
      std::memcpy(&rec, buf.data() + off, sizeof(rec));
      off += sizeof(rec);
      if (off + rec.incl_len > buf.size()) break;
      if (static_cast<int>(rec.incl_len) - kLinkHeader != kPacketSize) {
        off += rec.incl_len;
        continue;
      }
      DataPacket pkt;
      std::memcpy(&pkt, buf.data() + off + kLinkHeader, kPacketSize);
      off += rec.incl_len;

      // Same content gates as the batch decoder above.
      const uint8_t expected_sensor = (n_rings == 16) ? 0x22 : 0x21;
      if (pkt.sensor_type != 0 && pkt.sensor_type != expected_sensor)
        continue;

      auto firing_ok = [](const FiringData& fd) {
        return (fd.block_id == 0 || fd.block_id == 0xEEFF) &&
               fd.rotational_position < 36000;
      };
      double d01 = 0.0;
      if (firing_ok(pkt.firings[0]) && firing_ok(pkt.firings[1])) {
        d01 = static_cast<double>(pkt.firings[1].rotational_position) -
              static_cast<double>(pkt.firings[0].rotational_position);
        if (d01 < 0) d01 += 36000.0;
        d01 *= 0.5;
      }

      for (int fi = 0; fi < kFiringsPerPkt; ++fi) {
        const FiringData& fd = pkt.firings[fi];
        if (fd.block_id != 0 && fd.block_id != 0xEEFF) continue;
        if (fd.rotational_position >= 36000) continue;
        for (int li = 0; li < kLasersPerFiring; ++li) {
          double az = static_cast<double>(fd.rotational_position);
          if (li >= n_rings) az += d01;
          if (az >= 36000.0) az -= 36000.0;
          if (last_azimuth > az) emit(cur);  // rotation boundary
          const int ring = li % n_rings;
          const double az_deg = az / 100.0;
          int col = static_cast<int>(az_deg / 360.0 * n_azimuth);
          if (col > n_azimuth - 1) col = n_azimuth - 1;
          const size_t cell =
              static_cast<size_t>(row_of_ring[ring]) * n_azimuth + col;
          cur->range_mm[cell] =
              static_cast<float>(fd.returns[li].distance) *
              distance_scale_mm;
          cur->azimuth_rad[cell] =
              static_cast<float>(az_deg * kPi / 180.0);
          last_azimuth = az;
        }
      }
    }
    delete cur;  // trailing incomplete rotation is dropped
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_push.notify_all();
  }
};

extern "C" {

// Open a streaming decode of `path`.  `row_of_ring` maps firing ring id ->
// vertical-angle-sorted row (length n_rings).  Returns nullptr when the
// file is unreadable or not a little-endian classic pcap, or when n_rings
// is not 16 or 32.
VdStream* vd_stream_open(const char* path, int n_rings, int n_azimuth,
                         const int32_t* row_of_ring,
                         float distance_scale_mm, int skip, int queue_cap) {
  if (!decodable_rings(n_rings)) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 24) {
    std::fclose(f);
    return nullptr;
  }
  auto* s = new VdStream();
  s->buf.resize(static_cast<size_t>(size));
  if (std::fread(s->buf.data(), 1, s->buf.size(), f) != s->buf.size()) {
    std::fclose(f);
    delete s;
    return nullptr;
  }
  std::fclose(f);
  uint32_t magic;
  std::memcpy(&magic, s->buf.data(), 4);
  if (magic != 0xA1B2C3D4u && magic != 0xA1B23C4Du) {
    delete s;
    return nullptr;
  }
  s->n_rings = n_rings;
  s->n_azimuth = n_azimuth;
  s->distance_scale_mm = distance_scale_mm;
  s->row_of_ring.assign(row_of_ring, row_of_ring + n_rings);
  s->skip = skip;
  s->queue_cap = queue_cap > 0 ? queue_cap : 4;
  s->bin_centers.resize(n_azimuth);
  for (int a = 0; a < n_azimuth; ++a)
    s->bin_centers[a] =
        static_cast<float>((a + 0.5) * 2.0 * kPi / n_azimuth);
  s->producer = std::thread([s] { s->run(); });
  return s;
}

// Pop the next sweep into caller-owned (n_rings*n_azimuth) float buffers.
// Blocks while the producer is behind; returns 1 on success, 0 at end.
int vd_stream_next(VdStream* s, float* range_mm, float* azimuth_rad) {
  if (!s) return 0;
  SweepImage* im = nullptr;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_push.wait(lk, [&] { return !s->q.empty() || s->done; });
    if (s->q.empty()) return 0;
    im = s->q.front();
    s->q.pop_front();
    s->cv_pop.notify_one();
  }
  std::memcpy(range_mm, im->range_mm.data(),
              im->range_mm.size() * sizeof(float));
  std::memcpy(azimuth_rad, im->azimuth_rad.data(),
              im->azimuth_rad.size() * sizeof(float));
  delete im;
  return 1;
}

void vd_stream_close(VdStream* s) {
  if (!s) return;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
    s->cv_pop.notify_all();
  }
  if (s->producer.joinable()) s->producer.join();
  for (auto* im : s->q) delete im;
  delete s;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native sweep preprocessing: ground / self-car / occlusion classification +
// compact extraction, mirroring bshot_slam_tpu_torch/ops/preprocess_host.py rule
// for rule (itself the float32 restatement of the reference's Preprocessor,
// src/preprocess.cpp:73-216).  One call classifies a (n_rings, n_az) range
// image and emits the kept points in azimuth-major order — the whole host
// side of a frame in ~1-2 ms of C instead of ~11 ms of numpy.
// ---------------------------------------------------------------------------

#include <cmath>

namespace {
constexpr int kClassKeep = 0;
constexpr int kClassGround = 1;
constexpr int kClassSelfcar = 2;
constexpr int kClassOccluded = 3;
constexpr float kEps = 1e-6f;

// The sine and cosine of the last two distinct azimuths a column met: the
// lasers of one firing share its azimuth, and an empty cell holds its
// bin's centre, so most cells of a column repeat one of two values.  Keyed
// by the float's bits (sin(-0) is -0), so each value is the one std::sin
// and std::cos give.
struct TrigCache {
  uint32_t key[2] = {0, 0};
  float sin_[2] = {0.0f, 0.0f}, cos_[2] = {0.0f, 0.0f};
  int filled = 0, next = 0;

  void get(float az, float* s, float* c) {
    uint32_t bits;
    std::memcpy(&bits, &az, sizeof bits);
    for (int e = 0; e < filled; ++e) {
      if (key[e] == bits) {
        *s = sin_[e];
        *c = cos_[e];
        return;
      }
    }
    *s = std::sin(az);
    *c = std::cos(az);
    key[next] = bits;
    sin_[next] = *s;
    cos_[next] = *c;
    next ^= 1;
    if (filled < 2) ++filled;
  }
};
}  // namespace

extern "C" {

struct PreprocessCfg {
  float vert_init_rad;
  float sensor_height_mm;
  float grad_th_deg;
  float lowpt_th_mm;
  float height_th_mm;
  float dist_th_mm;
  float angdiff_th_rad;
  float car_x0, car_x1, car_y0, car_y1, car_z0, car_z1;
};

}  // extern "C"

namespace {

// What the walk reads: the image, the rings' trig, the thresholds.
struct WalkInput {
  const float* range_mm;
  const float* az_rad;
  int n_rings, n_az;
  const float* cv;  // cos of each row's vertical angle
  const float* sv;  // sin of each row's vertical angle
  const PreprocessCfg* cfg;
  float horiz0;  // horizontal range of the walk's start point
  // Outside [s_lo, s_hi] the gradient's sine alone settles its comparisons.
  bool banded;
  float s_lo, s_hi;
};

// Bottom-up ground walk (reference: preprocess.cpp:73-166; rules mirror
// _ground_walk_host), writing every cell's class and the planes xs, ys, zs
// of the cells' XYZ.  The columns are independent, so the walk keeps each
// column's state and sweeps the rows in order, each row in passes over its
// columns: the azimuths' sines and cosines (a column repeats one or two
// azimuths, so through its TrigCache), the points and their gradients,
// then the rules.  The second and third passes hold no branch and no call,
// so the compiler runs them on SIMD lanes, eight wide where the host has
// AVX2 (a second copy, picked when the library loads); IEEE arithmetic,
// with no fused multiply-add, gives each lane what the scalar code gives.
__attribute__((target_clones("avx2", "default")))
void walk(const WalkInput& in, int32_t* classes_out, float* xs, float* ys,
          float* zs) {
  const int W = in.n_az;
  const PreprocessCfg& cfg = *in.cfg;
  const float H = cfg.sensor_height_mm, grad_th = cfg.grad_th_deg;
  std::vector<float> px(W), py(W), pz(W), pn(W), thz(W), sa(W), ca(W), sr(W);
  std::vector<int32_t> pig(W, 1), lost(W, 0), set_th(W, 0), steep(W),
      gentle(W);
  std::vector<TrigCache> trig(W);
  for (int j = 0; j < W; ++j) {
    const float az0 = in.az_rad[j];  // row 0's azimuth for this column
    px[j] = in.horiz0 * std::sin(az0);
    py[j] = in.horiz0 * std::cos(az0);
    pz[j] = -H;
    pn[j] = std::sqrt(px[j] * px[j] + py[j] * py[j] + pz[j] * pz[j]);
    thz[j] = pz[j];
  }
  const float lowpt_th = cfg.lowpt_th_mm, height_th = cfg.height_th_mm;
  const float cx0 = cfg.car_x0, cx1 = cfg.car_x1, cy0 = cfg.car_y0,
              cy1 = cfg.car_y1, cz0 = cfg.car_z0, cz1 = cfg.car_z1;

  for (int r = 0; r < in.n_rings; ++r) {
    const size_t row = static_cast<size_t>(r) * W;
    const float* __restrict d_r = in.range_mm + row;
    const float* __restrict az_r = in.az_rad + row;
    float* __restrict x_ = xs + row;
    float* __restrict y_ = ys + row;
    float* __restrict z_ = zs + row;
    for (int j = 0; j < W; ++j) trig[j].get(az_r[j], &sa[j], &ca[j]);

    // The cell's XYZ, float32 exactly as preprocess_host.polar_to_xyz_host,
    // and the sine of its gradient from the column's previous point.
    {
      const float cvr = in.cv[r], svr = in.sv[r];
      const float* __restrict s_ = sa.data();
      const float* __restrict c_ = ca.data();
      const float* __restrict qx = px.data();
      const float* __restrict qy = py.data();
      const float* __restrict qz = pz.data();
      float* __restrict g_ = sr.data();
      for (int j = 0; j < W; ++j) {
        const float d = d_r[j];
        const float x = d * cvr * s_[j], y = d * cvr * c_[j], z = d * svr;
        const float dx = x - qx[j], dy = y - qy[j], dz = z - qz[j];
        const float nrm = std::sqrt(dx * dx + dy * dy + dz * dz);
        float s = dz / (nrm + kEps);
        s = s > 1.0f ? 1.0f : s;
        s = s < -1.0f ? -1.0f : s;
        x_[j] = x; y_[j] = y; z_[j] = z; g_[j] = s;
      }
    }
    // grad > grad_th and grad < grad_th, grad = asin(s) in degrees.  asin
    // rises with s: outside a band of 1e-4 around sin(grad_th) in s (1e-4
    // rad or more in angle, thousands of asinf's rounding errors) s alone
    // settles both, so asinf runs only inside it (and for NaN).
    for (int j = 0; j < W; ++j) {
      steep[j] = in.banded && sr[j] > in.s_hi;
      gentle[j] = in.banded && sr[j] < in.s_lo;
    }
    for (int j = 0; j < W; ++j) {
      if (steep[j] | gentle[j]) continue;
      const float grad = std::asin(sr[j]) * 57.29577951308232f;
      steep[j] = grad > grad_th;
      gentle[j] = grad < grad_th;
    }

    // The rules, each column from its state after the row before.
    const int32_t* __restrict st_ = steep.data();
    const int32_t* __restrict ge_ = gentle.data();
    float* __restrict qx = px.data();
    float* __restrict qy = py.data();
    float* __restrict qz = pz.data();
    float* __restrict qn = pn.data();
    float* __restrict tz = thz.data();
    int32_t* __restrict pg = pig.data();
    int32_t* __restrict ls = lost.data();
    int32_t* __restrict ts = set_th.data();
    int32_t* __restrict cl = classes_out + row;
    for (int j = 0; j < W; ++j) {
      const float d = d_r[j], x = x_[j], y = y_[j], z = z_[j];
      const float norm_prev = qn[j], z_prev = qz[j];
      const int32_t gentle_j = ge_[j];
      int32_t g = pg[j], th_set = ts[j];
      float th_z = tz[j];
      // Rule 1: remember a threshold point.
      const int32_t cond1 = g & (st_[j] | (d == 0.0f) | (d < norm_prev));
      th_set |= cond1;
      th_z = cond1 ? z_prev : th_z;
      // Rule 2: ground continuation / lower-ground re-attach.
      const int32_t g_keep = g & gentle_j & (ls[j] ^ 1);
      const int32_t lower = (g ^ 1) & (z < lowpt_th) & gentle_j;
      int32_t cls = (g_keep | lower) ? kClassGround : kClassKeep;
      g = g_keep | lower;
      th_set = lower ? 0 : th_set;
      // Rule 3: lost point.
      const int32_t lost_new = d == 0.0f;
      cls = lost_new ? kClassGround : cls;
      g = lost_new ? 0 : g;
      // Rule 4: range shortened vs previous.
      const int32_t shorter = (d < norm_prev) & (d != 0.0f);
      cls = shorter ? kClassKeep : cls;
      g = shorter ? 0 : g;
      // Rule 5: threshold-point restart.
      const int32_t restart = th_set & ((z - th_z) < height_th) & (z < z_prev);
      th_set = restart ? 0 : th_set;
      cls = restart ? kClassGround : cls;
      g = restart ? 1 : g;
      // Rule 6: self-car crop box.
      const int32_t car = (x >= cx0) & (x <= cx1) & (y >= cy0) & (y <= cy1) &
                          (z >= cz0) & (z <= cz1);
      cl[j] = car ? kClassSelfcar : cls;
      pg[j] = g; ts[j] = th_set; tz[j] = th_z; ls[j] = lost_new;
      qx[j] = x; qy[j] = y; qz[j] = z;
      qn[j] = std::sqrt(x * x + y * y + z * z);
    }
  }
}

}  // namespace

extern "C" {

// Classify every cell and emit kept XYZ points (azimuth-major order).
// `selected` is an optional (n_rings*n_az) 0/1 mask (NULL = all selected,
// matching save_sel=True semantics).  `xyz_scratch` holds 3*n_rings*n_az
// floats (the cells' X, Y and Z planes).  Returns the number of kept
// points written to points_out (capped at max_points), or -1 on bad
// arguments.
int64_t vd_preprocess_extract(
    const float* range_mm, const float* az_rad, const float* vert_rad,
    int n_rings, int n_az, const PreprocessCfg* cfg,
    const uint8_t* selected,
    int32_t* classes_out, float* xyz_scratch, float* points_out,
    int64_t max_points) {
  if (n_rings <= 0 || n_az <= 0 || !cfg) return -1;

  // Per-ring vertical trig.
  std::vector<float> cv(n_rings), sv(n_rings);
  for (int r = 0; r < n_rings; ++r) {
    cv[r] = std::cos(vert_rad[r]);
    sv[r] = std::sin(vert_rad[r]);
  }
  const float grad_th = cfg->grad_th_deg;
  const double s_th = std::sin(static_cast<double>(grad_th) * (kPi / 180.0));
  const WalkInput in{range_mm, az_rad, n_rings, n_az, cv.data(), sv.data(), cfg,
                     -cfg->sensor_height_mm / std::tan(cfg->vert_init_rad),
                     grad_th > -80.0f && grad_th < 80.0f,
                     static_cast<float>(s_th - 1e-4),
                     static_cast<float>(s_th + 1e-4)};
  const size_t cells = static_cast<size_t>(n_rings) * n_az;
  float* xs = xyz_scratch;
  float* ys = xyz_scratch + cells;
  float* zs = xyz_scratch + 2 * cells;

  walk(in, classes_out, xs, ys, zs);

  // Occlusion pass (reference: preprocess.cpp:168-199; mirrors
  // _occlusion_host's previous-valid-neighbor comparison + scatter), then
  // each cell kept for extraction.
  std::vector<uint8_t> keep(cells);
  for (int r = 0; r < n_rings; ++r) {
    const size_t row = static_cast<size_t>(r) * n_az;
    int prev_idx = -1;
    for (int a = 0; a < n_az; ++a) {
      const bool valid = range_mm[row + a] > 0.0f;
      if (valid && prev_idx >= 0) {
        const float d_dist = range_mm[row + a] - range_mm[row + prev_idx];
        const float d_hor = az_rad[row + a] - az_rad[row + prev_idx];
        if (std::fabs(d_dist) > cfg->dist_th_mm &&
            std::fabs(d_hor) < cfg->angdiff_th_rad) {
          const size_t mark = d_dist > 0.0f ? row + a : row + prev_idx;
          if (classes_out[mark] == kClassKeep)
            classes_out[mark] = kClassOccluded;
        }
      }
      if (valid || a == 0) prev_idx = a;
    }
  }
  for (size_t i = 0; i < cells; ++i) {
    keep[i] = (range_mm[i] > 0.0f) & (classes_out[i] == kClassKeep) &
              (!selected || selected[i] != 0);
  }

  // Compact extraction, azimuth-major then vertical (reference:
  // preprocess.cpp:201-216 column-major map walk).
  int64_t n = 0;
  for (int a = 0; a < n_az && n < max_points; ++a) {
    for (int r = 0; r < n_rings && n < max_points; ++r) {
      const size_t i = static_cast<size_t>(r) * n_az + a;
      if (!keep[i]) continue;
      points_out[3 * n + 0] = xs[i];
      points_out[3 * n + 1] = ys[i];
      points_out[3 * n + 2] = zs[i];
      ++n;
    }
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Range-image binning of one decoded sweep, bit for bit
// bshot_slam_tpu_torch/ops/rangeimage.py's build_range_image (the engine's
// host ingest bins every sweep; numpy's scatter takes ~4 ms at 64 rings).
// ---------------------------------------------------------------------------

extern "C" {

// Bin `n` firings (azimuth in degrees, ring id, distance ticks, and an
// optional 0/1 select flag each) into caller-filled (n_rings, n_az) images:
// row row_of_ring[ring], column trunc(az / 360 * n_az) capped at n_az - 1;
// range = ticks * distance_scale_mm in float32, azimuth = az * (pi / 180)
// rounded to float32, select flag where `selected` is given; a later
// firing overwrites an earlier one in the same cell.  Returns 0; with
// nothing written, -1 where a ring lies outside the image and -2 where an
// azimuth is negative, not a number or too large for a column.
int vd_bin_sweep(const double* azimuth_deg, const int32_t* ring,
                 const uint16_t* distance, const uint8_t* selected, int64_t n,
                 const int32_t* row_of_ring, int n_rings, int n_az,
                 float distance_scale_mm, float* range_mm, float* azimuth_rad,
                 uint8_t* selected_out) {
  for (int64_t k = 0; k < n; ++k) {
    if (ring[k] < 0 || ring[k] >= n_rings) return -1;
    if (!(azimuth_deg[k] >= 0.0 && azimuth_deg[k] < 1e15)) return -2;
  }
  for (int64_t k = 0; k < n; ++k) {
    int64_t col = static_cast<int64_t>(azimuth_deg[k] / 360.0 * n_az);
    if (col > n_az - 1) col = n_az - 1;
    const size_t cell = static_cast<size_t>(row_of_ring[ring[k]]) * n_az + col;
    range_mm[cell] = static_cast<float>(distance[k]) * distance_scale_mm;
    azimuth_rad[cell] = static_cast<float>(azimuth_deg[k] * (kPi / 180.0));
    if (selected) selected_out[cell] = selected[k];
  }
  return 0;
}

}  // extern "C"
