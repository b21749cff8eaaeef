// webradio native ingest runtime.
//
// The reference implements its capture path in C++: a USB async thread
// converts u8 IQ to float and fills a 4-slot ring under a mutex+condvar,
// dropping blocks on overrun (reference src/io/rtlsdrtuner.cxx:33-117,
// 265-285).  This library provides the same runtime as a reusable native
// core, driven from Python via ctypes:
//
//   * wr_ring_*   — fixed-block SPSC ring with drop-oldest overflow and
//                   blocking pop (the pipeline pacing point);
//   * wr_convert_u8_iq / wr_convert_planes — hot host-side conversions
//     ((x - 128) / 128 like rtlsdrtuner.cxx:92-95, and complex interleave
//     -> separate I/Q planes as the device program consumes them);
//   * wr_rtltcp_* — an rtl_tcp network capture session: C++ reader thread
//     pulls u8 frames off the socket, converts, and feeds a ring without
//     touching the Python GIL.
//
// Build: see native/Makefile (plain C++17 + pthreads, no other deps).

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// conversions
// ---------------------------------------------------------------------------

// u8 interleaved IQ -> float32 planes: out_i[n] = (in[2n] - 128) / 128,
// out_q[n] = (in[2n+1] - 128) / 128   (rtlsdrtuner.cxx:92-95 semantics,
// deinterleaved straight into the [2, N] plane layout the device step takes).
void wr_convert_u8_iq(const uint8_t* in, float* out_i, float* out_q,
                      int64_t frames) {
  static float lut[256];
  static std::atomic<bool> lut_ready{false};
  if (!lut_ready.load(std::memory_order_acquire)) {
    for (int v = 0; v < 256; ++v) lut[v] = (float)(v - 128) / 128.0f;
    lut_ready.store(true, std::memory_order_release);
  }
  for (int64_t n = 0; n < frames; ++n) {
    out_i[n] = lut[in[2 * n]];
    out_q[n] = lut[in[2 * n + 1]];
  }
}

// complex64 interleaved (re, im) -> float32 planes.
void wr_convert_planes(const float* interleaved, float* out_i, float* out_q,
                       int64_t frames) {
  for (int64_t n = 0; n < frames; ++n) {
    out_i[n] = interleaved[2 * n];
    out_q[n] = interleaved[2 * n + 1];
  }
}

// ---------------------------------------------------------------------------
// block ring
// ---------------------------------------------------------------------------

struct WrRing {
  explicit WrRing(int64_t block_floats, int depth)
      : block_floats(block_floats), depth(depth) {}

  int64_t block_floats;
  int depth;
  std::deque<std::vector<float>> q;
  std::vector<std::vector<float>> free_list;
  std::mutex mu;
  std::condition_variable ready;
  std::atomic<bool> closed{false};
  std::atomic<int64_t> dropped{0};
  std::atomic<int64_t> total{0};

  std::vector<float> take_buffer() {
    if (!free_list.empty()) {
      auto b = std::move(free_list.back());
      free_list.pop_back();
      return b;
    }
    return std::vector<float>((size_t)block_floats);
  }
};

void* wr_ring_new(int64_t block_floats, int depth) {
  return new WrRing(block_floats, depth);
}

void wr_ring_free(void* ring) { delete static_cast<WrRing*>(ring); }

// Producer: copy one block in; drop-oldest when full (rtlsdrtuner.cxx:99-102).
void wr_ring_push(void* ring, const float* data) {
  auto* r = static_cast<WrRing*>(ring);
  std::lock_guard<std::mutex> lk(r->mu);
  auto buf = r->take_buffer();
  std::memcpy(buf.data(), data, (size_t)r->block_floats * sizeof(float));
  if ((int)r->q.size() >= r->depth) {
    r->free_list.emplace_back(std::move(r->q.front()));
    r->q.pop_front();
    r->dropped.fetch_add(1, std::memory_order_relaxed);
  }
  r->q.emplace_back(std::move(buf));
  r->total.fetch_add(1, std::memory_order_relaxed);
  r->ready.notify_one();
}

// Consumer: blocking pop into caller storage. Returns 1 on success, 0 on
// timeout/closed-and-empty. timeout_ms < 0 waits forever.
int wr_ring_pop(void* ring, float* out, int64_t timeout_ms) {
  auto* r = static_cast<WrRing*>(ring);
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [&] { return !r->q.empty() || r->closed.load(); };
  if (timeout_ms < 0) {
    r->ready.wait(lk, pred);
  } else if (!r->ready.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                pred)) {
    return 0;
  }
  if (r->q.empty()) return 0;  // closed
  auto buf = std::move(r->q.front());
  r->q.pop_front();
  std::memcpy(out, buf.data(), (size_t)r->block_floats * sizeof(float));
  r->free_list.emplace_back(std::move(buf));
  return 1;
}

void wr_ring_close(void* ring) {
  auto* r = static_cast<WrRing*>(ring);
  r->closed.store(true);
  r->ready.notify_all();
}

int64_t wr_ring_dropped(void* ring) {
  return static_cast<WrRing*>(ring)->dropped.load();
}

int64_t wr_ring_total(void* ring) {
  return static_cast<WrRing*>(ring)->total.load();
}

int64_t wr_ring_depth_now(void* ring) {
  auto* r = static_cast<WrRing*>(ring);
  std::lock_guard<std::mutex> lk(r->mu);
  return (int64_t)r->q.size();
}

// ---------------------------------------------------------------------------
// rtl_tcp capture session (socket reader thread in C++)
// ---------------------------------------------------------------------------

struct WrRtlTcp {
  int fd = -1;
  int64_t frames_per_block = 0;
  uint32_t tuner_type = 0;   // rtl_tcp header: enum rtlsdr_tuner
  uint32_t gain_count = 0;   // rtl_tcp header: supported gain count
  WrRing* ring = nullptr;  // owned
  std::thread reader;
  std::atomic<bool> stop{false};

  ~WrRtlTcp() {
    stop.store(true);
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
    if (reader.joinable()) reader.join();
    if (fd >= 0) ::close(fd);
    delete ring;
  }
};

static bool read_exact(int fd, uint8_t* buf, size_t n,
                       const std::atomic<bool>& stop) {
  size_t got = 0;
  while (got < n && !stop.load(std::memory_order_relaxed)) {
    ssize_t r = ::recv(fd, buf + got, n - got, 0);
    if (r <= 0) return false;
    got += (size_t)r;
  }
  return got == n;
}

// Connect to an rtl_tcp server. Returns a session handle or null.
void* wr_rtltcp_open(const char* host, int port, int64_t frames_per_block,
                     int ring_depth) {
  struct addrinfo hints = {};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  char portstr[16];
  snprintf(portstr, sizeof portstr, "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) return nullptr;
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    if (fd >= 0) ::close(fd);
    freeaddrinfo(res);
    return nullptr;
  }
  freeaddrinfo(res);

  uint8_t hdr[12];
  std::atomic<bool> no_stop{false};
  if (!read_exact(fd, hdr, sizeof hdr, no_stop) ||
      std::memcmp(hdr, "RTL0", 4) != 0) {
    ::close(fd);
    return nullptr;
  }

  auto* s = new WrRtlTcp;
  s->fd = fd;
  s->frames_per_block = frames_per_block;
  // header fields are big-endian u32: dongle tuner type + gain count
  uint32_t be;
  std::memcpy(&be, hdr + 4, 4);
  s->tuner_type = ntohl(be);
  std::memcpy(&be, hdr + 8, 4);
  s->gain_count = ntohl(be);
  s->ring = new WrRing(2 * frames_per_block, ring_depth);
  s->reader = std::thread([s] {
    std::vector<uint8_t> raw((size_t)2 * s->frames_per_block);
    std::vector<float> planes((size_t)2 * s->frames_per_block);
    while (!s->stop.load(std::memory_order_relaxed)) {
      if (!read_exact(s->fd, raw.data(), raw.size(), s->stop)) break;
      wr_convert_u8_iq(raw.data(), planes.data(),
                       planes.data() + s->frames_per_block,
                       s->frames_per_block);
      wr_ring_push(s->ring, planes.data());
    }
    wr_ring_close(s->ring);
  });
  return s;
}

// Standard rtl_tcp command: 1-byte opcode + u32 big-endian argument.
int wr_rtltcp_command(void* session, uint8_t op, uint32_t arg) {
  auto* s = static_cast<WrRtlTcp*>(session);
  uint8_t msg[5];
  msg[0] = op;
  uint32_t be = htonl(arg);
  std::memcpy(msg + 1, &be, 4);
  return ::send(s->fd, msg, sizeof msg, MSG_NOSIGNAL) == (ssize_t)sizeof msg
             ? 0
             : -1;
}

// Pop one converted [2, frames] plane block. 1 = ok, 0 = timeout/ended.
int wr_rtltcp_pop(void* session, float* out, int64_t timeout_ms) {
  auto* s = static_cast<WrRtlTcp*>(session);
  return wr_ring_pop(s->ring, out, timeout_ms);
}

int64_t wr_rtltcp_dropped(void* session) {
  return static_cast<WrRtlTcp*>(session)->ring->dropped.load();
}

// Dongle identity from the rtl_tcp connect header (tuner type enum +
// supported-gain count) — the wire analog of the reference's USB-string
// and tuner probing readback (rtlsdrtuner.cxx:215-222).
void wr_rtltcp_dongle_info(void* session, uint32_t* tuner_type,
                           uint32_t* gain_count) {
  auto* s = static_cast<WrRtlTcp*>(session);
  *tuner_type = s->tuner_type;
  *gain_count = s->gain_count;
}

void wr_rtltcp_close(void* session) { delete static_cast<WrRtlTcp*>(session); }

// ---------------------------------------------------------------------------
// synthetic multi-carrier source (off-GIL tone synthesizer)
// ---------------------------------------------------------------------------
//
// The Python ToneSource's numpy loop holds the GIL the serving pump
// needs. This synthesizes the same carrier ensemble (io/source.py
// ToneSource laws: AM 1+0.5 sin envelope, NBFM with 5 kHz deviation via
// the closed-form phase integral) on a C++ thread paced to the nominal
// rate, pushing [2, N] float32 plane blocks into a drop-oldest ring — the
// same producer contract as real hardware DMA (rtlsdrtuner.cxx:86-117).

struct WrTone {
  double fs = 0;
  int64_t frames = 0;
  double noise = 0;
  struct Carrier {
    double offset;
    int kind;  // 0 = AM, 1 = FM, else CW
    double audio;
  };
  std::vector<Carrier> carriers;
  WrRing* ring = nullptr;
  std::thread synth;
  std::atomic<bool> stop{false};
  uint64_t s0 = 0, s1 = 0;  // xorshift128+ noise state

  ~WrTone() {
    stop.store(true);
    if (synth.joinable()) synth.join();
    delete ring;
  }

  inline double uni() {  // xorshift128+ -> uniform [-1, 1)
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    uint64_t r = s1 + y;
    return ((double)(r >> 11) / (double)(1ull << 53)) * 2.0 - 1.0;
  }
};

void* wr_tone_open(double sample_rate, int64_t frames_per_block,
                   int ring_depth, int n_carriers, const double* offsets,
                   const int32_t* kinds, const double* audio_hz,
                   double noise, uint64_t seed) {
  auto* s = new WrTone;
  s->fs = sample_rate;
  s->frames = frames_per_block;
  s->noise = noise;
  for (int k = 0; k < n_carriers; ++k)
    s->carriers.push_back({offsets[k], (int)kinds[k], audio_hz[k]});
  s->s0 = seed * 0x9E3779B97F4A7C15ull + 0xBF58476D1CE4E5B9ull;
  s->s1 = (seed ^ 0x94D049BB133111EBull) | 1ull;
  s->ring = new WrRing(2 * frames_per_block, ring_depth);
  s->synth = std::thread([s] {
    std::vector<float> planes((size_t)2 * s->frames);
    const double two_pi = 6.283185307179586476925286766559;
    const float scale =
        1.0f / (float)std::max<size_t>(1, s->carriers.size());
    int64_t n0 = 0;
    int64_t blocks = 0;
    auto t_start = std::chrono::steady_clock::now();
    while (!s->stop.load(std::memory_order_relaxed)) {
      float* re = planes.data();
      float* im = planes.data() + s->frames;
      std::memset(re, 0, sizeof(float) * (size_t)s->frames);
      std::memset(im, 0, sizeof(float) * (size_t)s->frames);
      for (auto& c : s->carriers) {
        for (int64_t n = 0; n < s->frames; ++n) {
          double t = (double)(n0 + n) / s->fs;
          double theta, env = 1.0;
          if (c.kind == 1) {
            // NBFM: phi = 2*pi*f0*t - (D/fa) cos(2*pi*fa*t), D = 5 kHz
            theta = std::fmod(
                two_pi * c.offset * t -
                    5000.0 / c.audio * std::cos(two_pi * c.audio * t),
                two_pi);
          } else {
            theta = std::fmod(two_pi * c.offset * t, two_pi);
            if (c.kind == 0) env = 1.0 + 0.5 * std::sin(two_pi * c.audio * t);
          }
          re[n] += (float)(env * std::cos(theta));
          im[n] += (float)(env * std::sin(theta));
        }
      }
      if (s->noise > 0) {
        // uniform with the gaussian's variance (sqrt(3) scale) — a test
        // source's noise floor, not a calibrated channel model
        const float a = (float)(s->noise * 1.7320508075688772);
        for (int64_t n = 0; n < s->frames; ++n) {
          re[n] += a * (float)s->uni();
          im[n] += a * (float)s->uni();
        }
      }
      for (int64_t n = 0; n < 2 * s->frames; ++n) planes[(size_t)n] *= scale;
      n0 += s->frames;
      ++blocks;
      // pace to real time on the synth thread (the DMA-cadence analog);
      // sleep_until keeps long-run cadence exact regardless of synth cost
      auto deadline =
          t_start + std::chrono::nanoseconds((int64_t)(
                        1e9 * (double)blocks * (double)s->frames / s->fs));
      std::this_thread::sleep_until(deadline);
      if (s->stop.load(std::memory_order_relaxed)) break;
      wr_ring_push(s->ring, planes.data());
    }
    wr_ring_close(s->ring);
  });
  return s;
}

int wr_tone_pop(void* session, float* out, int64_t timeout_ms) {
  return wr_ring_pop(static_cast<WrTone*>(session)->ring, out, timeout_ms);
}

int64_t wr_tone_dropped(void* session) {
  return static_cast<WrTone*>(session)->ring->dropped.load();
}

// Stop the synthesizer and wake every blocked wr_tone_pop (they return 0
// once the ring is empty) without freeing the session: the caller frees
// it with wr_tone_close after its poppers have returned.
void wr_tone_shutdown(void* session) {
  auto* s = static_cast<WrTone*>(session);
  s->stop.store(true);
  wr_ring_close(s->ring);
}

void wr_tone_close(void* session) { delete static_cast<WrTone*>(session); }

}  // extern "C"
