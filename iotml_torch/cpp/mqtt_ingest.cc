// Native MQTT ingest front-end — the fleet-scale hot path in C++.
//
// Role: the reference's ingestion edge is a native (JVM) HiveMQ cluster
// whose job, for this pipeline, is exactly one thing: absorb qos-0/1
// PUBLISH floods from ~100k devices and hand the payloads to the Kafka
// extension (SURVEY L2).  The Python fronts (`mqtt.wire.MqttServer`,
// `mqtt.eventserver.MqttEventServer`) carry the full broker semantics
// (subscriptions, retained messages, QoS 2 exactly-once, backpressure);
// THIS engine is the specialized ingest-only listener for raw throughput:
// an epoll loop + MQTT frame parser in C++, accumulating extracted
// (topic, payload) pairs into a flat arena the Python side drains in bulk
// (one ctypes call per thousands of messages, zero per-message Python).
//
// Protocol surface (deliberately narrow — it is an ingest edge, not a
// broker): CONNECT/CONNACK (3.1.1 and 5), PUBLISH qos 0/1 (+PUBACK),
// PINGREQ/PINGRESP, DISCONNECT.  SUBSCRIBE is answered with the per-filter
// failure code 0x80 (this front has no outbound delivery); a QoS 2
// PUBLISH drops the connection (exactly-once lives on the Python fronts).
// Malformed frames drop only their own connection.
//
// C API (ctypes, see mqtt/native_ingest.py):
//   iotml_mqtt_ingest_create(port)         -> handle (0 on failure)
//   iotml_mqtt_ingest_port(h)              -> bound port
//   iotml_mqtt_ingest_poll(h, timeout_ms)  -> buffered message count
//   iotml_mqtt_ingest_drain(h, &blob, &tlens, &plens) -> n messages;
//       blob is [topic bytes][payload bytes] per message, lengths in the
//       two int32 arrays; pointers valid until the next poll/clear
//   iotml_mqtt_ingest_clear(h)             -> reset the arena
//   iotml_mqtt_ingest_conns(h)             -> live connection count
//   iotml_mqtt_ingest_close(h)

#include <arpa/inet.h>
#include <malloc.h>
#include <ctime>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <unordered_map>
#include <vector>

namespace {

constexpr uint8_t CONNECT = 1, PUBLISH = 3, PUBACK = 4, SUBSCRIBE = 8,
                  UNSUBSCRIBE = 10, PINGREQ = 12, DISCONNECT = 14;

struct Conn {
  std::vector<uint8_t> in;
  uint8_t level = 4;     // protocol level from CONNECT (4 = 3.1.1, 5 = v5)
  bool connected = false;
};

struct Ingest {
  int lfd = -1;
  int ep = -1;
  uint16_t port = 0;
  std::unordered_map<int, Conn> conns;
  // drained-message arena
  std::vector<uint8_t> blob;
  std::vector<int32_t> tlens;
  std::vector<int32_t> plens;
  int64_t last_trim_ms = 0;  // rate limit for malloc_trim (see clear())
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void close_conn(Ingest* ig, int fd) {
  epoll_ctl(ig->ep, EPOLL_CTL_DEL, fd, nullptr);
  ::close(fd);
  ig->conns.erase(fd);
}

// best-effort small control response (CONNACK/PUBACK/PINGRESP fit kernel
// buffers virtually always; on EAGAIN with NOTHING sent the ack is dropped
// whole — qos1 senders retry, which is within at-least-once).  A PARTIAL
// write (0 < sent < n) is worse than a dropped ack: the client's inbound
// stream now starts mid-frame and every later ack misparses, so the only
// framing-safe move is to drop the connection.  Returns false in that case.
bool reply(int fd, const uint8_t* data, size_t n) {
  ssize_t sent = ::send(fd, data, n, MSG_NOSIGNAL);
  return !(sent >= 0 && static_cast<size_t>(sent) < n);
}

// parse one frame out of buf[pos..n); returns false if incomplete.
// On success sets ptype, flags, body span [bstart, bend) and new pos.
bool parse_frame(const std::vector<uint8_t>& buf, size_t& pos,
                 uint8_t& ptype, uint8_t& flags, size_t& bstart,
                 size_t& bend, bool& malformed) {
  size_t n = buf.size();
  if (n - pos < 2) return false;
  uint8_t h = buf[pos];
  size_t i = pos + 1;
  uint32_t mult = 1, length = 0;
  for (int k = 0; k < 4; ++k) {
    if (i >= n) return false;
    uint8_t b = buf[i++];
    length += (b & 0x7F) * mult;
    if (!(b & 0x80)) goto have_len;
    mult *= 128;
  }
  malformed = true;
  return false;
have_len:
  if (n - i < length) return false;
  ptype = h >> 4;
  flags = h & 0x0F;
  bstart = i;
  bend = i + length;
  pos = bend;
  return true;
}

// returns false when the connection must be dropped
bool handle_frame(Ingest* ig, int fd, Conn& c, uint8_t ptype, uint8_t flags,
                  const uint8_t* b, size_t n) {
  switch (ptype) {
    case CONNECT: {
      // [len][name][level][flags][keepalive][props?][client id...]
      if (n < 4) return false;
      size_t p = 2 + ((b[0] << 8) | b[1]);  // skip protocol name
      if (p >= n) return false;
      c.level = b[p];
      c.connected = true;
      if (c.level >= 5) {
        const uint8_t ack[] = {0x20, 0x03, 0x00, 0x00, 0x00};
        return reply(fd, ack, sizeof ack);
      }
      const uint8_t ack[] = {0x20, 0x02, 0x00, 0x00};
      return reply(fd, ack, sizeof ack);
    }
    case PUBLISH: {
      if (!c.connected) return false;
      uint8_t qos = (flags >> 1) & 0x03;
      if (qos > 1) return false;  // qos 2 belongs to the Python fronts
      if (n < 2) return false;
      size_t tlen = (b[0] << 8) | b[1];
      size_t p = 2 + tlen;
      if (p > n) return false;
      uint16_t pid = 0;
      if (qos == 1) {
        if (p + 2 > n) return false;
        pid = (b[p] << 8) | b[p + 1];
        p += 2;
      }
      if (c.level >= 5) {
        // properties: varint length then that many bytes
        uint32_t mult = 1, plen = 0;
        size_t q = p;
        for (int k = 0; k < 4; ++k) {
          if (q >= n) return false;
          uint8_t v = b[q++];
          plen += (v & 0x7F) * mult;
          if (!(v & 0x80)) break;
          mult *= 128;
        }
        p = q + plen;
        if (p > n) return false;
      }
      // append to the arena: [topic][payload]
      ig->blob.insert(ig->blob.end(), b + 2, b + 2 + tlen);
      ig->blob.insert(ig->blob.end(), b + p, b + n);
      ig->tlens.push_back(static_cast<int32_t>(tlen));
      ig->plens.push_back(static_cast<int32_t>(n - p));
      if (qos == 1) {
        const uint8_t ack[] = {0x40, 0x02, uint8_t(pid >> 8),
                               uint8_t(pid & 0xFF)};
        return reply(fd, ack, sizeof ack);
      }
      return true;
    }
    case SUBSCRIBE: {
      // ingest-only: refuse every filter (0x80), per-spec SUBACK shape
      if (n < 2) return false;
      // count filters: walk [len][filter][qos] tuples after pid (+props v5)
      size_t p = 2;
      if (c.level >= 5) {
        uint32_t mult = 1, plen = 0;
        for (int k = 0; k < 4 && p < n; ++k) {
          uint8_t v = b[p++];
          plen += (v & 0x7F) * mult;
          if (!(v & 0x80)) break;
          mult *= 128;
        }
        p += plen;
      }
      int filters = 0;
      while (p + 2 <= n) {
        size_t fl = (b[p] << 8) | b[p + 1];
        p += 2 + fl + 1;
        if (p <= n) ++filters;
      }
      if (filters <= 0) return false;
      std::vector<uint8_t> ack;
      size_t body = 2 + (c.level >= 5 ? 1 : 0) + filters;
      ack.push_back(0x90);
      // remaining length is a varint: >127 filters needs multiple bytes
      size_t rem = body;
      do {
        uint8_t v = rem % 128;
        rem /= 128;
        ack.push_back(rem ? (v | 0x80) : v);
      } while (rem);
      ack.push_back(b[0]);
      ack.push_back(b[1]);
      if (c.level >= 5) ack.push_back(0x00);
      for (int k = 0; k < filters; ++k) ack.push_back(0x80);
      return reply(fd, ack.data(), ack.size());
    }
    case UNSUBSCRIBE: {
      if (n < 2) return false;
      uint8_t ack[] = {0xB0, 0x02, b[0], b[1]};
      return reply(fd, ack, sizeof ack);
    }
    case PINGREQ: {
      const uint8_t ack[] = {0xD0, 0x00};
      return reply(fd, ack, sizeof ack);
    }
    case DISCONNECT:
      return false;
    default:
      return false;  // anything else is a protocol violation here
  }
}

}  // namespace

extern "C" {

void* iotml_mqtt_ingest_create(uint16_t port) {
  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return nullptr;
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  // deep receive buffers, inherited by accepted sockets with the right
  // window scale: under backpressure stalls the unread kernel buffers
  // overflow on loopback (drops → sender RTO exponential backoff, stuck
  // flows at rto ~29s) — a deep buffer rides the stall out instead
  int rcvbuf = 1 << 20;
  setsockopt(lfd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof rcvbuf);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) < 0 ||
      listen(lfd, 1024) < 0) {
    ::close(lfd);
    return nullptr;
  }
  socklen_t alen = sizeof addr;
  getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
  set_nonblock(lfd);
  int ep = epoll_create1(0);
  if (ep < 0) {
    ::close(lfd);
    return nullptr;
  }
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = lfd;
  epoll_ctl(ep, EPOLL_CTL_ADD, lfd, &ev);
  auto* ig = new Ingest();
  ig->lfd = lfd;
  ig->ep = ep;
  ig->port = ntohs(addr.sin_port);
  return ig;
}

int iotml_mqtt_ingest_port(void* h) {
  return static_cast<Ingest*>(h)->port;
}

long iotml_mqtt_ingest_conns(void* h) {
  return static_cast<long>(static_cast<Ingest*>(h)->conns.size());
}

// Intake backpressure: when the drain side (Python) lags, stop reading —
// kernel socket buffers fill and TCP pushes back on the publishers, the
// same watermark stance as the Python event server.  Bounds both the
// arena and the size of any single drained batch.
// measured sweet spot: a smaller arena (16k msgs) serializes intake
// against the Python forward pass and halves sustained throughput; this
// size keeps intake running while a drained batch is being forwarded
constexpr size_t kMaxBufferedMsgs = 65536;
constexpr size_t kMaxBufferedBytes = 32u << 20;

long iotml_mqtt_ingest_poll(void* h, int timeout_ms) {
  auto* ig = static_cast<Ingest*>(h);
  if (ig->tlens.size() >= kMaxBufferedMsgs ||
      ig->blob.size() >= kMaxBufferedBytes) {
    return static_cast<long>(ig->tlens.size());
  }
  epoll_event evs[256];
  int nev = epoll_wait(ig->ep, evs, 256, timeout_ms);
  if (nev < 0 && errno != EINTR) return -1;
  for (int e = 0; e < nev; ++e) {
    int fd = evs[e].data.fd;
    if (fd == ig->lfd) {
      for (;;) {
        int cfd = ::accept(ig->lfd, nullptr, nullptr);
        if (cfd < 0) break;
        set_nonblock(cfd);
        int one = 1;
        setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        epoll_event cev{};
        cev.events = EPOLLIN;
        cev.data.fd = cfd;
        epoll_ctl(ig->ep, EPOLL_CTL_ADD, cfd, &cev);
        ig->conns.emplace(cfd, Conn{});
      }
      continue;
    }
    // mid-pass backpressure: once the arena is full, stop consuming the
    // remaining readable connections this pass — their data stays in the
    // kernel (level-triggered epoll re-reports them after the drain)
    if (ig->tlens.size() >= kMaxBufferedMsgs ||
        ig->blob.size() >= kMaxBufferedBytes) {
      break;
    }
    auto it = ig->conns.find(fd);
    if (it == ig->conns.end()) continue;
    Conn& c = it->second;
    bool drop = false;
    bool eof = false;
    for (;;) {
      uint8_t chunk[65536];
      ssize_t got = ::recv(fd, chunk, sizeof chunk, 0);
      if (got > 0) {
        c.in.insert(c.in.end(), chunk, chunk + got);
        if (got < static_cast<ssize_t>(sizeof chunk)) break;
        // bound per-event intake: a connection whose kernel buffer filled
        // during a backpressure stall must not balloon its parse buffer
        // (the capacity would be retained); the rest re-reports next pass
        if (c.in.size() >= (256u << 10)) break;
      } else if (got == 0) {
        eof = true;  // parse what arrived in this pass FIRST — frames
        break;       // read together with the FIN must not be discarded
      } else {
        if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
          drop = true;
        break;
      }
    }
    if (!drop) {
      size_t pos = 0;
      uint8_t ptype, flags;
      size_t bs, be;
      bool malformed = false;
      while (parse_frame(c.in, pos, ptype, flags, bs, be, malformed)) {
        if (!handle_frame(ig, fd, c, ptype, flags, c.in.data() + bs,
                          be - bs)) {
          drop = true;
          break;
        }
      }
      if (malformed) drop = true;
      if (!drop && pos > 0) {
        c.in.erase(c.in.begin(), c.in.begin() + pos);
        // shrink burst capacity: after a backlog burst (e.g. the post-
        // stop drain of a full fleet) EVERY connection's parse buffer
        // holds a tens-to-hundreds-of-KB capacity; at 9k connections the
        // old >256KB threshold retained over a GB of dead capacity.  The
        // 64KB threshold keeps steady-state buffers (a few KB per pass)
        // untouched — no shrink/regrow churn — while reclaiming the
        // drain-phase spikes (capacity cap is 256KB, the per-event
        // intake bound).
        if (c.in.capacity() > (64u << 10) && c.in.size() < 4096)
          c.in.shrink_to_fit();
      }
    }
    if (drop || eof) close_conn(ig, fd);
  }
  return static_cast<long>(ig->tlens.size());
}

long iotml_mqtt_ingest_drain(void* h, const uint8_t** blob,
                             const int32_t** tlens, const int32_t** plens) {
  auto* ig = static_cast<Ingest*>(h);
  *blob = ig->blob.data();
  *tlens = ig->tlens.data();
  *plens = ig->plens.data();
  return static_cast<long>(ig->tlens.size());
}

void iotml_mqtt_ingest_clear(void* h) {
  auto* ig = static_cast<Ingest*>(h);
  ig->blob.clear();
  ig->tlens.clear();
  ig->plens.clear();
  // hand freed heap back to the kernel: the burst buffers this engine
  // churns (arena + per-conn parse buffers) otherwise sit in glibc's
  // arenas and read as broker RSS forever.  Rate-limited to ~2/s —
  // clear() runs after EVERY drained pass under load, and an
  // every-pass trim would walk the arenas and madvise pages the next
  // burst faults straight back in.  malloc_trim is glibc-specific; on
  // other libcs it simply doesn't exist and this file is glibc/Linux-
  // only already (epoll).
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC_COARSE, &ts);
  int64_t now_ms = ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
  if (now_ms - ig->last_trim_ms >= 500) {
    ig->last_trim_ms = now_ms;
    malloc_trim(0);
  }
}

void iotml_mqtt_ingest_close(void* h) {
  auto* ig = static_cast<Ingest*>(h);
  for (auto& kv : ig->conns) ::close(kv.first);
  ::close(ig->lfd);
  ::close(ig->ep);
  delete ig;
}

}  // extern "C"
