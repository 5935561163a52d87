// iotml_torch native Kafka wire client: a copy of the JAX package's
// iotml/cpp/kafka_client.cc, the C++ half of the stream data plane.
//
// A blocking TCP client speaking the classic Kafka protocol subset of
// stream/kafka_wire.py: request header v1; MessageSet v1; Produce v2,
// Fetch v2, ListOffsets v1, Metadata v1, OffsetCommit v2, OffsetFetch v1,
// CreateTopics v0, SaslHandshake v0 + the raw PLAIN token.
//
// The headline entry point is iotml_kafka_fetch_decode(): one call does
// the fetch, the Confluent 5-byte framing strip and the schema-compiled
// Avro decode (iotml_decode_batch, avro_engine.cc) straight into
// caller-owned columnar buffers, with no per-message Python object.
//
// Two changes from the JAX copy:
// - Message sets are encoded and decoded by msgset_engine.cc
//   (iotml_msgset_encode / iotml_msgset_decode), the one codec of the
//   port: the wire client's and server's sets and this client's go
//   through the same code.  That decoder refuses an entry whose size is
//   under 14 bytes, the smallest body (the JAX copy accepted any size
//   >= 0 and, for 0..3, ran its CRC over ~2^64 bytes past the buffer);
//   a refused set fails the fetch with K_EMSGSET.  The fetch staging
//   area is therefore columnar (the decoder's own layout), and
//   fetch_decode hands the staged value blob to the Avro decoder without
//   copying it again.
// - One produce entry point takes the value-null (tombstone) column,
//   NULL when no value is null (the JAX copy had two).
//
// Error convention: functions return >= 0 on success; -2 for socket or
// frame IO failure (-1 is reserved: OffsetFetch uses it for "no committed
// offset"); -3 for a message set the decoder refused; -(1000 +
// kafka_error_code) for protocol errors, so Python maps e.g. -1003 back
// to UNKNOWN_TOPIC_OR_PARTITION.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
int64_t iotml_decode_batch(const uint8_t* blob, const int64_t* offsets,
                           int64_t n_msgs, const int8_t* types,
                           const uint8_t* nullable, int64_t n_fields,
                           int64_t strip, double* out_numeric,
                           char* out_labels, int64_t label_stride);
int64_t iotml_msgset_encode(const uint8_t* values, const int64_t* val_off,
                            const uint8_t* val_null, const uint8_t* keys,
                            const int64_t* key_off, const uint8_t* key_null,
                            const int64_t* timestamps,
                            const int64_t* offsets, int64_t n,
                            uint8_t* out_buf, int64_t out_cap);
int64_t iotml_msgset_decode(const uint8_t* buf, int64_t len, int64_t max_n,
                            int64_t* offsets, int64_t* ts,
                            int64_t* key_off, uint8_t* key_null,
                            uint8_t* keys, int64_t keys_cap,
                            int64_t* val_off, uint8_t* val_null,
                            uint8_t* values, int64_t values_cap);
}

namespace {

constexpr int16_t API_PRODUCE = 0, API_FETCH = 1, API_LIST_OFFSETS = 2,
                  API_METADATA = 3, API_OFFSET_COMMIT = 8,
                  API_OFFSET_FETCH = 9, API_SASL_HANDSHAKE = 17,
                  API_CREATE_TOPICS = 19, API_RAW_PRODUCE = 65;
constexpr int16_t ERR_NONE = 0, ERR_TOPIC_EXISTS = 36;
constexpr int64_t K_EIO = -2;  // -1 would collide with OffsetFetch's "none"
constexpr int64_t K_EMSGSET = -3;  // the message-set decoder refused a set
// The fused decode found a Confluent schema id outside the pinned band
// at the CURRENT cursor (nothing decoded): the caller re-reads the chunk
// through the name-resolving Python path (native_kafka maps this to
// SchemaIdMismatchError).  -1999 sits between the protocol-error band
// (-1000 - code) and the decode-error band (-(row + 1) - 2000).
constexpr int64_t K_ESCHEMA = -1999;
// no MessageSet entry is shorter (v0: offset, size and a 14-byte body)
constexpr int64_t MIN_ENTRY = 26;
// a v1 entry's framing: offset, size, crc, magic, attributes, timestamp
// and the two lengths
constexpr int64_t ENTRY_FRAMING = 34;

inline int64_t proto_err(int16_t code) { return -(1000 + (int64_t)code); }

// ------------------------------------------------------------ buffers
struct Writer {
  std::vector<uint8_t> buf;
  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf.insert(buf.end(), b, b + n);
  }
  void i8(int8_t v) { buf.push_back(static_cast<uint8_t>(v)); }
  void i16(int16_t v) {
    buf.push_back((v >> 8) & 0xFF);
    buf.push_back(v & 0xFF);
  }
  void i32(int32_t v) {
    for (int s = 24; s >= 0; s -= 8) buf.push_back((v >> s) & 0xFF);
  }
  void i64(int64_t v) {
    for (int s = 56; s >= 0; s -= 8) buf.push_back((v >> s) & 0xFF);
  }
  void str(const char* s) {  // non-null Kafka STRING
    int16_t n = s ? static_cast<int16_t>(strlen(s)) : 0;
    i16(n);
    if (s) raw(s, n);
  }
  void null_str() { i16(-1); }
  void bytes(const uint8_t* p, int32_t n) {  // n < 0 → null BYTES
    i32(n);
    if (n > 0) raw(p, n);
  }
};

struct Reader {
  const uint8_t* buf;
  size_t len, pos = 0;
  bool fail = false;
  Reader(const uint8_t* b, size_t n) : buf(b), len(n) {}
  bool need(size_t n) {
    if (pos + n > len) { fail = true; return false; }
    return true;
  }
  int8_t i8() { return need(1) ? static_cast<int8_t>(buf[pos++]) : 0; }
  int16_t i16() {
    if (!need(2)) return 0;
    int16_t v = (buf[pos] << 8) | buf[pos + 1];
    pos += 2;
    return v;
  }
  int32_t i32() {
    if (!need(4)) return 0;
    int32_t v = 0;
    for (int i = 0; i < 4; ++i) v = (v << 8) | buf[pos++];
    return v;
  }
  int64_t i64() {
    if (!need(8)) return 0;
    int64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | buf[pos++];
    return v;
  }
  void skip_str() {
    int16_t n = i16();
    if (n > 0 && need(n)) pos += n;
  }
  std::string str() {
    int16_t n = i16();
    if (n <= 0 || !need(n)) return "";
    std::string s(reinterpret_cast<const char*>(buf + pos), n);
    pos += n;
    return s;
  }
  // BYTES: returns length (-1 null) and sets *out to the in-place pointer.
  int32_t bytes(const uint8_t** out) {
    int32_t n = i32();
    if (n < 0) { *out = nullptr; return -1; }
    if (!need(n)) { *out = nullptr; return -1; }
    *out = buf + pos;
    pos += n;
    return n;
  }
};

// ------------------------------------------------------------- staging
// One fetch's message set, decoded by iotml_msgset_decode into its
// columnar layout; entries [first, first + n) are the ones the fetch
// keeps (at or after the requested offset, at most max_messages).
struct Staged {
  std::vector<int64_t> offsets, ts, key_off, val_off;
  std::vector<uint8_t> key_null, val_null, keys, values;
  int64_t first = 0, n = 0;
  void clear() { first = n = 0; }
  int64_t value_len(int64_t i) const { return val_off[i + 1] - val_off[i]; }
  const uint8_t* value(int64_t i) const { return values.data() + val_off[i]; }
};

struct Client {
  int fd = -1;
  int32_t corr = 0;
  std::string client_id;
  Staged staged;
  int64_t staged_high_watermark = -1;
  // Exclusive upper bound on positionally-safe Confluent writer ids for
  // the fused fetch_decode paths (< 0 = no check).  Evolved writer
  // schemas live in the reserved id band: a staged value that is not
  // magic-0 framed or whose id is >= this limit stops the decode BEFORE
  // that message, so an evolved writer surfaces as K_ESCHEMA instead of
  // being positionally mis-read.
  int64_t pinned_id_limit = -1;
};

// Decode one partition's set into the staging area.  Entries below
// min_offset are skipped (a prefix: a set's offsets ascend); a truncated
// trailing entry is dropped by the decoder.  False when the decoder
// refuses the set (CRC mismatch, an entry size under 14 bytes).
bool stage_message_set(Staged& s, const uint8_t* buf, int64_t len,
                       int64_t min_offset, int64_t max_messages) {
  s.clear();
  int64_t max_n = len / MIN_ENTRY + 1;
  s.offsets.resize(max_n);
  s.ts.resize(max_n);
  s.key_null.resize(max_n);
  s.val_null.resize(max_n);
  s.key_off.resize(max_n + 1);
  s.val_off.resize(max_n + 1);
  s.keys.resize(std::max<int64_t>(len, 1));
  s.values.resize(std::max<int64_t>(len, 1));
  int64_t got = iotml_msgset_decode(
      buf, len, max_n, s.offsets.data(), s.ts.data(), s.key_off.data(),
      s.key_null.data(), s.keys.data(), len, s.val_off.data(),
      s.val_null.data(), s.values.data(), len);
  if (got < 0) return false;
  int64_t first = 0;
  while (first < got && s.offsets[first] < min_offset) ++first;
  s.first = first;
  s.n = std::max<int64_t>(0, std::min(got - first, max_messages));
  return true;
}

// ------------------------------------------------------------ transport
bool send_all(int fd, const uint8_t* p, size_t n) {
  while (n) {
    ssize_t k = ::send(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= k;
  }
  return true;
}

bool recv_all(int fd, uint8_t* p, size_t n) {
  while (n) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= k;
  }
  return true;
}

bool send_frame(Client* c, const std::vector<uint8_t>& payload) {
  uint8_t hdr[4];
  uint32_t n = static_cast<uint32_t>(payload.size());
  for (int i = 0; i < 4; ++i) hdr[i] = (n >> (24 - 8 * i)) & 0xFF;
  return send_all(c->fd, hdr, 4) &&
         send_all(c->fd, payload.data(), payload.size());
}

bool recv_frame(Client* c, std::vector<uint8_t>& out) {
  uint8_t hdr[4];
  if (!recv_all(c->fd, hdr, 4)) return false;
  int32_t n = 0;
  for (int i = 0; i < 4; ++i) n = (n << 8) | hdr[i];
  if (n < 0 || n > (1 << 30)) return false;
  out.resize(n);
  return n == 0 || recv_all(c->fd, out.data(), n);
}

// Send header+body, receive the response, verify the correlation id.
// Returns the response bytes after the correlation id in `resp`.
bool request(Client* c, int16_t api, int16_t version, const Writer& body,
             std::vector<uint8_t>& resp) {
  Writer w;
  w.i16(api);
  w.i16(version);
  int32_t corr = ++c->corr;
  w.i32(corr);
  w.str(c->client_id.c_str());
  w.raw(body.buf.data(), body.buf.size());
  if (!send_frame(c, w.buf)) return false;
  std::vector<uint8_t> frame;
  if (!recv_frame(c, frame)) return false;
  Reader r(frame.data(), frame.size());
  if (r.i32() != corr) return false;
  resp.assign(frame.begin() + 4, frame.end());
  return true;
}

}  // namespace

extern "C" {

// Connect (optionally SASL/PLAIN-authenticating, the reference cluster's
// mechanism).  Returns an opaque handle or NULL.
void* iotml_kafka_connect(const char* host, int32_t port,
                          const char* client_id, const char* user,
                          const char* password, double timeout_s) {
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  char portbuf[16];
  snprintf(portbuf, sizeof portbuf, "%d", port);
  if (getaddrinfo(host, portbuf, &hints, &res) != 0 || !res) return nullptr;
  // Non-blocking connect with the caller's deadline: a plain ::connect
  // ignores SO_SNDTIMEO and can block for the kernel TCP timeout.
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
    int rc = ::connect(fd, ai->ai_addr, ai->ai_addrlen);
    if (rc != 0 && errno == EINPROGRESS) {
      pollfd pfd{fd, POLLOUT, 0};
      if (::poll(&pfd, 1, static_cast<int>(timeout_s * 1000)) == 1) {
        int err = 0;
        socklen_t len = sizeof err;
        getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
        rc = err == 0 ? 0 : -1;
      } else {
        rc = -1;  // timeout
      }
    }
    if (rc == 0) {
      fcntl(fd, F_SETFL, flags);  // back to blocking for send/recv timeouts
      break;
    }
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return nullptr;
  timeval tv;
  tv.tv_sec = static_cast<long>(timeout_s);
  tv.tv_usec = static_cast<long>((timeout_s - tv.tv_sec) * 1e6);
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);

  Client* c = new Client;
  c->fd = fd;
  c->client_id = client_id ? client_id : "iotml-native";

  if (user) {
    Writer body;
    body.str("PLAIN");
    std::vector<uint8_t> resp;
    if (!request(c, API_SASL_HANDSHAKE, 0, body, resp)) {
      delete c; ::close(fd); return nullptr;
    }
    Reader r(resp.data(), resp.size());
    if (r.i16() != ERR_NONE) { delete c; ::close(fd); return nullptr; }
    // raw PLAIN token frame (pre-KIP-152): \0 user \0 password
    std::vector<uint8_t> token;
    token.push_back(0);
    token.insert(token.end(), user, user + strlen(user));
    token.push_back(0);
    const char* pw = password ? password : "";
    token.insert(token.end(), pw, pw + strlen(pw));
    std::vector<uint8_t> ok;
    if (!send_frame(c, token) || !recv_frame(c, ok) || !ok.empty()) {
      delete c; ::close(fd); return nullptr;
    }
  }
  return c;
}

void iotml_kafka_close(void* h) {
  Client* c = static_cast<Client*>(h);
  if (!c) return;
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

// Pin the exclusive upper bound on positionally-safe writer ids that the
// fused fetch_decode paths verify before their strip=5 decode (< 0
// disables the check).  Per handle, so the fetch_decode ABI is untouched.
void iotml_kafka_set_pinned_id_limit(void* h, int64_t limit) {
  static_cast<Client*>(h)->pinned_id_limit = limit;
}

// Partition count for one topic (Metadata v1); 0 = unknown topic.
int64_t iotml_kafka_metadata(void* h, const char* topic) {
  Client* c = static_cast<Client*>(h);
  Writer body;
  body.i32(1);
  body.str(topic);
  std::vector<uint8_t> resp;
  if (!request(c, API_METADATA, 1, body, resp)) return K_EIO;
  Reader r(resp.data(), resp.size());
  int32_t n_brokers = r.i32();
  for (int32_t i = 0; i < n_brokers && !r.fail; ++i) {
    r.i32();        // node id
    r.skip_str();   // host
    r.i32();        // port
    r.skip_str();   // rack
  }
  r.i32();  // controller
  int32_t n_topics = r.i32();
  int64_t parts = 0;
  for (int32_t t = 0; t < n_topics && !r.fail; ++t) {
    int16_t err = r.i16();
    std::string name = r.str();
    r.i8();  // is_internal
    int32_t n_parts = r.i32();
    for (int32_t p = 0; p < n_parts && !r.fail; ++p) {
      r.i16();  // err
      r.i32();  // partition id
      r.i32();  // leader
      int32_t nr = r.i32();
      for (int32_t k = 0; k < nr && !r.fail; ++k) r.i32();
      int32_t ni = r.i32();
      for (int32_t k = 0; k < ni && !r.fail; ++k) r.i32();
    }
    if (name == topic && err == ERR_NONE) parts = n_parts;
  }
  return r.fail ? K_EIO : parts;
}

// CreateTopics v0 with an optional cleanup.policy config entry (NULL or
// empty = none).  Returns 0 when created as asked, 1 when the topic
// already existed (the caller refreshes the real partition count).
int64_t iotml_kafka_create_topic(void* h, const char* topic,
                                 int32_t partitions,
                                 const char* cleanup_policy) {
  Client* c = static_cast<Client*>(h);
  Writer body;
  body.i32(1);
  body.str(topic);
  body.i32(partitions);
  body.i16(1);   // replication factor
  body.i32(0);   // replica assignments
  if (cleanup_policy && *cleanup_policy) {
    body.i32(1);  // one config entry
    body.str("cleanup.policy");
    body.str(cleanup_policy);
  } else {
    body.i32(0);  // configs
  }
  body.i32(10000);  // timeout ms
  std::vector<uint8_t> resp;
  if (!request(c, API_CREATE_TOPICS, 0, body, resp)) return K_EIO;
  Reader r(resp.data(), resp.size());
  int32_t n = r.i32();
  int64_t existed = 0;
  for (int32_t i = 0; i < n && !r.fail; ++i) {
    r.skip_str();
    int16_t err = r.i16();
    if (err == ERR_TOPIC_EXISTS) existed = 1;
    else if (err != ERR_NONE) return proto_err(err);
  }
  return r.fail ? K_EIO : existed;
}

// ListOffsets v1: timestamp -1 → end offset, -2 → begin offset.
int64_t iotml_kafka_list_offset(void* h, const char* topic, int32_t partition,
                                int64_t timestamp) {
  Client* c = static_cast<Client*>(h);
  Writer body;
  body.i32(-1);  // replica id
  body.i32(1);
  body.str(topic);
  body.i32(1);
  body.i32(partition);
  body.i64(timestamp);
  std::vector<uint8_t> resp;
  if (!request(c, API_LIST_OFFSETS, 1, body, resp)) return K_EIO;
  Reader r(resp.data(), resp.size());
  int32_t n_topics = r.i32();
  for (int32_t t = 0; t < n_topics && !r.fail; ++t) {
    r.skip_str();
    int32_t n_parts = r.i32();
    for (int32_t p = 0; p < n_parts; ++p) {
      r.i32();  // partition
      int16_t err = r.i16();
      r.i64();  // timestamp
      int64_t off = r.i64();
      if (r.fail) return K_EIO;
      if (err != ERR_NONE) return proto_err(err);
      return off;
    }
  }
  return K_EIO;
}

// Produce v2, one (topic, partition), acks=all.  Values (and optional
// keys) arrive as a contiguous blob + n+1 offsets; value_null (NULL when
// no value is null) marks tombstones, sent as a null value.  Returns the
// broker-assigned base offset of the batch.
int64_t iotml_kafka_produce(void* h, const char* topic, int32_t partition,
                            const uint8_t* values, const int64_t* val_offsets,
                            const uint8_t* value_null, const uint8_t* keys,
                            const int64_t* key_offsets,
                            const uint8_t* key_null,
                            const int64_t* timestamps, int64_t n) {
  Client* c = static_cast<Client*>(h);
  int64_t cap = n * ENTRY_FRAMING + (n ? val_offsets[n] : 0) +
                (keys && n ? key_offsets[n] : 0);
  std::vector<uint8_t> ms(std::max<int64_t>(cap, 1));
  int64_t len = iotml_msgset_encode(values, val_offsets, value_null, keys,
                                    key_offsets, key_null, timestamps,
                                    nullptr, n, ms.data(), cap);
  if (len < 0) return K_EIO;
  Writer body;
  body.i16(-1);     // acks = all
  body.i32(10000);  // timeout
  body.i32(1);
  body.str(topic);
  body.i32(1);
  body.i32(partition);
  body.bytes(ms.data(), static_cast<int32_t>(len));
  std::vector<uint8_t> resp;
  if (!request(c, API_PRODUCE, 2, body, resp)) return K_EIO;
  Reader r(resp.data(), resp.size());
  int32_t n_topics = r.i32();
  int64_t base = K_EIO;
  for (int32_t t = 0; t < n_topics && !r.fail; ++t) {
    r.skip_str();
    int32_t n_parts = r.i32();
    for (int32_t p = 0; p < n_parts && !r.fail; ++p) {
      r.i32();  // partition
      int16_t err = r.i16();
      int64_t b = r.i64();
      r.i64();  // log append time
      if (err != ERR_NONE) return proto_err(err);
      base = b;
    }
  }
  r.i32();  // throttle
  return r.fail ? K_EIO : base;
}

// RAW_PRODUCE (the JAX package's extension, api 65 v0): ship a batch of
// pre-framed store frames the broker appends verbatim.  Returns the base
// offset, or -1035 (UNSUPPORTED_VERSION: the port's server answers so),
// -1002 (CORRUPT_MESSAGE), -1006 (NOT_LEADER), K_EIO on transport death.
int64_t iotml_kafka_produce_raw(void* h, const char* topic,
                                int32_t partition, const uint8_t* frames,
                                int64_t frames_len) {
  Client* c = static_cast<Client*>(h);
  if (!frames || frames_len < 0) return K_EIO;
  Writer body;
  body.str(topic);
  body.i32(partition);
  body.bytes(frames, static_cast<int32_t>(frames_len));
  std::vector<uint8_t> resp;
  if (!request(c, API_RAW_PRODUCE, 0, body, resp)) return K_EIO;
  Reader r(resp.data(), resp.size());
  int16_t err = r.i16();
  if (err != ERR_NONE) return proto_err(err);
  int64_t base = r.i64();
  r.i32();  // count
  return r.fail ? K_EIO : base;
}

// Fetch v2 into the handle's staging area.  Returns the messages staged
// (>= 0) or an error.  Staged data is then read out through
// iotml_kafka_staged_* / iotml_kafka_take, or decoded in place by
// iotml_kafka_fetch_decode.
int64_t iotml_kafka_fetch(void* h, const char* topic, int32_t partition,
                          int64_t offset, int64_t max_messages) {
  Client* c = static_cast<Client*>(h);
  c->staged.clear();
  Writer body;
  body.i32(-1);       // replica
  body.i32(0);        // max wait ms
  body.i32(1);        // min bytes
  body.i32(1);
  body.str(topic);
  body.i32(1);
  body.i32(partition);
  body.i64(offset);
  body.i32(4 << 20);  // max bytes
  std::vector<uint8_t> resp;
  if (!request(c, API_FETCH, 2, body, resp)) return K_EIO;
  Reader r(resp.data(), resp.size());
  r.i32();  // throttle
  int32_t n_topics = r.i32();
  for (int32_t t = 0; t < n_topics && !r.fail; ++t) {
    r.skip_str();
    int32_t n_parts = r.i32();
    for (int32_t p = 0; p < n_parts; ++p) {
      r.i32();  // partition id
      int16_t err = r.i16();
      int64_t hwm = r.i64();
      const uint8_t* ms;
      int32_t msn = r.bytes(&ms);
      if (r.fail) return K_EIO;
      if (err == 1 /*OFFSET_OUT_OF_RANGE*/) {
        // retention trimmed the log head past this offset; the server
        // rides the EARLIEST retained offset in the hwm slot, so the
        // caller resets without a second round trip
        c->staged_high_watermark = hwm;
        return proto_err(err);
      }
      if (err != ERR_NONE) return proto_err(err);
      c->staged_high_watermark = hwm;
      if (msn > 0 &&
          !stage_message_set(c->staged, ms, msn, offset, max_messages))
        return K_EMSGSET;
    }
  }
  return c->staged.n;
}

// Value and key bytes of the staged messages; returns the staged count.
int64_t iotml_kafka_staged_bytes(void* h, int64_t* value_bytes,
                                 int64_t* key_bytes) {
  const Staged& s = static_cast<Client*>(h)->staged;
  int64_t lo = s.first, hi = s.first + s.n;
  if (value_bytes) *value_bytes = s.n ? s.val_off[hi] - s.val_off[lo] : 0;
  if (key_bytes) *key_bytes = s.n ? s.key_off[hi] - s.key_off[lo] : 0;
  return s.n;
}

// Value-null flags of the staged messages (1 byte each).  Read BEFORE
// iotml_kafka_take (take clears the staging area); returns the count.
int64_t iotml_kafka_staged_value_nulls(void* h, uint8_t* out) {
  const Staged& s = static_cast<Client*>(h)->staged;
  for (int64_t i = 0; i < s.n; ++i) out[i] = s.val_null[s.first + i];
  return s.n;
}

int64_t iotml_kafka_high_watermark(void* h) {
  return static_cast<Client*>(h)->staged_high_watermark;
}

// Copy the staged messages out as contiguous blobs + n+1 offset arrays;
// key_null (1 byte a message) tells a null key from an empty one.
int64_t iotml_kafka_take(void* h, uint8_t* values, int64_t* val_offsets,
                         uint8_t* keys, int64_t* key_offsets,
                         uint8_t* key_null, int64_t* msg_offsets,
                         int64_t* timestamps) {
  Staged& s = static_cast<Client*>(h)->staged;
  int64_t lo = s.first, n = s.n;
  if (n) {
    memcpy(values, s.values.data() + s.val_off[lo],
           s.val_off[lo + n] - s.val_off[lo]);
    memcpy(keys, s.keys.data() + s.key_off[lo],
           s.key_off[lo + n] - s.key_off[lo]);
  }
  for (int64_t i = 0; i <= n; ++i) {
    val_offsets[i] = s.val_off[lo + i] - s.val_off[lo];
    key_offsets[i] = s.key_off[lo + i] - s.key_off[lo];
  }
  for (int64_t i = 0; i < n; ++i) {
    key_null[i] = s.key_null[lo + i];
    msg_offsets[i] = s.offsets[lo + i];
    timestamps[i] = s.ts[lo + i];
  }
  s.clear();
  return n;
}

// The fused hot path: fetch + framing strip + columnar Avro decode in one
// native call.  Decodes at most max_rows messages from `offset` into
// out_numeric / out_labels (layouts as in iotml_decode_batch) and, when
// out_keys is not NULL, each message's key (key_stride bytes a row,
// zero-padded, cut at key_stride - 1).  *next_offset receives the cursor
// after the last decoded message.  Returns rows decoded (0 = nothing at
// `offset`), or a negative error (a decode failure is -(row + 1) - 2000).
int64_t iotml_kafka_fetch_decode_keys(
    void* h, const char* topic, int32_t partition, int64_t offset,
    const int8_t* types, const uint8_t* nullable, int64_t n_fields,
    int64_t strip, double* out_numeric, char* out_labels,
    int64_t label_stride, char* out_keys, int64_t key_stride,
    int64_t max_rows, int64_t* next_offset) {
  Client* c = static_cast<Client*>(h);
  int64_t n = iotml_kafka_fetch(h, topic, partition, offset, max_rows);
  *next_offset = offset;
  if (n <= 0) return n;
  Staged& s = c->staged;
  const int64_t lo = s.first;
  // The guard behind the blind Confluent strip: decode only the prefix of
  // messages whose 5-byte header is a pinned writer id; the first evolved
  // frame ends the batch, so the caller's cursor lands exactly on it.
  if (strip == 5 && c->pinned_id_limit >= 0) {
    int64_t ok = 0;
    for (; ok < n; ++ok) {
      int64_t i = lo + ok;
      const uint8_t* v = s.value(i);
      if (s.val_null[i] || s.value_len(i) < 5 || v[0] != 0) break;
      int64_t sid = (int64_t(v[1]) << 24) | (int64_t(v[2]) << 16) |
                    (int64_t(v[3]) << 8) | int64_t(v[4]);
      if (sid >= c->pinned_id_limit) break;
    }
    if (ok == 0) {
      s.clear();
      return K_ESCHEMA;
    }
    n = ok;
  }
  if (out_keys) {
    for (int64_t i = 0; i < n; ++i) {
      char* krow = out_keys + i * key_stride;
      memset(krow, 0, key_stride);
      int64_t kn = s.key_null[lo + i]
                       ? 0
                       : s.key_off[lo + i + 1] - s.key_off[lo + i];
      kn = std::min(kn, key_stride - 1);
      if (kn > 0) memcpy(krow, s.keys.data() + s.key_off[lo + i], kn);
    }
  }
  // the staged value blob and its offsets are the Avro decoder's layout
  int64_t rc = iotml_decode_batch(s.values.data(), s.val_off.data() + lo, n,
                                  types, nullable, n_fields, strip,
                                  out_numeric, out_labels, label_stride);
  int64_t next = s.offsets[lo + n - 1] + 1;
  s.clear();
  if (rc < 0) return rc - 2000;
  *next_offset = next;
  return rc;
}

// The keyless form: one implementation, keys skipped.
int64_t iotml_kafka_fetch_decode(void* h, const char* topic,
                                 int32_t partition, int64_t offset,
                                 const int8_t* types, const uint8_t* nullable,
                                 int64_t n_fields, int64_t strip,
                                 double* out_numeric, char* out_labels,
                                 int64_t label_stride, int64_t max_rows,
                                 int64_t* next_offset) {
  return iotml_kafka_fetch_decode_keys(h, topic, partition, offset, types,
                                       nullable, n_fields, strip,
                                       out_numeric, out_labels,
                                       label_stride, nullptr, 0, max_rows,
                                       next_offset);
}

// OffsetCommit v2, simple-consumer style (generation -1, empty member):
// many partitions of ONE topic in a single request.
int64_t iotml_kafka_commit_many(void* h, const char* group,
                                const char* topic,
                                const int32_t* partitions,
                                const int64_t* next_offsets, int64_t n) {
  Client* c = static_cast<Client*>(h);
  Writer body;
  body.str(group);
  body.i32(-1);   // generation
  body.str("");   // member id
  body.i64(-1);   // retention: broker default
  body.i32(1);
  body.str(topic);
  body.i32(static_cast<int32_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    body.i32(partitions[i]);
    body.i64(next_offsets[i]);
    body.null_str();  // metadata
  }
  std::vector<uint8_t> resp;
  if (!request(c, API_OFFSET_COMMIT, 2, body, resp)) return K_EIO;
  Reader r(resp.data(), resp.size());
  int32_t n_topics = r.i32();
  for (int32_t t = 0; t < n_topics && !r.fail; ++t) {
    r.skip_str();
    int32_t n_parts = r.i32();
    for (int32_t p = 0; p < n_parts && !r.fail; ++p) {
      r.i32();
      int16_t err = r.i16();
      if (err != ERR_NONE) return proto_err(err);
    }
  }
  return r.fail ? K_EIO : 0;
}

int64_t iotml_kafka_commit(void* h, const char* group, const char* topic,
                           int32_t partition, int64_t next_offset) {
  return iotml_kafka_commit_many(h, group, topic, &partition,
                                 &next_offset, 1);
}

// OffsetFetch v1 → the committed next offset, or -1 when there is none.
int64_t iotml_kafka_committed(void* h, const char* group, const char* topic,
                              int32_t partition) {
  Client* c = static_cast<Client*>(h);
  Writer body;
  body.str(group);
  body.i32(1);
  body.str(topic);
  body.i32(1);
  body.i32(partition);
  std::vector<uint8_t> resp;
  if (!request(c, API_OFFSET_FETCH, 1, body, resp)) return K_EIO;
  Reader r(resp.data(), resp.size());
  int32_t n_topics = r.i32();
  for (int32_t t = 0; t < n_topics && !r.fail; ++t) {
    r.skip_str();
    int32_t n_parts = r.i32();
    for (int32_t p = 0; p < n_parts; ++p) {
      r.i32();
      int64_t off = r.i64();
      r.skip_str();  // metadata
      int16_t err = r.i16();
      if (r.fail) return K_EIO;
      if (err != ERR_NONE) return proto_err(err);
      return off;  // -1 = no committed offset
    }
  }
  return K_EIO;
}

}  // extern "C"
