// iotml_torch native stream engine: Kafka MessageSet v1 codec (a copy of
// the standalone msgset half of the JAX package's iotml/cpp/kafka_client.cc,
// with the CRC-32, Writer and Reader helpers it needs).
//
// MessageSet v1 entry, all big-endian:
//   offset i64 | size i32 | crc u32 | magic i8 (1) | attributes i8 (0)
//   | timestamp i64 | key BYTES | value BYTES
// where BYTES is an i32 length (-1 = null) and the bytes, and the CRC-32
// covers magic..value.  The wire client's produce requests and the wire
// server's fetch responses carry one set per partition; the pure-Python
// codec in stream/kafka_wire.py is the plain version and the tests hold
// the bytes equal.
//
// One change from the JAX copy: encode takes a val_null column (NULL when
// no value is null), so a tombstone (null value) is encoded here too and
// no encode call needs the pure codec.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- crc32
uint32_t crc32_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc32_table[i] = c;
    }
  }
} crc_init;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc32_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------ buffers
struct Writer {
  std::vector<uint8_t> buf;
  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf.insert(buf.end(), b, b + n);
  }
  void i8(int8_t v) { buf.push_back(static_cast<uint8_t>(v)); }
  void i32(int32_t v) {
    for (int s = 24; s >= 0; s -= 8) buf.push_back((v >> s) & 0xFF);
  }
  void u32(uint32_t v) {
    for (int s = 24; s >= 0; s -= 8) buf.push_back((v >> s) & 0xFF);
  }
  void i64(int64_t v) {
    for (int s = 56; s >= 0; s -= 8) buf.push_back((v >> s) & 0xFF);
  }
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
  int32_t i32() {
    if (!need(4)) return 0;
    int32_t v = 0;
    for (int i = 0; i < 4; ++i) v = (v << 8) | buf[pos++];
    return v;
  }
  uint32_t u32() { return static_cast<uint32_t>(i32()); }
  int64_t i64() {
    if (!need(8)) return 0;
    int64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | buf[pos++];
    return v;
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

}  // namespace

extern "C" {

// Encode n records (columnar) into out_buf.  keys / key_off / key_null
// may be NULL (every key null), val_null may be NULL (no value null),
// offsets may be NULL (all 0, the client-produce convention).  Returns
// bytes written, or -(needed) when out_cap is too small (the caller
// calls again with a buffer of that size).
int64_t iotml_msgset_encode(const uint8_t* values, const int64_t* val_off,
                            const uint8_t* val_null, const uint8_t* keys,
                            const int64_t* key_off, const uint8_t* key_null,
                            const int64_t* timestamps,
                            const int64_t* offsets, int64_t n,
                            uint8_t* out_buf, int64_t out_cap) {
  Writer w;
  w.buf.reserve(static_cast<size_t>(
      n * 34 + (n ? val_off[n] : 0) + (keys && n ? key_off[n] : 0)));
  for (int64_t i = 0; i < n; ++i) {
    Writer body;
    body.i8(1);  // magic 1
    body.i8(0);  // attributes
    body.i64(timestamps ? timestamps[i] : 0);
    if (keys && !(key_null && key_null[i])) {
      body.bytes(keys + key_off[i],
                 static_cast<int32_t>(key_off[i + 1] - key_off[i]));
    } else {
      body.bytes(nullptr, -1);
    }
    if (val_null && val_null[i]) {
      body.bytes(nullptr, -1);
    } else {
      body.bytes(values + val_off[i],
                 static_cast<int32_t>(val_off[i + 1] - val_off[i]));
    }
    w.i64(offsets ? offsets[i] : 0);
    w.i32(static_cast<int32_t>(body.buf.size() + 4));
    w.u32(crc32(body.buf.data(), body.buf.size()));
    w.raw(body.buf.data(), body.buf.size());
  }
  int64_t total = static_cast<int64_t>(w.buf.size());
  if (total > out_cap) return -total;
  if (total) memcpy(out_buf, w.buf.data(), total);
  return total;
}

// Decode up to max_n records into columnar outputs.  Returns the record
// count; -1 on CRC mismatch / an entry size under 14; -2 when the caller's
// key/value capacity is too small.  A truncated trailing record is
// dropped, as the pure decoder drops it (Kafka fetch responses may carry
// partial tails).  Null keys set key_null=1; null values decode as empty
// with val_null=1 so the caller can keep None apart from b"".
int64_t iotml_msgset_decode(const uint8_t* buf, int64_t len, int64_t max_n,
                            int64_t* offsets, int64_t* ts,
                            int64_t* key_off, uint8_t* key_null,
                            uint8_t* keys, int64_t keys_cap,
                            int64_t* val_off, uint8_t* val_null,
                            uint8_t* values, int64_t values_cap) {
  Reader r(buf, static_cast<size_t>(len));
  int64_t n = 0;
  int64_t kpos = 0, vpos = 0;
  key_off[0] = 0;
  val_off[0] = 0;
  while (r.pos + 12 <= static_cast<size_t>(len) && n < max_n) {
    int64_t offset = r.i64();
    int32_t size = r.i32();
    // 14 bytes is the smallest body (crc, magic, attributes, two
    // lengths): a smaller size would move the reads past the entry's end
    if (size < 14) return -1;
    if (r.pos + static_cast<size_t>(size) > static_cast<size_t>(len)) {
      break;  // partial trailing message
    }
    size_t end = r.pos + size;
    uint32_t crc = r.u32();
    if (crc32(buf + r.pos, end - r.pos) != crc) return -1;
    int8_t magic = r.i8();
    r.i8();  // attributes (no compression in this subset)
    int64_t t = magic >= 1 ? r.i64() : 0;
    const uint8_t* kp;
    int32_t kn = r.bytes(&kp);
    const uint8_t* vp;
    int32_t vn = r.bytes(&vp);
    if (r.fail) return -1;
    r.pos = end;
    if (kn > 0 && kpos + kn > keys_cap) return -2;
    if (vn > 0 && vpos + vn > values_cap) return -2;
    offsets[n] = offset;
    ts[n] = t;
    key_null[n] = kn < 0;
    if (kn > 0) {
      memcpy(keys + kpos, kp, kn);
      kpos += kn;
    }
    key_off[n + 1] = kpos;
    val_null[n] = vn < 0;
    if (vn > 0) {
      memcpy(values + vpos, vp, vn);
      vpos += vn;
    }
    val_off[n + 1] = vpos;
    ++n;
  }
  return n;
}

}  // extern "C"
