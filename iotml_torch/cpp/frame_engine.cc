// iotml_torch native stream engine: the WRITE half of the store-frame
// codec (a copy of the JAX package's iotml/cpp/frame_engine.cc: its
// crc32c, write_frame and iotml_frames_encode_values).
//
// One segmented-log frame (store/segment.py layout), all big-endian:
//
//     u32 length | u32 crc32c | u8 attrs | i64 offset | i64 ts |
//     i32 key_len | key | u32 value_len | value | [headers]
//
// where the CRC32C (Castagnoli) covers every byte after the crc field.
// Two entry points:
//   iotml_crc32c                 CRC32C of a buffer, continuing `crc` (the
//                                store's checksum: segment frames, the
//                                offsets file, the remote tier's blobs);
//   iotml_frames_encode_values   opaque value bytes -> contiguous,
//                                ready-to-append store frames stamped
//                                base_offset + i (the durable broker's
//                                fused produce_many framing).
// Byte parity with store/segment.py's encode_record (the plain version)
// and with the JAX package's frames is pinned by the tests.  Frames with
// headers are never framed here: the traced path keeps the per-record
// Python encoder.
//
// The decode, columnar encode, restamp and validate entries of the JAX
// engine are not in this copy.

#include <cstdint>
#include <cstring>

namespace {

// frame geometry (store/segment.py): length prefix + fixed head
constexpr int64_t kLenSize = 4;
constexpr int64_t kHeadSize = 4 + 1 + 8 + 8 + 4;  // crc, attrs, offset, ts, key_len
constexpr uint8_t kAttrNullValue = 0x02;

// ---------------------------------------------------------------- crc32c
// Castagnoli (reflected 0x82F63B78); the table is built once, thread-safe
// (a function-local static).  The plain version is store/segment.py's
// _crc32c_py.
struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
      t[i] = crc;
    }
  }
};

inline const uint32_t* crc32c_table() {
  static const Crc32cTable table;
  return table.t;
}

inline uint32_t crc32c_extend(uint32_t crc, const uint8_t* data, int64_t n) {
  const uint32_t* table = crc32c_table();
  crc ^= 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i)
    crc = table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

inline void put32(uint8_t* p, uint32_t v) {
  p[0] = (v >> 24) & 0xFF;
  p[1] = (v >> 16) & 0xFF;
  p[2] = (v >> 8) & 0xFF;
  p[3] = v & 0xFF;
}

inline void put64(uint8_t* p, uint64_t v) {
  put32(p, static_cast<uint32_t>(v >> 32));
  put32(p + 4, static_cast<uint32_t>(v));
}

// One store frame around a ready value (or tombstone), byte-identical
// to store/segment.py encode_record.  Returns bytes written, or -1 if
// `cap` is too small.  `value_null` frames a tombstone (attrs bit 1,
// value_len 0), byte-distinct from an empty value.
int64_t write_frame(uint8_t* out, int64_t cap, int64_t offset, int64_t ts,
                    const uint8_t* key, int64_t key_len, bool key_null,
                    const uint8_t* value, int64_t value_len,
                    bool value_null) {
  if (value_null) value_len = 0;
  int64_t body = kHeadSize + (key_null ? 0 : key_len) + 4 + value_len;
  if (kLenSize + body > cap) return -1;
  put32(out, static_cast<uint32_t>(body));
  uint8_t* b = out + kLenSize;
  b[4] = value_null ? kAttrNullValue : 0;  // attrs: headers never framed here
  put64(b + 5, static_cast<uint64_t>(offset));
  put64(b + 13, static_cast<uint64_t>(ts));
  put32(b + 21, static_cast<uint32_t>(key_null ? -1 : key_len));
  uint8_t* p = b + kHeadSize;
  if (!key_null && key_len > 0) std::memcpy(p, key, key_len);
  if (!key_null) p += key_len;
  put32(p, static_cast<uint32_t>(value_len));
  p += 4;
  if (value_len > 0) std::memcpy(p, value, value_len);
  put32(b, crc32c_extend(0, b + 4, body - 4));
  return kLenSize + body;
}

}  // namespace

extern "C" {

// CRC32C of data[0:n], continuing `crc` (0 starts a new checksum), as
// google_crc32c.extend(crc, data) computes it.
uint32_t iotml_crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
  if (n <= 0) return crc;
  return crc32c_extend(crc, data, n);
}

// Opaque-value framing: [(key, value, ts)] columnar blobs -> contiguous
// store frames stamped base_offset + i.  key_null / value_null mark null
// keys and tombstones (either may be NULL: nothing null); keys and
// key_offsets both NULL frame every key null.  Returns frame bytes, or
// -1 on overflow of out_capacity.
int64_t iotml_frames_encode_values(
    const uint8_t* values, const int64_t* value_offsets,
    const uint8_t* keys, const int64_t* key_offsets,
    const uint8_t* key_null, const uint8_t* value_null,
    const int64_t* timestamps, int64_t n_msgs, int64_t base_offset,
    uint8_t* out, int64_t out_capacity) {
  if (n_msgs < 0 || !out || !value_offsets) return -1;
  int64_t pos = 0;
  for (int64_t i = 0; i < n_msgs; ++i) {
    bool knull = true;
    const uint8_t* kp = nullptr;
    int64_t kn = 0;
    if (keys && key_offsets) {
      knull = key_null != nullptr && key_null[i] != 0;
      kp = keys + key_offsets[i];
      kn = key_offsets[i + 1] - key_offsets[i];
    }
    bool vnull = value_null != nullptr && value_null[i] != 0;
    int64_t wrote = write_frame(
        out + pos, out_capacity - pos, base_offset + i,
        timestamps ? timestamps[i] : 0, kp, kn, knull,
        values + value_offsets[i], value_offsets[i + 1] - value_offsets[i],
        vnull);
    if (wrote < 0) return -1;
    pos += wrote;
  }
  return pos;
}

}  // extern "C"
