// iotml_torch native stream engine: the store-frame codec, both
// directions (a copy of the JAX package's iotml/cpp/frame_engine.cc).
//
// One segmented-log frame (store/segment.py layout), all big-endian:
//
//     u32 length | u32 crc32c | u8 attrs | i64 offset | i64 ts |
//     i32 key_len | key | u32 value_len | value | [headers]
//
// where the CRC32C (Castagnoli) covers every byte after the crc field.
// Entry points:
//   iotml_crc32c                     CRC32C of a buffer, continuing `crc`
//                                    (the store's checksum: segment
//                                    frames, the offsets file, the remote
//                                    tier's blobs);
//   iotml_frames_decode_columnar_ts  a raw batch of frames -> caller-owned
//   iotml_frames_decode_columnar     float32 / fixed-stride label / key
//                                    columns, CRC-verified, the Confluent
//                                    writer id checked against the pinned
//                                    band (the columnar ring's decoder;
//                                    the _ts form also reports the event
//                                    time bounds of what it consumed);
//   iotml_frames_encode_columnar     columnar rows -> Confluent-framed
//                                    Avro values -> ready-to-append frames
//                                    in one call (the KSQL JSON leg's raw
//                                    produce);
//   iotml_frames_encode_values       opaque value bytes -> frames stamped
//                                    base_offset + i (the durable
//                                    broker's fused produce_many, the
//                                    MQTT bridge's raw leg);
//   iotml_frames_restamp             RAW_PRODUCE landing: CRC-validate a
//                                    pre-framed batch whole and stamp the
//                                    log offsets into the heads (CRCs
//                                    recomputed in place);
//   iotml_frames_validate            CRC + offset-monotonicity walk.
// Byte parity with store/segment.py's encode_record / scan_records (the
// plain versions, with ops/framing.py's *_py functions) and with the JAX
// package's engine is pinned by the tests.  Frames with headers are never
// framed here: the traced path keeps the per-record Python encoder.
//
// Decoding always stops BEFORE the frame that ends it, so the caller's
// cursor lands exactly on it:
//   - a torn or corrupt frame (short buffer, bad CRC, malformed Avro):
//     FRAMES_STOP_TORN, the crash-recovery contract;
//   - a value that is not magic-0 Confluent-framed, or whose writer id is
//     at or above the pinned limit (an evolved writer):
//     FRAMES_STOP_SCHEMA, the caller resolves that chunk by name;
//   - the caller's buffers are full (cap_rows).
// Tombstones (attrs bit 1) carry no payload: skipped and counted.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// frame geometry (store/segment.py): length prefix + fixed head
constexpr int64_t kLenSize = 4;
constexpr int64_t kHeadSize = 4 + 1 + 8 + 8 + 4;  // crc, attrs, offset, ts, key_len
constexpr int64_t kMinBody = kHeadSize + 4;       // + value_len
constexpr uint8_t kAttrNullValue = 0x02;

enum FieldType : int8_t {
  FR_FLOAT = 0,
  FR_DOUBLE = 1,
  FR_INT = 2,
  FR_LONG = 3,
  FR_STRING = 4,
  FR_BOOLEAN = 5,
};

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

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int64_t be64(const uint8_t* p) {
  return (int64_t(be32(p)) << 32) | int64_t(be32(p + 4));
}

// Avro zigzag varint (same contract as avro_engine.cc's reader).
inline int64_t frame_read_varint(const uint8_t* buf, int64_t pos,
                                 int64_t end, int64_t* out) {
  uint64_t acc = 0;
  int shift = 0;
  while (pos < end) {
    uint8_t b = buf[pos++];
    if (shift == 63 && (b & 0x7E)) return -1;
    acc |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
      return pos;
    }
    shift += 7;
    if (shift > 63) return -1;
  }
  return -1;
}

// Avro-decode one record body into a float32 numeric row + fixed-stride
// label slots.  Returns true on success.  float32 by contract: the
// device batch is float32, and a single double→float rounding here is
// bit-identical to numpy's astype on the Python oracle path.
bool decode_avro_row(const uint8_t* buf, int64_t pos, int64_t end,
                     const int8_t* types, const uint8_t* nullable,
                     int64_t n_fields, float* num_row, char* lab_row,
                     int64_t label_stride) {
  int64_t ncol = 0, scol = 0;
  for (int64_t f = 0; f < n_fields; ++f) {
    bool is_null = false;
    if (nullable[f]) {
      int64_t branch;
      pos = frame_read_varint(buf, pos, end, &branch);
      if (pos < 0) return false;
      is_null = (branch == 0);
    }
    switch (types[f]) {
      case FR_FLOAT: {
        float v = 0.0f;
        if (!is_null) {
          if (pos + 4 > end) return false;
          std::memcpy(&v, buf + pos, 4);
          pos += 4;
        }
        num_row[ncol++] = v;
        break;
      }
      case FR_DOUBLE: {
        double v = 0.0;
        if (!is_null) {
          if (pos + 8 > end) return false;
          std::memcpy(&v, buf + pos, 8);
          pos += 8;
        }
        num_row[ncol++] = static_cast<float>(v);
        break;
      }
      case FR_INT:
      case FR_LONG: {
        int64_t v = 0;
        if (!is_null) {
          pos = frame_read_varint(buf, pos, end, &v);
          if (pos < 0) return false;
        }
        num_row[ncol++] = static_cast<float>(static_cast<double>(v));
        break;
      }
      case FR_BOOLEAN: {
        float v = 0.0f;
        if (!is_null) {
          if (pos + 1 > end) return false;
          v = buf[pos++] ? 1.0f : 0.0f;
        }
        num_row[ncol++] = v;
        break;
      }
      case FR_STRING: {
        char* slot = lab_row + scol * label_stride;
        ++scol;
        if (is_null) {
          slot[0] = '\0';
          break;
        }
        int64_t len;
        pos = frame_read_varint(buf, pos, end, &len);
        if (pos < 0 || len < 0 || pos + len > end) return false;
        int64_t copy = len < label_stride - 1 ? len : label_stride - 1;
        std::memcpy(slot, buf + pos, copy);
        slot[copy] = '\0';
        pos += len;
        break;
      }
      default:
        return false;
    }
  }
  return true;
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

// flag bits reported through *out_flags
enum FrameFlags : int64_t {
  FRAMES_STOP_TORN = 1,      // torn/corrupt frame parked the scan
  FRAMES_STOP_SCHEMA = 2,    // Confluent schema id != expect_schema_id
};

// Decode a raw batch of store frames into columnar buffers.
//
//   buf/buf_len: contiguous frame bytes (a segment byte range, a wire
//       RAW_FETCH payload, or the in-memory broker's re-framed batch).  May
//       begin with frames below start_offset (sparse-index alignment:
//       skipped after CRC verification) and end mid-frame (the torn
//       tail ends the batch, exactly like crash recovery).
//   start_offset: frames with offset < start_offset are skipped.
//   types/nullable/n_fields: the reader schema's compiled descriptors.
//   pinned_id_limit: the EXCLUSIVE upper bound on positionally-safe
//       Confluent writer ids (>= 0).  Registry-allocated v1-compatible
//       schemas get small ids; EVOLVED writer schemas live in the
//       reserved band at/above core.schema.RESERVED_ID_BASE — a
//       value that is not magic-0 framed, or whose id is >= this limit,
//       stops the scan with FRAMES_STOP_SCHEMA (the caller resolves by
//       name in Python; nothing is blind-stripped).  < 0 decodes the
//       value as BARE Avro (no header, no strip) — the store-native
//       form.
//   out_numeric: [cap_rows x n_numeric] float32, row-major.
//   out_labels/label_stride: string fields, NUL-terminated slots.
//   out_keys/key_stride: optional (NULL) per-row message key copies,
//       zero-padded, truncated at stride-1 (the routing identity).
//   out_next_offset: cursor after the last CONSUMED frame (decoded or
//       skipped-tombstone); unchanged when nothing was consumed.
//   out_flags / out_skipped: stop reason bits; tombstones skipped.
//
//   out_ts_min / out_ts_max (the _ts variant): event-time bounds (ms)
//       over the frames CONSUMED at/after start_offset this call —
//       decoded rows and skipped tombstones alike (both advance the
//       stream's event-time watermark).  -1 when nothing was consumed.
//       This is the zero-per-record-cost watermark source: the
//       timestamps are already in every frame head, so batch min/max
//       falls out of the walk the decoder does anyway.
//
// Returns rows decoded (>= 0), or -1 on invalid arguments.
int64_t iotml_frames_decode_columnar_ts(
    const uint8_t* buf, int64_t buf_len, int64_t start_offset,
    const int8_t* types, const uint8_t* nullable, int64_t n_fields,
    int64_t pinned_id_limit, float* out_numeric, char* out_labels,
    int64_t label_stride, char* out_keys, int64_t key_stride,
    int64_t cap_rows, int64_t* out_next_offset, int64_t* out_flags,
    int64_t* out_skipped, int64_t* out_ts_min, int64_t* out_ts_max) {
  if (!buf || !types || !nullable || !out_numeric || !out_labels ||
      label_stride < 1 || cap_rows < 0 || (out_keys && key_stride < 1))
    return -1;
  int64_t n_numeric = 0, n_strings = 0;
  for (int64_t f = 0; f < n_fields; ++f) {
    if (types[f] == FR_STRING) ++n_strings; else ++n_numeric;
  }
  int64_t rows = 0, skipped = 0, flags = 0;
  int64_t pos = 0;
  int64_t next_offset = start_offset;
  int64_t ts_min = -1, ts_max = -1;
  while (rows < cap_rows) {
    if (pos + kLenSize > buf_len) break;  // clean end of buffer
    int64_t length = static_cast<int64_t>(be32(buf + pos));
    int64_t body = pos + kLenSize;
    int64_t end = body + length;
    if (length < kMinBody || end > buf_len) {
      flags |= FRAMES_STOP_TORN;  // torn tail / corrupt length prefix
      break;
    }
    uint32_t crc = be32(buf + body);
    if (crc32c_extend(0, buf + body + 4, length - 4) != crc) {
      flags |= FRAMES_STOP_TORN;  // corrupt frame: recovery's contract
      break;
    }
    uint8_t attrs = buf[body + 4];
    int64_t offset = be64(buf + body + 5);
    int64_t ts = be64(buf + body + 13);
    int32_t key_len = static_cast<int32_t>(be32(buf + body + 21));
    int64_t p = body + kHeadSize;
    const uint8_t* key = nullptr;
    int64_t kn = 0;
    if (key_len >= 0) {
      key = buf + p;
      kn = key_len;
      p += key_len;
    }
    if (p + 4 > end) {
      flags |= FRAMES_STOP_TORN;
      break;
    }
    int64_t value_len = static_cast<int64_t>(be32(buf + p));
    p += 4;
    if (p + value_len > end) {
      flags |= FRAMES_STOP_TORN;
      break;
    }
    if (offset < start_offset) {
      pos = end;  // sparse-index alignment: before the requested cursor
      continue;
    }
    if (attrs & kAttrNullValue) {
      // tombstone: no Avro payload to decode; consumed, counted — and
      // it still advances the event-time watermark
      ++skipped;
      next_offset = offset + 1;
      if (ts_min < 0 || ts < ts_min) ts_min = ts;
      if (ts > ts_max) ts_max = ts;
      pos = end;
      continue;
    }
    int64_t vpos = p;
    int64_t vend = p + value_len;
    if (pinned_id_limit >= 0) {
      if (value_len < 5 || buf[vpos] != 0 ||
          static_cast<int64_t>(be32(buf + vpos + 1)) >= pinned_id_limit) {
        flags |= FRAMES_STOP_SCHEMA;  // evolved writer: resolve in Python
        break;
      }
      vpos += 5;  // Confluent header verified, not blind-stripped
    }
    float* num_row = out_numeric + rows * n_numeric;
    char* lab_row = out_labels + rows * n_strings * label_stride;
    if (!decode_avro_row(buf, vpos, vend, types, nullable, n_fields,
                         num_row, lab_row, label_stride)) {
      flags |= FRAMES_STOP_TORN;  // malformed Avro inside a valid frame
      break;
    }
    if (out_keys) {
      char* krow = out_keys + rows * key_stride;
      std::memset(krow, 0, key_stride);
      if (key && kn > 0) {
        int64_t copy = kn < key_stride - 1 ? kn : key_stride - 1;
        std::memcpy(krow, key, copy);
      }
    }
    ++rows;
    next_offset = offset + 1;
    if (ts_min < 0 || ts < ts_min) ts_min = ts;
    if (ts > ts_max) ts_max = ts;
    pos = end;
  }
  if (out_next_offset) *out_next_offset = next_offset;
  if (out_flags) *out_flags = flags;
  if (out_skipped) *out_skipped = skipped;
  if (out_ts_min) *out_ts_min = ts_min;
  if (out_ts_max) *out_ts_max = ts_max;
  return rows;
}

// The same decode without the event-time out-params (the JAX engine's
// older entry, kept with its signature).
int64_t iotml_frames_decode_columnar(
    const uint8_t* buf, int64_t buf_len, int64_t start_offset,
    const int8_t* types, const uint8_t* nullable, int64_t n_fields,
    int64_t pinned_id_limit, float* out_numeric, char* out_labels,
    int64_t label_stride, char* out_keys, int64_t key_stride,
    int64_t cap_rows, int64_t* out_next_offset, int64_t* out_flags,
    int64_t* out_skipped) {
  return iotml_frames_decode_columnar_ts(
      buf, buf_len, start_offset, types, nullable, n_fields,
      pinned_id_limit, out_numeric, out_labels, label_stride, out_keys,
      key_stride, cap_rows, out_next_offset, out_flags, out_skipped,
      nullptr, nullptr);
}

// avro_engine.cc's columnar Avro encoder, linked into the same .so —
// the value bytes of the fused produce leg come from the ONE encoder.
int64_t iotml_encode_batch_nulls(const double* numeric, const char* labels,
                                 int64_t label_stride, int64_t n_msgs,
                                 const int8_t* types, const uint8_t* nullable,
                                 int64_t n_fields, int64_t frame_schema_id,
                                 uint8_t* out, int64_t out_capacity,
                                 int64_t* out_offsets, const uint8_t* nulls);

// Fused produce leg: columnar rows → Confluent-framed Avro values →
// contiguous ready-to-append store frames.  Offsets are stamped
// base_offset + i (a producing client passes 0 and the broker restamps
// at append; an in-process caller holding the log end passes it
// directly so no restamp pass is needed).
//
//   numeric/labels/nulls: the columnar row layout of
//       iotml_encode_batch_nulls (avro_engine.cc) — nulls may be NULL.
//   keys/key_offsets/key_null: optional per-row message keys.  All
//       NULL = every key null (the unkeyed stream case).  With
//       key_offsets NULL but key_stride > 0, `keys` is a FIXED-STRIDE
//       [n x key_stride] block of NUL-terminated entries (an S-dtype
//       numpy column — the zero-per-record-object produce form).
//   timestamps: per-row record timestamps (ms).
//   schema_id: Confluent header id (>= 0) — the ONE framing point.
// Returns total frame bytes written into `out`, or -1 on overflow /
// impossible null.
int64_t iotml_frames_encode_columnar(
    const double* numeric, const char* labels, int64_t label_stride,
    int64_t n_msgs, const int8_t* types, const uint8_t* nullable,
    int64_t n_fields, int64_t schema_id, const uint8_t* nulls,
    const uint8_t* keys, const int64_t* key_offsets, int64_t key_stride,
    const uint8_t* key_null, const int64_t* timestamps,
    int64_t base_offset, uint8_t* out, int64_t out_capacity) {
  if (n_msgs < 0 || !out) return -1;
  if (n_msgs == 0) return 0;
  int64_t n_strings = 0;
  for (int64_t f = 0; f < n_fields; ++f)
    if (types[f] == FR_STRING) ++n_strings;
  // scratch for the Avro values: same worst-case bound the Avro encoder
  // itself uses (5 header + 20/field + label strides per row)
  int64_t vcap = n_msgs * (5 + n_fields * 20 + n_strings * label_stride) + 64;
  std::vector<uint8_t> values(static_cast<size_t>(vcap));
  std::vector<int64_t> voff(static_cast<size_t>(n_msgs + 1));
  int64_t total = iotml_encode_batch_nulls(
      numeric, labels, label_stride, n_msgs, types, nullable, n_fields,
      schema_id, values.data(), vcap, voff.data(), nulls);
  if (total < 0) return -1;
  int64_t pos = 0;
  for (int64_t i = 0; i < n_msgs; ++i) {
    bool knull = true;
    const uint8_t* kp = nullptr;
    int64_t kn = 0;
    if (keys && key_offsets) {
      knull = key_null != nullptr && key_null[i] != 0;
      kp = keys + key_offsets[i];
      kn = key_offsets[i + 1] - key_offsets[i];
    } else if (keys && key_stride > 0) {
      // fixed-stride NUL-terminated keys (an S-dtype numpy column)
      knull = key_null != nullptr && key_null[i] != 0;
      kp = keys + i * key_stride;
      while (kn < key_stride && kp[kn]) ++kn;
    }
    int64_t wrote = write_frame(
        out + pos, out_capacity - pos, base_offset + i,
        timestamps ? timestamps[i] : 0, kp, kn, knull,
        values.data() + voff[i], voff[i + 1] - voff[i], false);
    if (wrote < 0) return -1;
    pos += wrote;
  }
  return pos;
}

// Broker-side RAW_PRODUCE landing: CRC-validate every frame of a
// pre-framed batch and stamp the real log offsets (base_offset + i)
// into the frame heads, recomputing each CRC in place.  STRICT: any
// torn tail, corrupt frame or trailing garbage rejects the WHOLE batch
// (returns -(frames_ok + 1)) before a byte may land in the segment —
// Kafka CORRUPT_MESSAGE semantics.  On success returns the frame count
// with *out_max_ts the newest record timestamp (the timeindex anchor).
int64_t iotml_frames_restamp(uint8_t* buf, int64_t buf_len,
                             int64_t base_offset, int64_t* out_max_ts) {
  int64_t pos = 0, n = 0, max_ts = -1;
  while (pos < buf_len) {
    if (pos + kLenSize > buf_len) return -(n + 1);  // trailing garbage
    int64_t length = static_cast<int64_t>(be32(buf + pos));
    int64_t body = pos + kLenSize;
    int64_t end = body + length;
    if (length < kMinBody || end > buf_len) return -(n + 1);
    uint32_t crc = be32(buf + body);
    if (crc32c_extend(0, buf + body + 4, length - 4) != crc) return -(n + 1);
    put64(buf + body + 5, static_cast<uint64_t>(base_offset + n));
    put32(buf + body, crc32c_extend(0, buf + body + 4, length - 4));
    int64_t ts = be64(buf + body + 13);
    if (ts > max_ts) max_ts = ts;
    ++n;
    pos = end;
  }
  if (out_max_ts) *out_max_ts = max_ts;
  return n;
}

// Replica mirror-leg validation: walk a raw fetch batch, CRC-verify
// every frame, and report the byte range + offset span of the frames
// at/after `start_offset` (leading frames below it are the sparse-index
// alignment the read path documents; a torn TAIL ends the batch
// cleanly when strict == 0, rejects it when strict != 0).  Offsets must
// be strictly increasing.  Returns the frame count in range with
//   *out_first/*out_last   offset span (first == -1 when empty),
//   *out_start/*out_end    byte range [start, end) of those frames,
//   *out_max_ts            newest timestamp in range,
//   *out_contiguous        1 when last - first + 1 == count (no holes).
// A corrupt frame (strict) or non-monotone offset returns -(count+1).
int64_t iotml_frames_validate(const uint8_t* buf, int64_t buf_len,
                              int64_t start_offset, int64_t strict,
                              int64_t* out_first, int64_t* out_last,
                              int64_t* out_start, int64_t* out_end,
                              int64_t* out_max_ts,
                              int64_t* out_contiguous) {
  int64_t pos = 0, n = 0;
  int64_t first = -1, last = -1, max_ts = -1;
  int64_t byte_start = -1, byte_end = 0;
  int64_t prev_off = -1;
  while (pos < buf_len) {
    if (pos + kLenSize > buf_len) {
      if (strict) return -(n + 1);
      break;
    }
    int64_t length = static_cast<int64_t>(be32(buf + pos));
    int64_t body = pos + kLenSize;
    int64_t end = body + length;
    if (length < kMinBody || end > buf_len ||
        crc32c_extend(0, buf + body + 4, length - 4) != be32(buf + body)) {
      if (strict) return -(n + 1);
      break;  // torn tail: the valid prefix is the batch
    }
    int64_t offset = be64(buf + body + 5);
    if (offset <= prev_off) return -(n + 1);  // non-monotone: corrupt
    prev_off = offset;
    if (offset >= start_offset) {
      if (first < 0) {
        first = offset;
        byte_start = pos;
      }
      last = offset;
      int64_t ts = be64(buf + body + 13);
      if (ts > max_ts) max_ts = ts;
      byte_end = end;
      ++n;
    }
    pos = end;
  }
  if (out_first) *out_first = first;
  if (out_last) *out_last = last;
  if (out_start) *out_start = byte_start < 0 ? 0 : byte_start;
  if (out_end) *out_end = byte_end;
  if (out_max_ts) *out_max_ts = max_ts;
  if (out_contiguous)
    *out_contiguous = (n == 0 || last - first + 1 == n) ? 1 : 0;
  return n;
}

}  // extern "C"
