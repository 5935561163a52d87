// iotml_torch native stream engine: columnar Avro codec + Confluent framing.
//
// A copy of the JAX package's engine (iotml/cpp/avro_engine.cc), the C++
// half of the reference's data plane (the tensorflow_io.kafka ops:
// decode_avro / KafkaDataset framing strip — reference
// cardata-v3.py:46-74).  Python hands a contiguous blob of messages +
// offsets; we decode straight into caller-owned columnar buffers
// (doubles, row-major [n_rows x n_numeric]) plus a fixed-stride label
// column — the layout the batcher normalizes and stacks, no
// Python-object round trip.
//
// Schema support is what the car/KSQL schemas need: the primitives
// float/double/int/long/boolean/string and the nullable 2-branch union
// ["null", T].  Schemas arrive pre-compiled as a type/flag descriptor
// array, so the inner loop is branch-light and allocation-free.
//
// Built by iotml_torch/stream/native.py at first use (g++ -O3 -shared,
// with fmt_engine.cc, into one library; no external deps).

#include <cstdint>
#include <cstring>

#include "utf8_check.h"

namespace {

enum FieldType : int8_t {
  F_FLOAT = 0,
  F_DOUBLE = 1,
  F_INT = 2,
  F_LONG = 3,
  F_STRING = 4,
  F_BOOLEAN = 5,
};

// Avro zigzag varint. Returns new position, or -1 on truncation.
// `overlong` (optional) reports a non-minimal encoding — a multi-byte
// varint whose final byte is 0x00 encodes a value a shorter varint could
// carry; the canonical re-encode would differ byte-wise, which strict
// (pass-through) callers must reject.
inline int64_t read_varint(const uint8_t* buf, int64_t pos, int64_t end,
                           int64_t* out, bool* overlong = nullptr) {
  uint64_t acc = 0;
  int shift = 0;
  int64_t start = pos;
  while (pos < end) {
    uint8_t b = buf[pos++];
    // 10th byte: only its lowest bit fits in 64 (the Avro long limit).
    // Without this check the high payload bits would shift out silently
    // and a >64-bit varint would validate with a truncated value.
    if (shift == 63 && (b & 0x7E)) return -1;
    acc |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
      if (overlong) *overlong = (b == 0x00 && pos - start > 1);
      return pos;
    }
    shift += 7;
    if (shift > 63) return -1;
  }
  return -1;
}

inline int64_t write_varint(uint8_t* buf, int64_t pos, int64_t v) {
  uint64_t z = (static_cast<uint64_t>(v) << 1) ^
               static_cast<uint64_t>(v >> 63);
  while (true) {
    uint8_t b = z & 0x7F;
    z >>= 7;
    if (z) {
      buf[pos++] = b | 0x80;
    } else {
      buf[pos++] = b;
      return pos;
    }
  }
}

}  // namespace

extern "C" {

// Decode n_msgs Avro records.
//   blob/offsets: messages live at blob[offsets[i] .. offsets[i+1])
//   types/nullable: per-field descriptors, n_fields entries
//   strip: bytes to skip at each message head (5 for Confluent framing)
//   out_numeric: [n_msgs x n_numeric] row-major doubles (numeric fields in
//                schema order; string fields excluded). Nulls decode as 0.
//   out_labels/label_stride: every string field's bytes are copied (NUL-
//                terminated, truncated to stride-1) into consecutive slots:
//                row-major [n_msgs x n_strings] with the given stride.
// Returns number of rows decoded; a malformed message stops decoding and
// returns the negative of (rows_ok + 1) so callers can pinpoint it.
static int64_t decode_impl(const uint8_t* blob,
                           const int64_t* offsets, int64_t n_msgs,
                           const int8_t* types,
                           const uint8_t* nullable, int64_t n_fields,
                           int64_t strip, double* out_numeric,
                           char* out_labels, int64_t label_stride,
                           uint8_t* out_nulls, bool strict) {
  // out_nulls: optional [n_msgs * n_fields] bitmap (1 = the nullable
  // union chose the null branch).  The columnar outputs cannot represent
  // null distinctly (numeric null -> 0.0, string null -> ""), so callers
  // needing exact null semantics check the bitmap and fall back.
  //
  // strict mode is the pass-through/count validation gate: it rejects
  // anything the Python codec would reject (invalid UTF-8 in a string,
  // union branch outside {0,1}) OR would silently CANONICALIZE on a
  // decode→re-encode round trip (trailing bytes after the record,
  // non-minimal varints) — exactly the conditions under which forwarding
  // the original bytes unchanged would diverge from the per-row path.
  //
  // Precompute per-field output slot (numeric col or string col).
  int64_t n_numeric = 0, n_strings = 0;
  for (int64_t f = 0; f < n_fields; ++f) {
    if (types[f] == F_STRING) ++n_strings; else ++n_numeric;
  }
  for (int64_t i = 0; i < n_msgs; ++i) {
    const uint8_t* buf = blob;
    int64_t pos = offsets[i] + strip;
    int64_t end = offsets[i + 1];
    if (pos > end) return -(i + 1);
    double* num_row = out_numeric + i * n_numeric;
    char* lab_row = out_labels + i * n_strings * label_stride;
    int64_t ncol = 0, scol = 0;
    for (int64_t f = 0; f < n_fields; ++f) {
      bool is_null = false;
      if (nullable[f]) {
        int64_t branch;
        bool overlong = false;
        pos = read_varint(buf, pos, end, &branch, &overlong);
        if (pos < 0) return -(i + 1);
        if (strict && (overlong || (branch != 0 && branch != 1)))
          return -(i + 1);
        is_null = (branch == 0);
      }
      if (out_nulls) out_nulls[i * n_fields + f] = is_null ? 1 : 0;
      switch (types[f]) {
        case F_FLOAT: {
          double v = 0.0;
          if (!is_null) {
            if (pos + 4 > end) return -(i + 1);
            float fv;
            std::memcpy(&fv, buf + pos, 4);
            pos += 4;
            v = fv;
          }
          num_row[ncol++] = v;
          break;
        }
        case F_DOUBLE: {
          double v = 0.0;
          if (!is_null) {
            if (pos + 8 > end) return -(i + 1);
            std::memcpy(&v, buf + pos, 8);
            pos += 8;
          }
          num_row[ncol++] = v;
          break;
        }
        case F_INT:
        case F_LONG: {
          int64_t v = 0;
          if (!is_null) {
            bool overlong = false;
            pos = read_varint(buf, pos, end, &v, &overlong);
            if (pos < 0 || (strict && overlong)) return -(i + 1);
          }
          num_row[ncol++] = static_cast<double>(v);
          break;
        }
        case F_BOOLEAN: {
          double v = 0.0;
          if (!is_null) {
            if (pos + 1 > end) return -(i + 1);
            v = buf[pos++] ? 1.0 : 0.0;
          }
          num_row[ncol++] = v;
          break;
        }
        case F_STRING: {
          char* slot = lab_row + scol * label_stride;
          ++scol;
          if (is_null) {
            slot[0] = '\0';
            break;
          }
          int64_t len;
          bool overlong = false;
          pos = read_varint(buf, pos, end, &len, &overlong);
          if (pos < 0 || len < 0 || pos + len > end) return -(i + 1);
          if (strict && (overlong ||
                         !iotml::valid_utf8(buf + pos, buf + pos + len)))
            return -(i + 1);
          int64_t copy = len < label_stride - 1 ? len : label_stride - 1;
          std::memcpy(slot, buf + pos, copy);
          slot[copy] = '\0';
          pos += len;
          break;
        }
        default:
          return -(i + 1);
      }
    }
    if (strict && pos != end) return -(i + 1);  // trailing bytes
  }
  return n_msgs;
}

int64_t iotml_decode_batch_nulls(const uint8_t* blob,
                                 const int64_t* offsets, int64_t n_msgs,
                                 const int8_t* types,
                                 const uint8_t* nullable, int64_t n_fields,
                                 int64_t strip, double* out_numeric,
                                 char* out_labels, int64_t label_stride,
                                 uint8_t* out_nulls) {
  return decode_impl(blob, offsets, n_msgs, types, nullable, n_fields,
                     strip, out_numeric, out_labels, label_stride,
                     out_nulls, /*strict=*/false);
}

int64_t iotml_decode_batch(const uint8_t* blob, const int64_t* offsets,
                           int64_t n_msgs, const int8_t* types,
                           const uint8_t* nullable, int64_t n_fields,
                           int64_t strip, double* out_numeric,
                           char* out_labels, int64_t label_stride) {
  return decode_impl(blob, offsets, n_msgs, types, nullable, n_fields,
                     strip, out_numeric, out_labels, label_stride, nullptr,
                     /*strict=*/false);
}

// Strict validation decode for the pass-through/count fast paths (see
// decode_impl): rejects what the Python codec rejects or would
// canonicalize, so "validated" means "forwarding the original bytes is
// byte-identical to decode→re-encode".
int64_t iotml_decode_batch_strict(const uint8_t* blob,
                                  const int64_t* offsets, int64_t n_msgs,
                                  const int8_t* types,
                                  const uint8_t* nullable, int64_t n_fields,
                                  int64_t strip, double* out_numeric,
                                  char* out_labels, int64_t label_stride) {
  return decode_impl(blob, offsets, n_msgs, types, nullable, n_fields,
                     strip, out_numeric, out_labels, label_stride, nullptr,
                     /*strict=*/true);
}

// Encode n_msgs records from columnar input (the decode layout in reverse).
//   out: caller-allocated; out_offsets[n_msgs+1] filled with message bounds.
//   frame_schema_id: >= 0 writes the Confluent 5-byte header (magic 0 +
//                big-endian id); < 0 emits bare Avro.
// Returns total bytes written, or -1 if out_capacity would overflow.
int64_t iotml_encode_batch_nulls(const double* numeric, const char* labels,
                                 int64_t label_stride, int64_t n_msgs,
                                 const int8_t* types, const uint8_t* nullable,
                                 int64_t n_fields, int64_t frame_schema_id,
                                 uint8_t* out, int64_t out_capacity,
                                 int64_t* out_offsets,
                                 const uint8_t* nulls) {
  int64_t n_numeric = 0, n_strings = 0;
  for (int64_t f = 0; f < n_fields; ++f) {
    if (types[f] == F_STRING) ++n_strings; else ++n_numeric;
  }
  int64_t pos = 0;
  for (int64_t i = 0; i < n_msgs; ++i) {
    out_offsets[i] = pos;
    // worst case per row: 5 frame + fields * (10 varint + 8 payload) + strings
    if (pos + 5 + n_fields * 20 + n_strings * label_stride > out_capacity)
      return -1;
    if (frame_schema_id >= 0) {
      out[pos++] = 0;
      uint32_t id = static_cast<uint32_t>(frame_schema_id);
      out[pos++] = (id >> 24) & 0xFF;
      out[pos++] = (id >> 16) & 0xFF;
      out[pos++] = (id >> 8) & 0xFF;
      out[pos++] = id & 0xFF;
    }
    const double* num_row = numeric + i * n_numeric;
    const char* lab_row = labels + i * n_strings * label_stride;
    const uint8_t* null_row = nulls ? nulls + i * n_fields : nullptr;
    int64_t ncol = 0, scol = 0;
    for (int64_t f = 0; f < n_fields; ++f) {
      if (null_row && null_row[f]) {
        // null value: branch 0 of the ["null", T] union, no payload.
        // A null in a non-nullable field has no encoding — reject so the
        // caller's Python path decides (it raises there too).
        if (!nullable[f]) return -1;
        pos = write_varint(out, pos, 0);
        if (types[f] == F_STRING) ++scol; else ++ncol;
        continue;
      }
      if (nullable[f]) pos = write_varint(out, pos, 1);  // branch 1 = value
      switch (types[f]) {
        case F_FLOAT: {
          float fv = static_cast<float>(num_row[ncol++]);
          std::memcpy(out + pos, &fv, 4);
          pos += 4;
          break;
        }
        case F_DOUBLE: {
          double v = num_row[ncol++];
          std::memcpy(out + pos, &v, 8);
          pos += 8;
          break;
        }
        case F_INT:
        case F_LONG:
          pos = write_varint(out, pos,
                             static_cast<int64_t>(num_row[ncol++]));
          break;
        case F_BOOLEAN:
          out[pos++] = num_row[ncol++] != 0.0 ? 1 : 0;
          break;
        case F_STRING: {
          const char* s = lab_row + scol * label_stride;
          ++scol;
          int64_t len = 0;
          while (len < label_stride && s[len]) ++len;
          pos = write_varint(out, pos, len);
          std::memcpy(out + pos, s, len);
          pos += len;
          break;
        }
        default:
          return -1;
      }
    }
  }
  out_offsets[n_msgs] = pos;
  return pos;
}

int64_t iotml_encode_batch(const double* numeric, const char* labels,
                           int64_t label_stride, int64_t n_msgs,
                           const int8_t* types, const uint8_t* nullable,
                           int64_t n_fields, int64_t frame_schema_id,
                           uint8_t* out, int64_t out_capacity,
                           int64_t* out_offsets) {
  return iotml_encode_batch_nulls(numeric, labels, label_stride, n_msgs,
                                  types, nullable, n_fields, frame_schema_id,
                                  out, out_capacity, out_offsets, nullptr);
}

}  // extern "C"
