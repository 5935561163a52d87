// iotml_torch native stream engine: batch JSON → columnar decoder.
//
// A copy of the JAX package's engine (iotml/cpp/json_engine.cc).  The
// KSQL-equivalent pipeline's input leg (reference
// infrastructure/confluent/01_installConfluentPlatform.sh:229-236 —
// SENSOR_DATA_S over VALUE_FORMAT='JSON') parses one flat JSON object per
// fleet message.  This decoder parses a whole poll's worth of messages in
// one call, straight into the same columnar (float64 matrix +
// fixed-stride labels) layout the Avro engine uses, so the CSAS
// JSON→AVRO leg runs native end to end.  Built by
// iotml_torch/stream/native.py at first use, into the one library.
//
// Exactness stance (mirrors _NativeAvroSource): anything this parser
// cannot reproduce byte-for-byte against the Python path marks the ROW for
// fallback — Python re-decodes just those rows.  Fallback triggers:
// escapes in strings, strings at/over the label stride, nested
// objects/arrays, NaN/Infinity literals, type mismatches, non-decimal
// number spellings (hex), floats in integer columns, |int| >= 2^53 (the
// float64-exact bound), and null/missing on a NON-nullable column.
// Missing columns and explicit nulls on nullable columns are NOT
// fallbacks: they set the per-field null bitmap (the realistic fleet
// payload always has them — the KSQL name-mangling quirk makes the
// underscore-digit columns permanently null).  Unknown keys are skipped
// (the star projection ignores them), matching dict semantics; duplicate
// known keys overwrite (Python dict: last wins).
//
// Number parity: strtod and Python's float() are both correctly-rounded
// IEEE-754 decimal conversions, so any decimal token lands on the same
// double.  Tokens are pre-scanned to reject spellings strtod accepts but
// JSON does not (hex, leading '+', "1.", ".5", infinity).
//
// Strictness parity: Python's json.loads(bytes) first utf-8-decodes the
// whole message (invalid UTF-8 → UnicodeDecodeError → row dropped) and
// rejects raw control characters inside strings ("Invalid control
// character") — each row is therefore UTF-8-validated up front, and the
// string scans treat any byte < 0x20 as a fallback trigger.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>

#include "utf8_check.h"

namespace {

// strtod is LC_NUMERIC-sensitive: under a non-C locale (an embedding app
// setting de_DE) every fractional token would parse short and silently
// demote the whole fast path to 0% hit rate.  Pin a C locale once and use
// strtod_l so number parity with Python's float() holds regardless of the
// process locale.  Never freed: one per process, alive for its lifetime.
inline locale_t c_numeric_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

enum FieldType : int8_t {
  F_FLOAT = 0,
  F_DOUBLE = 1,
  F_INT = 2,
  F_LONG = 3,
  F_STRING = 4,
  F_BOOLEAN = 5,
};

constexpr double kIntExact = 9007199254740992.0;  // 2^53

inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && is_ws(*p)) ++p;
  return p;
}

// Validate a JSON number token [p, q) per RFC 8259 grammar:
//   -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?
// `is_integral` reports no '.'/exponent (safe for int columns).
bool valid_json_number(const char* p, const char* q, bool* is_integral) {
  const char* s = p;
  if (s < q && *s == '-') ++s;
  if (s >= q) return false;
  if (*s == '0') {
    ++s;
  } else if (*s >= '1' && *s <= '9') {
    while (s < q && *s >= '0' && *s <= '9') ++s;
  } else {
    return false;
  }
  bool integral = true;
  if (s < q && *s == '.') {
    integral = false;
    ++s;
    if (s >= q || *s < '0' || *s > '9') return false;
    while (s < q && *s >= '0' && *s <= '9') ++s;
  }
  if (s < q && (*s == 'e' || *s == 'E')) {
    integral = false;
    ++s;
    if (s < q && (*s == '+' || *s == '-')) ++s;
    if (s >= q || *s < '0' || *s > '9') return false;
    while (s < q && *s >= '0' && *s <= '9') ++s;
  }
  *is_integral = integral;
  return s == q;
}

struct Column {
  const char* name;  // uppercase
  int64_t name_len;
  int8_t type;
  int64_t slot;  // index into the numeric matrix or the label row
};

using iotml::valid_utf8;

}  // namespace

extern "C" {

// Parse n_msgs flat JSON objects into columnar buffers.
//
//   blob/offsets      — concatenated messages, offsets[n_msgs+1]
//   names_blob/name_offsets — concatenated UPPERCASE column names in schema
//                       order (the sink schema: numeric fields fill
//                       `numeric` left-to-right, string fields fill
//                       `labels`), name_offsets[n_fields+1]
//   types[n_fields]   — FieldType per column
//   nullable[n_fields]— 1 where the column is a ["null", T] union
//   numeric           — [n_msgs x n_numeric] float64, row-major
//   labels            — [n_msgs x n_strings] fixed-stride bytes, caller
//                       zeroed
//   nulls             — [n_msgs x n_fields] uint8, caller zeroed; set to 1
//                       where the column is null/missing in that row
//   fallback[n_msgs]  — set to 1 where the row needs the Python path
//
// Returns the number of rows decoded natively (n_msgs - fallbacks), or -1
// on invalid arguments.  Rows marked fallback have undefined column
// contents — the caller re-decodes them in Python.
int64_t iotml_json_decode_batch(
    const char* blob, const int64_t* offsets, int64_t n_msgs,
    const char* names_blob, const int64_t* name_offsets,
    const int8_t* types, const uint8_t* nullable, int64_t n_fields,
    double* numeric, int64_t n_numeric,
    char* labels, int64_t n_strings, int64_t stride,
    uint8_t* nulls, uint8_t* fallback) {
  if (n_fields <= 0 || n_fields > 64) return -1;
  Column cols[64];
  {
    int64_t num_slot = 0, str_slot = 0;
    for (int64_t i = 0; i < n_fields; ++i) {
      cols[i].name = names_blob + name_offsets[i];
      cols[i].name_len = name_offsets[i + 1] - name_offsets[i];
      cols[i].type = types[i];
      cols[i].slot = (types[i] == F_STRING) ? str_slot++ : num_slot++;
    }
    if (num_slot != n_numeric || str_slot != n_strings) return -1;
  }

  int64_t ok_rows = 0;
  char keybuf[128];
  for (int64_t r = 0; r < n_msgs; ++r) {
    const char* p = blob + offsets[r];
    const char* end = blob + offsets[r + 1];
    double* num_row = numeric + r * n_numeric;
    char* lab_row = labels + r * n_strings * stride;
    uint8_t* null_row = nulls + r * n_fields;
    uint64_t found = 0;
    bool bad = false;

    // json.loads(bytes) utf-8-decodes the whole message first: a row the
    // Python path would reject with UnicodeDecodeError must fall back
    if (!valid_utf8(reinterpret_cast<const uint8_t*>(p),
                    reinterpret_cast<const uint8_t*>(end)))
      bad = true;
    if (!bad) p = skip_ws(p, end);
    if (!bad && (p >= end || *p != '{')) bad = true;
    if (!bad) {
      ++p;
      p = skip_ws(p, end);
      if (p < end && *p == '}') {
        ++p;  // empty object: every column is missing → all-null below
      } else {
        for (;;) {
          // ---- key
          p = skip_ws(p, end);
          if (p >= end || *p != '"') { bad = true; break; }
          ++p;
          int64_t klen = 0;
          while (p < end && *p != '"' && *p != '\\' &&
                 (uint8_t)*p >= 0x20 && (uint8_t)*p < 0x80 &&
                 klen < (int64_t)sizeof keybuf) {
            char c = *p++;
            keybuf[klen++] = (c >= 'a' && c <= 'z') ? c - 32 : c;
          }
          // stops on escape, raw control char, an over-long key, or a
          // non-ASCII key byte → Python (its str.upper() is Unicode-aware:
          // 'ﬂow'.upper() == 'FLOW' could match a column this byte-wise
          // fold cannot)
          if (p >= end || *p != '"') { bad = true; break; }
          ++p;
          p = skip_ws(p, end);
          if (p >= end || *p != ':') { bad = true; break; }
          ++p;
          p = skip_ws(p, end);
          if (p >= end) { bad = true; break; }

          // ---- column lookup (19-ish columns: linear memcmp is fine)
          int64_t ci = -1;
          for (int64_t i = 0; i < n_fields; ++i) {
            if (cols[i].name_len == klen &&
                memcmp(cols[i].name, keybuf, klen) == 0) {
              ci = i;
              break;
            }
          }

          // ---- value
          char c = *p;
          if (c == '"') {
            ++p;
            const char* s = p;
            while (p < end && *p != '"' && *p != '\\' &&
                   (uint8_t)*p >= 0x20)
              ++p;
            // stops on escape or raw control char (json.loads strict mode
            // rejects both) → Python decides
            if (p >= end || *p != '"') { bad = true; break; }
            int64_t slen = p - s;
            ++p;
            if (ci >= 0) {
              if (cols[ci].type != F_STRING || slen >= stride) {
                bad = true;
                break;
              }
              char* slot = lab_row + cols[ci].slot * stride;
              memcpy(slot, s, slen);
              // duplicate key overwriting a longer value: clear the tail
              // (otherwise stale bytes from the first value survive)
              if (slen < stride) memset(slot + slen, 0, stride - slen);
              null_row[ci] = 0;
              found |= 1ull << ci;
            }
          } else if (c == '-' || (c >= '0' && c <= '9')) {
            const char* s = p;
            while (p < end && (*p == '-' || *p == '+' || *p == '.' ||
                               *p == 'e' || *p == 'E' ||
                               (*p >= '0' && *p <= '9')))
              ++p;
            bool integral = false;
            if (!valid_json_number(s, p, &integral)) { bad = true; break; }
            if (ci >= 0) {
              int8_t t = cols[ci].type;
              if (t == F_STRING || t == F_BOOLEAN) { bad = true; break; }
              if ((t == F_INT || t == F_LONG) && !integral) {
                bad = true;  // float into an integer column: Python decides
                break;
              }
              char* tok_end = nullptr;
              locale_t cloc = c_numeric_locale();
              // newlocale can fail (ENOMEM): plain strtod is only wrong
              // under a non-C locale, and a wrong parse trips tok_end !=
              // p → Python fallback (slow, never incorrect)
              double v = cloc ? strtod_l(s, &tok_end, cloc)
                              : strtod(s, &tok_end);
              if (tok_end != p) { bad = true; break; }
              if ((t == F_INT || t == F_LONG) &&
                  (v >= kIntExact || v <= -kIntExact)) {
                bad = true;  // beyond float64-exact int range
                break;
              }
              if (t == F_FLOAT && (v > 3.4028234663852886e38 ||
                                   v < -3.4028234663852886e38)) {
                // beyond float32 range (incl. strtod's ERANGE infinity):
                // Python's struct.pack('<f') raises for finite overflow —
                // the Python leg owns that error semantics
                bad = true;
                break;
              }
              num_row[cols[ci].slot] = v;
              null_row[ci] = 0;
              found |= 1ull << ci;
            }
          } else if (c == 't' && end - p >= 4 && memcmp(p, "true", 4) == 0) {
            p += 4;
            if (ci >= 0) {
              if (cols[ci].type != F_BOOLEAN) { bad = true; break; }
              num_row[cols[ci].slot] = 1.0;
              null_row[ci] = 0;
              found |= 1ull << ci;
            }
          } else if (c == 'f' && end - p >= 5 && memcmp(p, "false", 5) == 0) {
            p += 5;
            if (ci >= 0) {
              if (cols[ci].type != F_BOOLEAN) { bad = true; break; }
              num_row[cols[ci].slot] = 0.0;
              null_row[ci] = 0;
              found |= 1ull << ci;
            }
          } else if (c == 'n' && end - p >= 4 && memcmp(p, "null", 4) == 0) {
            p += 4;
            if (ci >= 0) {
              if (!nullable[ci]) { bad = true; break; }  // Python raises
              null_row[ci] = 1;
              if (cols[ci].type == F_STRING)  // deterministic contents
                memset(lab_row + cols[ci].slot * stride, 0, stride);
              else
                num_row[cols[ci].slot] = 0.0;
              found |= 1ull << ci;
            }
          } else {
            // nested object/array, NaN/Infinity, garbage → Python
            bad = true;
            break;
          }

          p = skip_ws(p, end);
          if (p < end && *p == ',') {
            ++p;
            continue;
          }
          if (p < end && *p == '}') {
            ++p;
            break;
          }
          bad = true;
          break;
        }
      }
    }
    if (!bad) {
      p = skip_ws(p, end);
      if (p != end) bad = true;  // trailing garbage
    }
    if (!bad) {
      // columns never seen: null when the schema allows, else Python
      // (a missing non-nullable column raises on the Python path too —
      // that path owns the error semantics)
      for (int64_t i = 0; i < n_fields && !bad; ++i) {
        if (!(found & (1ull << i))) {
          if (!nullable[i]) {
            bad = true;
          } else {
            null_row[i] = 1;
            if (cols[i].type != F_STRING) num_row[cols[i].slot] = 0.0;
            // (string slots: caller-zeroed labels are already empty)
          }
        }
      }
    }
    if (bad) {
      fallback[r] = 1;
    } else {
      ++ok_rows;
    }
  }
  return ok_rows;
}

}  // extern "C"
