// iotml_torch native stream engine: batch np.array2string row formatter
// (a copy of the JAX package's iotml/cpp/fmt_engine.cc).
//
// The serve path's payload contract is np.array2string(row) — the exact
// bytes the reference's OutputCallback produced (cardata-v3.py:247) — and
// formatting is the scorer's host bottleneck (serve/fastfmt.py).  The
// per-element plain version drives dragon4 from Python; this engine
// formats the whole drain in one call: per-element shortest-repr +
// cutoff formatting via std::to_chars, then numpy's exact
// padding/wrap/bracket assembly, all in C++.
//
// Byte parity relies on two identities (pinned by
// tests/test_torch_fastfmt.py against numpy on adversarial inputs):
//   1. dragon4(unique=True, precision=8, fractional=True) equals the
//      shortest round-trip representation when that fits in 8 fractional
//      digits — to_chars's shortest form, same closest-among-shortest
//      digit selection;
//   2. when the shortest form needs more than 8 fractional digits,
//      dragon4's cutoff rounding equals the correctly-rounded fixed
//      8-fractional-digit conversion of the EXACT binary value (both
//      round-to-nearest, ties-to-even over the exact value) — to_chars
//      fixed form on the double-widened element.
// trim='.' semantics: trailing zeros trimmed, the trailing point kept
// ("1." for 1.0), matching numpy's positional float repr.
//
// Eligibility mirrors fastfmt.format_rows exactly (finite rows, no
// exponential trigger: max|x| < 1e8, nonzero min|x| >= 1e-4,
// max/min <= 1000, all compared in float64): ineligible rows are flagged
// and the Python side formats them through np.array2string itself.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

// GCC 10's libstdc++ ships integer std::to_chars only — the
// floating-point overloads (P0067R5) arrived in GCC 11.  The engine's
// contract needs exactly two conversions: the shortest round-trip form
// and the correctly-rounded fixed 8-fractional-digit form.  Where FP
// to_chars exists we use it; otherwise a portable snprintf-based
// fallback supplies the same bytes: shortest = the smallest %.*e
// precision that round-trips through strtof/strtod (correct rounding at
// the minimal precision selects the same closest-among-shortest digits
// to_chars does), fixed-8 = %.8f (glibc printf is correctly rounded).
// Parity across both paths is pinned by tests/test_torch_fastfmt.py.
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
#define IOTML_HAVE_FP_TO_CHARS 1
#else
#define IOTML_HAVE_FP_TO_CHARS 0
#endif

namespace {

#if IOTML_HAVE_FP_TO_CHARS

template <typename T>
int shortest_chars(T value, char* buf, int cap) {
  auto res = std::to_chars(buf, buf + cap, value);
  return static_cast<int>(res.ptr - buf);
}

int fixed8_chars(double value, char* buf, int cap) {
  auto res = std::to_chars(buf, buf + cap, value,
                           std::chars_format::fixed, 8);
  return static_cast<int>(res.ptr - buf);
}

#else  // GCC 10 fallback: snprintf + round-trip minimal precision

inline bool roundtrips(const char* buf, float value) {
  return std::strtof(buf, nullptr) == value;
}
inline bool roundtrips(const char* buf, double value) {
  return std::strtod(buf, nullptr) == value;
}

template <typename T>
int shortest_chars(T value, char* buf, int cap) {
  // max_digits10: 9 (float) / 17 (double) always round-trips
  const int max_prec = sizeof(T) == 4 ? 9 : 17;
  int n = 0;
  for (int prec = 1; prec <= max_prec; ++prec) {
    // %.*e prints `prec` significant digits (1 before the point,
    // prec-1 after): the scientific form parses identically to
    // to_chars general output in format_elem's digit/exponent split
    n = std::snprintf(buf, cap, "%.*e", prec - 1, double(value));
    if (roundtrips(buf, value)) break;
  }
  // canonicalize to the to_chars shape the parser expects: strip a
  // zero-padded fraction ("1.000000e+01" never appears at minimal
  // precision) and the exponent's leading zeros/'+' don't matter to
  // the parser, so the snprintf form is accepted as-is.
  return n;
}

int fixed8_chars(double value, char* buf, int cap) {
  return std::snprintf(buf, cap, "%.8f", value);
}

#endif  // IOTML_HAVE_FP_TO_CHARS

constexpr int kLinewidth = 75;
constexpr int kElemW = kLinewidth - 1;  // minus max(len(sep.rstrip()), ']')

// Format one element into `word` (no padding): sign + integer digits +
// '.' + fractional digits (possibly none), trim='.' applied.  Returns
// length, and the dot position via *dot (index of '.').  `shortest` is
// the to_chars shortest form of the value at ITS OWN precision (f32
// elements use float shortest — dragon4 runs at array dtype precision);
// `exact` is the element widened to double for the cutoff conversion.
template <typename T>
int format_elem(T value, double exact, char* word, int* dot) {
  char buf[64];
  int n = shortest_chars(value, buf, sizeof buf);
  buf[n] = '\0';
  // parse shortest form: [-]digits[.digits][e±dd]
  int w = 0;
  const char* p = buf;
  bool neg = false;
  if (*p == '-') {
    neg = true;
    ++p;
  }
  // split into digit string + decimal exponent
  char digits[40];
  int nd = 0;
  int exp10 = 0;       // position of decimal point after digits[0]
  bool seen_dot = false;
  int int_digits = 0;  // digits before the '.' in the shortest form
  for (; *p; ++p) {
    if (*p == '.') {
      seen_dot = true;
      int_digits = nd;
    } else if (*p == 'e' || *p == 'E') {
      int e = 0, sign = 1;
      ++p;
      if (*p == '-') {
        sign = -1;
        ++p;
      } else if (*p == '+') {
        ++p;
      }
      for (; *p; ++p) e = e * 10 + (*p - '0');
      exp10 = sign * e;
      break;
    } else {
      digits[nd++] = *p;
    }
  }
  if (!seen_dot && exp10 == 0 && int_digits == 0) int_digits = nd;
  // decimal value = 0.digits × 10^point_pos
  int point;
  if (seen_dot || (!seen_dot && exp10 == 0)) {
    point = int_digits;      // "dd.ddd" or "ddd"
    // to_chars never emits both a dot and an exponent in general form?
    // It can ("1.2345e+08") — exp10 shifts the point.
    point += exp10;
  } else {
    point = 1 + exp10;       // "de±x": one leading digit
  }
  // strip trailing zero digits (shortest form shouldn't have any, except
  // the single "0")
  while (nd > 1 && digits[nd - 1] == '0' && nd > point) --nd;
  int frac = nd - point;     // fractional digit count (may be <= 0)
  if (frac > 8) {
    // cutoff: correctly-rounded fixed 8-fractional-digit conversion of
    // the exact value, trailing zeros trimmed
    int n2 = fixed8_chars(exact, buf, sizeof buf);
    // trim='.': strip ALL trailing zeros, keep the bare point ("1.").
    // The loop cannot cross the '.': eligibility guarantees a nonzero
    // digit somewhere (mn >= 1e-4), and integer-part zeros sit left of
    // the point, which is a non-'0' stopper.
    while (n2 > 1 && buf[n2 - 1] == '0') --n2;
    std::memcpy(word, buf, n2);
    word[n2] = '\0';
    const char* d = static_cast<const char*>(std::memchr(word, '.', n2));
    *dot = static_cast<int>(d - word);
    return n2;
  }
  // positional render from digits/point
  if (neg) word[w++] = '-';
  if (point <= 0) {
    word[w++] = '0';
    *dot = w;
    word[w++] = '.';
    for (int k = 0; k < -point; ++k) word[w++] = '0';
    for (int k = 0; k < nd; ++k) word[w++] = digits[k];
  } else if (point >= nd) {
    for (int k = 0; k < nd; ++k) word[w++] = digits[k];
    for (int k = 0; k < point - nd; ++k) word[w++] = '0';
    *dot = w;
    word[w++] = '.';
  } else {
    for (int k = 0; k < point; ++k) word[w++] = digits[k];
    *dot = w;
    word[w++] = '.';
    for (int k = point; k < nd; ++k) word[w++] = digits[k];
  }
  word[w] = '\0';
  return w;
}

// numpy 1-D assembly: pad every word to common (left, right) widths
// around the '.', hanging indent ' ', separator ' ', wrap when the next
// word would cross elem_width, strip the indent of the first line,
// wrap in brackets.
template <typename T>
int64_t format_rows_impl(const T* rows, int64_t n, int64_t f, char* out,
                         int64_t cap, int64_t* offsets, uint8_t* fallback) {
  // per-row scratch: formatted words and their dot positions
  char* words = new char[f * 40];
  int* wlen = new int[f];
  int* wdot = new int[f];
  int64_t pos = 0;
  for (int64_t r = 0; r < n; ++r) {
    offsets[r] = pos;
    const T* row = rows + r * f;
    // ---- eligibility (exactly fastfmt.format_rows's predicate)
    bool finite = true;
    double mx = 0.0, mn = 0.0;
    bool has_nz = false;
    for (int64_t j = 0; j < f; ++j) {
      double a = static_cast<double>(row[j]);
      if (!std::isfinite(a)) {
        finite = false;
        break;
      }
      a = std::fabs(a);
      if (a > 0.0) {
        if (!has_nz) {
          mx = mn = a;
          has_nz = true;
        } else {
          if (a > mx) mx = a;
          if (a < mn) mn = a;
        }
      }
    }
    bool exp_trigger =
        has_nz && (mx >= 1e8 || mn < 1e-4 || mx / mn > 1000.0);
    if (!finite || exp_trigger) {
      fallback[r] = 1;
      continue;
    }
    // ---- per-element format + common pad widths
    int pad_left = 0, pad_right = 0;
    for (int64_t j = 0; j < f; ++j) {
      char* wp = words + j * 40;
      int dot;
      wlen[j] = format_elem(row[j], static_cast<double>(row[j]), wp, &dot);
      wdot[j] = dot;
      int left = dot;                 // chars before '.'
      int right = wlen[j] - dot - 1;  // chars after '.'
      if (left > pad_left) pad_left = left;
      if (right > pad_right) pad_right = right;
    }
    // worst-case row bytes: f * (padded word + sep) + newlines + brackets
    int64_t worst = f * (pad_left + pad_right + 2) + f + (f + 1) + 2;
    if (pos + worst > cap) {
      delete[] words;
      delete[] wlen;
      delete[] wdot;
      return -1;
    }
    // ---- assembly
    char* o = out + pos;
    int64_t w = 0;
    o[w++] = '[';
    int line_len = 1;  // the hanging indent ' ' (slot [0] becomes '[')
    int64_t line_start = 0;  // index in o of this line's first char
    for (int64_t j = 0; j < f; ++j) {
      int lead = pad_left - wdot[j];
      int trail = pad_right - (wlen[j] - wdot[j] - 1);
      int wordw = pad_left + pad_right + 1;
      if (line_len + wordw > kElemW && line_len > 1) {
        // wrap: rstrip the current line, newline, hang indent
        while (w > line_start && o[w - 1] == ' ') --w;
        o[w++] = '\n';
        line_start = w;
        o[w++] = ' ';
        line_len = 1;
      }
      for (int k = 0; k < lead; ++k) o[w++] = ' ';
      std::memcpy(o + w, words + j * 40, wlen[j]);
      w += wlen[j];
      for (int k = 0; k < trail; ++k) o[w++] = ' ';
      line_len += wordw;
      if (j != f - 1) {
        o[w++] = ' ';
        line_len += 1;
      }
    }
    o[w++] = ']';
    pos += w;
  }
  offsets[n] = pos;
  delete[] words;
  delete[] wlen;
  delete[] wdot;
  return pos;
}

}  // namespace

extern "C" {

// Format n rows of f float32 elements; out/offsets as in the other batch
// APIs, fallback[r]=1 marks rows the caller must np.array2string itself
// (their offsets span zero bytes).  Returns total bytes or -1 on a full
// output buffer.
int64_t iotml_format_rows_f32(const float* rows, int64_t n, int64_t f,
                              char* out, int64_t cap, int64_t* offsets,
                              uint8_t* fallback) {
  return format_rows_impl(rows, n, f, out, cap, offsets, fallback);
}

int64_t iotml_format_rows_f64(const double* rows, int64_t n, int64_t f,
                              char* out, int64_t cap, int64_t* offsets,
                              uint8_t* fallback) {
  return format_rows_impl(rows, n, f, out, cap, offsets, fallback);
}

}  // extern "C"
