// Shared UTF-8 well-formedness check (RFC 3629: no overlongs, no
// surrogates, max U+10FFFF) — the parity gate for Python's
// bytes.decode("utf-8"), used by the JSON parser's whole-message prescan
// and the Avro decoder's strict mode.
#ifndef IOTML_UTF8_CHECK_H_
#define IOTML_UTF8_CHECK_H_

#include <cstdint>

namespace iotml {

inline bool valid_utf8(const uint8_t* p, const uint8_t* end) {
  while (p < end) {
    uint8_t c = *p;
    if (c < 0x80) {
      ++p;
      continue;
    }
    int n;
    uint32_t cp;
    if ((c & 0xE0) == 0xC0) {
      n = 1;
      cp = c & 0x1F;
      if (cp < 0x02) return false;  // overlong (< U+0080)
    } else if ((c & 0xF0) == 0xE0) {
      n = 2;
      cp = c & 0x0F;
    } else if ((c & 0xF8) == 0xF0) {
      n = 3;
      cp = c & 0x07;
    } else {
      return false;
    }
    if (end - p <= n) return false;
    for (int k = 1; k <= n; ++k) {
      if ((p[k] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (p[k] & 0x3F);
    }
    if (n == 2 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF)))
      return false;
    if (n == 3 && (cp < 0x10000 || cp > 0x10FFFF)) return false;
    p += n + 1;
  }
  return true;
}

}  // namespace iotml

#endif  // IOTML_UTF8_CHECK_H_
