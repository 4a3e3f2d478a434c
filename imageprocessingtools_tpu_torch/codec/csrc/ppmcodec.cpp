// Native PPM codec core: header lexing + batched pixel decode + P4 packing.
//
// Implements the same verified P6 grammar as codec/ppm.py (the reference's
// header lexer semantics: '#'-to-newline comments anywhere in the header,
// whitespace-separated unsigned tokens, literal "P6" magic, maxval
// pass-through, strict trailer check) with the unsafe paths hardened.
// Exposed as a C ABI for ctypes; used for high-throughput batched host
// decode feeding device transfers (the reference decodes one image per
// process; this decodes N in parallel into one contiguous HWC buffer).
//
// Build: g++ -O2 -shared -fPIC -o libppmcodec.so ppmcodec.cpp -pthread

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int kOk = 0;
constexpr int kErrToken = -1;     // "error in getting next token. wrong format."
constexpr int kErrMagic = -2;     // "error. invalid file format."
constexpr int kErrWidth = -3;
constexpr int kErrHeight = -4;
constexpr int kErrMaxval = -5;
constexpr int kErrShort = -6;     // "Error: unexpected end of file."
constexpr int kErrTrailer = -7;   // "file format error"
constexpr int kErrDims = -8;      // batch: image dims mismatch
constexpr int kErrDigits = -9;    // >9-digit-char header int (quirk-B4 bound)
constexpr int kErrOpen = -10;     // file open / stat / read failure

struct Lexer {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int cur = '\n';  // matches the reference's seed current_char
  bool eof = false;

  bool next_char() {  // returns false on hardened failure (unterminated comment)
    if (eof) return true;
    if (pos < size) {
      cur = data[pos++];
    } else {
      eof = true;
      return true;
    }
    if (cur == '#') {
      for (;;) {
        if (pos >= size) return false;  // hardened: no OOB scan
        cur = data[pos++];
        if (cur == '\n') break;
      }
      cur = '\n';
    }
    return true;
  }

  static bool is_space(int c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
           c == '\r';
  }
  static bool is_digit(int c) { return c >= '0' && c <= '9'; }
  static bool is_alpha(int c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
  }

  // kinds: 0 = uint (value in *out), 1 = magic "P6", 2 = other word, <0 error
  int next_token(uint64_t* out) {
    while (!eof && is_space(cur)) {
      if (!next_char()) return kErrTrailer;
    }
    if (!eof && is_digit(cur)) {
      uint64_t v = 0;
      int nchars = 0;
      while (!eof && is_digit(cur)) {
        if (++nchars <= 9) {
          v = v * 10 + static_cast<uint64_t>(cur - '0');
        }
        if (!next_char()) return kErrTrailer;
      }
      // Quirk-B4 hardening, identical to the Python lexer: the reference's
      // 10-byte token buffer counts raw digit CHARS (leading zeros
      // included) and overflows (UB) at >= 10, so <= 9 chars is its
      // entire UB-free domain. Reject cleanly with a dedicated code so the
      // caller does not remap it to a positional message (and never hand a
      // value that could truncate at the uint32 ABI to the caller).
      if (nchars > 9) return kErrDigits;
      *out = v;
      return 0;
    }
    if (!eof && is_alpha(cur)) {
      char word[8] = {0};
      int n = 0;
      while (!eof && (is_alpha(cur) || is_digit(cur))) {
        if (n < 7) word[n++] = static_cast<char>(cur);
        if (!next_char()) return kErrTrailer;
      }
      // Reference consumes one extra char after a word token.
      if (!next_char()) return kErrTrailer;
      return (word[0] == 'P' && word[1] == '6' && word[2] == 0) ? 1 : 2;
    }
    return kErrToken;
  }
};

}  // namespace

extern "C" {

// Parse a P6 header. On success fills w/h/maxval and the payload byte offset
// and validates the payload length exactly (trailer check). `full_size` is
// the on-disk file size the payload checks run against; `size` is the number
// of bytes actually present in `data` (a prefix for the batched serving
// header pass — the caller retries with the whole file when the header
// straddles the prefix, mirroring codec/ppm.py::parse_file_header).
static int parse_header_impl(const uint8_t* data, size_t size,
                             uint64_t full_size, uint32_t* w, uint32_t* h,
                             uint32_t* maxval, size_t* offset) {
  Lexer lex{data, size};
  uint64_t v = 0;
  // Message-parity contract (matches codec/ppm.py::_parse_header exactly):
  // at the MAGIC position every lexer failure — token error, unterminated
  // comment (kErrTrailer), >9-digit bound (kErrDigits) — is remapped to the
  // token-error message (the Python parser catches-and-remaps there); at
  // width/height/maxval positions lexer failures keep their OWN messages
  // and only a wrong-KIND token (word where a uint is required) maps to the
  // positional message, mirroring the reference's CHECK_ERROR structure
  // (ppmx-edward.c:416-438).
  int k = lex.next_token(&v);
  if (k < 0) return kErrToken;
  if (k != 1) return kErrMagic;
  uint64_t w64 = 0, h64 = 0;
  int rc = lex.next_token(&w64);
  if (rc < 0) return rc;
  if (rc != 0) return kErrWidth;
  rc = lex.next_token(&h64);
  if (rc < 0) return rc;
  if (rc != 0) return kErrHeight;
  rc = lex.next_token(&v);
  if (rc < 0) return rc;
  if (rc != 0) return kErrMaxval;
  *maxval = static_cast<uint32_t>(v);
  *offset = lex.pos;
  // Dimensions past 2^30 cannot have a full payload in any real input and
  // would overflow the need computation; classify as short BEFORE the u32
  // narrowing (matches the Python codec's "unexpected end of file").
  if (w64 > (1u << 30) || h64 > (1u << 30)) return kErrShort;
  *w = static_cast<uint32_t>(w64);
  *h = static_cast<uint32_t>(h64);
  const uint64_t need = static_cast<uint64_t>(*w) * (*h) * 3u;
  const uint64_t avail = full_size - lex.pos;
  // Reference quirk: the per-pixel bounds check (ppmx-edward.c:315) fires
  // only when a pixel STARTS past EOF, so payloads short by 1-3 bytes reach
  // the strict trailer check (:453, "file format error") instead.
  if (avail + 3 < need) return kErrShort;
  if (avail != need) return kErrTrailer;
  return kOk;
}

int ppmx_parse_header(const uint8_t* data, size_t size, uint32_t* w,
                      uint32_t* h, uint32_t* maxval, size_t* offset) {
  return parse_header_impl(data, size, size, w, h, maxval, offset);
}

// Header pass over a file PREFIX: token grammar runs on `data[:size]`, the
// payload-length checks run against `full_size`. Returns kErrPrefix when
// the header consumed the whole prefix of a larger file (the result cannot
// be trusted; re-read the full file and retry).
int ppmx_parse_header_prefix(const uint8_t* data, size_t size,
                             uint64_t full_size, uint32_t* w, uint32_t* h,
                             uint32_t* maxval, size_t* offset) {
  int rc = parse_header_impl(data, size, full_size, w, h, maxval, offset);
  if (rc == kOk && *offset >= size && full_size > size) return -100;
  return rc;
}

// Decode one P6 into dst[h*w*3] (caller sized from ppmx_parse_header).
int ppmx_decode_one(const uint8_t* data, size_t size, uint8_t* dst,
                    uint32_t expect_w, uint32_t expect_h) {
  uint32_t w, h, maxval;
  size_t off;
  int rc = ppmx_parse_header(data, size, &w, &h, &maxval, &off);
  if (rc != kOk) return rc;
  if (w != expect_w || h != expect_h) return kErrDims;
  std::memcpy(dst, data + off, static_cast<size_t>(w) * h * 3u);
  return kOk;
}

// Batched parallel decode of n same-shape P6 buffers into one contiguous
// uint8[n, h, w, 3] array. Returns 0 or the first error code encountered.
int ppmx_decode_batch(const uint8_t* const* datas, const size_t* sizes, int n,
                      uint8_t* dst, uint32_t w, uint32_t h, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  const size_t stride = static_cast<size_t>(w) * h * 3u;
  std::vector<int> rcs(static_cast<size_t>(nthreads), kOk);
  auto worker = [&](int t) {
    for (int i = t; i < n; i += nthreads) {
      int rc = ppmx_decode_one(datas[i], sizes[i], dst + stride * i, w, h);
      if (rc != kOk && rcs[static_cast<size_t>(t)] == kOk)
        rcs[static_cast<size_t>(t)] = rc;
    }
  };
  if (nthreads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nthreads));
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  for (int rc : rcs)
    if (rc != kOk) return rc;
  return kOk;
}

namespace {

// Full positional read with EINTR/partial handling; true iff `len` bytes read.
bool pread_full(int fd, uint8_t* buf, size_t len, uint64_t off) {
  while (len > 0) {
    ssize_t n = ::pread(fd, buf, len, static_cast<off_t>(off));
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (n == 0) return false;  // EOF before `len` (file shrank under us)
    buf += n;
    len -= static_cast<size_t>(n);
    off += static_cast<uint64_t>(n);
  }
  return true;
}

// Decode one P6 FILE with the payload pread() directly into dst[eh*ew*3] —
// no intermediate whole-file buffer (one copy page-cache->tensor instead of
// the read()+memcpy two-copy path). Header grammar/checks are exactly
// parse_header_impl over a 64 KB prefix, retried over the whole file when
// the header straddles it (giant comment runs — rare path, heap buffer).
int decode_file_impl(const char* path, uint8_t* dst, uint32_t ew,
                     uint32_t eh) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return kErrOpen;
  struct stat st;
  if (::fstat(fd, &st) != 0 || !S_ISREG(st.st_mode)) {
    ::close(fd);
    return kErrOpen;
  }
  const uint64_t fsize = static_cast<uint64_t>(st.st_size);
  const size_t need = static_cast<size_t>(ew) * eh * 3u;
  uint8_t prefix[65536];
  const size_t pre =
      static_cast<size_t>(fsize < sizeof prefix ? fsize : sizeof prefix);
  if (!pread_full(fd, prefix, pre, 0)) {
    ::close(fd);
    return kErrOpen;
  }
  uint32_t pw = 0, ph = 0, mv = 0;
  size_t off = 0;
  int rc = parse_header_impl(prefix, pre, fsize, &pw, &ph, &mv, &off);
  if (rc == kOk && off >= pre && fsize > pre) rc = kErrToken;  // straddle
  if (rc != kOk && fsize > pre) {
    // Prefix verdicts on a partial view can be truncation artifacts:
    // re-parse over the whole file (mirrors parse_file_header's retry).
    try {
      std::vector<uint8_t> all(fsize);
      if (!pread_full(fd, all.data(), fsize, 0)) {
        ::close(fd);
        return kErrOpen;
      }
      rc = parse_header_impl(all.data(), fsize, fsize, &pw, &ph, &mv, &off);
      if (rc == kOk) {
        if (pw != ew || ph != eh) rc = kErrDims;
        else std::memcpy(dst, all.data() + off, need);
      }
    } catch (const std::bad_alloc&) {
      rc = kErrOpen;  // a multi-GB junk "header" — surface as unreadable
    }
    ::close(fd);
    return rc;
  }
  if (rc != kOk) {
    ::close(fd);
    return rc;
  }
  if (pw != ew || ph != eh) {
    ::close(fd);
    return kErrDims;
  }
  if (!pread_full(fd, dst, need, off)) {
    ::close(fd);
    return kErrShort;
  }
  ::close(fd);
  return kOk;
}

}  // namespace

// Batched parallel decode straight from FILES into one contiguous
// uint8[n, h, w, 3] tensor: the read()-free twin of ppmx_decode_batch.
// Per-file results land in rcs[i] (0 ok, header codes above, -10
// open/stat/read failure) so one corrupt file never costs a re-decode
// pass; returns 0 iff every file succeeded, else the first nonzero rc in
// input order. Rows for failed files are undefined.
int ppmx_decode_batch_files(const char* const* paths, int n, uint8_t* dst,
                            uint32_t w, uint32_t h, int* rcs, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  const size_t stride = static_cast<size_t>(w) * h * 3u;
  auto worker = [&](int t) {
    for (int i = t; i < n; i += nthreads)
      rcs[i] = decode_file_impl(paths[i], dst + stride * i, w, h);
  };
  if (nthreads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nthreads));
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  for (int i = 0; i < n; ++i)
    if (rcs[i] != kOk) return rcs[i];
  return kOk;
}

// Pack bilevel rows MSB-first, zero-padded to byte boundary (P4 payload).
void ppmx_pack_bits(const uint8_t* src, uint8_t* dst, uint32_t w, uint32_t h) {
  const uint32_t row_bytes = (w + 7u) / 8u;
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w;
    uint8_t* out = dst + static_cast<size_t>(y) * row_bytes;
    std::memset(out, 0, row_bytes);
    for (uint32_t x = 0; x < w; ++x)
      out[x >> 3] = static_cast<uint8_t>(out[x >> 3] |
                                         ((row[x] & 1u) << (7u - (x & 7u))));
  }
}

// Encode a P6/P5 payload (header is trivial to build in the host language);
// provided for symmetric batched encode: interleave is a straight memcpy
// since our layout is already HWC.
void ppmx_copy(const uint8_t* src, uint8_t* dst, size_t nbytes) {
  std::memcpy(dst, src, nbytes);
}

namespace {

// Full write with EINTR/partial-write handling; true on success.
bool write_all(int fd, const uint8_t* buf, size_t len) {
  while (len > 0) {
    ssize_t n = ::write(fd, buf, len);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    buf += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

}  // namespace

// Batched parallel file ENCODE: the write-side twin of ppmx_decode_batch
// (the reference's encoder, ppmx-edward.c:221-301, emits ONE byte per
// fwrite; this writes each file as two full buffers — header + payload —
// and parallelizes across files). File i on disk is
//   headers[i][0:header_lens[i]] ++ src[i*stride : i*stride + payload_bytes]
// (headers carry the magic/comment/dims/maxval built by the host language;
// payloads are the already-contiguous uint8 image/packed-bit rows). Per-file
// results land in rcs[i]: 0 ok, -10 open failure, -11 write/close failure.
// Returns 0 iff every file succeeded, else the first nonzero rc.
int ppmx_encode_batch_files(const uint8_t* src, size_t stride,
                            size_t payload_bytes, int n,
                            const char* const* paths,
                            const uint8_t* const* headers,
                            const size_t* header_lens, int* rcs,
                            int nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto worker = [&](int t) {
    for (int i = t; i < n; i += nthreads) {
      int fd = ::open(paths[i], O_WRONLY | O_CREAT | O_TRUNC, 0666);
      if (fd < 0) {
        rcs[i] = -10;
        continue;
      }
      bool ok = write_all(fd, headers[i], header_lens[i]) &&
                write_all(fd, src + stride * static_cast<size_t>(i),
                          payload_bytes);
      if (::close(fd) != 0) ok = false;
      rcs[i] = ok ? kOk : -11;
    }
  };
  if (nthreads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nthreads));
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  for (int i = 0; i < n; ++i)
    if (rcs[i] != kOk) return rcs[i];
  return kOk;
}

}  // extern "C"
