// A zstd decoder (RFC 8878), the port's reader of the zstd frames inside
// orbax directory checkpoints (utils/zstd.py, utils/ocdbt.py,
// utils/zarr2.py): the card's machine has no zstd library, and a decoder
// in Python would take minutes on a 105 MB checkpoint.
//
// It decodes every frame the format allows without a dictionary:
//
//   * frames with or without Frame_Content_Size, single segment or with a
//     window descriptor; skippable frames are skipped, several frames are
//     concatenated; the content checksum (XXH64's low 32 bits) is verified
//     when the frame carries one;
//   * raw, RLE and compressed blocks up to 128 KiB;
//   * literals raw, RLE, Huffman-coded with a new table or with the
//     previous block's table (treeless), in 1 or 4 streams, the table's
//     weights direct or FSE-coded;
//   * sequences whose literal-length, offset and match-length tables are
//     predefined, RLE, FSE-coded or repeated from the previous block, and
//     the three repeat offsets carried across blocks.
//
// A frame that needs a dictionary is refused with an error naming the
// dictionary ID.  Any malformed input raises an error: the decoder never
// returns short output.
//
// Host C++, not a CUDA kernel: built with g++ -O3 -shared -fPIC into
// subspace_reg_tpu_torch/_build/ at first use (utils/cuda_build.py) and
// bound with ctypes (utils/zstd.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "zstd_decode.cpp reads little-endian words directly"
#endif

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Corrupt(msg); }

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// little-endian integer of `n` (<= 8) bytes
inline uint64_t rd_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= static_cast<uint64_t>(p[i]) << (8 * i);
  return v;
}

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    do {
      v1 = xxh_round(v1, rd64(p));
      v2 = xxh_round(v2, rd64(p + 8));
      v3 = xxh_round(v3, rd64(p + 16));
      v4 = xxh_round(v4, rd64(p + 24));
      p += 32;
    } while (end - p >= 32);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = P5;
  }
  h += len;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xxh_round(0, rd64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (static_cast<uint64_t>(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------- bit readers

// Forward, least significant bit first (FSE table descriptions).  Bits past
// the end read as 0; the caller checks bytes_used() against the size.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;

  uint32_t peek(int k) const {
    size_t byte = bit >> 3;
    uint64_t v = 0;
    if (byte < n) v = rd_le(p + byte, static_cast<int>(n - byte < 8 ? n - byte : 8));
    return static_cast<uint32_t>((v >> (bit & 7)) & ((1ull << k) - 1));
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    bit += k;
    return v;
  }
  void skip(int k) { bit += k; }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward (FSE and Huffman streams): the stream's last byte holds a 1
// above the final padding; reading starts below it and moves toward byte
// 0.  `pos` counts the bits not yet read; bits below position 0 read as 0
// and drive `pos` negative, which the callers check.
struct BackwardBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;

  BackwardBits(const uint8_t* data, size_t size) : p(data), n(static_cast<int64_t>(size)) {
    if (size == 0) fail("empty bitstream");
    uint8_t last = data[size - 1];
    if (last == 0) fail("bitstream's last byte has no end marker");
    pos = (n - 1) * 8 + highbit(last);
  }

  // bits [start, start + k) of the stream, start >= 0, k <= 56
  inline uint64_t get(int64_t start, int k) const {
    int64_t byte = start >> 3;
    uint64_t v;
    if (byte + 8 <= n) {
      v = rd64(p + byte);
    } else {
      v = rd_le(p + byte, static_cast<int>(n - byte));
    }
    return (v >> (start & 7)) & ((1ull << k) - 1);
  }

  inline uint64_t read(int k) {
    if (k == 0) return 0;
    pos -= k;
    if (pos >= 0) return get(pos, k);
    int have = k + static_cast<int>(pos);  // bits above position 0
    if (have <= 0) return 0;
    return get(0, have) << (-pos);
  }
};

// ------------------------------------------------------------------ FSE

struct FseTable {
  int log = -1;  // -1: no table yet
  std::vector<uint8_t> symbol;
  std::vector<uint8_t> bits;
  std::vector<uint16_t> base;
};

void build_fse(FseTable& t, const int16_t* norm, int n_symbols, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint32_t> next(n_symbols);
  int64_t high = size - 1;
  for (int s = 0; s < n_symbols; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("FSE table overflows");
      t.symbol[high--] = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint32_t>(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < n_symbols; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = static_cast<uint8_t>(s);
      do {
        pos = (pos + step) & mask;
      } while (static_cast<int64_t>(pos) > high);
    }
  }
  if (pos != 0) fail("FSE table's probabilities do not fill it");
  for (uint32_t i = 0; i < size; ++i) {
    uint32_t x = next[t.symbol[i]]++;
    int nb = log - highbit(x);
    t.bits[i] = static_cast<uint8_t>(nb);
    t.base[i] = static_cast<uint16_t>((x << nb) - size);
  }
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.symbol.assign(1, symbol);
  t.bits.assign(1, 0);
  t.base.assign(1, 0);
}

// An FSE table description (RFC 8878 4.1.1) at p[0..n): fills `norm`
// (n_symbols entries) and `log`, returns the bytes it took.
size_t read_fse_description(const uint8_t* p, size_t n, int max_log, int max_symbol,
                            int16_t* norm, int& n_symbols, int& log) {
  if (n == 0) fail("truncated FSE table description");
  ForwardBits br{p, n};
  log = static_cast<int>(br.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, s = 0;
  bool previous0 = false;
  while (remaining > 1 && s <= max_symbol) {
    if (previous0) {
      int n0 = s;
      while (true) {
        int r = static_cast<int>(br.read(2));
        n0 += r;
        if (r != 3) break;
        if (n0 > max_symbol + 1) fail("FSE zero run past the last symbol");
      }
      if (n0 > max_symbol) fail("FSE zero run past the last symbol");
      while (s < n0) norm[s++] = 0;
    }
    const int max = (2 * threshold - 1) - remaining;
    const uint32_t v = br.peek(nb);
    int count;
    if (static_cast<int>(v & (threshold - 1)) < max) {
      count = static_cast<int>(v & (threshold - 1));
      br.skip(nb - 1);
    } else {
      count = static_cast<int>(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(nb);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail("FSE probabilities exceed the table");
    norm[s++] = static_cast<int16_t>(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE probabilities do not sum to the table size");
  if (br.bytes_used() > n) fail("truncated FSE table description");
  n_symbols = s;
  return br.bytes_used();
}

// -------------------------------------------------------------- Huffman

constexpr int kMaxHufBits = 11;

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<uint16_t> entry;  // symbol | bits << 8, indexed by the next max_bits bits
};

// A Huffman tree description (RFC 8878 4.2.1) at p[0..n) into `h`;
// returns the bytes it took.
size_t read_huffman_table(const uint8_t* p, size_t n, HufTable& h) {
  if (n == 0) fail("truncated Huffman tree description");
  uint8_t w[256];
  int nw = 0;
  size_t used;
  const uint8_t header = p[0];
  if (header >= 128) {
    nw = header - 127;
    const size_t bytes = (nw + 1) / 2;
    if (1 + bytes > n) fail("truncated Huffman weights");
    for (int i = 0; i < nw; ++i) {
      const uint8_t b = p[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  } else {
    const size_t csize = header;
    if (csize == 0 || 1 + csize > n) fail("truncated Huffman weights");
    int16_t norm[256];
    int n_symbols, log;
    const size_t hs = read_fse_description(p + 1, csize, 6, 255, norm, n_symbols, log);
    FseTable t;
    build_fse(t, norm, n_symbols, log);
    BackwardBits bb(p + 1 + hs, csize - hs);
    uint32_t s1 = static_cast<uint32_t>(bb.read(log));
    uint32_t s2 = static_cast<uint32_t>(bb.read(log));
    while (true) {
      if (nw > 253) fail("too many Huffman weights");
      w[nw++] = t.symbol[s1];
      s1 = t.base[s1] + static_cast<uint32_t>(bb.read(t.bits[s1]));
      if (bb.pos < 0) {
        w[nw++] = t.symbol[s2];
        break;
      }
      w[nw++] = t.symbol[s2];
      s2 = t.base[s2] + static_cast<uint32_t>(bb.read(t.bits[s2]));
      if (bb.pos < 0) {
        w[nw++] = t.symbol[s1];
        break;
      }
    }
    used = 1 + csize;
  }
  if (nw > 255) fail("too many Huffman weights");
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > kMaxHufBits) fail("Huffman weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all 0");
  const int max_bits = highbit(total) + 1;
  if (max_bits > kMaxHufBits) fail("Huffman code longer than 11 bits");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights leave no power of 2 for the last symbol");
  w[nw++] = static_cast<uint8_t>(highbit(left) + 1);
  // symbols with more bits take the lower table indices; within one
  // length, symbols in increasing order
  uint32_t rank_count[kMaxHufBits + 2] = {0};
  uint8_t bits[256];
  for (int i = 0; i < nw; ++i) {
    bits[i] = w[i] ? static_cast<uint8_t>(max_bits + 1 - w[i]) : 0;
    rank_count[bits[i]]++;
  }
  uint32_t rank_start[kMaxHufBits + 2];
  uint32_t next = 0;
  for (int b = max_bits; b >= 1; --b) {
    rank_start[b] = next;
    next += rank_count[b] << (max_bits - b);
  }
  if (next != (1u << max_bits)) fail("Huffman table does not fill");
  h.max_bits = max_bits;
  h.entry.assign(1u << max_bits, 0);
  for (int i = 0; i < nw; ++i) {
    if (!bits[i]) continue;
    const uint32_t len = 1u << (max_bits - bits[i]);
    const uint16_t e = static_cast<uint16_t>(i | (bits[i] << 8));
    for (uint32_t j = 0; j < len; ++j) h.entry[rank_start[bits[i]] + j] = e;
    rank_start[bits[i]] += len;
  }
  return used;
}

void huffman_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackwardBits bb(p, n);
  const int mb = h.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  uint32_t state = static_cast<uint32_t>(bb.read(mb));
  const uint16_t* table = h.entry.data();
  size_t i = 0;
  // fast path: every read stays above bit 0 of the stream
  while (i < count && bb.pos >= 64) {
    const uint16_t e = table[state];
    out[i++] = static_cast<uint8_t>(e);
    const int nb = e >> 8;
    bb.pos -= nb;
    state = ((state << nb) | static_cast<uint32_t>(bb.get(bb.pos, nb))) & mask;
  }
  for (; i < count; ++i) {
    const uint16_t e = table[state];
    out[i] = static_cast<uint8_t>(e);
    const int nb = e >> 8;
    state = ((state << nb) | static_cast<uint32_t>(bb.read(nb))) & mask;
  }
  if (bb.pos != -mb) fail("Huffman stream does not end where its symbols do");
}

// ------------------------------------------------------------ sequences

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,   11,   12,   13,   14,    15,    16,
                              17, 18, 19, 20, 21, 22, 23, 24,   25,   26,   27,   28,    29,    30,
                              31, 32, 33, 34, 35, 37, 39, 41,   43,   47,   51,   59,    67,    83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

enum { kLL = 0, kOF = 1, kML = 2 };
const int kMaxLog[3] = {9, 8, 9};
const int kMaxSymbol[3] = {35, 31, 52};
const char* const kTableName[3] = {"literal length", "offset", "match length"};

// ---------------------------------------------------------------- frame

// Output: a malloc'd buffer handed to the caller as is.
struct Out {
  uint8_t* data = nullptr;
  size_t size = 0, cap = 0;

  void reserve(size_t want) {
    if (want <= cap) return;
    size_t c = cap ? cap : 1 << 16;
    while (c < want) c *= 2;
    auto* d = static_cast<uint8_t*>(std::realloc(data, c));
    if (!d) throw std::bad_alloc();
    data = d;
    cap = c;
  }
};

struct FrameState {
  HufTable huf;
  FseTable tables[3];
  uint32_t rep[3] = {1, 4, 8};
};

// The literals section of a compressed block at p[0..n) into `lit`;
// returns its size in bytes.
size_t read_literals(const uint8_t* p, size_t n, FrameState& st, std::vector<uint8_t>& lit) {
  if (n == 0) fail("truncated literals section");
  const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
  if (type <= 1) {  // raw, RLE
    size_t hs, regen;
    if (sf == 1) {
      hs = 2;
    } else if (sf == 3) {
      hs = 3;
    } else {
      hs = 1;
    }
    if (hs > n) fail("truncated literals header");
    regen = hs == 1 ? p[0] >> 3 : rd_le(p, static_cast<int>(hs)) >> 4;
    if (regen > kBlockMax) fail("literals above the block maximum");
    lit.resize(regen);
    if (type == 0) {
      if (hs + regen > n) fail("truncated raw literals");
      if (regen) std::memcpy(lit.data(), p + hs, regen);
      return hs + regen;
    }
    if (hs + 1 > n) fail("truncated RLE literals");
    std::memset(lit.data(), p[hs], regen);
    return hs + 1;
  }
  // Huffman-coded (2) or treeless (3)
  const int hs = sf <= 1 ? 3 : sf + 2;
  const int size_bits = sf <= 1 ? 10 : (sf == 2 ? 14 : 18);
  if (static_cast<size_t>(hs) > n) fail("truncated literals header");
  const uint64_t v = rd_le(p, hs);
  const size_t regen = (v >> 4) & ((1u << size_bits) - 1);
  const size_t csize = (v >> (4 + size_bits)) & ((1u << size_bits) - 1);
  const int streams = sf == 0 ? 1 : 4;
  if (regen > kBlockMax) fail("literals above the block maximum");
  if (hs + csize > n) fail("truncated compressed literals");
  const uint8_t* q = p + hs;
  size_t left = csize;
  if (type == 2) {
    const size_t used = read_huffman_table(q, left, st.huf);
    q += used;
    left -= used;
  } else if (st.huf.max_bits == 0) {
    fail("treeless literals without an earlier Huffman table");
  }
  lit.resize(regen);
  if (streams == 1) {
    huffman_stream(st.huf, q, left, lit.data(), regen);
  } else {
    if (left < 6) fail("truncated literals jump table");
    size_t sz[4] = {rd_le(q, 2), rd_le(q + 2, 2), rd_le(q + 4, 2), 0};
    if (sz[0] + sz[1] + sz[2] + 6 > left) fail("literals jump table past the section");
    sz[3] = left - 6 - sz[0] - sz[1] - sz[2];
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("too few literals for 4 streams");
    const uint8_t* s = q + 6;
    for (int i = 0; i < 4; ++i) {
      const size_t cnt = i < 3 ? seg : regen - 3 * seg;
      huffman_stream(st.huf, s, sz[i], lit.data() + i * seg, cnt);
      s += sz[i];
    }
  }
  return hs + csize;
}

void read_table(int which, int mode, const uint8_t*& p, const uint8_t* end, FseTable& t) {
  if (mode == 0) {  // predefined
    const int16_t* norm = which == kLL ? kLLDefault : (which == kML ? kMLDefault : kOFDefault);
    const int count = which == kLL ? 36 : (which == kML ? 53 : 29);
    build_fse(t, norm, count, which == kOF ? 5 : 6);
  } else if (mode == 1) {  // RLE
    if (p >= end) fail("truncated RLE sequence table");
    if (*p > kMaxSymbol[which]) fail(std::string("RLE ") + kTableName[which] + " code out of range");
    rle_fse(t, *p++);
  } else if (mode == 2) {  // FSE-coded
    int16_t norm[64];
    int n_symbols, log;
    p += read_fse_description(p, end - p, kMaxLog[which], kMaxSymbol[which], norm, n_symbols, log);
    build_fse(t, norm, n_symbols, log);
  } else if (t.log < 0) {  // repeat
    fail(std::string("repeated ") + kTableName[which] + " table without an earlier one");
  }
}

void decode_block(const uint8_t* p, size_t n, FrameState& st, Out& out, size_t frame_start,
                  size_t block_max) {
  std::vector<uint8_t> lit;
  size_t used = read_literals(p, n, st, lit);
  const uint8_t* q = p + used;
  const uint8_t* end = p + n;
  if (q >= end) fail("truncated sequences section");
  uint32_t n_seq = *q++;
  if (n_seq >= 128) {
    if (n_seq == 255) {
      if (end - q < 2) fail("truncated sequence count");
      n_seq = rd_le(q, 2) + 0x7F00;
      q += 2;
    } else {
      if (end - q < 1) fail("truncated sequence count");
      n_seq = ((n_seq - 128) << 8) + *q++;
    }
  }
  if (n_seq == 0) {
    if (q != end) fail("bytes after an empty sequences section");
    if (lit.size() > block_max) fail("block above its maximum size");
    out.reserve(out.size + lit.size());
    if (!lit.empty()) std::memcpy(out.data + out.size, lit.data(), lit.size());
    out.size += lit.size();
    return;
  }
  if (q >= end) fail("truncated sequence modes");
  const uint8_t modes = *q++;
  if (modes & 3) fail("reserved bits set in the sequence modes");
  read_table(kLL, modes >> 6, q, end, st.tables[kLL]);
  read_table(kOF, (modes >> 4) & 3, q, end, st.tables[kOF]);
  read_table(kML, (modes >> 2) & 3, q, end, st.tables[kML]);
  if (q >= end) fail("truncated sequence bitstream");
  BackwardBits bb(q, end - q);
  const FseTable &tll = st.tables[kLL], &tof = st.tables[kOF], &tml = st.tables[kML];
  uint32_t sll = static_cast<uint32_t>(bb.read(tll.log));
  uint32_t sof = static_cast<uint32_t>(bb.read(tof.log));
  uint32_t sml = static_cast<uint32_t>(bb.read(tml.log));
  out.reserve(out.size + block_max);
  const size_t block_start = out.size;
  size_t li = 0;
  uint32_t* rep = st.rep;
  for (uint32_t i = 0; i < n_seq; ++i) {
    const int of_code = tof.symbol[sof], ll_code = tll.symbol[sll], ml_code = tml.symbol[sml];
    if (of_code > 31) fail("offset code above 31");
    if (ll_code > 35 || ml_code > 52) fail("length code out of range");
    const uint32_t of_value = (1u << of_code) + static_cast<uint32_t>(bb.read(of_code));
    const uint32_t ml = kMLBase[ml_code] + static_cast<uint32_t>(bb.read(kMLBits[ml_code]));
    const uint32_t ll = kLLBase[ll_code] + static_cast<uint32_t>(bb.read(kLLBits[ll_code]));
    uint32_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const uint32_t idx = of_value - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (offset == 0) fail("repeat offset of 0");
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < n_seq) {
      sll = tll.base[sll] + static_cast<uint32_t>(bb.read(tll.bits[sll]));
      sml = tml.base[sml] + static_cast<uint32_t>(bb.read(tml.bits[sml]));
      sof = tof.base[sof] + static_cast<uint32_t>(bb.read(tof.bits[sof]));
    }
    if (ll > lit.size() - li) fail("sequence takes more literals than the block has");
    if (out.size - block_start + ll + ml > block_max) fail("block above its maximum size");
    if (ll) std::memcpy(out.data + out.size, lit.data() + li, ll);
    out.size += ll;
    li += ll;
    if (offset > out.size - frame_start) fail("match offset before the frame's start");
    uint8_t* dst = out.data + out.size;
    const uint8_t* src = dst - offset;
    if (offset >= ml) {
      std::memcpy(dst, src, ml);
    } else {
      for (uint32_t k = 0; k < ml; ++k) dst[k] = src[k];
    }
    out.size += ml;
  }
  if (bb.pos != 0) fail("sequence bitstream does not end where its sequences do");
  const size_t rest = lit.size() - li;
  if (out.size - block_start + rest > block_max) fail("block above its maximum size");
  if (rest) std::memcpy(out.data + out.size, lit.data() + li, rest);
  out.size += rest;
}

// One frame at p[0..n) appended to `out`; returns the bytes it took.
size_t decode_frame(const uint8_t* p, size_t n, Out& out) {
  if (n < 6) fail("truncated frame header");
  const uint8_t fhd = p[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  const int did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit set in the frame header");
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    const uint8_t wd = p[pos++];
    window = 1ull << (10 + (wd >> 3));
    window += (window >> 3) * (wd & 7);
  }
  const int did_size = did_flag == 3 ? 4 : did_flag;
  const int fcs_size = fcs_flag == 0 ? single : (1 << fcs_flag);
  if (pos + did_size + fcs_size > n) fail("truncated frame header");
  const uint64_t dict_id = rd_le(p + pos, did_size);
  pos += did_size;
  if (dict_id != 0) {
    fail("zstd frame needs dictionary " + std::to_string(dict_id) +
         "; dictionaries are not supported");
  }
  bool has_size = fcs_size > 0;
  uint64_t content = rd_le(p + pos, fcs_size) + (fcs_size == 2 ? 256 : 0);
  pos += fcs_size;
  if (single) window = content;
  const size_t block_max = window < kBlockMax ? static_cast<size_t>(window) : kBlockMax;
  const size_t start = out.size;
  if (has_size) out.reserve(start + (content < (1ull << 30) ? content : (1ull << 30)));
  FrameState st;
  bool last = false;
  while (!last) {
    if (pos + 3 > n) fail("truncated block header");
    const uint32_t bh = static_cast<uint32_t>(rd_le(p + pos, 3));
    pos += 3;
    last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > block_max) fail("block above its maximum size");
    if (type == 0) {
      if (pos + size > n) fail("truncated raw block");
      out.reserve(out.size + size);
      if (size) std::memcpy(out.data + out.size, p + pos, size);
      out.size += size;
      pos += size;
    } else if (type == 1) {
      if (pos + 1 > n) fail("truncated RLE block");
      out.reserve(out.size + size);
      std::memset(out.data + out.size, p[pos], size);
      out.size += size;
      pos += 1;
    } else {
      if (pos + size > n) fail("truncated compressed block");
      decode_block(p + pos, size, st, out, start, block_max);
      pos += size;
    }
    if (has_size && out.size - start > content) fail("frame decodes past its content size");
  }
  if (has_size && out.size - start != content) fail("frame decodes short of its content size");
  if (checksum) {
    if (pos + 4 > n) fail("truncated content checksum");
    const uint32_t want = rd32(p + pos);
    const uint32_t got = static_cast<uint32_t>(xxh64(out.data + start, out.size - start));
    if (want != got) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void copy_error(const char* msg, char* err, size_t err_cap) {
  if (!err || err_cap == 0) return;
  std::strncpy(err, msg, err_cap - 1);
  err[err_cap - 1] = 0;
}

}  // namespace

extern "C" {

// Decode every frame of src[0..n) into a malloc'd buffer (*out, *out_len;
// the caller frees it with zstd_free).  Returns 0, or 1 with the reason in
// err[0..err_cap) and nothing allocated.
int zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_len, char* err,
                    size_t err_cap) {
  Out o;
  try {
    if (n == 0) fail("no zstd frame in empty input");
    size_t pos = 0;
    while (pos < n) {
      if (n - pos < 4) fail("truncated frame magic");
      const uint32_t magic = rd32(src + pos);
      if ((magic & kSkippableMask) == kSkippableMagic) {
        if (n - pos < 8) fail("truncated skippable frame");
        const uint64_t size = rd32(src + pos + 4);
        if (size > n - pos - 8) fail("truncated skippable frame");
        pos += 8 + size;
      } else if (magic == kMagic) {
        pos += decode_frame(src + pos, n - pos, o);
      } else {
        fail("not a zstd frame (magic " + std::to_string(magic) + ")");
      }
    }
    *out = o.data;
    *out_len = o.size;
    return 0;
  } catch (const std::bad_alloc&) {
    std::free(o.data);
    copy_error("out of memory", err, err_cap);
  } catch (const std::exception& e) {
    std::free(o.data);
    copy_error(e.what(), err, err_cap);
  }
  return 1;
}

void zstd_free(uint8_t* p) { std::free(p); }

}  // extern "C"
