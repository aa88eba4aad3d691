// lmic_rans — native rANS range coder for lmic_tpu.
//
// A from-scratch 64-bit rANS implementation producing the same stream format
// as the reference coder (compressai/cpp_exts/rans/rans_interface.cpp +
// third_party/ryg_rans/rans64.h): 16-bit probability precision, per-symbol
// CDF rows selected by an index array, out-of-range values escaped through a
// sentinel symbol followed by 4-bit bypass nibbles (sign folded as
// raw = -2v-1 / 2(v-max)), encoder state flushed as two little-endian 32-bit
// words, stream words emitted back-to-front.
//
// Differences from the reference binding, by design:
//   * C ABI over flat int32/uint8 arrays (ctypes + numpy zero-copy) instead
//     of pybind11 std::vector marshaling — the reference converts tensors to
//     Python lists per image, which dominates its host-side coding cost.
//   * one-shot encode needs no intermediate symbol buffer: symbols are
//     emitted in a single reverse pass.
//   * decoder symbol search is a binary search (CDF rows are strictly
//     increasing) instead of a linear scan.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 16;
constexpr uint32_t kBypassPrecision = 4;
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;
constexpr uint64_t kRansL = 1ull << 31;

struct Enc {
  uint64_t x = kRansL;

  // Emit one symbol with cumulative range [start, start + freq) at the given
  // precision. Words are written *backwards* through `ptr`.
  inline void put(uint32_t **ptr, uint32_t start, uint32_t freq) {
    uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
    if (x >= x_max) {
      *--(*ptr) = static_cast<uint32_t>(x);
      x >>= 32;
    }
    x = ((x / freq) << kPrecision) + (x % freq) + start;
  }

  // Raw-bit bypass: value `val` in `nbits` bits (nbits <= 16).
  inline void put_bits(uint32_t **ptr, uint32_t val, uint32_t nbits) {
    uint32_t freq = 1u << (16 - nbits);
    uint64_t x_max = ((kRansL >> 16) << 32) * freq;
    if (x >= x_max) {
      *--(*ptr) = static_cast<uint32_t>(x);
      x >>= 32;
    }
    x = (x << nbits) | val;
  }

  inline void flush(uint32_t **ptr) {
    *ptr -= 2;
    (*ptr)[0] = static_cast<uint32_t>(x);
    (*ptr)[1] = static_cast<uint32_t>(x >> 32);
  }
};

struct Dec {
  uint64_t x = 0;
  const uint32_t *ptr = nullptr;
  const uint32_t *end = nullptr;

  // `nbytes` bounds every read: a truncated or corrupted stream decodes
  // to garbage symbols (renorm words past the end read as 0) instead of
  // reading past the buffer. Valid streams never hit the bound — the
  // branch is perfectly predicted and free in the hot path.
  inline void init(const uint32_t *p, int64_t nbytes) {
    const int64_t nwords = nbytes < 0 ? 0 : nbytes / 4;
    end = p + nwords;
    if (nwords >= 2) {
      x = (static_cast<uint64_t>(p[1]) << 32) | p[0];
      ptr = p + 2;
    } else {
      x = 0;
      ptr = end;
    }
  }

  inline uint32_t next_word() {
    return ptr < end ? *ptr++ : 0u;
  }

  inline uint32_t peek() const {
    return static_cast<uint32_t>(x & ((1u << kPrecision) - 1));
  }

  inline void advance(uint32_t start, uint32_t freq) {
    constexpr uint64_t mask = (1ull << kPrecision) - 1;
    x = freq * (x >> kPrecision) + (x & mask) - start;
    if (x < kRansL) {
      x = (x << 32) | next_word();
    }
  }

  inline uint32_t get_bits(uint32_t nbits) {
    uint32_t val = static_cast<uint32_t>(x) & ((1u << nbits) - 1);
    x >>= nbits;
    if (x < kRansL) {
      x = (x << 32) | next_word();
    }
  return val;
  }
};

// Map a source symbol to (cdf slot, escaped raw value). Returns the slot and
// sets `raw_val` when the value escapes the table range.
inline int32_t fold_symbol(int32_t value, int32_t max_value,
                           uint32_t *raw_val, bool *escaped) {
  if (value < 0) {
    *raw_val = static_cast<uint32_t>(-2 * value - 1);
    *escaped = true;
    return max_value;
  }
  if (value >= max_value) {
    *raw_val = static_cast<uint32_t>(2 * (value - max_value));
    *escaped = true;
    return max_value;
  }
  *escaped = false;
  return value;
}

// Emit one source symbol in reverse sub-symbol order (bypass nibbles, bypass
// counts, then the main slot). Used by the single-pass reverse encoder.
inline void encode_one_reverse(Enc &enc, uint32_t **ptr, int32_t symbol,
                               const int32_t *cdf, int32_t cdf_size,
                               int32_t offset) {
  const int32_t max_value = cdf_size - 2;
  uint32_t raw_val = 0;
  bool escaped = false;
  const int32_t slot = fold_symbol(symbol - offset, max_value, &raw_val,
                                   &escaped);

  if (escaped) {
    int32_t n_bypass = 0;
    while ((raw_val >> (n_bypass * kBypassPrecision)) != 0) ++n_bypass;

    for (int32_t j = n_bypass - 1; j >= 0; --j) {
      enc.put_bits(ptr, (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal,
                   kBypassPrecision);
    }
    // Count sequence forward order: (15)*k then n_bypass - 15k. Reverse it.
    int32_t k = n_bypass / static_cast<int32_t>(kMaxBypassVal);
    enc.put_bits(ptr, n_bypass - k * kMaxBypassVal, kBypassPrecision);
    for (int32_t j = 0; j < k; ++j) {
      enc.put_bits(ptr, kMaxBypassVal, kBypassPrecision);
    }
  }

  const uint32_t start = static_cast<uint32_t>(cdf[slot]);
  const uint32_t freq = static_cast<uint32_t>(cdf[slot + 1] - cdf[slot]);
  enc.put(ptr, start, freq);
}

// First slot s with cdf[s] <= cum < cdf[s+1]; binary search over the strictly
// increasing row prefix [0, size).
inline int32_t find_slot(const int32_t *cdf, int32_t size, uint32_t cum) {
  int32_t lo = 0, hi = size;  // invariant: cdf[lo] <= cum < cdf[hi]
  while (hi - lo > 1) {
    const int32_t mid = (lo + hi) >> 1;
    if (static_cast<uint32_t>(cdf[mid]) <= cum) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

inline int32_t decode_one(Dec &dec, const int32_t *cdf, int32_t cdf_size,
                          int32_t offset) {
  const int32_t max_value = cdf_size - 2;
  const uint32_t cum = dec.peek();
  const int32_t s = find_slot(cdf, cdf_size, cum);
  dec.advance(static_cast<uint32_t>(cdf[s]),
              static_cast<uint32_t>(cdf[s + 1] - cdf[s]));

  int32_t value = s;
  if (value == max_value) {
    uint32_t val = dec.get_bits(kBypassPrecision);
    uint32_t n_bypass = val;
    while (val == kMaxBypassVal) {
      val = dec.get_bits(kBypassPrecision);
      n_bypass += val;
    }
    uint32_t raw_val = 0;
    for (uint32_t j = 0; j < n_bypass; ++j) {
      const uint32_t bits = dec.get_bits(kBypassPrecision);
      // valid streams carry <= 8 nibbles (int32 payload); cap the
      // shift so a corrupt count cannot shift past uint32 width (UB)
      if (j < 32 / kBypassPrecision) {
        raw_val |= bits << (j * kBypassPrecision);
      }
    }
    value = static_cast<int32_t>(raw_val >> 1);
    if (raw_val & 1) {
      value = -value - 1;
    } else {
      value += max_value;
    }
  }
  return value + offset;
}

struct RansSymbol {
  uint16_t start;
  uint16_t range;
  bool bypass;
};

// Buffered (chunked) encoder used by autoregressive codecs: chunks arrive in
// forward order; flush() emits the whole buffer in reverse.
struct BufferedEncoder {
  std::vector<RansSymbol> syms;
};

void buffered_append(BufferedEncoder *be, const int32_t *symbols,
                     const int32_t *indexes, int64_t n, const int32_t *cdfs,
                     int64_t cdf_stride, const int32_t *cdfs_sizes,
                     const int32_t *offsets) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdfs_sizes[idx] - 2;

    uint32_t raw_val = 0;
    bool escaped = false;
    const int32_t slot =
        fold_symbol(symbols[i] - offsets[idx], max_value, &raw_val, &escaped);

    be->syms.push_back({static_cast<uint16_t>(cdf[slot]),
                        static_cast<uint16_t>(cdf[slot + 1] - cdf[slot]),
                        false});

    if (escaped) {
      int32_t n_bypass = 0;
      while ((raw_val >> (n_bypass * kBypassPrecision)) != 0) ++n_bypass;

      int32_t val = n_bypass;
      while (val >= static_cast<int32_t>(kMaxBypassVal)) {
        be->syms.push_back({static_cast<uint16_t>(kMaxBypassVal),
                            static_cast<uint16_t>(kMaxBypassVal + 1), true});
        val -= kMaxBypassVal;
      }
      be->syms.push_back({static_cast<uint16_t>(val),
                          static_cast<uint16_t>(val + 1), true});
      for (int32_t j = 0; j < n_bypass; ++j) {
        const uint32_t v = (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal;
        be->syms.push_back({static_cast<uint16_t>(v),
                            static_cast<uint16_t>(v + 1), true});
      }
    }
  }
}

int64_t buffered_flush(BufferedEncoder *be, uint8_t *out, int64_t capacity) {
  std::vector<uint32_t> buf(be->syms.size() + 2);
  uint32_t *ptr = buf.data() + buf.size();
  Enc enc;
  for (auto it = be->syms.rbegin(); it != be->syms.rend(); ++it) {
    if (!it->bypass) {
      enc.put(&ptr, it->start, it->range);
    } else {
      enc.put_bits(&ptr, it->start, kBypassPrecision);
    }
  }
  enc.flush(&ptr);
  const int64_t nbytes =
      (buf.data() + buf.size() - ptr) * static_cast<int64_t>(sizeof(uint32_t));
  if (nbytes > capacity) return -1;
  std::memcpy(out, ptr, nbytes);
  be->syms.clear();
  return nbytes;
}

struct StreamDecoder {
  std::string stream;
  Dec dec;
};

}  // namespace

extern "C" {

// One-shot encode. Returns the stream size in bytes (written at out[0..n)),
// or -1 if `out_capacity` is too small.
int64_t lmic_rans_encode_with_indexes(
    const int32_t *symbols, const int32_t *indexes, int64_t n,
    const int32_t *cdfs, int64_t cdf_stride, const int32_t *cdfs_sizes,
    const int32_t *offsets, uint8_t *out, int64_t out_capacity) {
  // Worst case per symbol: 1 main word + (8 nibbles + 2 count) bypass words,
  // each sub-symbol emitting at most one renormalization word; + 2 flush.
  std::vector<uint32_t> buf(static_cast<size_t>(n) * 12 + 2);
  uint32_t *ptr = buf.data() + buf.size();
  Enc enc;

  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t idx = indexes[i];
    encode_one_reverse(enc, &ptr, symbols[i], cdfs + idx * cdf_stride,
                       cdfs_sizes[idx], offsets[idx]);
  }
  enc.flush(&ptr);

  const int64_t nbytes =
      (buf.data() + buf.size() - ptr) * static_cast<int64_t>(sizeof(uint32_t));
  if (nbytes > out_capacity) return -1;
  std::memcpy(out, ptr, nbytes);
  return nbytes;
}

// One-shot decode of `n` symbols into out_symbols. Returns n.
int64_t lmic_rans_decode_with_indexes(
    const uint8_t *stream, int64_t nbytes, const int32_t *indexes, int64_t n,
    const int32_t *cdfs, int64_t cdf_stride, const int32_t *cdfs_sizes,
    const int32_t *offsets, int32_t *out_symbols) {
  Dec dec;
  dec.init(reinterpret_cast<const uint32_t *>(stream), nbytes);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    out_symbols[i] =
        decode_one(dec, cdfs + idx * cdf_stride, cdfs_sizes[idx],
                   offsets[idx]);
  }
  return n;
}

// Build a coarse cum->slot lookup table: lut[row * 256 + (cum >> 8)] is the
// slot containing the bucket's first cum value; decode starts there and
// scans forward. 256 entries/row keeps the whole table L1/L2-resident
// (a full 2^16-entry LUT measures ~2x SLOWER than binary search — it
// DRAM-misses on nearly every symbol).
constexpr uint32_t kLutShift = 8;
constexpr int64_t kLutSpan = int64_t(1) << (kPrecision - kLutShift);

void lmic_rans_build_lut(const int32_t *cdfs, int64_t cdf_stride,
                         const int32_t *cdfs_sizes, int64_t rows,
                         uint16_t *lut) {
  for (int64_t r = 0; r < rows; ++r) {
    const int32_t *cdf = cdfs + r * cdf_stride;
    uint16_t *row = lut + r * kLutSpan;
    const int32_t nslots = cdfs_sizes[r] - 1;
    int32_t s = 0;
    for (int64_t b = 0; b < kLutSpan; ++b) {
      const int32_t cum = static_cast<int32_t>(b << kLutShift);
      while (s + 1 < nslots && cdf[s + 1] <= cum) ++s;
      row[b] = static_cast<uint16_t>(s);
    }
  }
}

// LUT-accelerated one-shot decode (same stream format as
// lmic_rans_decode_with_indexes).
int64_t lmic_rans_decode_with_indexes_lut(
    const uint8_t *stream, int64_t nbytes, const int32_t *indexes, int64_t n,
    const int32_t *cdfs, int64_t cdf_stride, const int32_t *cdfs_sizes,
    const int32_t *offsets, const uint16_t *lut, int32_t *out_symbols) {
  Dec dec;
  dec.init(reinterpret_cast<const uint32_t *>(stream), nbytes);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdfs_sizes[idx] - 2;
    const uint32_t cum = dec.peek();
    int32_t s = lut[idx * kLutSpan + (cum >> kLutShift)];
    while (static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;
    dec.advance(static_cast<uint32_t>(cdf[s]),
                static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
    int32_t value = s;
    if (value == max_value) {
      uint32_t val = dec.get_bits(kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec.get_bits(kBypassPrecision);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        const uint32_t bits = dec.get_bits(kBypassPrecision);
      // valid streams carry <= 8 nibbles (int32 payload); cap the
      // shift so a corrupt count cannot shift past uint32 width (UB)
      if (j < 32 / kBypassPrecision) {
        raw_val |= bits << (j * kBypassPrecision);
      }
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    out_symbols[i] = value + offsets[idx];
  }
  return n;
}

// ---- Buffered encoder (chunked, autoregressive encode) ----

void *lmic_rans_encoder_new() { return new BufferedEncoder(); }

void lmic_rans_encoder_append(void *handle, const int32_t *symbols,
                              const int32_t *indexes, int64_t n,
                              const int32_t *cdfs, int64_t cdf_stride,
                              const int32_t *cdfs_sizes,
                              const int32_t *offsets) {
  buffered_append(static_cast<BufferedEncoder *>(handle), symbols, indexes, n,
                  cdfs, cdf_stride, cdfs_sizes, offsets);
}

int64_t lmic_rans_encoder_flush(void *handle, uint8_t *out, int64_t capacity) {
  return buffered_flush(static_cast<BufferedEncoder *>(handle), out, capacity);
}

void lmic_rans_encoder_free(void *handle) {
  delete static_cast<BufferedEncoder *>(handle);
}

// ---- Streaming decoder (chunked, autoregressive decode) ----

void *lmic_rans_decoder_new(const uint8_t *stream, int64_t nbytes) {
  auto *sd = new StreamDecoder();
  sd->stream.assign(reinterpret_cast<const char *>(stream),
                    static_cast<size_t>(nbytes));
  sd->dec.init(reinterpret_cast<const uint32_t *>(sd->stream.data()),
               static_cast<int64_t>(sd->stream.size()));
  return sd;
}

int64_t lmic_rans_decoder_decode(void *handle, const int32_t *indexes,
                                 int64_t n, const int32_t *cdfs,
                                 int64_t cdf_stride, const int32_t *cdfs_sizes,
                                 const int32_t *offsets, int32_t *out) {
  auto *sd = static_cast<StreamDecoder *>(handle);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    out[i] = decode_one(sd->dec, cdfs + idx * cdf_stride, cdfs_sizes[idx],
                        offsets[idx]);
  }
  return n;
}

// LUT-accelerated streaming decode (see lmic_rans_build_lut).
int64_t lmic_rans_decoder_decode_lut(
    void *handle, const int32_t *indexes, int64_t n, const int32_t *cdfs,
    int64_t cdf_stride, const int32_t *cdfs_sizes, const int32_t *offsets,
    const uint16_t *lut, int32_t *out) {
  auto *sd = static_cast<StreamDecoder *>(handle);
  Dec &dec = sd->dec;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t *cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdfs_sizes[idx] - 2;
    const uint32_t cum = dec.peek();
    int32_t s = lut[idx * kLutSpan + (cum >> kLutShift)];
    while (static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;
    dec.advance(static_cast<uint32_t>(cdf[s]),
                static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
    int32_t value = s;
    if (value == max_value) {
      uint32_t val = dec.get_bits(kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec.get_bits(kBypassPrecision);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        const uint32_t bits = dec.get_bits(kBypassPrecision);
      // valid streams carry <= 8 nibbles (int32 payload); cap the
      // shift so a corrupt count cannot shift past uint32 width (UB)
      if (j < 32 / kBypassPrecision) {
        raw_val |= bits << (j * kBypassPrecision);
      }
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    out[i] = value + offsets[idx];
  }
  return n;
}

void lmic_rans_decoder_free(void *handle) {
  delete static_cast<StreamDecoder *>(handle);
}

}  // extern "C"
