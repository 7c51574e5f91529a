// Arithmetic (range) coder over per-symbol quantized CDFs.
//
// TPU-native replacement for the torchac C++ extension used by the
// reference (graphs/models/LLICTI_nets.py:400-407, 485-493).  The CDF
// contract matches torchac's int16-normalized format (LLICTI_nets.py:955-983):
// a CDF row of Lp uint16 entries, strictly increasing modulo 2^16, with
// entry 0 == 0 and entry Lp-1 wrapping to 0 (interpreted as 2^16).
//
// Two encode entry points:
//  * rc_encode_lohi: takes precomputed per-symbol (cdf[s], cdf[s+1]) pairs —
//    the TPU gathers just these 2 values per pixel, slashing host transfer
//    ~250x vs shipping full CDF tables (our key encode-path optimization).
//  * rc_encode_cdf:  takes full per-pixel CDF rows (torchac-style).
// Decode requires full rows (binary search per symbol): rc_decode_cdf.
//
// Coder: classic 32-bit binary arithmetic coder with pending-bit carry
// handling; bit-exact self-inverse.  C ABI for ctypes; thread-safe
// (no global state), so Python can fan out independent streams across a
// thread pool (the GIL is released during ctypes calls).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kTop = 0x80000000u;
constexpr uint32_t kQuarter = 0x40000000u;
constexpr int kPrecision = 16;

class BitWriter {
 public:
  BitWriter(uint8_t* buf, int64_t cap) : buf_(buf), cap_(cap) {}

  inline void put_bit(int bit) {
    cur_ = static_cast<uint8_t>((cur_ << 1) | bit);
    if (++nbits_ == 8) {
      if (len_ < cap_) buf_[len_] = cur_;
      ++len_;
      nbits_ = 0;
      cur_ = 0;
    }
  }

  inline void put_bit_plus_pending(int bit, int64_t& pending) {
    put_bit(bit);
    for (; pending > 0; --pending) put_bit(!bit);
  }

  int64_t finish() {
    // flush partial byte (pad with zeros)
    if (nbits_ > 0) {
      cur_ = static_cast<uint8_t>(cur_ << (8 - nbits_));
      if (len_ < cap_) buf_[len_] = cur_;
      ++len_;
    }
    return len_;  // may exceed cap_: caller must check (buffer overflow)
  }

 private:
  uint8_t* buf_;
  int64_t cap_;
  int64_t len_ = 0;
  int nbits_ = 0;
  uint8_t cur_ = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* buf, int64_t len) : buf_(buf), len_(len) {}

  inline int get_bit() {
    if (pos_ >= len_) return 0;  // zero-padding past end (matches writer flush)
    int bit = (buf_[pos_] >> (7 - nbits_)) & 1;
    if (++nbits_ == 8) {
      nbits_ = 0;
      ++pos_;
    }
    return bit;
  }

 private:
  const uint8_t* buf_;
  int64_t len_;
  int64_t pos_ = 0;
  int nbits_ = 0;
};

// cdf entry fetch with the wrap convention: stored 0 at the top means 2^16.
inline uint32_t cdf_hi(uint16_t v) { return v == 0 ? (1u << kPrecision) : v; }

struct Encoder {
  uint32_t low = 0;
  uint32_t high = 0xFFFFFFFFu;
  int64_t pending = 0;

  inline void encode(uint32_t c_lo, uint32_t c_hi, BitWriter& bw) {
    const uint64_t span = static_cast<uint64_t>(high) - low + 1;
    high = low + static_cast<uint32_t>((span * c_hi) >> kPrecision) - 1;
    low = low + static_cast<uint32_t>((span * c_lo) >> kPrecision);
    for (;;) {
      if (high < kTop) {
        bw.put_bit_plus_pending(0, pending);
      } else if (low >= kTop) {
        bw.put_bit_plus_pending(1, pending);
        low -= kTop;
        high -= kTop;
      } else if (low >= kQuarter && high < kTop + kQuarter) {
        ++pending;
        low -= kQuarter;
        high -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1;
    }
  }

  inline void finish(BitWriter& bw) {
    ++pending;
    if (low < kQuarter) {
      bw.put_bit_plus_pending(0, pending);
    } else {
      bw.put_bit_plus_pending(1, pending);
    }
  }
};

struct Decoder {
  uint32_t low = 0;
  uint32_t high = 0xFFFFFFFFu;
  uint32_t value = 0;
  BitReader* br;

  explicit Decoder(BitReader* r) : br(r) {
    for (int i = 0; i < 32; ++i) value = (value << 1) | br->get_bit();
  }

  // returns the scaled cumulative target in [0, 2^16)
  inline uint32_t target() const {
    const uint64_t span = static_cast<uint64_t>(high) - low + 1;
    return static_cast<uint32_t>(
        ((static_cast<uint64_t>(value - low) + 1) * (1u << kPrecision) - 1) /
        span);
  }

  inline void consume(uint32_t c_lo, uint32_t c_hi) {
    const uint64_t span = static_cast<uint64_t>(high) - low + 1;
    high = low + static_cast<uint32_t>((span * c_hi) >> kPrecision) - 1;
    low = low + static_cast<uint32_t>((span * c_lo) >> kPrecision);
    for (;;) {
      if (high < kTop) {
        // nothing
      } else if (low >= kTop) {
        low -= kTop;
        high -= kTop;
        value -= kTop;
      } else if (low >= kQuarter && high < kTop + kQuarter) {
        low -= kQuarter;
        high -= kQuarter;
        value -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1;
      value = (value << 1) | br->get_bit();
    }
  }
};

}  // namespace

extern "C" {

// Encode n symbols given per-symbol (lo, hi) cumulative bounds.
// hi==0 is interpreted as 2^16.  Returns bytes written, or -1 if out_cap
// was insufficient (caller should retry with a larger buffer).
int64_t rc_encode_lohi(const uint16_t* lo, const uint16_t* hi, int64_t n,
                       uint8_t* out, int64_t out_cap) {
  BitWriter bw(out, out_cap);
  Encoder enc;
  for (int64_t i = 0; i < n; ++i) {
    enc.encode(lo[i], cdf_hi(hi[i]), bw);
  }
  enc.finish(bw);
  int64_t len = bw.finish();
  return len <= out_cap ? len : -1;
}

// Encode n symbols from full per-symbol CDF rows (row-major [n, Lp]).
int64_t rc_encode_cdf(const uint16_t* cdf, int32_t Lp, const int16_t* syms,
                      int64_t n, uint8_t* out, int64_t out_cap) {
  BitWriter bw(out, out_cap);
  Encoder enc;
  for (int64_t i = 0; i < n; ++i) {
    const uint16_t* row = cdf + i * Lp;
    const int s = syms[i];
    enc.encode(row[s], cdf_hi(row[s + 1]), bw);
  }
  enc.finish(bw);
  int64_t len = bw.finish();
  return len <= out_cap ? len : -1;
}

// Decode n symbols from full per-symbol CDF rows (row-major [n, Lp]).
// Returns 0 on success.
int64_t rc_decode_cdf(const uint16_t* cdf, int32_t Lp, int64_t n,
                      const uint8_t* in, int64_t in_len, int16_t* out_syms) {
  BitReader br(in, in_len);
  Decoder dec(&br);
  const int32_t nsym = Lp - 1;
  for (int64_t i = 0; i < n; ++i) {
    const uint16_t* row = cdf + i * Lp;
    const uint32_t t = dec.target();
    // binary search: largest s with row[s] <= t  (row[0] == 0)
    int32_t lo_i = 0, hi_i = nsym;  // invariant: row[lo_i] <= t < cdf_hi(row[hi_i])
    while (hi_i - lo_i > 1) {
      const int32_t mid = (lo_i + hi_i) >> 1;
      const uint32_t v = (mid == nsym) ? (1u << kPrecision) : row[mid];
      if (v <= t) {
        lo_i = mid;
      } else {
        hi_i = mid;
      }
    }
    const int32_t s = lo_i;
    out_syms[i] = static_cast<int16_t>(s);
    dec.consume(row[s], cdf_hi(row[s + 1]));
  }
  return 0;
}

// Decode a stream where every symbol shares ONE CDF row (used for unit
// tests and uniform/raw side-band coding).
int64_t rc_decode_shared_cdf(const uint16_t* cdf_row, int32_t Lp, int64_t n,
                             const uint8_t* in, int64_t in_len,
                             int16_t* out_syms) {
  BitReader br(in, in_len);
  Decoder dec(&br);
  const int32_t nsym = Lp - 1;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t t = dec.target();
    int32_t lo_i = 0, hi_i = nsym;
    while (hi_i - lo_i > 1) {
      const int32_t mid = (lo_i + hi_i) >> 1;
      const uint32_t v = (mid == nsym) ? (1u << kPrecision) : cdf_row[mid];
      if (v <= t) {
        lo_i = mid;
      } else {
        hi_i = mid;
      }
    }
    const int32_t s = lo_i;
    out_syms[i] = static_cast<int16_t>(s);
    dec.consume(cdf_row[s], cdf_hi(cdf_row[s + 1]));
  }
  return 0;
}

}  // extern "C"
