// Native host oracle: scalar tower field + additive NTT + mt19937.
//
// Role: the framework's fast, independent reference implementation for
// generating golden vectors at sizes the Python scalar oracle cannot reach
// (the JAX pipelines are validated bit-exactly against it).  This mirrors
// the reference repo's use of host-side C++ for offline tooling (its
// circuit generator and CPU verifier paths); the algorithms are the
// standard Fan-Paar tower recursion and the Gao-Mateer additive NTT as
// described in SURVEY.md §2/§3 — implemented fresh against the same math as
// binius_ntt_tpu/fields/tower_scalar.py and binius_ntt_tpu/ntt/reference.py.
//
// Build: g++ -O2 -shared -fPIC -o liboracle.so oracle.cpp
//
// Exposed C ABI (see binius_ntt_tpu/utils/native_oracle.py):
//   mt19937_fill(seed, out, n)
//   tower_mul128(a, b, out, n)         // n muls of little-endian 4-word vals
//   additive_ntt32(in, log_h, log_rate, out)
//   additive_ntt128(in, log_h, log_rate, out)  // 4 words per element

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------- mt19937 (standard parameters) ----------------

struct MT {
  uint32_t st[624];
  int idx;
  explicit MT(uint32_t seed) {
    st[0] = seed;
    for (int i = 1; i < 624; ++i)
      st[i] = 1812433253u * (st[i - 1] ^ (st[i - 1] >> 30)) + i;
    idx = 624;
  }
  void twist() {
    for (int i = 0; i < 624; ++i) {
      uint32_t y = (st[i] & 0x80000000u) | (st[(i + 1) % 624] & 0x7fffffffu);
      uint32_t m = (y & 1u) ? 0x9908b0dfu : 0u;
      st[i] = st[(i + 397) % 624] ^ (y >> 1) ^ m;
    }
    idx = 0;
  }
  uint32_t next() {
    if (idx >= 624) twist();
    uint32_t y = st[idx++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }
};

// ---------------- Fan-Paar tower over uint64 (heights 0..6) ----------------

template <int H>
struct Tower {
  static constexpr uint64_t half_bits = 1ull << (H - 1);
  static constexpr uint64_t mask =
      (H == 6) ? 0xffffffffull : ((1ull << (1ull << (H - 1))) - 1ull);

  static uint64_t mul(uint64_t a, uint64_t b) {
    uint64_t a0 = a & mask, a1 = (a >> (1ull << (H - 1))) & mask;
    uint64_t b0 = b & mask, b1 = (b >> (1ull << (H - 1))) & mask;
    uint64_t z0 = Tower<H - 1>::mul(a0, b0);
    uint64_t z2 = Tower<H - 1>::mul(a1, b1);
    uint64_t z1 = Tower<H - 1>::mul(a0 ^ a1, b0 ^ b1) ^ z0 ^ z2;
    uint64_t z2a = Tower<H - 1>::mul_alpha(z2);
    return (z0 ^ z2) | ((z1 ^ z2a) << (1ull << (H - 1)));
  }
  static uint64_t sq(uint64_t a) {
    uint64_t a0 = a & mask, a1 = (a >> (1ull << (H - 1))) & mask;
    uint64_t z0 = Tower<H - 1>::sq(a0);
    uint64_t z2 = Tower<H - 1>::sq(a1);
    return (z0 ^ z2) | (Tower<H - 1>::mul_alpha(z2) << (1ull << (H - 1)));
  }
  static uint64_t mul_alpha(uint64_t a) {
    uint64_t a0 = a & mask, a1 = (a >> (1ull << (H - 1))) & mask;
    return a1 | ((a0 ^ Tower<H - 1>::mul_alpha(a1)) << (1ull << (H - 1)));
  }
  static uint64_t inv(uint64_t a) {
    if (a == 0) return 0;
    uint64_t a1 = (a >> (1ull << (H - 1))) & mask;
    if (a1 == 0) return Tower<H - 1>::inv(a);
    uint64_t a0 = a & mask;
    uint64_t inter = a0 ^ Tower<H - 1>::mul_alpha(a1);
    uint64_t delta = Tower<H - 1>::mul(a0, inter) ^ Tower<H - 1>::sq(a1);
    uint64_t dinv = Tower<H - 1>::inv(delta);
    return Tower<H - 1>::mul(dinv, inter) |
           (Tower<H - 1>::mul(dinv, a1) << (1ull << (H - 1)));
  }
};

template <>
struct Tower<0> {
  static uint64_t mul(uint64_t a, uint64_t b) { return a & b & 1; }
  static uint64_t sq(uint64_t a) { return a & 1; }
  static uint64_t mul_alpha(uint64_t a) { return a & 1; }
  static uint64_t inv(uint64_t a) { return a & 1; }
};

// Height-3 table floor: the golden-tail digests (log_h 26..28) cost hours
// per entry on one core if the recursion bottoms out at height 0.  Bottoming
// out in a 64 KB height-3 mul table (built once, at load, from the same
// Karatsuba recursion over Tower<2>) keeps the results bit-identical while
// cutting the leaf-op count per Tower<6>::mul from 3^6 recursive calls to
// 3^3 L1-resident loads.
struct T3Tables {
  uint8_t mul[256][256];
  uint8_t alpha[256];
  uint8_t sq[256];
  uint8_t inv[256];
  T3Tables() {
    auto rmul = [](uint64_t a, uint64_t b) -> uint64_t {
      uint64_t a0 = a & 0xf, a1 = (a >> 4) & 0xf;
      uint64_t b0 = b & 0xf, b1 = (b >> 4) & 0xf;
      uint64_t z0 = Tower<2>::mul(a0, b0);
      uint64_t z2 = Tower<2>::mul(a1, b1);
      uint64_t z1 = Tower<2>::mul(a0 ^ a1, b0 ^ b1) ^ z0 ^ z2;
      return (z0 ^ z2) | ((z1 ^ Tower<2>::mul_alpha(z2)) << 4);
    };
    for (int a = 0; a < 256; ++a) {
      uint64_t a0 = a & 0xf, a1 = (uint64_t(a) >> 4) & 0xf;
      alpha[a] = uint8_t(a1 | ((a0 ^ Tower<2>::mul_alpha(a1)) << 4));
      uint64_t s0 = Tower<2>::sq(a0), s2 = Tower<2>::sq(a1);
      sq[a] = uint8_t((s0 ^ s2) | (Tower<2>::mul_alpha(s2) << 4));
      if (a == 0) {
        inv[a] = 0;
      } else if (a1 == 0) {
        inv[a] = uint8_t(Tower<2>::inv(a0));
      } else {
        uint64_t inter = a0 ^ Tower<2>::mul_alpha(a1);
        uint64_t delta = Tower<2>::mul(a0, inter) ^ Tower<2>::sq(a1);
        uint64_t dinv = Tower<2>::inv(delta);
        inv[a] = uint8_t(Tower<2>::mul(dinv, inter) |
                         (Tower<2>::mul(dinv, a1) << 4));
      }
      for (int b = 0; b < 256; ++b) mul[a][b] = uint8_t(rmul(a, b));
    }
  }
};

const T3Tables T3;  // built at library load

template <>
struct Tower<3> {
  static uint64_t mul(uint64_t a, uint64_t b) { return T3.mul[a][b]; }
  static uint64_t sq(uint64_t a) { return T3.sq[a]; }
  static uint64_t mul_alpha(uint64_t a) { return T3.alpha[a]; }
  static uint64_t inv(uint64_t a) { return T3.inv[a]; }
};

// 128-bit elements as two uint64 halves (one Karatsuba level over height 6).
struct U128 {
  uint64_t lo, hi;
};

inline U128 mul128(U128 a, U128 b) {
  uint64_t z0 = Tower<6>::mul(a.lo, b.lo);
  uint64_t z2 = Tower<6>::mul(a.hi, b.hi);
  uint64_t z1 = Tower<6>::mul(a.lo ^ a.hi, b.lo ^ b.hi) ^ z0 ^ z2;
  uint64_t z2a = Tower<6>::mul_alpha(z2);
  return U128{z0 ^ z2, z1 ^ z2a};
}

inline U128 sq128(U128 a) {
  uint64_t z0 = Tower<6>::sq(a.lo);
  uint64_t z2 = Tower<6>::sq(a.hi);
  return U128{z0 ^ z2, Tower<6>::mul_alpha(z2)};
}

inline U128 mul_alpha128(U128 a) {
  return U128{a.hi, a.lo ^ Tower<6>::mul_alpha(a.hi)};
}

inline U128 inv128(U128 a) {
  if (a.lo == 0 && a.hi == 0) return U128{0, 0};
  if (a.hi == 0) return U128{Tower<6>::inv(a.lo), 0};
  uint64_t inter = a.lo ^ Tower<6>::mul_alpha(a.hi);
  uint64_t delta = Tower<6>::mul(a.lo, inter) ^ Tower<6>::sq(a.hi);
  uint64_t dinv = Tower<6>::inv(delta);
  return U128{Tower<6>::mul(dinv, inter), Tower<6>::mul(dinv, a.hi)};
}

// ---------------- additive NTT (generic over the two element types) -------

// subspace-evaluation table: rows[s][j], s < log_h, j < log_h+log_rate-1-s;
// twiddle(s, indicator) = XOR of rows[s][k] over set bits k.
template <typename E, E (*MUL)(E, E), E (*SQ)(E), E (*INV)(E), E ONE_F()>
struct ANTT {
  static std::vector<std::vector<E>> precompute(int log_h, int log_rate,
                                                E (*from_pow2)(int)) {
    int width = log_h + log_rate - 1;
    std::vector<std::vector<E>> rows(log_h, std::vector<E>(width));
    for (int i = 1; i < log_h + log_rate; ++i) rows[0][i - 1] = from_pow2(i);
    std::vector<E> norms{ONE_F()};
    for (int i = 1; i < log_h; ++i) {
      E np_ = norms.back();
      auto smap = [&](E x) {
        E s = SQ(x);
        E t = MUL(np_, x);
        // add = XOR, done by caller type
        return xor_e(s, t);
      };
      E norm_i = smap(rows[i - 1][0]);
      for (int j = 1; j < log_h + log_rate - i; ++j)
        rows[i][j - 1] = smap(rows[i - 1][j]);
      norms.push_back(norm_i);
    }
    for (int i = 0; i < log_h; ++i) {
      E inv_n = INV(norms[i]);
      for (int j = 0; j < log_h + log_rate - i - 1; ++j)
        rows[i][j] = MUL(inv_n, rows[i][j]);
    }
    return rows;
  }

  static E xor_e(E a, E b);

  static void apply(const E* input, int log_h, int log_rate, E* out,
                    E (*from_pow2)(int)) {
    auto rows = precompute(log_h, log_rate, from_pow2);
    const size_t n = size_t(1) << log_h;
    for (int coset = 0; coset < (1 << log_rate); ++coset) {
      E* data = out + size_t(coset) * n;
      std::memcpy(data, input, n * sizeof(E));
      for (int s = log_h - 1; s >= 0; --s) {
        size_t nblocks = n >> (s + 1);
        for (size_t block = 0; block < nblocks; ++block) {
          uint64_t ind = (uint64_t(coset) << (log_h - 1 - s)) | block;
          E w{};
          for (int k = 0; k < log_h + log_rate - 1 - s; ++k)
            if ((ind >> k) & 1) w = xor_e(w, rows[s][k]);
          size_t base = block << (s + 1);
          for (size_t bidx = 0; bidx < (size_t(1) << s); ++bidx) {
            E u = data[base + bidx];
            E v = data[base + bidx + (size_t(1) << s)];
            E u2 = xor_e(u, MUL(w, v));
            data[base + bidx] = u2;
            data[base + bidx + (size_t(1) << s)] = xor_e(u2, v);
          }
        }
      }
    }
  }
};

// uint32 (height 5) instantiation helpers
static uint32_t mul32(uint32_t a, uint32_t b) {
  return uint32_t(Tower<5>::mul(a, b));
}
static uint32_t sq32(uint32_t a) { return uint32_t(Tower<5>::sq(a)); }
static uint32_t inv32(uint32_t a) { return uint32_t(Tower<5>::inv(a)); }
static uint32_t one32() { return 1u; }
static uint32_t pow2_32(int i) { return 1u << i; }

static U128 mul128e(U128 a, U128 b) { return mul128(a, b); }
static U128 sq128e(U128 a) { return sq128(a); }
static U128 inv128e(U128 a) { return inv128(a); }
static U128 one128() { return U128{1, 0}; }
static U128 pow2_128(int i) {
  return (i < 64) ? U128{1ull << i, 0} : U128{0, 1ull << (i - 64)};
}

template <>
uint32_t ANTT<uint32_t, mul32, sq32, inv32, one32>::xor_e(uint32_t a,
                                                          uint32_t b) {
  return a ^ b;
}
template <>
U128 ANTT<U128, mul128e, sq128e, inv128e, one128>::xor_e(U128 a, U128 b) {
  return U128{a.lo ^ b.lo, a.hi ^ b.hi};
}

}  // namespace

extern "C" {

void mt19937_fill(uint32_t seed, uint32_t* out, size_t n) {
  MT g(seed);
  for (size_t i = 0; i < n; ++i) out[i] = g.next();
}

void tower_mul128(const uint32_t* a, const uint32_t* b, uint32_t* out,
                  size_t n) {
  for (size_t i = 0; i < n; ++i) {
    U128 x{uint64_t(a[4 * i]) | (uint64_t(a[4 * i + 1]) << 32),
           uint64_t(a[4 * i + 2]) | (uint64_t(a[4 * i + 3]) << 32)};
    U128 y{uint64_t(b[4 * i]) | (uint64_t(b[4 * i + 1]) << 32),
           uint64_t(b[4 * i + 2]) | (uint64_t(b[4 * i + 3]) << 32)};
    U128 z = mul128(x, y);
    out[4 * i] = uint32_t(z.lo);
    out[4 * i + 1] = uint32_t(z.lo >> 32);
    out[4 * i + 2] = uint32_t(z.hi);
    out[4 * i + 3] = uint32_t(z.hi >> 32);
  }
}

void additive_ntt32(const uint32_t* in, int log_h, int log_rate,
                    uint32_t* out) {
  ANTT<uint32_t, mul32, sq32, inv32, one32>::apply(in, log_h, log_rate, out,
                                                   pow2_32);
}

void additive_ntt128(const uint32_t* in, int log_h, int log_rate,
                     uint32_t* out) {
  const size_t n = size_t(1) << log_h;
  std::vector<U128> ein(n);
  for (size_t i = 0; i < n; ++i)
    ein[i] = U128{uint64_t(in[4 * i]) | (uint64_t(in[4 * i + 1]) << 32),
                  uint64_t(in[4 * i + 2]) | (uint64_t(in[4 * i + 3]) << 32)};
  std::vector<U128> eout(n << log_rate);
  ANTT<U128, mul128e, sq128e, inv128e, one128>::apply(
      ein.data(), log_h, log_rate, eout.data(), pow2_128);
  for (size_t i = 0; i < eout.size(); ++i) {
    out[4 * i] = uint32_t(eout[i].lo);
    out[4 * i + 1] = uint32_t(eout[i].lo >> 32);
    out[4 * i + 2] = uint32_t(eout[i].hi);
    out[4 * i + 3] = uint32_t(eout[i].hi >> 32);
  }
}

}  // extern "C"
