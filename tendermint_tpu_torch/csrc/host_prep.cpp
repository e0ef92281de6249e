// Host prep of the ed25519 and sr25519 commit paths: commit selection,
// tally and canonical vote sign bytes over a commit's columns; the
// challenges k = SHA-512(R || A || M) mod L; the RLC lane scalars; and the
// reduction of sr25519's 64-byte challenges mod L.
//
// Counterpart: native/tm_native.cpp of the JAX package (sha512 :172-340,
// sc_mul / sc_add :1344-1406, native_pool_width / parallel_ranges /
// offsets_valid :1745-1790, scalar_below_l :1836, ed25519_challenges_buf
// :1853, ed25519_rlc_prep :2019, vote_sign_bytes_batch_buf :2129,
// commit_prep_fused :2247), as the port's own copy with a plain C
// interface: no Python C API, every output in a buffer the caller
// allocates, loaded with ctypes by ops/host.py (which checks shapes,
// dtypes and contiguity first). SHA-512 is the scalar implementation
// below, threaded over ranges of signatures where the hashing pays for
// the threads. commit_prep_fused here leaves out the reference's
// device-hash RAM blocks. Every entry returns 0 on success and -1 on
// inputs it refuses (an offset table that is not non-decreasing from 0
// inside its buffer, a buffer too short); the threads never touch Python
// objects, and ctypes releases the interpreter lock for the call.

#include <sched.h>

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace sha512 {

static const uint64_t K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

static inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

struct Ctx {
  uint64_t h[8];
  uint8_t buf[128];
  size_t buflen;
  uint64_t total;  // bytes
};

static void init(Ctx* c) {
  static const uint64_t H0[8] = {
      0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
      0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
      0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  memcpy(c->h, H0, sizeof H0);
  c->buflen = 0;
  c->total = 0;
}

static void compress(Ctx* c, const uint8_t* p) {
  uint64_t w[80];
  for (int i = 0; i < 16; i++) {
    w[i] = 0;
    for (int b = 0; b < 8; b++) w[i] = (w[i] << 8) | p[8 * i + b];
  }
  for (int i = 16; i < 80; i++) {
    uint64_t s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7);
    uint64_t s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint64_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3], e = c->h[4], f = c->h[5],
           g = c->h[6], h = c->h[7];
  for (int i = 0; i < 80; i++) {
    uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = h + S1 + ch + K[i] + w[i];
    uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    uint64_t maj = (a & b) ^ (a & cc) ^ (b & cc);
    uint64_t t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = cc;
    cc = b;
    b = a;
    a = t1 + t2;
  }
  c->h[0] += a;
  c->h[1] += b;
  c->h[2] += cc;
  c->h[3] += d;
  c->h[4] += e;
  c->h[5] += f;
  c->h[6] += g;
  c->h[7] += h;
}

static void update(Ctx* c, const uint8_t* data, size_t n) {
  c->total += n;
  if (c->buflen) {
    size_t take = 128 - c->buflen;
    if (take > n) take = n;
    memcpy(c->buf + c->buflen, data, take);
    c->buflen += take;
    data += take;
    n -= take;
    if (c->buflen == 128) {
      compress(c, c->buf);
      c->buflen = 0;
    }
  }
  while (n >= 128) {
    compress(c, data);
    data += 128;
    n -= 128;
  }
  if (n) {
    memcpy(c->buf, data, n);
    c->buflen = n;
  }
}

static void final(Ctx* c, uint8_t out[64]) {
  uint64_t bits = c->total * 8;
  uint8_t pad = 0x80;
  update(c, &pad, 1);
  uint8_t z = 0;
  while (c->buflen != 112) update(c, &z, 1);
  uint8_t len[16] = {0};
  for (int i = 0; i < 8; i++) len[15 - i] = uint8_t(bits >> (8 * i));
  update(c, len, 16);
  for (int i = 0; i < 8; i++)
    for (int b = 0; b < 8; b++) out[8 * i + b] = uint8_t(c->h[i] >> (56 - 8 * b));
}

// x = a 64-byte little-endian integer mod L, L = 2^252 + C,
// C = 27742317777372353535851937790883648493. Since 2^252 = -C (mod L),
// each fold rewrites x = hi 2^252 + lo as lo + K_r - hi C, K_r a multiple
// of L large enough to keep the result positive (K1 = L << 133,
// K2 = L << 7, K3 = L; 512 -> 386 -> 260 -> 254 bits), then subtracts L
// while x >= L (at most 3 times: x < 2^254 < 4L).
static const uint64_t C_LO = 0x5812631a5cf5d3edULL;
static const uint64_t C_HI = 0x14def9dea2f79cd6ULL;  // C = C_HI << 64 | C_LO
static const uint64_t L_LIMBS[4] = {C_LO, C_HI, 0, 0x1000000000000000ULL};
static const uint64_t FOLD_K[3][7] = {
    {0x0000000000000000ULL, 0x0000000000000000ULL, 0x024c634b9eba7da0ULL,
     0x9bdf3bd45ef39acbULL, 0x0000000000000002ULL, 0x0000000000000000ULL,
     0x0000000000000002ULL},
    {0x09318d2e7ae9f680ULL, 0x6f7cef517bce6b2cULL, 0x000000000000000aULL,
     0x0000000000000000ULL, 0x0000000000000008ULL, 0x0000000000000000ULL,
     0x0000000000000000ULL},
    {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0x0000000000000000ULL,
     0x1000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL,
     0x0000000000000000ULL}};

static void mod_l(const uint8_t digest[64], uint8_t out[32]) {
  uint64_t x[8] = {0};
  for (int i = 0; i < 8; i++)
    for (int b = 0; b < 8; b++) x[i] |= uint64_t(digest[8 * i + b]) << (8 * b);
  for (int round = 0; round < 3; round++) {
    // hi = x >> 252 (up to 5 limbs), lo = x & (2^252 - 1)
    uint64_t hi[5];
    for (int i = 0; i < 5; i++) {
      uint64_t v = (i + 3 < 8) ? (x[i + 3] >> 60) : 0;
      if (i + 4 < 8) v |= x[i + 4] << 4;
      hi[i] = v;
    }
    uint64_t lo[4] = {x[0], x[1], x[2], x[3] & 0x0fffffffffffffffULL};
    // t = hi C (7 limbs)
    uint64_t t[7];
    unsigned __int128 carry = 0;
    for (int i = 0; i < 7; i++) {
      unsigned __int128 acc = carry;
      if (i < 5) acc += (unsigned __int128)hi[i] * C_LO;
      if (i >= 1 && i <= 5) acc += (unsigned __int128)hi[i - 1] * C_HI;
      t[i] = uint64_t(acc);
      carry = acc >> 64;
    }
    // x = lo + K_round - t, never negative
    memset(x, 0, sizeof x);
    unsigned __int128 acc2 = 0;
    uint64_t borrow = 0;
    for (int i = 0; i < 7; i++) {
      acc2 += (i < 4 ? lo[i] : 0);
      acc2 += FOLD_K[round][i];
      uint64_t add = uint64_t(acc2);
      unsigned __int128 d = (unsigned __int128)add - t[i] - borrow;
      x[i] = uint64_t(d);
      borrow = (uint64_t)(d >> 64) ? 1 : 0;
      acc2 >>= 64;
    }
  }
  for (int rep = 0; rep < 3; rep++) {
    bool ge = true;
    for (int i = 3; i >= 0; i--) {
      if (x[i] > L_LIMBS[i]) break;
      if (x[i] < L_LIMBS[i]) {
        ge = false;
        break;
      }
    }
    if (!ge) break;
    uint64_t borrow = 0;
    for (int i = 0; i < 4; i++) {
      unsigned __int128 d = (unsigned __int128)x[i] - L_LIMBS[i] - borrow;
      x[i] = uint64_t(d);
      borrow = (uint64_t)(d >> 64) ? 1 : 0;
    }
  }
  for (int i = 0; i < 4; i++)
    for (int b = 0; b < 8; b++) out[8 * i + b] = uint8_t(x[i] >> (8 * b));
}

// k = SHA-512(R || A || M) mod L, 32 bytes little-endian.
static void challenge(const uint8_t* r, const uint8_t* pub, const uint8_t* msg, size_t mlen,
                      uint8_t k[32]) {
  Ctx c;
  init(&c);
  update(&c, r, 32);
  update(&c, pub, 32);
  update(&c, msg, mlen);
  uint8_t digest[64];
  final(&c, digest);
  mod_l(digest, k);
}

}  // namespace sha512

namespace sc {

static void load4(uint64_t out[4], const uint8_t a[32]) {
  for (int i = 0; i < 4; i++) {
    out[i] = 0;
    for (int j = 0; j < 8; j++) out[i] |= (uint64_t)a[8 * i + j] << (8 * j);
  }
}

// out = a b mod L: the full 512-bit schoolbook product, then mod_l.
static void mul(uint8_t out[32], const uint8_t a[32], const uint8_t b[32]) {
  uint64_t al[4], bl[4];
  load4(al, a);
  load4(bl, b);
  uint64_t prod[8] = {0};
  for (int i = 0; i < 4; i++) {
    unsigned __int128 carry = 0;
    for (int j = 0; j < 4; j++) {
      unsigned __int128 cur = (unsigned __int128)al[i] * bl[j] + prod[i + j] + carry;
      prod[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    prod[i + 4] = (uint64_t)carry;
  }
  uint8_t wide[64];
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) wide[8 * i + j] = (uint8_t)(prod[i] >> (8 * j));
  sha512::mod_l(wide, out);
}

// out = (a + b) mod L for a, b < L; out may alias a or b.
static void add(uint8_t out[32], const uint8_t a[32], const uint8_t b[32]) {
  uint64_t al[4], bl[4], s[4];
  load4(al, a);
  load4(bl, b);
  unsigned __int128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (unsigned __int128)al[i] + bl[i];
    s[i] = (uint64_t)c;
    c >>= 64;
  }
  // sum < 2L (< 2^253): one conditional subtract of L
  bool ge = c != 0;
  if (!ge) {
    ge = true;
    for (int i = 3; i >= 0; i--) {
      if (s[i] > sha512::L_LIMBS[i]) break;
      if (s[i] < sha512::L_LIMBS[i]) {
        ge = false;
        break;
      }
    }
  }
  if (ge) {
    uint64_t borrow = 0;
    for (int i = 0; i < 4; i++) {
      unsigned __int128 d = (unsigned __int128)s[i] - sha512::L_LIMBS[i] - borrow;
      s[i] = (uint64_t)d;
      borrow = (uint64_t)(d >> 64) ? 1 : 0;
    }
  }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(s[i] >> (8 * j));
}

// s < L (RFC 8032's scalar range) for a 32-byte little-endian s.
static inline bool below_l(const uint8_t s[32]) {
  static const uint8_t L_BYTES[32] = {0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58,
                                      0xd6, 0x9c, 0xf7, 0xa2, 0xde, 0xf9, 0xde, 0x14,
                                      0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
                                      0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};
  for (int j = 31; j >= 0; j--) {
    if (s[j] < L_BYTES[j]) return true;
    if (s[j] > L_BYTES[j]) return false;
  }
  return false;  // s == L
}

}  // namespace sc

// Threads: the CPUs of this process's affinity mask, or TM_NATIVE_THREADS
// (1..1023) when set.
static unsigned pool_width() {
  unsigned hw = 0;
  cpu_set_t setmask;
  if (sched_getaffinity(0, sizeof(setmask), &setmask) == 0) hw = (unsigned)CPU_COUNT(&setmask);
  if (!hw) hw = std::thread::hardware_concurrency();
  const char* env = getenv("TM_NATIVE_THREADS");
  if (env && *env) {
    long v = strtol(env, nullptr, 10);
    if (v > 0 && v < 1024) hw = (unsigned)v;
  }
  return hw ? hw : 1;
}

// fn(lo, hi) over [0, n) in pool_width() contiguous ranges, one thread
// each; on the calling thread alone below min_serial items.
template <typename Fn>
static void parallel_ranges(int64_t n, int64_t min_serial, Fn fn) {
  int64_t nthreads = (int64_t)pool_width();
  if (nthreads > n) nthreads = n > 0 ? n : 1;
  if (nthreads <= 1 || n < min_serial) {
    fn((int64_t)0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; t++) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// An offset table of n messages: offs[0] = 0, non-decreasing, inside the
// buffer. Checked before any thread starts: a decreasing pair would wrap
// offs[i+1] - offs[i] to a huge length.
static bool offsets_valid(const int64_t* op, int64_t n, int64_t msgs_len) {
  if (n < 0) return false;
  if (n == 0) return true;
  if (op[0] != 0 || op[n] > msgs_len) return false;
  for (int64_t i = 0; i < n; i++)
    if (op[i + 1] < op[i]) return false;
  return true;
}

static size_t put_uvarint(uint8_t* dst, uint64_t v) {
  size_t i = 0;
  while (v >= 0x80) {
    dst[i++] = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  dst[i++] = (uint8_t)v;
  return i;
}

static size_t uvarint_len(uint64_t v) {
  size_t i = 1;
  while (v >= 0x80) {
    v >>= 7;
    i++;
  }
  return i;
}

// Canonical vote sign bytes: delimited(prefix || field 5 {Timestamp} ||
// suffix), the Timestamp's seconds and nanos as varints of their 64-bit
// two's complement, each left out when 0 (proto3).
static size_t sign_bytes_len(size_t plen, size_t slen, int64_t secs, int64_t nanos) {
  size_t tn = (secs ? 1 + uvarint_len((uint64_t)secs) : 0) +
              (nanos ? 1 + uvarint_len((uint64_t)nanos) : 0);
  size_t body = plen + 1 + uvarint_len(tn) + tn + slen;
  return uvarint_len(body) + body;
}

static void sign_bytes_put(uint8_t* p, const uint8_t* pfx, size_t plen, const uint8_t* sfx,
                           size_t slen, int64_t secs, int64_t nanos) {
  uint8_t ts_body[22];
  size_t tn = 0;
  if (secs) {
    ts_body[tn++] = 0x08;
    tn += put_uvarint(ts_body + tn, (uint64_t)secs);
  }
  if (nanos) {
    ts_body[tn++] = 0x10;
    tn += put_uvarint(ts_body + tn, (uint64_t)nanos);
  }
  uint8_t mid[32];
  size_t mn = 0;
  mid[mn++] = 0x2a;
  mn += put_uvarint(mid + mn, tn);
  memcpy(mid + mn, ts_body, tn);
  mn += tn;
  p += put_uvarint(p, plen + mn + slen);
  memcpy(p, pfx, plen);
  p += plen;
  memcpy(p, mid, mn);
  p += mn;
  memcpy(p, sfx, slen);
}

extern "C" {

// The threads a call may use (pool_width()).
int tm_host_threads(void) { return (int)pool_width(); }

// out[32 i ..] = k_i = SHA-512(rs[32 i ..] || pubs[32 i ..] || message i)
// mod L, message i = msgs[offs[i] .. offs[i + 1]).
int tm_ed25519_challenges_buf(const uint8_t* rs, const uint8_t* pubs, const uint8_t* msgs,
                              int64_t msgs_len, const int64_t* offs, int64_t n, uint8_t* out) {
  if (!offsets_valid(offs, n, msgs_len)) return -1;
  parallel_ranges(n, 2048, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++)
      sha512::challenge(rs + 32 * i, pubs + 32 * i, msgs + offs[i],
                        (size_t)(offs[i + 1] - offs[i]), out + 32 * i);
  });
  return 0;
}

// The RLC host prep of n signatures (pubs n x 32, sigs n x 64 = R || s,
// messages as above) padded to `total` rows (a multiple of m, >= n) in
// g = total / m lanes of m: k_out (n x 32) the challenges; su_out
// (g + total) x 32, first the lane scalars S_lane = (s_0 + sum_{j >= 1}
// z_j s_j) mod L, then U_i = k_0 for a lane's row 0 and (z_i k_i) mod L
// for its rows 1..m-1; sok_out (total) 1 where s < L. z is total x 32.
// Padding rows: U = 0 and s_ok = 1, no S term.
int tm_ed25519_rlc_prep(const uint8_t* pubs, const uint8_t* sigs, const uint8_t* msgs,
                        int64_t msgs_len, const int64_t* offs, int64_t n, const uint8_t* z,
                        int64_t m, int64_t total, uint8_t* k_out, uint8_t* su_out,
                        uint8_t* sok_out) {
  if (m <= 0 || total < n || total % m || !offsets_valid(offs, n, msgs_len)) return -1;
  int64_t g = total / m;
  uint8_t* S = su_out;
  uint8_t* U = su_out + 32 * g;
  // lane-disjoint: a lane reads its rows and writes only its own slots
  parallel_ranges(g, 256, [&](int64_t lane_lo, int64_t lane_hi) {
    for (int64_t lane = lane_lo; lane < lane_hi; lane++) {
      int64_t base = lane * m;
      for (int64_t i = base; i < base + m; i++) {
        if (i >= n) {
          sok_out[i] = 1;
          continue;
        }
        sok_out[i] = sc::below_l(sigs + 64 * i + 32) ? 1 : 0;
        sha512::challenge(sigs + 64 * i, pubs + 32 * i, msgs + offs[i],
                          (size_t)(offs[i + 1] - offs[i]), k_out + 32 * i);
      }
      uint8_t wide[64] = {0};
      if (base < n) memcpy(wide, sigs + 64 * base + 32, 32);
      sha512::mod_l(wide, S + 32 * lane);
      if (base < n)
        memcpy(U + 32 * base, k_out + 32 * base, 32);
      else
        memset(U + 32 * base, 0, 32);
      for (int64_t j = 1; j < m; j++) {
        int64_t i = base + j;
        if (i >= n) {
          memset(U + 32 * i, 0, 32);
          continue;
        }
        uint8_t zs[32];
        sc::mul(zs, z + 32 * i, sigs + 64 * i + 32);
        sc::add(S + 32 * lane, S + 32 * lane, zs);
        sc::mul(U + 32 * i, z + 32 * i, k_out + 32 * i);
      }
    }
  });
  return 0;
}

// out[32 i ..] = digests[64 i ..] (little-endian) mod L. On the calling
// thread: 10,000 reductions took 0.95 ms on one thread and 2.46 ms on 8
// on an H100's host (chip_smoke.py's host phase).
int tm_mod_l_many(const uint8_t* digests, int64_t n, uint8_t* out) {
  if (n < 0) return -1;
  for (int64_t i = 0; i < n; i++) sha512::mod_l(digests + 64 * i, out + 32 * i);
  return 0;
}

// The sign bytes of n votes of one template (prefix, suffix), times[2 i]
// and times[2 i + 1] vote i's Timestamp seconds and nanos: record i at
// buf[offs[i] .. offs[i + 1]), offs (n + 1). -1 when the records need more
// than cap bytes.
int tm_vote_sign_bytes_batch_buf(const uint8_t* pfx, int64_t plen, const uint8_t* sfx,
                                 int64_t slen, const int64_t* times, int64_t n, uint8_t* buf,
                                 int64_t cap, int64_t* offs) {
  if (n < 0 || plen < 0 || slen < 0) return -1;
  offs[0] = 0;
  for (int64_t i = 0; i < n; i++)
    offs[i + 1] = offs[i] + (int64_t)sign_bytes_len((size_t)plen, (size_t)slen, times[2 * i],
                                                    times[2 * i + 1]);
  if (offs[n] > cap) return -1;
  for (int64_t i = 0; i < n; i++)
    sign_bytes_put(buf + offs[i], pfx, (size_t)plen, sfx, (size_t)slen, times[2 * i],
                   times[2 * i + 1]);
  return 0;
}

// The commit side of verify_commit over a commit's columns (flags n,
// sigs n x 64, ts_secs, ts_nanos n) and its validator set's (pubs n x 32,
// power n): selection, the voting-power tally against threshold, the
// sign bytes of every selected vote (prefix pfx_nil for a NIL vote,
// pfx_commit otherwise) and the pub / sig rows of the selection.
//
// mode bits: 1 selects COMMIT votes only (else every vote but ABSENT),
// 2 tallies COMMIT votes only, 4 stops after the vote that takes the
// tally above threshold (and keeps it).
//
// Writes sel_out (up to n) the selected rows, *m_out their count and
// *tallied_out the tally. Returns 1, having done nothing more, when the
// tally is not above threshold; else 0 with pub_out (m x 32), sig_out
// (m x 64), the sign bytes in msgs_out and offs_out (m + 1); -1 when they
// need more than msgs_cap bytes.
int tm_commit_prep_fused(const uint8_t* flags, const uint8_t* sigs, const int64_t* ts_secs,
                         const int32_t* ts_nanos, const uint8_t* pubs, const int64_t* power,
                         int64_t n, const uint8_t* pfx_commit, int64_t pfx_commit_len,
                         const uint8_t* pfx_nil, int64_t pfx_nil_len, const uint8_t* sfx,
                         int64_t sfx_len, int64_t threshold, int64_t mode, int64_t* sel_out,
                         int64_t* m_out, int64_t* tallied_out, uint8_t* pub_out,
                         uint8_t* sig_out, uint8_t* msgs_out, int64_t msgs_cap,
                         int64_t* offs_out) {
  if (n < 0 || pfx_commit_len < 0 || pfx_nil_len < 0 || sfx_len < 0) return -1;
  const bool sel_commit = mode & 1, count_fb = mode & 2, early = mode & 4;
  int64_t m = 0, tallied = 0;
  for (int64_t i = 0; i < n; i++) {
    uint8_t f = flags[i];
    if (sel_commit ? (f != 2) : (f == 1)) continue;
    sel_out[m++] = i;
    if (!count_fb || f == 2) tallied += power[i];
    if (early && tallied > threshold) break;
  }
  *m_out = m;
  *tallied_out = tallied;
  if (tallied <= threshold) return 1;
  offs_out[0] = 0;
  for (int64_t j = 0; j < m; j++) {
    int64_t i = sel_out[j];
    size_t plen = (size_t)(flags[i] == 3 ? pfx_nil_len : pfx_commit_len);
    offs_out[j + 1] = offs_out[j] + (int64_t)sign_bytes_len(plen, (size_t)sfx_len, ts_secs[i],
                                                            (int64_t)ts_nanos[i]);
  }
  if (offs_out[m] > msgs_cap) return -1;
  // on the calling thread, unlike the reference (threads from 1,024
  // rows): at 10,000 rows it took 0.92 ms on one thread and 3.05 ms on
  // 8 on an H100's host (chip_smoke.py's host phase)
  for (int64_t j = 0; j < m; j++) {
    int64_t i = sel_out[j];
    memcpy(pub_out + 32 * j, pubs + 32 * i, 32);
    memcpy(sig_out + 64 * j, sigs + 64 * i, 64);
    bool nil = flags[i] == 3;
    sign_bytes_put(msgs_out + offs_out[j], nil ? pfx_nil : pfx_commit,
                   (size_t)(nil ? pfx_nil_len : pfx_commit_len), sfx, (size_t)sfx_len,
                   ts_secs[i], (int64_t)ts_nanos[i]);
  }
  return 0;
}

}  // extern "C"
