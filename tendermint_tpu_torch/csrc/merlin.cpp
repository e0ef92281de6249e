// Merlin transcripts on STROBE-128 / Keccak-f[1600]: the sr25519
// (schnorrkel) challenges of a batch, on the host.
//
// Counterpart: native/tm_native.cpp:509-703 (keccak_f1600, Strobe,
// sr25519_challenge_64) of the JAX package, as a plain C entry over a
// batch's columns: the port keeps its own copy and loads it with ctypes
// (ops/host.py), built with the host C++ compiler. It mirrors
// crypto/_merlin.py byte for byte (tests/test_torch_merlin.py holds the
// two equal); the pure-Python transcript costs milliseconds a signature,
// this about two microseconds.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace merlin {

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROTC[5][5] = {{0, 36, 3, 41, 18},
                               {1, 44, 10, 45, 2},
                               {62, 6, 43, 15, 61},
                               {28, 55, 25, 21, 56},
                               {27, 20, 39, 8, 14}};

static inline uint64_t rotl64(uint64_t v, int n) {
  return n ? (v << n) | (v >> (64 - n)) : v;
}

// The 24-round permutation of a 200-byte state, lanes little-endian.
static void keccak_f1600(uint8_t state[200]) {
  uint64_t lanes[5][5];
  for (int x = 0; x < 5; x++)
    for (int y = 0; y < 5; y++) memcpy(&lanes[x][y], state + 8 * (x + 5 * y), 8);
  for (int r = 0; r < 24; r++) {
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; x++)
      c[x] = lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4];
    for (int x = 0; x < 5; x++) d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) lanes[x][y] ^= d[x];
    uint64_t b[5][5];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y][(2 * x + 3 * y) % 5] = rotl64(lanes[x][y], ROTC[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        lanes[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y]);
    lanes[0][0] ^= RC[r];
  }
  for (int x = 0; x < 5; x++)
    for (int y = 0; y < 5; y++) memcpy(state + 8 * (x + 5 * y), &lanes[x][y], 8);
}

static const int STROBE_R = 166;  // strobe128 rate
static const uint8_t F_I = 1, F_A = 1 << 1, F_C = 1 << 2, F_M = 1 << 4, F_K = 1 << 5;

// merlin's subset of STROBE-128: meta_ad, ad, prf (no transport, no key).
struct Strobe {
  uint8_t state[200];
  int pos, pos_begin;

  void run_f() {
    state[pos] ^= (uint8_t)pos_begin;
    state[pos + 1] ^= 0x04;
    state[STROBE_R + 1] ^= 0x80;
    keccak_f1600(state);
    pos = 0;
    pos_begin = 0;
  }

  void absorb(const uint8_t* d, size_t n) {
    for (size_t i = 0; i < n; i++) {
      state[pos] ^= d[i];
      if (++pos == STROBE_R) run_f();
    }
  }

  void squeeze(uint8_t* out, size_t n) {
    for (size_t i = 0; i < n; i++) {
      out[i] = state[pos];
      state[pos] = 0;
      if (++pos == STROBE_R) run_f();
    }
  }

  void begin_op(uint8_t flags) {
    const uint8_t old_begin = (uint8_t)pos_begin;
    pos_begin = pos + 1;
    const uint8_t hdr[2] = {old_begin, flags};
    absorb(hdr, 2);
    if ((flags & (F_C | F_K)) && pos != 0) run_f();
  }

  void meta_ad(const uint8_t* d, size_t n, bool more) {
    if (!more) begin_op(F_M | F_A);
    absorb(d, n);
  }

  void ad(const uint8_t* d, size_t n) {
    begin_op(F_A);
    absorb(d, n);
  }

  void prf(uint8_t* out, size_t n) {
    begin_op(F_I | F_A | F_C);
    squeeze(out, n);
  }

  void init(const uint8_t* label, size_t n) {
    memset(state, 0, 200);
    const uint8_t hdr[6] = {1, STROBE_R + 2, 1, 0, 1, 12 * 8};
    memcpy(state, hdr, 6);
    memcpy(state + 6, "STROBEv1.0.2", 12);
    keccak_f1600(state);
    pos = 0;
    pos_begin = 0;
    meta_ad(label, n, false);
  }
};

static void le32(uint8_t out[4], size_t n) {
  for (int i = 0; i < 4; i++) out[i] = (uint8_t)((n >> (8 * i)) & 0xff);
}

static void append_message(Strobe& s, const char* label, const uint8_t* msg, size_t mn) {
  uint8_t le[4];
  le32(le, mn);
  s.meta_ad((const uint8_t*)label, strlen(label), false);
  s.meta_ad(le, 4, true);
  s.ad(msg, mn);
}

// The schnorrkel signing transcript of one signature and its 64-byte
// "sign:c" challenge (crypto/sr25519.py _signing_transcript + verify).
static void challenge_64(const uint8_t* ctx, size_t ctx_len, const uint8_t* msg,
                         size_t msg_len, const uint8_t* pub, const uint8_t* r,
                         uint8_t out[64]) {
  Strobe s;
  s.init((const uint8_t*)"Merlin v1.0", 11);
  append_message(s, "dom-sep", (const uint8_t*)"SigningContext", 14);
  append_message(s, "", ctx, ctx_len);
  append_message(s, "sign-bytes", msg, msg_len);
  append_message(s, "proto-name", (const uint8_t*)"Schnorr-sig", 11);
  append_message(s, "sign:pk", pub, 32);
  append_message(s, "sign:R", r, 32);
  uint8_t le[4];
  le32(le, 64);
  s.meta_ad((const uint8_t*)"sign:c", 6, false);
  s.meta_ad(le, 4, true);
  s.prf(out, 64);
}

}  // namespace merlin

// ---- C interface (loaded with ctypes by ops/host.py) ------------------------
// Signature i: key pubs[32 i .. 32 i + 32), R rs[32 i ..), message
// msg_buf[offsets[i] .. offsets[i + 1]); its challenge goes to
// out[64 i .. 64 i + 64). The caller checks the sizes and the offsets.

extern "C" int tm_sr25519_challenges(const uint8_t* ctx, int64_t ctx_len,
                                     const uint8_t* pubs, const uint8_t* rs,
                                     const uint8_t* msg_buf, const int64_t* offsets,
                                     int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    merlin::challenge_64(ctx, (size_t)ctx_len, msg_buf + offsets[i],
                         (size_t)(offsets[i + 1] - offsets[i]), pubs + 32 * i, rs + 32 * i,
                         out + 64 * i);
  }
  return 0;
}
