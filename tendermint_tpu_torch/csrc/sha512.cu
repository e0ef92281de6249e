// The ed25519 challenge k = SHA-512(R || A || M) mod L on the card, for
// sm_90a.
//
// Counterpart: tendermint_tpu/ops/sha512.py sha512_blocks (:174, with
// _compress_block :109) followed by tendermint_tpu/ops/sc.py
// digest_to_le_bits (:65), mod_l_from_bits (:38) and limbs_to_bits (:57):
// the device-hash prologue of the op-graph kernels (ed25519_verify.py
// :290-330). Plain PyTorch version: tendermint_tpu_torch/ops/sha512.py
// sha512_challenge_plain, which this kernel matches byte for byte.
//
// Input: each message already padded on the host into NBLOCK 128-byte
// blocks (terminator and 128-bit length in place) as big-endian 64-bit
// words split into their high and low 32 bits, (B, NBLOCK, 16) each, and
// its block count (B,). Output: (B, 32) bytes of k, little-endian, the
// layout of the host challenges, so both hash routes feed the same
// verify kernels (ed25519_verify.cu).
//
// Design: one thread a message. The TPU kernel kept each 64-bit word as
// two uint32 lanes, with rotations split into 32-bit shifts and carries
// rippled by compares, because its vector unit has no 64-bit integers;
// here the words are native uint64_t, and a rotation is a funnel shift
// pair. The compression is the textbook 80 rounds over a 16-word rolling
// schedule. The reference reduces the digest by a 512-step bitwise
// Horner on 13-bit limbs; here the digest, read as a little-endian
// integer (RFC 8032), is reduced by a Horner over its 64 bytes on nine
// 32-bit words: acc = 256 acc + byte, then the quotient by L estimated as
// acc >> 252 (at most one too large, since L exceeds 2^252 by less than
// 2^125) and acc - q L, plus L if that went negative. Both reductions
// are exact, so k is the same bytes.
//
// Its work: 32-bit integer operations, counted from this source with a
// 64-bit operation as two. A block takes 5,728: 80 rounds of 50 (two big
// sigmas of three rotations and two XORs, 10 each; choose 6; majority
// 10; five 64-bit additions), 64 scheduled words of 26 (two small sigmas
// of 10, three additions), the 16 words' loads and the state's eight
// additions (64). The reduction takes 6,400: 64 steps of 100 (the byte,
// the 9-word shift, the quotient, 8 words of a 32 x 32 -> 64 multiply, a
// subtract and a borrow, the top word). chip_smoke.py records these as
// the kernel's count (SHA_KERNEL_OPS_*); its bound counts the least the
// function needs instead: 28 operations a round and 20 a scheduled word
// with three-input logic ops and funnel shifts (SHA_OPS_PER_BLOCK), and a
// reduction by three folds of 2^252 = -c mod L (sha_fold_mod_l), a small
// fraction of this Horner. Verification hashes public data: nothing here
// is constant time.

#include <cuda_runtime.h>

#include <cstdint>

namespace sha {

__constant__ uint64_t K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

// L = 2^252 + 27742317777372353535851937790883648493, eight 32-bit words,
// least first.
__constant__ uint32_t LW[8] = {0x5cf5d3ed, 0x5812631a, 0xa2f79cd6, 0x14def9de,
                               0x00000000, 0x00000000, 0x00000000, 0x10000000};

constexpr int THREADS = 128;

__device__ __forceinline__ uint64_t ror(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// One compression of h by the 16 words w (overwritten by the schedule).
__device__ __forceinline__ void compress(uint64_t (&h)[8], uint64_t (&w)[16]) {
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll 16
  for (int t = 0; t < 80; ++t) {
    const int j = t & 15;
    if (t >= 16) {
      const uint64_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      const uint64_t s0 = ror(w15, 1) ^ ror(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = ror(w2, 19) ^ ror(w2, 61) ^ (w2 >> 6);
      w[j] += s0 + w[(t + 9) & 15] + s1;
    }
    const uint64_t S1 = ror(e, 14) ^ ror(e, 18) ^ ror(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = hh + S1 + ch + K[t] + w[j];
    const uint64_t S0 = ror(a, 28) ^ ror(a, 34) ^ ror(a, 39);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint64_t t2 = S0 + maj;
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

// The 64-byte digest (h as big-endian words: byte 8 i + p is byte p of
// h[i] from the top) read as a little-endian integer, mod L, into 32
// little-endian bytes.
__device__ __forceinline__ void reduce_mod_l(const uint64_t (&h)[8], uint8_t* __restrict__ out) {
  uint32_t acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0;
#pragma unroll 1
  for (int j = 63; j >= 0; --j) {
    const uint32_t byte = (uint32_t)(h[j >> 3] >> (56 - 8 * (j & 7))) & 0xff;
    // acc = 256 acc + byte (acc < L, so the result is below 2^261)
#pragma unroll
    for (int i = 8; i > 0; --i) acc[i] = (acc[i] << 8) | (acc[i - 1] >> 24);
    acc[0] = (acc[0] << 8) | byte;
    // q = acc >> 252 is floor(acc / L) or one more
    const uint32_t q = (acc[7] >> 28) | (acc[8] << 4);
    // acc -= q L, in 64-bit steps with a signed borrow
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t v = (int64_t)acc[i] - (int64_t)((uint64_t)q * LW[i] & 0xffffffffu) + borrow;
      acc[i] = (uint32_t)v;
      borrow = (v >> 32) - (int64_t)((uint64_t)q * LW[i] >> 32);
    }
    const int64_t top = (int64_t)acc[8] + borrow;
    acc[8] = (uint32_t)top;
    if (top < 0) {  // one L too many: add it back
      uint64_t c = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c += (uint64_t)acc[i] + LW[i];
        acc[i] = (uint32_t)c;
        c >>= 32;
      }
      acc[8] = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) out[4 * i + b] = (uint8_t)(acc[i] >> (8 * b));
}

// sha512_challenge — replaces sha512.sha512_blocks (sha512.py:174) and
// the sc reduction (sc.py:38-65). Thread i hashes message i's first
// n_blocks[i] blocks (at most nblock) from the SHA-512 IV and writes its
// k to out[32 i ..]. Bound: operations (the rounds and the reduction).
__global__ void __launch_bounds__(THREADS)
sha512_challenge_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
                        const int32_t* __restrict__ n_blocks, uint8_t* __restrict__ out, int n,
                        int nblock) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t h[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
                   0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                   0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  const int nb = n_blocks[i] < nblock ? n_blocks[i] : nblock;
#pragma unroll 1
  for (int blk = 0; blk < nb; ++blk) {
    const size_t base = ((size_t)i * nblock + blk) * 16;
    uint64_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = ((uint64_t)hi[base + j] << 32) | lo[base + j];
    compress(h, w);
  }
  reduce_mod_l(h, out + (size_t)i * 32);
}

}  // namespace sha

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. Grid: ceil(n / THREADS) blocks of
// THREADS threads, a thread a message, the tail masked in the kernel.

extern "C" int tm_sha512_challenge(const void* hi, const void* lo, const void* n_blocks,
                                   void* out, int n, int nblock, void* stream) {
  const dim3 grid((n + sha::THREADS - 1) / sha::THREADS);
  sha::sha512_challenge_kernel<<<grid, sha::THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)hi, (const uint32_t*)lo, (const int32_t*)n_blocks, (uint8_t*)out, n,
      nblock);
  return (int)cudaGetLastError();
}
