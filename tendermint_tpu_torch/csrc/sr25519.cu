// The sr25519 (schnorrkel over ristretto255) kernels for sm_90a.
//
// Counterpart: tendermint_tpu/ops/pallas_sr25519.py; plain PyTorch
// versions: tendermint_tpu_torch/ops/sr25519.py (k1r_decode_plain,
// k3r_ladder_plain), which these kernels match limb for limb. The path is
// K1r here, then verify.cu's K2 (k2_table) on K1r's coordinates, then K3r
// here: schnorrkel's R == [s]B - [k]A with k the merlin challenge from
// the host. Global arrays keep the JAX layout, (rows, n) with the
// signature last, in K1's output layout (fe25519.cuh).
//
// What bounds them. The work is 32-bit multiply-adds of the limb
// convolutions: 400 per field multiply, 210 per squaring. Counted from the
// formulas (chip_smoke.py counts them by running the plain versions), per
// signature:
//   K1r  128,740: 2 ristretto decodes (A and R) of 257 squarings + 26
//        multiplies, most of it pow22523 inside sqrt_ratio
//   K3r  926,160: 127 iterations of 2 doubles and 1 Niels add, then the
//        4 multiplies of the two cross-multiplied equality tests
// against 132 SMs x 64 INT32 lanes per clock at the SM clock nvidia-smi
// reports (1,980 MHz on an H100 80GB HBM3 at 700 W). At 10,240 signatures
// that is 0.079 and 0.57 ms. The bytes each moves (22 and 105 MB) take
// 0.007 and 0.03 ms at 3.35 TB/s, so both are bound by operations.
//
// What the design does about it: as verify.cu, the signatures are the
// parallelism. K1r runs a thread per (signature, point), so A and R decode
// in two threads: 20,480 threads at 10,240 signatures, one wave. Its
// decode runs inline with no call (fe25519.cuh ristretto_decode), so the
// kernel has no stack frame: 0.241 ms against its bound of 0.079, 254
// registers, where the out-of-line decode's 528-byte frame took 0.254.
// Four threads a decode on the limb-split field product, as the warm K1s
// run, took 0.28 ms here (81,920 threads, two waves), and a pair of
// threads a decode (40,960 threads, one wave at 168 registers) 0.27:
// each thread of a pair issues about as many instructions a squaring as
// one thread does alone, so at 20,480 decodes the split's own
// instructions cost more than its extra warps gain (tools/
// torch_ladder_ab.py, PERF.md). K3r runs a quad of four threads per
// signature over the shared ladder, as verify.cu's K3 does (fe25519.cuh
// quad functions): thread q holds coordinate q of the accumulator,
// computes product q of each round and loads only the table coordinate
// it multiplies, before the iteration's doubles. The final test is exact ristretto equality
// against R (z = 1): X yR == Y xR or Y yR == X xR, with no [8] doubles,
// since ristretto points have no cofactor component to clear; each quad
// thread forms one of its four cross products. At 10,240 signatures that
// is 40,960 threads in 640 blocks of 64, registers capped for 5 blocks an
// SM so that the grid is one wave (verify.cu's K3 settled the same
// shape by a sweep). ptxas: 128 registers, 0 bytes of stack frame, no
// local loads or stores in its SASS. The accumulator stays in registers:
// passed to out-of-line point functions, it and each table entry went
// through a 640-byte stack frame, and a one-thread K3r took 10.38 ms
// against 2.08 (tools/torch_ladder_ab.py, PERF.md).

#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace edw {

// K1r — replaces pallas_sr25519._k1r_decode_kernel (pallas_sr25519.py:75).
// Thread (i, p), p = blockIdx.y: p = 0 unpacks the digits of s and
// decodes A (point 0 of coords) with the host flag aok; p = 1 the digits
// of k and R (point 1) with rok. The host flags say the encoding is
// canonical (below p) and even. The decode (fe25519.cuh ristretto_decode)
// is inline, its chain too, so the kernel has no stack frame. Bound:
// operations (the decodes).
__global__ void __launch_bounds__(VTHREADS)
k1r_decode_kernel(const uint8_t* __restrict__ a_t, const uint8_t* __restrict__ r_t,
                  const uint8_t* __restrict__ s_t, const uint8_t* __restrict__ k_t,
                  const int32_t* __restrict__ aok, const int32_t* __restrict__ rok,
                  int32_t* __restrict__ coords, int32_t* __restrict__ ok,
                  int32_t* __restrict__ sdig, int32_t* __restrict__ kdig, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (i >= n) return;
  store_digits(p == 0 ? sdig : kdig, 0, (p == 0 ? s_t : k_t) + i, n, i, n);
  const uint8_t* src = p == 0 ? a_t : r_t;
  int32_t e[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) e[b] = src[(size_t)b * n + i];
  const bool host_ok = (p == 0 ? aok : rok)[i] != 0;
  pt P;
  const bool okp = ristretto_decode(P, e, host_ok);
  ok[(size_t)p * n + i] = okp ? 1 : 0;
  store_point(coords, p, P, i, n);
}

// K3r runs a quad of threads per signature, K3R_THREADS / 4 signatures a
// block, with registers capped for K3R_MIN_BLOCKS blocks an SM.
constexpr int K3R_THREADS = 64;
constexpr int K3R_MIN_BLOCKS = 5;

// K3r — replaces pallas_sr25519._k3r_ladder_kernel (pallas_sr25519.py:98).
// A quad of four threads runs one signature's joint ladder
// acc = [s]B + [k](-A) over K2's table: 127 iterations, digit positions
// 126 down to 0, of a double that skips T, a double that makes it, and a
// Niels add of entry sdig + 4 kdig that skips T. Then acc == R in the
// ristretto group, ANDed with the two decode flags and the host flag sok
// (s < L and the schnorrkel marker bit), in quad thread 0. Bound:
// operations (the ladder), sequential within a signature.
__global__ void __launch_bounds__(K3R_THREADS, K3R_MIN_BLOCKS)
k3r_ladder_kernel(const int32_t* __restrict__ tbl, const int32_t* __restrict__ sdig,
                  const int32_t* __restrict__ kdig,
                  const int32_t* __restrict__ coords, const int32_t* __restrict__ ok,
                  const int32_t* __restrict__ sok, int32_t* __restrict__ out, int n) {
  const int q = threadIdx.x & 3;
  const int quad = blockIdx.x * (K3R_THREADS / 4) + (threadIdx.x >> 2);
  const int i = quad < n ? quad : n - 1;  // a quad past the end runs masked
  const int c = niels_coord(q);
  fe acc = quad_identity(q);
#pragma unroll 1
  for (int it = 0; it < 127; ++it) {
    const int pos = 126 - it;
    const int j = (pos & 3) * 32 + (pos >> 2);
    const int e = sdig[(size_t)j * n + i] + 4 * kdig[(size_t)j * n + i];
    const fe ent = load_fe(tbl, (e * 4 + c) * 32, i, n);
#pragma unroll 1
    for (int d = 0; d < 2; ++d) acc = quad_double(acc, q, d == 1);
    acc = quad_add_niels(acc, ent, q, false);
  }
  const fe r = load_fe(coords, (4 + ristretto_coord(q)) * 32, i, n);  // R's x or y
  const bool eq = quad_ristretto_eq(acc, r, q);
  if (q != 0 || quad >= n) return;
  out[i] = (ok[i] != 0 && ok[(size_t)n + i] != 0 && sok[i] != 0 && eq) ? 1 : 0;
}

}  // namespace edw

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. K1r's grid is sig_grid (fe25519.cuh);
// K3r's is ceil(4 n / K3R_THREADS), a quad a signature, with the tail
// masked per quad.

using edw::sig_grid;

extern "C" int tm_k1r_decode(const void* a_t, const void* r_t, const void* s_t,
                             const void* k_t, const void* aok, const void* rok,
                             void* coords, void* ok, void* sdig, void* kdig, int n,
                             void* stream) {
  edw::k1r_decode_kernel<<<sig_grid(n, 2), edw::VTHREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a_t, (const uint8_t*)r_t, (const uint8_t*)s_t,
      (const uint8_t*)k_t, (const int32_t*)aok, (const int32_t*)rok, (int32_t*)coords,
      (int32_t*)ok, (int32_t*)sdig, (int32_t*)kdig, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_k3r_ladder(const void* tbl, const void* sdig, const void* kdig,
                             const void* coords, const void* ok, const void* sok,
                             void* out, int n, void* stream) {
  const dim3 grid((4 * n + edw::K3R_THREADS - 1) / edw::K3R_THREADS);
  edw::k3r_ladder_kernel<<<grid, edw::K3R_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, (const int32_t*)sdig, (const int32_t*)kdig,
      (const int32_t*)coords, (const int32_t*)ok, (const int32_t*)sok, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
