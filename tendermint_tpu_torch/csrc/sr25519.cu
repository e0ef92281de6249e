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
// in two threads; K3r runs a thread per signature over the shared ladder
// (fe25519.cuh ladder). The final test is exact ristretto equality
// against R (z = 1): X yR == Y xR or Y yR == X xR, with no [8] doubles,
// since ristretto points have no cofactor component to clear.

#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace edw {

// K1r — replaces pallas_sr25519._k1r_decode_kernel (pallas_sr25519.py:75).
// Thread (i, p), p = blockIdx.y: p = 0 unpacks the digits of s and
// decodes A (point 0 of coords) with the host flag aok; p = 1 the digits
// of k and R (point 1) with rok. The host flags say the encoding is
// canonical (below p) and even. Bound: operations (the decodes).
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

// K3r — replaces pallas_sr25519._k3r_ladder_kernel (pallas_sr25519.py:98).
// One thread per signature runs the joint ladder acc = [s]B + [k](-A)
// over K2's table, then tests acc == R in the ristretto group, ANDed with
// the two decode flags and the host flag sok (s < L and the schnorrkel
// marker bit). Bound: operations (the ladder), sequential within a
// signature.
__global__ void __launch_bounds__(VTHREADS)
k3r_ladder_kernel(const int32_t* __restrict__ tbl, const int32_t* __restrict__ sdig,
                  const int32_t* __restrict__ kdig,
                  const int32_t* __restrict__ coords, const int32_t* __restrict__ ok,
                  const int32_t* __restrict__ sok, int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  pt acc;
  ladder(acc, tbl, sdig, kdig, i, n);
  const fe rx = load_fe(coords, 4 * 32, i, n);
  const fe ry = load_fe(coords, 5 * 32, i, n);
  const bool eq1 = is_zero(sub(mul(acc.x, ry), mul(acc.y, rx)));
  const bool eq2 = is_zero(sub(mul(acc.y, ry), mul(acc.x, rx)));
  const bool valid =
      ok[i] != 0 && ok[(size_t)n + i] != 0 && sok[i] != 0 && (eq1 || eq2);
  out[i] = valid ? 1 : 0;
}

}  // namespace edw

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Each entry launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch.

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
  edw::k3r_ladder_kernel<<<sig_grid(n, 1), edw::VTHREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, (const int32_t*)sdig, (const int32_t*)kdig,
      (const int32_t*)coords, (const int32_t*)ok, (const int32_t*)sok, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
