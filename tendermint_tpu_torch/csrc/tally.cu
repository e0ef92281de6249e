// The voting-power tally of one shard of a commit, on the card, for
// sm_90a.
//
// Counterpart: tendermint_tpu/ops/sharded.py _commit_step (:93) and
// _commit_step_cached (:235), the part after the verify kernel: the sum
// of the base-2^16 power lanes over the shard's valid live rows and the
// count of its live invalid rows (:100-106, :244-247), also taken by the
// reference's sharded_pallas_verifier (:362-365) and sharded_rlc_verifier
// (:473-479, over lane verdicts repeated M times). The reference's psum
// over the mesh is a host sum of the shards' partials here
// (ops/sharded.py). Plain PyTorch version:
// tendermint_tpu_torch/ops/sharded.py commit_tally_plain, which this
// kernel matches word for word.
//
// Input: valid (rows / m,) int32 verdicts, row i under verdict i / m (m =
// 1 a signature a verdict; m = rlc.M for the RLC path's lane verdicts);
// live (rows,) int32; power (rows, 4) int32, split_power's lanes. Output:
// 5 words of 64 bits the caller zeroed: word l < 4 is the sum of
// power[i, l] over the rows with valid[i / m] && live[i], word 4 the
// count of the rows with live[i] && !valid[i / m].
//
// Design: a thread a row. Each thread forms its five 64-bit terms (a
// power lane sign-extended, so any int32 input sums exactly modulo 2^64,
// which is the int64 sum wherever that fits); a warp adds them up by
// __shfl_xor_sync on each word's two 32-bit halves, and its lane 0 adds
// each sum that is not 0 to its output word with one 64-bit atomicAdd.
// There is no block barrier and no shared memory, and the threads past
// the last row add zeros, so every thread of a warp reaches every
// shuffle. Integer sums make the result exact and independent of the
// order in which the warps land.
//
// What bounds it: bytes. A row reads 16 bytes of power, 4 of live and
// 4 / m of valid; 40 bytes are written. At 10,240 rows that is about
// 0.25 MB, 0.07 us at 3.35 TB/s, far under a launch's latency.

#include <cuda_runtime.h>

#include <cstdint>

namespace tally {

constexpr int THREADS = 256;
constexpr int WORDS = 5;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t lo = (uint32_t)__shfl_xor_sync(FULL, (int)(uint32_t)v, o, 32);
    const uint32_t hi = (uint32_t)__shfl_xor_sync(FULL, (int)(uint32_t)(v >> 32), o, 32);
    v += ((uint64_t)hi << 32) | lo;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
    commit_tally_kernel(const int32_t* __restrict__ valid, const int32_t* __restrict__ live,
                        const int32_t* __restrict__ power, unsigned long long* __restrict__ out,
                        int rows, int m) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  uint64_t t[WORDS] = {0, 0, 0, 0, 0};
  if (i < rows && live[i] != 0) {
    if (valid[i / m] != 0) {
      for (int l = 0; l < 4; ++l) t[l] = (uint64_t)(int64_t)power[4 * i + l];
    } else {
      t[4] = 1;
    }
  }
  for (int w = 0; w < WORDS; ++w) t[w] = warp_sum(t[w]);
  if ((threadIdx.x & 31) == 0)
    for (int w = 0; w < WORDS; ++w)
      if (t[w] != 0) atomicAdd(out + w, (unsigned long long)t[w]);
}

}  // namespace tally

// ---- C interface (loaded with ctypes by ops/kernels.py) --------------------
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of its launch. Grid: ceil(rows / THREADS) blocks of
// THREADS threads, a thread a row; rows must be at least 1.

extern "C" int tm_commit_tally(const void* valid, const void* live, const void* power, void* out,
                               int rows, int m, void* stream) {
  const dim3 grid((rows + tally::THREADS - 1) / tally::THREADS);
  tally::commit_tally_kernel<<<grid, tally::THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)valid, (const int32_t*)live, (const int32_t*)power,
      (unsigned long long*)out, rows, m);
  return (int)cudaGetLastError();
}
