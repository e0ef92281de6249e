#!/usr/bin/env python3
"""Measure how many 32 x 32 -> 64 multiply-adds (IMAD.WIDE.U32) and
32-bit multiply-adds (IMAD) one SM of a CUDA card issues a clock.

    python tools/torch_imad_rate.py [--iters N] [--chains C] [--unroll U]

The CUDA programming guide's throughput table gives 64 32-bit integer
multiply-adds a clock per SM for compute capability 9.0, and no rate of
its own for the wide multiply; chip_smoke.py's bound of the cold K1s
(decompress_wide, one IMAD.WIDE.U32 a product) rests on the ratio of
the two, which this script reads off the card.

Each thread runs C independent multiply-add chains of U steps a loop
pass, so the issue rate, not a chain's latency, bounds the loop once
enough warps share an SM: inline PTX `mad.lo.u32` into a 32-bit sum
(`int32`), and `mad.wide.u32` into a 64-bit sum (`wide`, the column sums
of the wide field). ptxas forms each wide product there as it does in
decompress_wide: an IMAD.WIDE.U32 of RZ, two of them summed into the
column by a three-input IADD3 and IADD3.X. Thread 0 of every block stamps clock64() after a
__syncthreads() before and after the loop, with its SM's id; per SM the
rate is the multiply-adds of its blocks over the cycles from its first
stamp to its last, so it does not depend on the SM clock. The script
builds the kernels with nvcc into build/imad_rate/, counts the
IMAD.WIDE and other IMAD instructions of each in `cuobjdump -sass`, runs
each at 8 to 64 warps an SM, and prints one JSON line: the card
(`nvidia-smi` name and power limit), the SASS counts, and per kernel and
warps an SM the median, least and greatest rate over the SMs, and the
CUDA-event time of the launch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build" / "imad_rate"
THREADS = 256
BLOCKS_PER_SM = (1, 2, 4, 8)  # 8 to 64 warps an SM
MODES = ("int32", "wide")  # the kernel's MODE, in its order

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

constexpr int CHAINS = %(chains)d;
constexpr int UNROLL = %(unroll)d;

// CHAINS independent chains a thread, UNROLL steps of each a loop pass:
//   INT32: acc32[i] = acc32[i] a[i] + b          (mad.lo.u32)
//   WIDE:  acc[i]   = a[i] b[u] + acc[i], 64 bits (mad.wide.u32), the column
//          sums of fe25519.cuh's wide_mul and wide_sq
// WIDE reads its UNROLL multiplicands from shared memory at an offset that
// moves every pass (UNROLL LDS a pass): with loop-invariant operands ptxas
// formed the products once, before the loop. As in decompress_wide, it
// forms each product as an IMAD.WIDE.U32 of RZ and sums two into the
// column with IADD3 and IADD3.X. The SASS counts show what ran.
enum { INT32, WIDE };

template <int MODE>
__global__ void rate_kernel(const uint32_t* __restrict__ in, uint64_t* __restrict__ sink,
                            long long* __restrict__ stamps, int iters) {
  __shared__ uint32_t sh[64];
  if (threadIdx.x < 64) sh[threadIdx.x] = in[threadIdx.x & 31] | 1;
  const uint32_t b = in[threadIdx.x & 31] | 1;
  uint32_t a[CHAINS], acc32[CHAINS];
  uint64_t acc[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) {
    a[i] = in[(threadIdx.x + i + 1) & 31];
    acc[i] = acc32[i] = a[i] ^ b;
  }
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const uint32_t* bk = sh + (k & 31);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t bu = MODE == WIDE ? bk[u] : b;
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) {
        if (MODE == INT32)
          asm volatile("mad.lo.u32 %%0, %%0, %%1, %%2;" : "+r"(acc32[i]) : "r"(a[i]), "r"(bu));
        else
          asm volatile("mad.wide.u32 %%0, %%1, %%2, %%0;" : "+l"(acc[i]) : "r"(a[i]), "r"(bu));
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint64_t s = 0;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) s += MODE == INT32 ? acc32[i] : acc[i];
  sink[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
    stamps[3 * blockIdx.x] = sm;
    stamps[3 * blockIdx.x + 1] = t0;
    stamps[3 * blockIdx.x + 2] = t1;
  }
}

extern "C" int rate_launch(int mode, int blocks, int threads, int iters, const void* in,
                           void* sink, void* stamps, void* stream) {
  auto k = mode == INT32 ? rate_kernel<INT32> : rate_kernel<WIDE>;
  k<<<blocks, threads, 0, (cudaStream_t)stream>>>((const uint32_t*)in, (uint64_t*)sink,
                                                  (long long*)stamps, iters);
  return (int)cudaGetLastError();
}
"""


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _build(chains: int, unroll: int) -> Path:
    out = BUILD / f"c{chains}u{unroll}"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "imad_rate.cu", out / "libimad_rate.so"
    src.write_text(SOURCE % {"chains": chains, "unroll": unroll})
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return lib


def _sass(lib: Path) -> dict:
    """Instructions, IMAD.WIDE and other IMAD of each kernel; the whole
    listing is kept beside the library (sass.txt)."""
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    (lib.parent / "sass.txt").write_text(text)
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : _Z11rate_kernelILi(\d)EEvPKjPmPxi", line)
        if "Function :" in line:
            name = MODES[int(m.group(1))] if m else None
            if name:
                out[name] = {"instructions": 0, "IMAD.WIDE": 0, "IMAD": 0}
            continue
        if name is None or not re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            continue
        rec = out[name]
        rec["instructions"] += 1
        rec["IMAD.WIDE"] += " IMAD.WIDE" in line
        rec["IMAD"] += bool(re.search(r" IMAD(?![.]WIDE|[.]MOV|[.]SHL)", line))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2048)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--unroll", type=int, default=8, help="at most 32")
    args = ap.parse_args()
    if not 1 <= args.unroll <= 32:
        ap.error("--unroll must be in 1..32 (the shared array holds 31 + 32 words)")
    import torch

    if not torch.cuda.is_available():
        print("torch_imad_rate: torch sees no CUDA device", file=sys.stderr)
        return 1
    lib_path = _build(args.chains, args.unroll)
    lib = ctypes.CDLL(str(lib_path))
    lib.rate_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    lib.rate_launch.restype = ctypes.c_int
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(7)
    inp = torch.randint(0, 2**31, (32,), generator=gen, dtype=torch.int64).to(torch.int32).to(dev)
    per_thread = args.iters * args.unroll * args.chains

    def run(mode: int, blocks: int) -> tuple:
        sink = torch.empty(blocks * THREADS, dtype=torch.int64, device=dev)
        stamps = torch.empty(3 * blocks, dtype=torch.int64, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

        def launch():
            err = lib.rate_launch(mode, blocks, THREADS, args.iters, ctypes.c_void_p(inp.data_ptr()),
                                  ctypes.c_void_p(sink.data_ptr()),
                                  ctypes.c_void_p(stamps.data_ptr()), stream)
            if err:
                raise RuntimeError(f"rate_launch failed: CUDA error {err}")

        launch()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        stop.record()
        stop.synchronize()
        per_sm = {}
        for sm, t0, t1 in stamps.view(blocks, 3).tolist():
            lo, hi, n = per_sm.get(sm, (t0, t1, 0))
            per_sm[sm] = (min(lo, t0), max(hi, t1), n + 1)
        rates = [n * THREADS * per_thread / (hi - lo) for lo, hi, n in per_sm.values()]
        return rates, start.elapsed_time(stop)

    result = {}
    for mode, key in enumerate(MODES):
        result[key] = {}
        for bps in BLOCKS_PER_SM:
            rates, ms = run(mode, bps * sms)
            result[key][bps * THREADS // 32] = {
                "per_sm_clock": statistics.median(rates), "least": min(rates),
                "greatest": max(rates), "sms": len(rates), "ms": ms}
    sass = _sass(lib_path)
    print(json.dumps({"card": card, "sms": sms, "chains": args.chains, "iters": args.iters,
                      "unroll": args.unroll, "sass": sass, "rates": result}), flush=True)
    # the rates count unroll * chains multiply-adds a loop pass: the SASS
    # must hold at least that many of each kernel's instruction
    if min(sass["wide"]["IMAD.WIDE"], sass["int32"]["IMAD"]) < args.unroll * args.chains:
        print("torch_imad_rate: ptxas folded the loop's multiply-adds; the rates are void",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
