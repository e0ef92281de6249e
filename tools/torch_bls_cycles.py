#!/usr/bin/env python3
"""Time the parts of the BLS12-381 kernels (csrc/bls12381.cu) on one CUDA
card, in SM clock cycles from clock64() stamps inside one block.

    python tools/torch_bls_cycles.py [--root DIR]

compiles the source of DIR (default: this checkout) cut above its C
interface, with a small harness, by nvcc for sm_90a into build/bls_cycles/,
runs it twice and prints one JSON line (the second run; the first warms
the instruction cache) with the card's name and power limit and the cycles
of each part:

- on one thread: fp_mul (a chain of 64 dependent products), fp_add (64
  dependent modular sums), fp_inv (8 inversions), point_add (9 complete
  additions, as the apk sum runs them);
- on a warp (bls_finalexp's team): a product stage (18 lanes, one product
  each), a combine of a full Fp12 product (12 lanes), team_cyclo_sqr, and
  team_mul of two full elements;
- on a block of THREADS (bls_miller's team): one step of miller_loop (the
  mean of 4 steps over zero coefficients).

The inputs are constants in range; no part's work depends on them but
fp_inv's. A final exponentiation is 314 cyclotomic squares, 55 Fp12
products, one norm inverse (37 products and one inversion) and some
small stages; a Miller loop 63 steps after the apk sum.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

HARNESS = r"""
#include "bls_body.cu"
#include <cstdio>
using namespace bls;

__global__ void bench_warp(long long* cyc, int32_t* sink) {
  __shared__ fp12 a, b, r;
  __shared__ fp prod[108];
  const int t = threadIdx.x;
  for (int o = t; o < 12; o += WARP) {
    a.c[o] = fp_const(ONE_W);
    a.c[o].v[0] += o;
    b.c[o] = fp_const(R2_W);
    b.c[o].v[0] += o;
  }
  for (int q = t; q < 108; q += WARP) prod[q] = fp_const(ONE_W);
  __syncwarp();
  long long c[9];
  fp x = a.c[0];
  c[0] = clock64();
  if (t == 0) {
    for (int i = 0; i < 64; ++i) x = fp_mul(x, b.c[0]);
  }
  __syncwarp();
  c[1] = clock64();
  if (t == 0) {
#pragma unroll 1
    for (int i = 0; i < 64; ++i) x = fp_add(x, b.c[i & 7]);
  }
  __syncwarp();
  c[2] = clock64();
  if (t == 0) {
    for (int i = 0; i < 8; ++i) x = fp_inv(x);
  }
  __syncwarp();
  c[3] = clock64();
  for (int i = 0; i < 32; ++i) {
    if (t < 18) prod[t] = fp_mul(a.c[t % 12], b.c[t % 12]);
    __syncwarp();
  }
  c[4] = clock64();
  for (int i = 0; i < 32; ++i) {
    if (t < 12) r.c[t] = pair_combine<ALL, ALL>(prod, t);
    __syncwarp();
  }
  c[5] = clock64();
  for (int i = 0; i < 32; ++i) team_cyclo_sqr<WARP>(a, prod, t);
  c[6] = clock64();
  for (int i = 0; i < 8; ++i) team_mul<WARP, ALL, ALL>(a, a, b, prod, t);
  c[7] = clock64();
  if (t == 0) {
    const int n[7] = {64, 64, 8, 32, 32, 32, 8};
    for (int i = 0; i < 7; ++i) cyc[i] = (c[i + 1] - c[i]) / n[i];
    fp_store(sink, x);
    fp_store(sink + 12, r.c[3]);
    fp_store(sink + 24, a.c[5]);
  }
}

__global__ void bench_block(long long* cyc, int32_t* sink, const int32_t* co) {
  __shared__ pt part[THREADS];
  __shared__ fp12 f;
  __shared__ fp xw[2], y[2], zw[2];
  __shared__ miller_smem s;
  const int t = threadIdx.x;
  if (t < 2) {
    xw[t] = fp_const(R2_W);
    y[t] = fp_const(ONE_W);
    zw[t] = fp_const(R2_W);
  }
  pt p{fp_const(ONE_W), fp_const(R2_W), fp_const(ONE_W)};
  __syncthreads();
  long long c[3];
  c[0] = clock64();
  for (int i = 0; i < 9; ++i) p = point_add(p, p);
  part[t] = p;
  __syncthreads();
  c[1] = clock64();
  const int32_t* const cc[2] = {co, co + PAIR_WORDS};
  miller_loop<THREADS>(f, cc, xw, y, zw, 4, s, t);
  c[2] = clock64();
  if (t == 0) {
    cyc[0] = (c[1] - c[0]) / 9;
    cyc[1] = (c[2] - c[1]) / 4;
    fp_store(sink, f.c[3]);
    fp_store(sink + 12, part[5].x);
  }
}

int main() {
  long long *cyc, h[16];
  int32_t *sink, *co;
  cudaMalloc(&cyc, 16 * 8);
  cudaMalloc(&sink, 4096);
  cudaMalloc(&co, 2 * PAIR_WORDS * 4);
  cudaMemset(co, 0, 2 * PAIR_WORDS * 4);
  for (int rep = 0; rep < 2; ++rep) {
    bench_warp<<<1, WARP>>>(cyc, sink);
    bench_block<<<1, THREADS>>>(cyc + 8, sink + 64, co);
    cudaMemcpy(h, cyc, 16 * 8, cudaMemcpyDeviceToHost);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    fprintf(stderr, "%s\n", cudaGetErrorString(err));
    return 1;
  }
  printf("{\"fp_mul\": %lld, \"fp_add\": %lld, \"fp_inv\": %lld, \"product_stage\": %lld, "
         "\"combine\": %lld, \"cyclo_sqr\": %lld, \"team_mul\": %lld, \"point_add\": %lld, "
         "\"miller_step\": %lld}\n",
         h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[8], h[9]);
  return 0;
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    src = Path(args.root) / "tendermint_tpu_torch" / "csrc" / "bls12381.cu"
    out = HERE / "build" / "bls_cycles"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bls_body.cu").write_text(src.read_text().split("// ---- C interface")[0])
    (out / "harness.cu").write_text(HARNESS)
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = str(Path(cuda) / "bin" / "nvcc") if (Path(cuda) / "bin" / "nvcc").exists() else (
        shutil.which("nvcc") or "nvcc")
    build = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", f"-I{out}", "-o", str(out / "bench"),
                            str(out / "harness.cu")], capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    run = subprocess.run([str(out / "bench")], capture_output=True, text=True)
    if run.returncode:
        print(run.stderr, file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"root": args.root, "card": card, "cycles": json.loads(run.stdout)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
