"""The quad point functions of the ladder kernels on the CPU.

csrc/fe25519.cuh's quad_double, quad_add_niels and quad_cofactor_eq let
four threads of a warp share one ladder: thread q holds coordinate q of
the point, computes product q of each round with mul/sq, and the quad
swaps the 20-limb products by __shfl_sync. CUDA code runs only on the
card, where tests/test_torch_cuda.py holds the whole kernels to their
plain versions. Here the header itself is compiled for the host with the
system C++ compiler, against a small stand-in for the CUDA runtime in
which every CUDA thread of one warp is an OS thread and a shuffle meets
at a barrier, so the kernels' split of the products, the Niels
coordinate each thread loads and the exchanges are checked on every run
against the plain point functions (ops/point.py, themselves held to the
JAX package's by test_torch_point.py).

Inputs: seeded random limbs in [0, 2^13), eight points (one warp of
eight quads). Tolerance: none; every limb of every coordinate is equal.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.ops import fe, kernels, point

torch.set_num_threads(1)

B = 8  # points: one warp of eight quads

# The CUDA runtime as far as fe25519.cuh uses it, for the host.
SHIM = r"""
#pragma once
#include <barrier>
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct EmuWarp { std::barrier<> bar{32}; int32_t vals[32]; };
inline thread_local EmuWarp* tl_warp;
inline thread_local int tl_lane;
inline int emu_shfl(int v, int src) {
  tl_warp->vals[tl_lane] = v;
  tl_warp->bar.arrive_and_wait();
  const int r = tl_warp->vals[src];
  tl_warp->bar.arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src, int width) {
  return emu_shfl(v, (tl_lane & ~(width - 1)) + (src & (width - 1)));
}
inline int __shfl_xor_sync(unsigned, int v, int m, int width) {
  return emu_shfl(v, (tl_lane & ~(width - 1)) + ((tl_lane ^ m) & (width - 1)));
}
"""

# op 0: quad_double, 1: quad_add_niels, 2: quad_cofactor_eq over (4, 20, b)
# arrays; thread 4k + q works on coordinate q of point k.
HARNESS = r"""
#include <thread>
#include <vector>
#include "fe25519.cuh"
using namespace edw;
static fe load(const int32_t* p, int c, int k, int b) {
  fe x;
  for (int l = 0; l < NL; ++l) x.v[l] = p[(c * NL + l) * b + k];
  return x;
}
extern "C" void emu_quad(int op, int need_t, const int32_t* pts, const int32_t* ents,
                         int32_t* out, int b) {
  EmuWarp warp;
  std::vector<std::thread> threads;
  for (int tid = 0; tid < 4 * b; ++tid)
    threads.emplace_back([=, &warp] {
      tl_warp = &warp;
      tl_lane = tid;
      const int q = tid & 3, k = tid >> 2;
      const fe c = load(pts, q, k, b);
      if (op == 2) {
        const bool eq = quad_cofactor_eq(c, load(ents, q, k, b), q);
        if (q == 0) out[k] = eq ? 1 : 0;
        return;
      }
      const fe r = op == 0 ? quad_double(c, q, need_t != 0)
                           : quad_add_niels(c, load(ents, niels_coord(q), k, b), q, need_t != 0);
      for (int l = 0; l < NL; ++l) out[(q * NL + l) * b + k] = r.v[l];
    });
  for (auto& t : threads) t.join();
}
"""


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("quad_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libquad_emu.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w", f"-I{d}", f"-I{kernels.CSRC}",
         "-o", str(lib), str(d / "harness.cpp"), "-lpthread"],
        check=True, capture_output=True, timeout=120,
    )
    fn = ctypes.CDLL(str(lib)).emu_quad
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return fn


def _points(seed: int):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 1 << 13, (fe.NLIMBS, B), dtype=np.int32))
                 for _ in range(4))


def _run(emu, op: int, need_t: bool, p, q=None):
    pts = torch.stack(p).contiguous()
    ents = torch.stack(q).contiguous() if q is not None else torch.zeros_like(pts)
    out = torch.full((4, fe.NLIMBS, B), -1, dtype=torch.int32)
    emu(op, int(need_t), pts.data_ptr(), ents.data_ptr(), out.data_ptr(), B)
    return out


@pytest.mark.parametrize("need_t", [True, False])
def test_quad_double_equals_point_double(emu, need_t):
    p = _points(1)
    want = torch.stack(point.point_double(p, need_t=need_t))
    assert torch.equal(_run(emu, 0, need_t, p), want)


@pytest.mark.parametrize("need_t", [True, False])
def test_quad_add_niels_equals_point_add_niels(emu, need_t):
    p, q = _points(2), _points(3)
    want = torch.stack(point.point_add_niels(p, q, need_t=need_t))
    assert torch.equal(_run(emu, 1, need_t, p, q), want)


def test_quad_cofactor_eq_equals_the_plain_test(emu):
    """[8]acc == [8]R against k3's plain test, on pairs that are the same
    projective point (R = lambda * acc, coordinate by coordinate) in the
    even columns and unrelated in the odd ones."""
    acc = _points(4)
    lam = fe.from_int(123456789, acc[0])
    r = tuple(torch.where(torch.arange(B) % 2 == 0, fe.mul(c, lam), o)
              for c, o in zip(acc, _points(5)))
    a8, r8 = acc, r
    for _ in range(3):
        a8 = point.point_double(a8, need_t=False)
        r8 = point.point_double(r8, need_t=False)
    want = (fe.is_zero(fe.sub(fe.mul(a8[0], r8[2]), fe.mul(r8[0], a8[2])))
            & fe.is_zero(fe.sub(fe.mul(a8[1], r8[2]), fe.mul(r8[1], a8[2]))))
    got = _run(emu, 2, False, acc, r)[0, 0]
    assert got.tolist() == want[0].int().tolist() == [1, 0] * (B // 2)
