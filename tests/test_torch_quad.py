"""The quad point functions and the quad kernels on the CPU.

csrc/fe25519.cuh's quad functions (quad_double, quad_add_niels,
quad_add, quad_to_niels, quad_cofactor_eq, quad_ristretto_eq) let four
threads of a warp share one point: thread q holds coordinate q of the
point, computes product q of each round with mul/sq, and the quad swaps
the 20-limb products by __shfl_sync. CUDA code runs only on the card,
where tests/test_torch_cuda.py holds the whole kernels to their plain
versions. Here the header itself is compiled for the host with the
system C++ compiler, against a small stand-in for the CUDA runtime in
which every CUDA thread of one warp is an OS thread and a shuffle meets
at a barrier, so the kernels' split of the products, the coordinate each
thread loads and the exchanges are checked on every run against the
plain point functions (ops/point.py, themselves held to the JAX
package's by test_torch_point.py). The same stand-in, with a launcher
that starts each warp of a block's threads, runs the whole k2_rlc and
k3r_ladder kernels of csrc/rlc.cu and csrc/sr25519.cu at a few lanes and
signatures against their plain versions.

Inputs: seeded random limbs in [0, 2^13), eight points (one warp of
eight quads); the kernels at 3 lanes of random limbs and at 20 sr25519
signatures (chip_smoke.py's ristretto edge battery and 2 padding rows).
Tolerance: none; every limb of every coordinate is equal.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import _edwards
from tendermint_tpu_torch.ops import fe, kernels, point, rlc, verify
from tendermint_tpu_torch.ops import sr25519 as osr
from tendermint_tpu_torch.ops.entry_block import EntryBlock

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
inline thread_local dim3 threadIdx, blockIdx, blockDim;
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

# op 0: quad_double, 1: quad_add_niels, 2: quad_cofactor_eq, 3: quad_add,
# 4: quad_to_niels, 5: quad_ristretto_eq over (4, 20, b) arrays; thread
# 4k + q works on coordinate q of point k.
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
      if (op == 2 || op == 5) {
        const bool eq = op == 2 ? quad_cofactor_eq(c, load(ents, q, k, b), q)
                                : quad_ristretto_eq(c, load(ents, ristretto_coord(q), k, b), q);
        if (q == 0) out[k] = eq ? 1 : 0;
        return;
      }
      const fe r = op == 0 ? quad_double(c, q, need_t != 0)
                   : op == 1 ? quad_add_niels(c, load(ents, niels_coord(q), k, b), q, need_t != 0)
                   : op == 3 ? quad_add(c, load(ents, q, k, b), q)
                             : quad_to_niels(c, q);
      for (int l = 0; l < NL; ++l) out[(q * NL + l) * b + k] = r.v[l];
    });
  for (auto& t : threads) t.join();
}
"""

# The kernels of rlc.cu and sr25519.cu (each cut above its C interface,
# whose <<<>>> launches are CUDA syntax), launched warp by warp: the 32
# threads of a warp run together, one warp after another.
KERNEL_HARNESS = r"""
#include <thread>
#include <vector>
#include "rlc_body.cu"
#include "sr25519_body.cu"
using namespace edw;
template <class F> static void launch(dim3 grid, int threads, F body) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (int w = 0; w < threads / 32; ++w) {
        EmuWarp warp;
        std::vector<std::thread> ts;
        for (int l = 0; l < 32; ++l)
          ts.emplace_back([=, &warp] {
            tl_warp = &warp;
            tl_lane = l;
            threadIdx = dim3(w * 32 + l);
            blockIdx = dim3(bx, by);
            blockDim = dim3(threads);
            body();
          });
        for (auto& t : ts) t.join();
      }
}
extern "C" void emu_k2_rlc(const int32_t* coords, int32_t* tbl, int g) {
  launch(dim3((4 * g + K2_THREADS - 1) / K2_THREADS, M), K2_THREADS,
         [=] { k2_rlc_kernel(coords, tbl, g); });
}
extern "C" void emu_k3r_ladder(const int32_t* tbl, const int32_t* sdig, const int32_t* kdig,
                               const int32_t* coords, const int32_t* ok, const int32_t* sok,
                               int32_t* out, int n) {
  launch(dim3((4 * n + K3R_THREADS - 1) / K3R_THREADS), K3R_THREADS,
         [=] { k3r_ladder_kernel(tbl, sdig, kdig, coords, ok, sok, out, n); });
}
"""


def _compile(cxx, d, src: str, lib: str):
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w", f"-I{d}", f"-I{kernels.CSRC}",
         "-o", str(d / lib), str(d / src), "-lpthread"],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(d / lib))


def _emu_dir(tmp_path_factory, name):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp(name)
    (d / "cuda_runtime.h").write_text(SHIM)
    return cxx, d


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx, d = _emu_dir(tmp_path_factory, "quad_emu")
    (d / "harness.cpp").write_text(HARNESS)
    fn = _compile(cxx, d, "harness.cpp", "libquad_emu.so").emu_quad
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return fn


@pytest.fixture(scope="module")
def emu_kernels(tmp_path_factory):
    cxx, d = _emu_dir(tmp_path_factory, "kernel_emu")
    for name in ("rlc", "sr25519"):
        text = (kernels.CSRC / f"{name}.cu").read_text()
        (d / f"{name}_body.cu").write_text(text.split("// ---- C interface")[0])
    (d / "harness.cpp").write_text(KERNEL_HARNESS)
    lib = _compile(cxx, d, "harness.cpp", "libkernel_emu.so")
    lib.emu_k2_rlc.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.emu_k3r_ladder.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]
    return lib


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


def test_quad_add_equals_point_add(emu):
    """quad_add against point.point_add on unrelated points, and with
    P = Q (the case the unified formula exists for)."""
    p, q = _points(6), _points(7)
    assert torch.equal(_run(emu, 3, True, p, q), torch.stack(point.point_add(p, q)))
    assert torch.equal(_run(emu, 3, True, p, p), torch.stack(point.point_add(p, p)))


def test_quad_to_niels_equals_to_niels(emu):
    p = _points(8)
    assert torch.equal(_run(emu, 4, False, p), torch.stack(point.to_niels(p)))


def test_quad_ristretto_eq_equals_the_plain_test(emu):
    """acc == R in the ristretto group against sr25519.ristretto_eq, with
    R = lambda * acc (the X yR == Y xR branch) in columns 0, 3, 6; R =
    lambda * (i Y, i X), the translate of acc by the 4-torsion point
    (sqrt(-1), 0) (only the Y yR == X xR branch), in 1, 4, 7; unrelated
    points in 2, 5."""
    acc = _points(9)
    lam = fe.from_int(987654321, acc[0])
    i_lam = fe.mul(lam, fe.from_int(_edwards.SQRT_M1, acc[0]))
    other = _points(10)
    col = torch.arange(B) % 3
    rx = torch.where(col == 0, fe.mul(acc[0], lam),
                     torch.where(col == 1, fe.mul(acc[1], i_lam), other[0]))
    ry = torch.where(col == 0, fe.mul(acc[1], lam),
                     torch.where(col == 1, fe.mul(acc[0], i_lam), other[1]))
    want = osr.ristretto_eq(acc, rx, ry)
    eq1 = fe.is_zero(fe.sub(fe.mul(acc[0], ry), fe.mul(acc[1], rx)))
    assert eq1[0].tolist() == (col == 0).tolist()
    assert want[0].tolist() == (col != 2).tolist()
    got = _run(emu, 5, False, acc, (rx, ry, rx, ry))[0, 0]
    assert got.tolist() == want[0].int().tolist()


@pytest.mark.parametrize("lanes", [1, 3])
def test_k2_rlc_kernel_equals_plain(emu_kernels, lanes):
    """The whole quad k2_rlc kernel against k2_rlc_plain on random
    coordinates, every row of the table: the limbs and the zero rows
    20..31 of each slot (the output starts as -1, as torch.empty may
    leave it). 1 and 3 lanes leave most quads of the block past the end."""
    rng = np.random.default_rng(lanes)
    coords = torch.from_numpy(rng.integers(0, 1 << 13, (rlc.COORD_ROWS, lanes), dtype=np.int32))
    want = rlc.k2_rlc_plain(coords)
    got = torch.full_like(want, -1)
    emu_kernels.emu_k2_rlc(coords.data_ptr(), got.data_ptr(), lanes)
    assert torch.equal(got, want)


def test_k3r_ladder_kernel_equals_plain(emu_kernels):
    """The whole quad k3r_ladder kernel against k3r_ladder_plain over
    chip_smoke.py's ristretto edge battery (valid and tampered signatures,
    keys and R that do not decode, the identity key, no marker, s >= L)
    and 2 padding rows (the all-zero identity, every flag 1): 20
    signatures, so the second block's quads run on a clamped column."""
    import chip_smoke

    ents = chip_smoke.sr_edge_entries()
    n = len(ents) + 2
    args = [torch.from_numpy(a) for a in osr.prepare_sr25519(EntryBlock.from_entries(ents), n)]
    coords, ok, sdig, kdig = osr.k1r_decode_plain(*args[:6])
    tbl = verify.k2_table_plain(coords)
    want = osr.k3r_ladder_plain(tbl, sdig, kdig, coords, ok, args[6])
    assert 0 < int(want.sum()) < n and want[0, -2:].tolist() == [1, 1]
    ins = [x.contiguous() for x in (tbl, sdig, kdig, coords, ok, args[6])]
    got = torch.full_like(want, -1)
    emu_kernels.emu_k3r_ladder(*(x.data_ptr() for x in ins), got.data_ptr(), n)
    assert torch.equal(got, want)
