"""The port's multi-device commit verification (tendermint_tpu_torch/ops/
sharded.py) on CPU shards, against the JAX package's
(tendermint_tpu/ops/sharded.py) over tests/conftest.py's forced host
devices.

(a) verify_commit_sharded_pallas and verify_commit_sharded_rlc on 1, 2
    and 4 CPU shards against crypto._edwards.verify_zip215 and the host
    tally.
(b) split_power and join_power against the reference's, both range
    errors included.
(c) verify_commit_sharded on make_mesh(2, device="cpu") against the
    reference's on sharded.make_mesh(2) at bucket 128 (two shards of 64):
    tests/test_torch_opgraph.py's ZIP-215 edge battery, a tampered
    signature, padding rows, powers up to 2^60 - 1; then the same for a
    warm epoch (verify_commit_sharded takes the cached kernel, as the
    reference's verify_commit_sharded_cached) whose table holds a key
    that does not decompress: verdicts, tally and all_valid equal.
(d) commit_tally_plain against the reference's tally: _host_tally, and
    the psum'd sums of its _commit_step under shard_map over two host
    devices, with the verify kernel replaced by a stand-in that hands on
    given verdicts (no ladder compiles): a verdict a row (m = 1), and lane
    verdicts repeated M times as its RLC step repeats them (m = 4).
Only the two JAX ladders of (c) compile (about 20 s each on this CPU).
Each compiles and runs in a Python process of its own (the `reference`
fixture; `python -c` from the repo root, tests/conftest.py's environment
inherited), started at the module's first test, so both run beside each
other and beside the port's plain ladders of (a); the tests of (c) read
their results. Every other verdict is checked against the oracle. Every
wait is bounded (WAIT), and the processes are stopped at the module's
end. Tolerance: none; verdicts, tallies, flags and error strings are
equal.
"""

import json
import os
import subprocess
import sys

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu.ops import ed25519_verify as jev  # noqa: E402
from tendermint_tpu.ops import entry_block as jeb  # noqa: E402
from tendermint_tpu.ops import epoch_cache as jep  # noqa: E402
from tendermint_tpu.ops import sharded as js  # noqa: E402
from tendermint_tpu_torch.crypto import _edwards  # noqa: E402
from tendermint_tpu_torch.ops import epoch_cache, kernels, rlc, sharded  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402
from tests.test_torch_opgraph import _edge_entries  # noqa: E402

torch.set_num_threads(1)

BUCKET = 128
TOP = (1 << 60) - 1
WARM_KEY = b"sharded warm set"
WAIT = 300  # seconds a test waits for a reference process
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_caches():
    epoch_cache.reset(4)
    yield
    epoch_cache.reset()


def _powers(n: int) -> list:
    """Powers from 1 to the top of the range (2^60 - 1), every lane used."""
    rng = np.random.default_rng(17)
    p = [int(x) for x in rng.integers(1, 1 << 40, n)]
    p[0], p[1], p[-1] = TOP, TOP - 65535, (1 << 48) + 7
    return p


def _tampered(ents: list, i: int) -> list:
    p, m, s = ents[i]
    return ents[:i] + [(p, m, s[:40] + bytes([s[40] ^ 0x10]) + s[41:])] + ents[i + 1:]


def _tally(powers, want) -> int:
    return sum(p for p, w in zip(powers, want) if w)


# -- (a) the per-signature and RLC faces against the oracle ---------------------------


@pytest.fixture(scope="module")
def small():
    """Twelve of the battery's rows, one tampered: valid, invalid and
    small-order keys; 3 RLC lanes, one with a bad signature."""
    ents = _tampered(_edge_entries()[:12], 1)
    want = [_edwards.verify_zip215(*e) for e in ents]
    assert True in want and False in want
    return ents, want


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_verify_commit_sharded_pallas_equals_oracle(small, nd):
    ents, want = small
    powers = _powers(len(ents))
    valid, tallied, all_valid = sharded.verify_commit_sharded_pallas(
        ents, powers, sharded.make_mesh(nd, device="cpu"))
    assert valid.tolist() == want
    assert tallied == _tally(powers, want) and all_valid is False
    if nd == 1:
        ok = [e for e, w in zip(ents, want) if w]
        assert sharded.verify_commit_sharded_pallas(
            ok, powers[: len(ok)], sharded.make_mesh(nd, device="cpu"))[2] is True


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_verify_commit_sharded_rlc_equals_oracle(small, nd):
    """The lanes split over nd shards (rlc_shape: a power of two a shard);
    a rejected lane's signatures are re-verified on the host and the valid
    ones' power added back."""
    ents, want = small
    powers = _powers(len(ents))
    g_shard, bucket = sharded.rlc_shape(len(ents), nd)
    assert g_shard * nd * rlc.M == bucket >= len(ents)
    valid, tallied, all_valid = sharded.verify_commit_sharded_rlc(
        ents, powers, sharded.make_mesh(nd, device="cpu"))
    assert valid.tolist() == want
    assert tallied == _tally(powers, want) and all_valid is False


def test_make_mesh_and_mesh():
    mesh = sharded.make_mesh(3, device="cpu")
    assert len(mesh) == 3 and mesh.distinct() == (torch.device("cpu"),)
    assert mesh.lanes_of(torch.device("cpu")) == [0, 1, 2]
    assert mesh.prefix(2) == sharded.Mesh(["cpu", "cpu"])
    with pytest.raises(ValueError):
        sharded.Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 0"):
            sharded.make_mesh(2)


# -- (b) the power lanes --------------------------------------------------------------


def test_split_and_join_power_equal_reference():
    rng = np.random.default_rng(3)
    powers = [0, 1, 65535, 65536, TOP, (1 << 62) - 1] + [int(x) for x in
                                                         rng.integers(0, 1 << 62, 64)]
    got, ref = sharded.split_power(powers), js.split_power(powers)
    assert got.dtype == ref.dtype == np.int32 and np.array_equal(got, ref)
    for r in range(len(powers)):
        assert sharded.join_power(got[r]) == js.join_power(ref[r]) == powers[r]
    for bad in ([-1], [1 << 62]):
        with pytest.raises(ValueError) as e1:
            sharded.split_power(bad)
        with pytest.raises(ValueError) as e2:
            js.split_power(bad)
        assert str(e1.value) == str(e2.value) == "voting power out of range"


# -- (c) the op-graph face against the reference's --------------------------------


def _cold_case() -> tuple:
    ents = _tampered(_edge_entries(), 2)
    return ents, _powers(len(ents))


def _warm_case() -> tuple:
    """The battery and a key that does not decompress (y = 2), the set
    holding their keys in sorted order: (entries, pub column, rows,
    powers)."""
    ents = _edge_entries()
    ents = ents + [((2).to_bytes(32, "little"), ents[0][1], ents[0][2])]
    keys = sorted({p for p, _, _ in ents})
    assert [k for k in keys if _edwards.decompress(k) is None] == [ents[-1][0]]
    row = {k: i for i, k in enumerate(keys)}
    pub_col = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 32)
    idx = np.array([row[p] for p, _, _ in ents], np.int32)
    return ents, pub_col, idx, _powers(len(ents))


def _plain(ref) -> tuple:
    return np.asarray(ref[0]).astype(bool).tolist(), ref[1], bool(ref[2])


def _reference_cold() -> tuple:
    ents, powers = _cold_case()
    return _plain(js.verify_commit_sharded(ents, powers, js.make_mesh(2), bucket=BUCKET))


def _reference_warm() -> tuple:
    """The reference's verify_commit_sharded on a warm block: its
    _commit_step_cached over the replicated table."""
    ents, pub_col, idx, powers = _warm_case()
    jep.reset(depth=4)
    assert jep.cache().note(WARM_KEY, pub_col) is None
    assert jep.cache().note(WARM_KEY, pub_col) is not None
    jblock = jeb.EntryBlock.from_entries(ents)
    jblock.val_idx, jblock.epoch_key = idx, WARM_KEY
    assert jep.lookup(jblock) is not None
    return _plain(js.verify_commit_sharded(jblock, powers, js.make_mesh(2), bucket=BUCKET))


def _reference_main(case: str) -> None:
    """The body of a reference process: tests/conftest.py's JAX set-up
    (its environment is inherited), then one case; prints its result as
    the last line of JSON."""
    import jax

    from tendermint_tpu.libs import jaxcache

    jax.config.update("jax_platforms", "cpu")
    jaxcache.enable(jax, ROOT)
    fn = {"cold": _reference_cold, "warm": _reference_warm}[case]
    print(json.dumps(fn()), flush=True)


class _Reference:
    """A case's reference process and its result, read once."""

    def __init__(self, case: str):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys; from tests.test_torch_sharded import "
             "_reference_main; _reference_main(sys.argv[1])", case],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._out = None

    def result(self) -> tuple:
        if self._out is None:
            out, err = self.proc.communicate(timeout=WAIT)
            assert self.proc.returncode == 0, err[-2000:]
            valid, tallied, all_valid = json.loads(out.strip().splitlines()[-1])
            self._out = (valid, tallied, all_valid)
        return self._out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate(timeout=WAIT)


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference processes of the cold and the warm case, started at
    the module's first test (module docstring)."""
    refs = {case: _Reference(case) for case in ("cold", "warm")}
    try:
        yield refs
    finally:
        for r in refs.values():
            r.stop()


def test_verify_commit_sharded_equals_reference(reference):
    ents, powers = _cold_case()
    want = [_edwards.verify_zip215(*e) for e in ents]
    assert True in want and False in want
    got = sharded.verify_commit_sharded(ents, powers, sharded.make_mesh(2, device="cpu"),
                                        bucket=BUCKET)
    ref = reference["cold"].result()
    assert got[0].tolist() == ref[0] == want
    assert got[1] == ref[1] == _tally(powers, want)
    assert got[2] is ref[2] is False


def test_verify_commit_sharded_cached_equals_reference(monkeypatch, reference):
    """A warm epoch (_warm_case): each shard gathers A from the table
    (og_verify_cached; the reference's _commit_step_cached)."""
    ents, pub_col, idx, powers = _warm_case()
    assert epoch_cache.cache().note(WARM_KEY, pub_col) is None
    assert epoch_cache.cache().note(WARM_KEY, pub_col) is not None
    block = EntryBlock.from_entries(ents)
    block.val_idx, block.epoch_key = idx, WARM_KEY
    assert epoch_cache.lookup(block) is not None
    want = [_edwards.verify_zip215(*e) for e in ents]
    assert want[-1] is False
    mesh = sharded.make_mesh(2, device="cpu")
    seen = []
    real = epoch_cache.EpochEntry.coords_tables

    def spy(ep, dev):
        seen.append(dev)
        return real(ep, dev)

    monkeypatch.setattr(epoch_cache.EpochEntry, "coords_tables", spy)
    got = sharded.verify_commit_sharded(block, powers, mesh, bucket=BUCKET)
    assert seen == [torch.device("cpu")]  # the table once a distinct device
    ref = reference["warm"].result()
    assert got[0].tolist() == ref[0] == want
    assert got[1] == ref[1] == _tally(powers, want)
    assert got[2] is ref[2] is False


# -- (d) the tally against the reference's ------------------------------------------------


def _tally_inputs(rows: int, m: int):
    """Verdicts with zeros and a value not 1, padding rows not live, and
    power lanes of powers up to 2^60 - 1."""
    rng = np.random.default_rng(rows + m)
    valid = rng.integers(0, 2, rows // m).astype(np.int32)
    valid[0], valid[-1] = 0, 7
    live = np.ones(rows, np.int32)
    live[-(rows // 5):] = 0
    powers = rng.integers(0, 1 << 60, rows)
    powers[:2] = TOP
    return valid, live, sharded.split_power(powers)


def _port_shards(valid, live, pw, m: int, nd: int):
    t = [torch.from_numpy(a) for a in (valid, live, pw)]
    return sum(sharded.commit_tally_plain(*(x.chunk(nd)[k].contiguous() for x in t), m)
               for k in range(nd))


@pytest.mark.parametrize("m", [1, 4])
def test_commit_tally_plain_equals_reference_tally(monkeypatch, m):
    import jax
    import jax.numpy as jnp

    rows = 64
    valid, live, pw = _tally_inputs(rows, m)
    got = _port_shards(valid, live, pw, m, 2)
    assert got.dtype == torch.int64 and got.shape == (5,)
    sig_valid = np.repeat(valid != 0, m)
    ref_valid, ref_power, ref_all = js._host_tally(sig_valid, pw, live.astype(bool), rows)
    assert sharded.join_power(got[:4].numpy()) == ref_power
    assert (int(got[4]) == 0) is ref_all is False
    # the reference's _commit_step with its verify kernel handing on s_ok
    monkeypatch.setattr(jev, "verify_kernel", lambda *a: a[6])
    fn, _ = js.sharded_commit_verifier(js.make_mesh(2))
    dummy = np.zeros((rows, 1), np.int32)
    out = fn(dummy, dummy[:, 0], dummy, dummy[:, 0], dummy.T, dummy.T,
             jnp.asarray(sig_valid), pw, live.astype(bool))
    lanes_sum = np.asarray(jax.device_get(out[1]))
    assert got[:4].tolist() == lanes_sum.astype(np.int64).tolist()
    assert (int(got[4]) == 0) is bool(out[2]) is False


def test_commit_tally_wrapper_checks_and_counts():
    valid, live, pw = _tally_inputs(40, 4)
    t = [torch.from_numpy(a) for a in (valid, live, pw)]
    before = kernels.LAUNCHES["commit_tally"]
    assert torch.equal(sharded.commit_tally(*t, 4), sharded.commit_tally_plain(*t, 4))
    assert kernels.LAUNCHES["commit_tally"] == before  # CPU tensors: the plain version
    with pytest.raises(ValueError, match="do not split"):
        sharded.commit_tally(t[0], t[1][:-1], t[2][:-1], 4)
    with pytest.raises(ValueError, match="valid must be"):
        sharded.commit_tally(t[0].to(torch.int64), t[1], t[2], 4)
