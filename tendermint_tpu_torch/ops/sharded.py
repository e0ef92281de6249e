"""Multi-device commit verification: a commit's signatures split over a
mesh of devices, each shard verified on its device, and the voting power
of the valid ones tallied.

Counterpart: tendermint_tpu/ops/sharded.py (make_mesh :82, _commit_step
:93, POWER_LANES and POWER_BASE :130, split_power :134, join_power :144,
verify_commit_sharded :148, _commit_step_cached :235,
verify_commit_sharded_pallas :389, _bucket_pow2 :441,
verify_commit_sharded_rlc :496, mesh_ready :573, dispatch_mesh :595,
mesh_valid_fn :605, mesh_valid_fn_cached :636, _MESH_SPECS :711,
mesh_arg_shardings :727). Three of its names have no function of their
own here: verify_commit_sharded_cached (:278) is verify_commit_sharded,
which takes the cached kernel for a warm block itself (as the
reference's does at :166); epoch_tables_sharded (:221) is the table
dict verify_commit_sharded builds, one coords_tables a device; and
mesh_pallas_valid_fn (:675) is per_sig_step. The reference runs each
step as one XLA program under shard_map over a jax Mesh; here:

- a **Mesh** is an ordered tuple of torch devices driven by this one
  process (the reference's Mesh is one process over its local devices).
  make_mesh(n) names n distinct cards, make_mesh(n, device="cpu") n
  shards on the CPU (the reference tests' forced host device count), and
  Mesh(devices) may name one card more than once: its shards then run
  one after another on it.
- **shards are contiguous row ranges**, the reference's P(AXIS) split:
  the padded bucket is rounded up to a multiple of the shard count, and
  shard k is rows [k B/nd, (k+1) B/nd). Batch-first arguments split on
  axis 0, batch-minor ones (the per-signature and RLC layouts) on their
  last axis. Each shard's arguments are copied to its device and its
  kernels launch on that device's current stream; all shards launch
  before any is read back, so distinct cards run at once.
- **the psum is a host sum**: each shard runs commit_tally (the kernel of
  csrc/tally.cu, the counterpart of the tally half of _commit_step :100
  and _commit_step_cached :244) into a (5,) int64 partial, four
  power-lane sums and the count of live invalid rows; the partials are
  read back with the shard's verdicts and summed on the host. The
  reference reads its psum only on the host (join_power, bool(all_valid),
  :195-199), and the verdict readback already waits for every card, so
  40 more bytes a card give the same numbers without a process group.
  The lanes are int64, which equals the reference's int32 lane sums
  wherever those are exact (below 2^31).
- a warm epoch's table is built once on each distinct device
  (EpochEntry.coords_tables keys it by device): the reference's
  replicated table.

The verifiers: verify_commit_sharded (the op-graph check, og_verify, with
the host challenges as the reference's _backend.prepare_batch gives
them; a warm epoch takes og_verify_cached), verify_commit_sharded_pallas
(the per-signature K1 -> K2 -> K3 of ops/verify.py on each shard, the
reference's bucket; its pick_block is the TPU's tiling and has no
counterpart) and verify_commit_sharded_rlc (the RLC lanes of ops/rlc.py,
the reference's lane arithmetic, commit_tally over lane verdicts
repeated rlc.M times, rejected lanes re-verified on the host for blame
and their valid signatures' power added back). Each returns (valid[n],
tallied power, all_valid), as the reference.

The mesh dispatcher's verdict-only faces (ops/mesh.py,
ops/pipeline.py): mesh_valid_fn, mesh_valid_fn_cached and
per_sig_step give the body a shard runs on its device (the
reference's shard_map'd functions; their mesh and donate arguments have
no counterpart: the dispatcher launches the body on each lane's device
itself), mesh_arg_shardings each argument's split axis as a Placement,
mesh_ready whether the dispatcher's mesh can place the lanes.

There is no capability probe: shard_map_available (:39) and the
per-call warn-once fallbacks (:180-187, :306-316, :415-420, :529-540)
have no counterpart, because the port launches on each device directly.
A kernel that fails raises; nothing moves to the CPU or to a plain
version. Spans: sharded.host_prep, sharded.device.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from . import kernels, rlc
from . import ed25519_verify as og
from . import verify as per_sig
from .entry_block import EntryBlock

_log = logging.getLogger("tendermint_tpu_torch.ops.sharded")

POWER_LANES = 4
POWER_BASE = 1 << 16
TALLY_WORDS = POWER_LANES + 1


# -- the mesh -----------------------------------------------------------------


def _norm(dev) -> torch.device:
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered tuple of torch devices: shard k runs on devices[k]. A
    device may appear more than once; its shards then run one after
    another on it."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence):
        devs = tuple(_norm(d) for d in devices)
        if not devs:
            raise ValueError("a mesh has at least one device")
        self.devices = devs

    def __len__(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices, each once, in the order they first appear."""
        return tuple(dict.fromkeys(self.devices))

    def lanes_of(self, dev) -> List[int]:
        """The shard indices that run on `dev`, in order."""
        return [k for k, d in enumerate(self.devices) if d == dev]

    def prefix(self, n: int) -> "Mesh":
        """The mesh of the first n shards' devices."""
        return self if n == len(self) else Mesh(self.devices[:n])


def make_mesh(n_devices: int = None, device=None) -> Mesh:
    """n distinct cards, cuda:0 ... cuda:n-1 (default: every visible
    card), raising when fewer are visible (reference :82-90); with
    device="cpu", n shards on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or count
    if n < 1 or count < n:
        raise RuntimeError(f"need {max(n, 1)} CUDA devices, have {count}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


# -- the voting-power lanes -----------------------------------------------------


def split_power(powers) -> np.ndarray:
    """(B,) voting powers (< 2^60 = MaxTotalVotingPower cap) -> (B, 4)
    int32 base-2^16 lanes (reference :134)."""
    p = np.asarray(powers, dtype=np.int64)
    if (p < 0).any() or (p >= 1 << 62).any():
        raise ValueError("voting power out of range")
    lanes = [(p >> (16 * i)) & 0xFFFF for i in range(POWER_LANES)]
    return np.stack(lanes, axis=1).astype(np.int32)


def join_power(lanes) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(np.asarray(lanes)))


# -- the tally kernel -----------------------------------------------------------


def _check_tally(valid, live, power, m: int):
    dev = kernels.device_of(live)
    rows = live.shape[0]
    if m < 1 or rows % m:
        raise ValueError(f"{rows} rows do not split into verdicts of {m}")
    kernels.check_tensor("valid", valid, (rows // m,), torch.int32, dev)
    kernels.check_tensor("live", live, (rows,), torch.int32, dev)
    kernels.check_tensor("power", power, (rows, POWER_LANES), torch.int32, dev)
    return dev, rows


def commit_tally_plain(valid, live, power, m: int = 1) -> torch.Tensor:
    """(rows / m,) int32 verdicts, (rows,) int32 live flags, (rows, 4)
    int32 power lanes -> (5,) int64: the power lanes summed over the rows
    with valid[i // m] and live[i], then the count of the live rows whose
    verdict is 0 (the reference's _commit_step tally, :100-106, and
    _host_tally :71)."""
    ok = valid.repeat_interleave(m) != 0
    lv = live != 0
    lanes = (power.to(torch.int64) * (ok & lv).to(torch.int64)[:, None]).sum(0)
    bad = (lv & ~ok).sum().to(torch.int64).reshape(1)
    return torch.cat([lanes, bad])


def commit_tally(valid, live, power, m: int = 1) -> torch.Tensor:
    """The shard's tally (csrc/tally.cu commit_tally_kernel, replacing the
    tally of sharded._commit_step :93 and _commit_step_cached :235); see
    commit_tally_plain. On the card its (5,) int64 output is zeroed, then
    one launch adds every row into it."""
    dev, rows = _check_tally(valid, live, power, m)
    if dev.type == "cpu":
        return commit_tally_plain(valid, live, power, m)
    out = torch.zeros((TALLY_WORDS,), dtype=torch.int64, device=dev)
    if rows:
        kernels.launch("commit_tally", valid, live, power, out, rows, m)
    return out


# -- shards ---------------------------------------------------------------------


def _as_block(entries) -> EntryBlock:
    return entries if isinstance(entries, EntryBlock) else EntryBlock.from_entries(list(entries))


def shard_of(a: np.ndarray, k: int, nd: int, axis: int) -> np.ndarray:
    """Shard k of nd of `a` along `axis`: its contiguous k-th row range, a
    view of `a`."""
    size = a.shape[axis] // nd
    at = [slice(None)] * a.ndim
    at[axis] = slice(k * size, (k + 1) * size)
    return a[tuple(at)]


def _to(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _round_up(bucket: int, nd: int) -> int:
    return bucket + (nd - bucket % nd) % nd


def _live_power(powers, n: int, bucket: int) -> tuple:
    """(bucket,) int32 live flags and (bucket, 4) int32 power lanes, the
    first n rows live."""
    live = np.zeros((bucket,), dtype=np.int32)
    live[:n] = 1
    pw = np.zeros((bucket, POWER_LANES), dtype=np.int32)
    pw[:n] = split_power(np.asarray(powers[:n]))
    return live, pw


def _tally_shards(mesh: Mesh, args, axes, step, live, pw, m: int = 1) -> tuple:
    """Each shard's arguments to its device, step(shard args) -> its
    (rows / m,) int32 verdicts there, then commit_tally; every shard
    launches before the first is read back. Returns the verdicts of all
    shards in order (numpy) and the host sum of their (5,) partials."""
    nd = len(mesh)
    launched = []
    for k, dev in enumerate(mesh.devices):
        dargs = [_to(shard_of(a, k, nd, ax), dev) for a, ax in zip(args, axes)]
        valid = step(dargs)
        part = commit_tally(valid, _to(shard_of(live, k, nd, 0), dev),
                            _to(shard_of(pw, k, nd, 0), dev), m)
        launched.append((valid, part))
    valid = np.concatenate([v.cpu().numpy() for v, _ in launched])
    total = np.zeros((TALLY_WORDS,), dtype=np.int64)
    for _, part in launched:
        total += part.cpu().numpy()
    return valid, total


# -- the shard bodies (also the mesh dispatcher's verdict-only faces) ------------


def _og_step(dargs) -> torch.Tensor:
    return og.og_verify(*dargs)


def _og_step_device_hash(dargs) -> torch.Tensor:
    return og.og_verify_device_hash(*dargs)


def per_sig_step(dargs) -> torch.Tensor:
    """K1 -> K2 -> K3 of ops/verify.py over one shard's batch-minor
    arguments (a_t, r_t, s_t, k_t, s_ok_t) -> its (rows,) int32 verdicts:
    the shard body of verify_commit_sharded_pallas and of the mesh
    dispatcher's per-signature superbatch (reference mesh_pallas_valid_fn
    :675)."""
    coords, ok, sdig, kdig = per_sig.k1_decompress(*dargs[:4])
    tbl = per_sig.k2_table(coords)
    return per_sig.k3_ladder(tbl, sdig, kdig, coords, ok, dargs[4])[0]


def _rlc_step(dargs) -> torch.Tensor:
    """K1 -> K2 -> K3 of ops/rlc.py over one shard's lanes (a_t, r_t,
    scal_t, sok_t) -> its (g,) int32 lane verdicts."""
    coords, ok, dig = rlc.k1_rlc(*dargs[:3])
    tbl = rlc.k2_rlc(coords)
    return rlc.k3_rlc(tbl, dig, coords, ok, dargs[3])[0]


def mesh_valid_fn(device_hash: bool = False):
    """The op-graph body a shard runs on its device (reference :605): its
    rows' (A, R, s, k, s_ok) -> (rows,) int32 verdicts by og_verify, or
    with device_hash the R || A || M block words in place of k
    (sha512_challenge, then og_verify)."""
    return _og_step_device_hash if device_hash else _og_step


def mesh_valid_fn_cached(ep, device_hash: bool = False):
    """The warm op-graph body (reference :636): A from the epoch's table
    on the shard's device (built there on first use), then
    og_verify_cached; with device_hash the challenges hash on the card."""
    fn = og.og_verify_cached_device_hash if device_hash else og.og_verify_cached

    def step(dargs) -> torch.Tensor:
        return fn(*ep.coords_tables(dargs[0].device), *dargs)

    return step


# -- the sharded commit verifiers -------------------------------------------------


def verify_commit_sharded(entries, powers, mesh: Mesh, bucket: int = None) -> tuple:
    """Verify a commit's signatures across the mesh and tally voting power
    (reference :148): (valid[n] bool, tallied power of the valid ones,
    all_valid). The op-graph check with the host challenges; a block of
    a warm epoch (val_idx and epoch_key, the set in the epoch cache)
    takes og_verify_cached over each device's table (the reference's
    dispatch to verify_commit_sharded_cached, :166). Rows pad to the reference's bucket
    (ed25519_verify.bucket_for of max(n, nd)) unless `bucket` is given,
    rounded up to a multiple of the shard count."""
    block = _as_block(entries)
    n, nd = len(block), len(mesh)
    bucket = _round_up(bucket or og.bucket_for(max(n, nd)), nd)
    with record_function("sharded.host_prep"):
        batch = og.prepare_batch(block, False, bucket)
        live, pw = _live_power(powers, n, bucket)
    if batch.ep is None:
        step = _og_step
    else:
        # the table once on each distinct device (reference epoch_tables_sharded :221)
        tables = {dev: batch.ep.coords_tables(dev) for dev in mesh.distinct()}

        def step(dargs):
            return og.og_verify_cached(*tables[dargs[0].device], *dargs)
    with record_function("sharded.device"):
        valid, total = _tally_shards(mesh, batch.args, (0,) * len(batch.args), step, live, pw)
    return valid[:n].astype(bool), join_power(total[:POWER_LANES]), int(total[POWER_LANES]) == 0


def _bucket_pow2(n: int, nd: int) -> int:
    b = nd
    while b < n:
        b *= 2
    return b


def verify_commit_sharded_pallas(entries, powers, mesh: Mesh, bucket: int = None) -> tuple:
    """verify_commit_sharded on the per-signature kernels (reference
    :389): prepare_compact's batch-minor arguments split on their last
    axis, K1 -> K2 -> K3 and commit_tally on each shard. Bucket: the
    reference's max(nd * 8, _bucket_pow2(n, nd)) unless given."""
    block = _as_block(entries)
    n, nd = len(block), len(mesh)
    bucket = _round_up(bucket or max(nd * 8, _bucket_pow2(n, nd)), nd)
    with record_function("sharded.host_prep"):
        args = per_sig.prepare_compact(block, bucket)
        live, pw = _live_power(powers, n, bucket)
    with record_function("sharded.device"):
        valid, total = _tally_shards(mesh, args, (-1,) * len(args), per_sig_step, live, pw)
    return valid[:n].astype(bool), join_power(total[:POWER_LANES]), int(total[POWER_LANES]) == 0


def rlc_shape(n: int, nd: int) -> tuple:
    """(g_shard, bucket) of the sharded RLC path (reference :512-520): the
    lanes a shard holds, a power of two, such that nd shards cover the
    n signatures' lanes, and the signatures they hold."""
    lanes_needed = max((n + rlc.M - 1) // rlc.M, 1)
    g_shard = 1
    while g_shard * nd < lanes_needed:
        g_shard *= 2
    return g_shard, g_shard * nd * rlc.M


def verify_commit_sharded_rlc(entries, powers, mesh: Mesh) -> tuple:
    """verify_commit_sharded on the RLC lanes (reference :496): lanes
    split over the mesh (rlc_shape), K1 -> K2 -> K3 on each shard, and
    commit_tally over the lane verdicts repeated rlc.M times; rejected
    lanes re-verify on the host (rlc.expand_lanes) and their valid
    signatures' power is added back, so verdicts, tally and all_valid
    are the single-device RLC path's."""
    block = _as_block(entries)
    n, nd = len(block), len(mesh)
    _g_shard, bucket = rlc_shape(n, nd)
    with record_function("sharded.host_prep"):
        args = rlc.prepare_rlc(block, bucket)
        live, pw = _live_power(powers, n, bucket)
    with record_function("sharded.device"):
        lane_valid, total = _tally_shards(mesh, args, (-1,) * len(args), _rlc_step, live, pw,
                                          rlc.M)
    lane_valid = lane_valid.astype(bool)
    tallied = join_power(total[:POWER_LANES])
    per_sig_valid = rlc.expand_lanes(lane_valid, block)
    rescued = per_sig_valid & ~np.repeat(lane_valid, rlc.M)[:n]
    tallied += sum(int(powers[i]) for i in np.nonzero(rescued)[0])
    all_valid = bool(per_sig_valid.all()) if n else int(total[POWER_LANES]) == 0
    return per_sig_valid, tallied, all_valid


# -- placement for the mesh dispatcher ------------------------------------------------


class Placement:
    """Where a superbatch's arguments go (the reference's per-argument
    NamedShardings, :727): argument i splits along axes[i] into len(mesh)
    row ranges, and range k goes to mesh.devices[k]. A device's arguments
    are its lanes' ranges stacked on a new first axis, so lane j of the
    device is the contiguous tensor t[j]."""

    __slots__ = ("mesh", "axes")

    def __init__(self, mesh: Mesh, axes: Sequence[int]):
        self.mesh = mesh
        self.axes = tuple(axes)

    def split(self, args) -> Dict[torch.device, list]:
        """Host arrays per distinct device: for each argument, its lanes'
        ranges on that device stacked (lanes_of order); a device of one
        lane gets a view of its range with a first axis of one."""
        if len(args) != len(self.axes):
            raise ValueError(f"{len(args)} arguments, the placement covers {len(self.axes)}")
        nd = len(self.mesh)

        def stacked(a, ax, lanes):
            if len(lanes) == 1:
                return shard_of(a, lanes[0], nd, ax)[None]
            return np.stack([shard_of(a, k, nd, ax) for k in lanes])

        return {dev: [stacked(a, ax, self.mesh.lanes_of(dev)) for a, ax in zip(args, self.axes)]
                for dev in self.mesh.distinct()}

    def lane_args(self, dev_args: list, j: int) -> list:
        """Lane j of a device's stacked arguments."""
        return [t[j] for t in dev_args]

    def join(self, rows: Dict[torch.device, np.ndarray]) -> np.ndarray:
        """The per-device verdict rows (each device's lanes one after
        another) -> the batch's row in lane order; a one-lane placement's
        row as its device gave it."""
        if len(self.mesh) == 1:
            return np.asarray(rows[self.mesh.devices[0]])
        parts = []
        for k, dev in enumerate(self.mesh.devices):
            lanes = self.mesh.lanes_of(dev)
            row = np.asarray(rows[dev]).reshape(-1)
            size = row.shape[0] // len(lanes)
            j = lanes.index(k)
            parts.append(row[j * size : (j + 1) * size])
        return np.concatenate(parts)


# Each kind of superbatch argument tuple and its arguments' split axes
# (reference :711): the op-graph arguments are batch-first rows, the
# per-signature ones batch-minor.
_MESH_SPECS = {
    "host_hash": (0,) * 5,  # A, R, s, k rows, s_ok
    "device_hash": (0,) * 7,  # A, R, s rows, hi, lo, counts, s_ok
    "cached": (0,) * 5,  # table columns, R, s, k rows, s_ok
    "cached_device_hash": (0,) * 7,  # table columns, R, s rows, hi, lo, counts, s_ok
    "pallas": (-1,) * 5,  # a_t, r_t, s_t, k_t, s_ok_t
}


def mesh_arg_shardings(mesh: Mesh, kind: str, n_args: int) -> Placement:
    """The placement of a superbatch of `kind` with n_args arguments: each
    lane's rows on its device (reference :727)."""
    axes = _MESH_SPECS[kind]
    if len(axes) != n_args:
        raise ValueError(f"{kind} superbatch has {n_args} args, specs cover {len(axes)}")
    return Placement(mesh, axes)


def dispatch_mesh(n_lanes: int, device) -> Mesh:
    """The dispatcher's mesh when none is given (reference :595): on the
    card, the first min(n_lanes, visible) cards; on the CPU, the one
    device (every lane above the first is then simulated)."""
    dev = _norm(device)
    if dev.type == "cuda":
        return make_mesh(max(min(n_lanes, torch.cuda.device_count()), 1))
    return Mesh([dev])


_warned: set = set()


def mesh_ready(n_lanes: int, mesh: Mesh) -> bool:
    """Whether `mesh` has an entry for each of n_lanes lanes (reference
    :573). When it has not, the superbatch runs as simulated lanes: the
    whole of it on the dispatcher's card, with the same kernels and the
    same verdicts; logged once per (lanes, mesh size)."""
    if len(mesh) >= n_lanes:
        return True
    key = (n_lanes, len(mesh))
    if key not in _warned:
        _warned.add(key)
        _log.warning("the mesh dispatcher has %d lanes and a mesh of %d devices: "
                     "simulated lanes on one device. Logged once.", n_lanes, len(mesh))
    return False
