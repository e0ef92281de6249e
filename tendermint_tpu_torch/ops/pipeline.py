"""The asynchronous verification dispatcher.

Counterpart: tendermint_tpu/ops/pipeline.py (DispatchError :209, _Job
:227, AsyncBatchVerifier :251 with its single-lane coalescer _worker
:720, _dispatcher :988 and _resolver :1295, shared_verifier :1330,
commit_entries :1346, verify_commits_pipelined :1447,
verify_headers_pipelined :1547). Verification jobs (EntryBlocks) are
submitted from any thread and come back as futures of (n,) bool
verdicts (an AggBlock of aggregated BLS12-381 commits: (k,) int32
verdict codes, one a commit). Three threads:

  coalescer   drains submit()s in arrival order, fuses jobs of one
              epoch and one scheme into device batches up to
              max_batch(), and runs each batch's host prep (by the
              block's scheme: ed25519's RLC, per-signature or op-graph
              prep, secp256k1's, bls12381's); it touches no CUDA
  dispatcher  the only thread that allocates device tensors, issues
              copies or launches kernels: it copies batch k+1's inputs
              through pinned staging on a copy stream (ops/device_pool)
              before it waits for a launch slot, so the copy runs beside
              kernel k; it launches on its compute stream, then copies
              the verdicts into pinned memory and records an event
  resolver    waits on that event (event.synchronize, which releases the
              interpreter lock), copies the verdicts out into a
              host-owned array, releases the batch's buffers, concludes
              the batch (the RLC blame pass) and completes the futures

`depth` bounds launched-but-unresolved batches; the buffer pool
(`pool_depth`, default depth + 1) bounds the input sets of one layout
that are launched or being copied. The dispatcher holds at most one
unlaunched slot, its current batch's; only the resolver, which waits on
nothing but launched work, releases the others, so a wait for a slot
always ends.

The BLS12-381 lane (reference :516-534): AggBlocks fuse only with
AggBlocks of the same committee (one epoch key: the bitmaps index one
committee), up to backend.max_coalesce(scheme) commits, and the
coalescer waits backend.coalesce_linger(scheme) for more of them even
when the device is idle. Its protocol branches on a host reduce of launch A's residues, so
the dispatch thread runs the whole of it in the batch's launch (launch
A, the readback of apk and the fused residue, launch B where a lane
failed) and hands on the int32 code row as a host tensor: its readback
is a plain host copy, and no pinned readback buffer is held across the
host reduce. The resolver gives each job its codes as int32 (a batch
with `codes` set is not turned into bools).

A batch whose host prep, copy or launch raises fails its own futures
with a DispatchError, and later batches go on. A failure at the
resolver's event wait is the device's (a failed launch, a sticky CUDA
error): it fails its batch, and from then on every batch fails with a
DispatchError naming it and every submit raises; nothing re-runs on the
CPU or on the plain version.

Spans (torch.profiler.record_function): pipeline.prep, pipeline.h2d,
pipeline.launch, pipeline.d2h, pipeline.resolve.

The dispatcher starts by making its device current
(torch.cuda.set_device), and launches inside torch.cuda.stream(compute):
the kernel wrappers launch on the current stream (ops/kernels.launch),
and an epoch's table (EpochEntry.coords_tables) is built on the first
warm batch's stream, the compute stream.

Mesh mode (mesh_lanes >= 1; reference _worker_mesh :870, _prepare_mesh
:638, submit :386-389): the coalescer drains up to mesh_lanes x
lane_cap signatures (lingering 8 ms while the device is busy), packs
whole jobs into the lanes of one superbatch (ops/mesh.pack_jobs: one
epoch and one scheme a lane; the jobs that fit no lane wait for the next
superbatch), and prepares it (ops/mesh.prepare_superbatch, span
pipeline.mesh_pack then pipeline.prep); submit chunks a block at the
lane capacity. Every batch runs through one path: it has a lane
placement (sharded.Placement), is copied to each distinct device of it
through that device's copy stream and slot (device_pool.PlacedSlots),
each lane's body launches on its device's compute stream, and each
device reads its verdicts back with an event the resolver waits on. A
superbatch placed lane by lane on the mesh has its own placement; every
other batch (the single-lane mode's, a one-lane superbatch, lanes the
mesh cannot place: simulated lanes) is one lane on the dispatcher's
card, its arrays one-lane views of the prepared ones. A pack or a
superbatch's prep that raises fails only its drained jobs. The reference's
TM_TPU_MESH and TM_TPU_MESH_LANE_BUCKET are the constructor arguments
mesh_lanes and lane_bucket; `mesh` (default sharded.dispatch_mesh) is the
devices the lanes go to. Mesh mode refuses an AggBlock (its BLS12-381
lanes are ROADMAP queue 1's next item); the single-lane mode serves it.

Not ported (ROADMAP): the replay and ingress priority classes (:124-135)
with their fuse caps, the ingress reservation, preemption and the prep
pool; they come with their first callers (ops/ingress.py, blocksync
replay), and until then every job is the consensus class's, served in
arrival order. Also the devcheck canaries and lint-bug seams; the
metrics and tracer flows; commit_entries_legacy (:1383), whose work the object path
of types/validation does here. The reference's TM_TPU_POOL_DEPTH is the
constructor argument pool_depth, with the same default.
"""

from __future__ import annotations

import contextlib
import functools
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from . import backend, commit_prep, sharded
from . import device_pool as _dpool
from . import mesh as _mesh
from .entry_block import AggBlock, EntryBlock, block_concat

CLOSE_TIMEOUT = 5.0  # seconds close() waits for each thread


class DispatchError(RuntimeError):
    """A batch failed on the dispatcher's side (host prep, copy, launch,
    the device, or its conclusion), with the batch's bucket and epoch;
    the original exception rides as __cause__."""

    def __init__(self, msg: str, *, bucket: int = 0,
                 epoch_key: Optional[bytes] = None):
        ek = epoch_key.hex()[:16] if epoch_key else None
        super().__init__(f"{msg} (bucket={bucket}, epoch={ek or 'uncached'})")
        self.bucket = bucket
        self.epoch_key = epoch_key


class _Job:
    __slots__ = ("entries", "future")

    def __init__(self, entries: EntryBlock):
        self.entries = entries
        self.future: Future = Future()


def _as_block(entries):
    if isinstance(entries, (EntryBlock, AggBlock)):
        return entries
    return EntryBlock.from_entries(list(entries))


def _dispatch_error(msg: str, e: BaseException, bucket: int, spans) -> DispatchError:
    err = DispatchError(f"{msg}: {e!r}", bucket=bucket,
                        epoch_key=spans[0][0].entries.epoch_key if spans else None)
    err.__cause__ = e
    return err


def _settle(fut: Future, result=None, exc: Optional[BaseException] = None) -> None:
    """Complete a future unless its caller cancelled it."""
    try:
        if exc is None:
            fut.set_result(result)
        else:
            fut.set_exception(exc)
    except InvalidStateError:
        pass


def _fail_spans(spans, err: BaseException) -> None:
    for job, _, _ in spans:
        _settle(job.future, exc=err)


class AsyncBatchVerifier:
    """The coalescing dispatcher of one device, with one dispatch
    thread (see the module docstring).

    `prepare(entries)` is the host stage: it returns a prepared batch
    with `args` (the numpy arrays to copy), `bucket`, `launch(dev_args)`
    (device tensors in, the device verdicts out, on the current stream)
    and `conclude(row)` (the host copy of those verdicts -> (n,) bool).
    The default is backend.prepare_block (by the block's scheme); tests
    pass stand-ins. A device batch is capped at
    backend.max_coalesce(scheme), read at each submit, and at `max_batch`
    where that is given.

    With mesh_lanes >= 1 the dispatcher runs in mesh mode (module
    docstring): `prepare(block, plan)` is then the host stage of a
    superbatch (default ops/mesh.prepare_superbatch over `mesh`), whose
    prepared batch may carry a lane placement."""

    def __init__(self, device=None, depth: int = 3, pool_depth: Optional[int] = None, *,
                 prepare=None, max_batch: Optional[int] = None, mesh_lanes: int = 0,
                 lane_bucket: Optional[int] = None, mesh: Optional[sharded.Mesh] = None):
        self.device = resolve_device(device)
        self._depth = max(int(depth), 1)
        self._pool_depth = self._depth + 1 if pool_depth is None else pool_depth
        self._pool = _dpool.DeviceBufferPool(self._pool_depth, self.device)
        self._mesh_lanes = max(int(mesh_lanes), 0)
        self._lane_cap = _mesh.lane_cap(lane_bucket)
        self.mesh: Optional[sharded.Mesh] = None
        # one pool a device: the dispatcher's, and each other device of the mesh
        self._pools = {self.device: self._pool}
        # where a batch without a lane placement runs: one lane, this device
        self._local = sharded.Mesh([self.device])
        if self._mesh_lanes:
            self.mesh = mesh or sharded.dispatch_mesh(self._mesh_lanes, self.device)
            for dev in self.mesh.distinct():
                if dev not in self._pools:
                    self._pools[dev] = _dpool.DeviceBufferPool(self._pool_depth, dev)
            prepare = prepare or functools.partial(_mesh.prepare_superbatch, mesh=self.mesh)
        self._prepare = prepare or backend.prepare_block
        self._max_batch = max_batch
        self._q: queue.Queue = queue.Queue()
        self._dispatch_q: queue.Queue = queue.Queue()
        self._resolve_q: queue.Queue = queue.Queue()
        self._stopped = threading.Event()
        self._sem = threading.Semaphore(self._depth)
        self._mtx = threading.Lock()
        self._inflight = 0
        # a device failure seen at the resolver: later batches fail with it
        self._broken: Optional[BaseException] = None
        # the idents of every thread that copied to or launched on the
        # device: one element, the dispatch thread
        self.dispatch_thread_idents: set = set()
        self._thread = threading.Thread(
            target=self._worker_mesh if self._mesh_lanes else self._worker, daemon=True,
            name="verify-coalesce")
        self._dispatch_thread = threading.Thread(target=self._dispatcher, daemon=True,
                                                 name="verify-dispatch")
        self._resolve_thread = threading.Thread(target=self._resolver, daemon=True,
                                                name="verify-resolve")
        self._thread.start()
        self._dispatch_thread.start()
        self._resolve_thread.start()

    # -- intake ------------------------------------------------------------

    def max_batch(self, scheme: str = "ed25519") -> int:
        cap = backend.max_coalesce(scheme)
        return cap if self._max_batch is None else min(cap, self._max_batch)

    def submit(self, entries) -> Future:
        """A future of the (n,) bool verdicts of `entries` (an EntryBlock,
        passed by reference, or (pub, msg, sig) triples), or of the (k,)
        int32 verdict codes of an AggBlock. A block above the batch cap
        (in mesh mode, the lane capacity) is split and its verdicts
        joined. In mesh mode an AggBlock raises ValueError."""
        if self._stopped.is_set():
            raise RuntimeError("verifier is closed")
        if self._broken is not None:
            raise RuntimeError(f"the device failed: {self._broken!r}")
        block = _as_block(entries)
        max_b = self.max_batch(block.scheme)
        if self._mesh_lanes:
            if isinstance(block, AggBlock):
                raise ValueError(f"a mesh-mode dispatcher takes no AggBlock ({_mesh.BLS_LANES_ITEM})")
            max_b = min(max_b, self._lane_cap)
        if len(block) > max_b:
            return self._submit_chunked(block, max_b)
        job = _Job(block)
        if len(block) == 0:
            _settle(job.future, np.zeros(0, dtype=np.int32 if isinstance(block, AggBlock)
                                         else bool))
            return job.future
        self._q.put(job)
        return job.future

    def _submit_chunked(self, block: EntryBlock, max_b: int) -> Future:
        """Slices of at most max_b through the normal queue, joined into
        one future (the first failure fails it)."""
        futs = [self.submit(block[i : i + max_b]) for i in range(0, len(block), max_b)]
        agg: Future = Future()
        done_lock = threading.Lock()

        def combine(_f) -> None:
            with done_lock:
                if agg.done() or not all(f.done() for f in futs):
                    return
                try:
                    parts = [f.result() for f in futs]
                except Exception as e:  # the first failure is the whole job's
                    _settle(agg, exc=e)
                    return
                _settle(agg, np.concatenate(parts))

        for f in futs:
            f.add_done_callback(combine)
        return agg

    def close(self, timeout: float = CLOSE_TIMEOUT) -> None:
        """Stop taking jobs, let the queued ones finish, and join the three
        threads, each within `timeout` seconds."""
        self._stopped.set()
        for t in (self._thread, self._dispatch_thread, self._resolve_thread):
            t.join(timeout=timeout)
        if not any(t.is_alive() for t in (self._dispatch_thread, self._resolve_thread)):
            for pool in self._pools.values():
                pool.close()

    # -- coalescer ---------------------------------------------------------

    def _worker(self) -> None:
        """Fuse queued jobs of one epoch key and one scheme into a batch
        up to max_batch(), peel trailing jobs while that lands the batch
        in a smaller bucket, prepare it and hand it to the dispatcher.
        Two blocks of different schemes never fuse (two cold blocks both
        have the epoch key None), nor two AggBlocks of two committees
        (their keys differ)."""
        hold: Optional[_Job] = None
        try:
            while True:
                job, hold = hold, None
                if job is None:
                    try:
                        job = self._q.get(timeout=0.05)
                    except queue.Empty:
                        if self._stopped.is_set() and self._q.empty():
                            break
                        continue
                jobs = [job]
                total = len(job.entries)
                key0 = job.entries.epoch_key
                scheme0 = job.entries.scheme
                # while the device is busy a short linger fuses stragglers;
                # an idle one waits as long as the scheme asks
                busy = self._inflight > 0 or self._dispatch_q.qsize() > 0
                linger = 0.008 if busy else backend.coalesce_linger(scheme0)
                deadline = time.monotonic() + linger if linger else 0.0
                limit = self.max_batch(scheme0)
                while total < limit:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        wait = deadline - time.monotonic()
                        if wait <= 0:
                            break
                        try:
                            nxt = self._q.get(timeout=wait)
                        except queue.Empty:
                            break
                    if (total + len(nxt.entries) > limit or nxt.entries.epoch_key != key0
                            or nxt.entries.scheme != scheme0):
                        hold = nxt
                        break
                    jobs.append(nxt)
                    total += len(nxt.entries)
                # a total just past a bucket pays its padding: peel trailing
                # jobs back while that lands the batch in a smaller bucket
                while len(jobs) > 1 and hold is None:
                    b = backend.quantized_bucket(total, scheme0)
                    if b - total <= max(b // 8, 1024):
                        break
                    if backend.quantized_bucket(total - len(jobs[-1].entries), scheme0) >= b:
                        break
                    hold = jobs.pop()
                    total -= len(hold.entries)
                spans = []
                off = 0
                for j in jobs:
                    spans.append((j, off, len(j.entries)))
                    off += len(j.entries)
                entries = (jobs[0].entries if len(jobs) == 1
                           else block_concat([j.entries for j in jobs]))
                try:
                    with record_function("pipeline.prep"):
                        prep = self._prepare(entries)
                except Exception as e:  # the batch's failure, reported on its futures
                    _fail_spans(spans, _dispatch_error("batch prep failed", e, 0, spans))
                    continue
                self._dispatch_q.put((spans, prep))
        finally:
            self._dispatch_q.put(None)

    def _worker_mesh(self) -> None:
        """The mesh-mode coalescer (reference :870): drain queued jobs up
        to mesh_lanes x lane_cap signatures, lingering 8 ms for more while
        the device is busy, pack them into the lanes of one superbatch
        (held-over jobs first, in arrival order), build and prepare it,
        and hand it to the dispatcher. Jobs that fit no lane wait for the
        next superbatch; a pack that raises fails the drained jobs, a prep
        that raises the superbatch's; the thread goes on either way. No
        empty job is queued (submit resolves it)."""
        held: List[_Job] = []
        try:
            while True:
                jobs, held = held, []
                if not jobs:
                    try:
                        jobs = [self._q.get(timeout=0.05)]
                    except queue.Empty:
                        if self._stopped.is_set() and self._q.empty():
                            break
                        continue
                total = sum(len(j.entries) for j in jobs)
                busy = self._inflight > 0 or self._dispatch_q.qsize() > 0
                deadline = time.monotonic() + 0.008 if busy else 0.0
                while total < self._mesh_lanes * self._lane_cap:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        wait = deadline - time.monotonic()
                        if wait <= 0:
                            break
                        try:
                            nxt = self._q.get(timeout=wait)
                        except queue.Empty:
                            break
                    jobs.append(nxt)
                    total += len(nxt.entries)
                try:
                    with record_function("pipeline.mesh_pack"):
                        plan, held = _mesh.pack_jobs(jobs, self._mesh_lanes, self._lane_cap)
                        block, spans = _mesh.build_superblock(plan)
                except Exception as e:  # the drained jobs' failure, not the thread's
                    drained = [(j, 0, len(j.entries)) for j in jobs]
                    _fail_spans(drained, _dispatch_error("mesh pack failed", e, 0, drained))
                    held = []
                    continue
                try:
                    with record_function("pipeline.prep"):
                        prep = self._prepare(block, plan)
                except Exception as e:  # the superbatch's failure
                    _fail_spans(spans, _dispatch_error("batch prep failed", e, plan.bucket,
                                                       spans))
                    continue
                self._dispatch_q.put((spans, prep))
        finally:
            self._dispatch_q.put(None)

    # -- dispatcher --------------------------------------------------------

    def _dispatcher(self) -> None:
        """Make the device current, a copy and a compute stream for each
        CUDA device it copies to (the dispatcher's and, in mesh mode,
        each other device of the mesh), then dispatch batches in order on
        the dispatcher's compute stream."""
        dev = self.device
        streams = {d: (None, None) for d in self._pools}
        on_compute = contextlib.nullcontext()
        if dev.type == "cuda":
            try:
                torch.cuda.set_device(dev)
                for d in streams:
                    if d.type == "cuda":
                        streams[d] = (torch.cuda.Stream(d), torch.cuda.Stream(d))
                on_compute = torch.cuda.stream(streams[dev][1])
            except Exception as e:  # every batch then fails with it
                self._broken = e
        with on_compute:
            while True:
                item = self._dispatch_q.get()
                if item is None:
                    self._resolve_q.put(None)
                    return
                self._dispatch_one(*item, streams)

    def _placed(self, prep) -> tuple:
        """(placement, per-device host arrays) of a prepared batch: a
        superbatch's lane placement, or else one lane on the dispatcher's
        device, whose arrays are the batch's own as one-lane views."""
        placement = getattr(prep, "placement", None)
        if placement is not None:
            return placement, prep.host
        placement = sharded.Placement(self._local, (0,) * len(prep.args))
        return placement, placement.split(prep.args)

    @staticmethod
    def _launch(prep, placement, dev_args: dict, streams: dict) -> dict:
        """Each lane's body on its device's compute stream, in lane order;
        each device's verdicts, its lanes one after another."""
        outs: Dict[torch.device, list] = {d: [] for d in dev_args}
        with contextlib.ExitStack() as on:
            for d in dev_args:
                if streams[d][1] is not None:
                    on.enter_context(torch.cuda.stream(streams[d][1]))
            for d in placement.mesh.devices:
                outs[d].append(prep.launch(placement.lane_args(dev_args[d], len(outs[d]))))
            return {d: o[0] if len(o) == 1 else torch.cat(o) for d, o in outs.items()}

    def _dispatch_one(self, spans, prep, streams) -> None:
        """One batch: copy it, wait for a launch slot, launch, start the
        readback and hand it to the resolver. Whatever fails fails only
        this batch, with its launch slot and buffers given back."""
        slots = None
        sem_held = False
        try:
            if self._broken is not None:
                raise RuntimeError(f"the device failed: {self._broken!r}")
            self.dispatch_thread_idents.add(threading.get_ident())
            placement, host = self._placed(prep)
            slots = _dpool.PlacedSlots(self._pools, placement, prep.bucket, host, streams)
            with record_function("pipeline.h2d"):
                dev_args = slots.transfer(host, streams)
            self._sem.acquire()
            sem_held = True
            with record_function("pipeline.launch"):
                out = self._launch(prep, placement, dev_args, streams)
            with record_function("pipeline.d2h"):
                done = slots.read_back(out, streams)
            with self._mtx:
                self._inflight += 1
            self._resolve_q.put((spans, prep, slots, done))
            sem_held = False  # the resolver releases it and the slots
            slots = None
        except Exception as e:  # this batch fails alone; the thread goes on
            _fail_spans(spans, _dispatch_error("batch dispatch failed", e, prep.bucket, spans))
        finally:
            if sem_held:
                self._sem.release()
            if slots is not None:
                slots.release()

    # -- resolver ----------------------------------------------------------

    def _resolver(self) -> None:
        while True:
            item = self._resolve_q.get()
            if item is None:
                return
            try:
                self._resolve(*item)
            finally:
                with self._mtx:
                    self._inflight -= 1
                self._sem.release()

    def _resolve(self, spans, prep, slots, done) -> None:
        """Wait for every device's readback, copy the verdicts out, release
        the slots, conclude, and give each job its own host-owned verdicts
        (bools, or int32 codes for a batch with `codes` set). Any failure
        fails this batch's futures; the slots go back either way."""
        with record_function("pipeline.resolve"):
            try:
                try:
                    for event in done:
                        event.synchronize()
                except Exception as e:  # the device failed: trust nothing after it
                    self._broken = e
                    raise
                row = slots.owned_verdicts()
                slots.release()
                verdicts = np.asarray(prep.conclude(row))
                if not getattr(prep, "codes", False):
                    verdicts = verdicts.astype(bool)
            except Exception as e:  # this batch fails alone
                slots.release()
                what = "device failed" if self._broken is e else "batch resolve failed"
                _fail_spans(spans, _dispatch_error(what, e, prep.bucket, spans))
                return
        for job, off, n in spans:
            _settle(job.future, verdicts[off : off + n].copy())


_shared: Dict[torch.device, AsyncBatchVerifier] = {}
_shared_mtx = threading.Lock()


def shared_verifier(device=None) -> AsyncBatchVerifier:
    """The process-wide dispatcher of `device` (default the CUDA card),
    made on first use."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _shared_mtx:
        v = _shared.get(dev)
        if v is None:
            v = _shared[dev] = AsyncBatchVerifier(dev)
        return v


def reset_shared() -> None:
    """Close and drop every shared dispatcher (tests)."""
    with _shared_mtx:
        vs = list(_shared.values())
        _shared.clear()
    for v in vs:
        v.close()


# -- commit-level entry points --------------------------------------------------


def commit_entries(chain_id: str, vals, commit, voting_power_needed: int) -> Tuple[EntryBlock, int]:
    """The EntryBlock of a commit's for-block signatures, stopping past
    voting_power_needed (validation.go:152 with countAllSignatures
    false), and the power tallied, by the fused commit prep
    (ops/commit_prep.py). A commit the fused prep cannot take goes
    through the object path of types/validation, as does an
    all-secp256k1 set (reference :1420-1429: its block is of scheme
    secp256k1, with the set's rows and epoch key); any other set raises
    TypeError."""
    from ..types import validation as _validation
    from ..types.validator_set import ErrNotEnoughVotingPowerSigned

    with record_function("commit.prep"):
        fused = commit_prep.prep_commit_from(
            commit, vals, chain_id, voting_power_needed,
            commit_prep.MODE_SELECT_COMMIT_ONLY | commit_prep.MODE_EARLY_STOP)
    if fused is not None:
        _sel, tallied, block = fused
        if block is None:
            raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
        return block, tallied
    if vals.ed25519_columns() is None and vals.secp256k1_columns() is None:
        raise TypeError("pubkey is not ed25519")
    block, _keys, _sig_idxs, tallied = _validation.select_block(
        chain_id, vals, commit, voting_power_needed, _validation._ignore_not_for_block,
        _validation._count_all, False, True)
    return block, tallied


def verify_commits_pipelined(chain_id: str, jobs: Sequence[Tuple[object, object, int, object]],
                             verifier: Optional[AsyncBatchVerifier] = None, *,
                             device=None) -> List[Optional[str]]:
    """jobs: (vals, block_id, height, commit) per header. Returns one
    entry per job: None, or its error string. A job's checks are
    verify_commit_light's (validation.go:59): the set and commit bind,
    then +2/3 of vals signed block_id at height. The signatures of all
    jobs are packed into full batches of backend.BUCKETS[-1] (a job may
    straddle two) and sent through `verifier` (default the device's
    shared one); a bad signature is blamed by its index within its job,
    `wrong signature (entry i)`. A batch holds one scheme: a job whose
    scheme differs from the running batch's starts a new one."""
    from ..types.validation import _verify_basic_vals_and_commit

    v = verifier or shared_verifier(device)
    errors: List[Optional[str]] = [None] * len(jobs)
    max_b = backend.BUCKETS[-1]
    futures: List[Future] = []
    job_spans: List[list] = [[] for _ in jobs]  # (future index, offset, n)
    cur: list = []
    cur_n = 0
    cur_spans: list = []  # (job index, offset in the batch, n)

    def flush() -> None:
        nonlocal cur, cur_n, cur_spans
        if not cur:
            return
        fi = len(futures)
        futures.append(v.submit(EntryBlock.concat(cur)))
        for job_i, off, n in cur_spans:
            job_spans[job_i].append((fi, off, n))
        cur, cur_n, cur_spans = [], 0, []

    for i, (vals, block_id, height, commit) in enumerate(jobs):
        try:
            _verify_basic_vals_and_commit(vals, commit, height, block_id)
            needed = vals.total_voting_power() * 2 // 3
            entries, _ = commit_entries(chain_id, vals, commit, needed)
        except (ValueError, RuntimeError) as e:
            errors[i] = str(e)
            continue
        if cur and cur[0].scheme != entries.scheme:
            flush()
        pos = 0
        while pos < len(entries):
            take = min(len(entries) - pos, max_b - cur_n)
            cur_spans.append((i, cur_n, take))
            cur.append(entries[pos : pos + take])
            cur_n += take
            pos += take
            if cur_n >= max_b:
                flush()
    flush()

    results: List[object] = []
    for fut in futures:
        try:
            results.append(fut.result(timeout=300))
        except Exception as e:  # the batch's failure is its jobs' error
            results.append(e)
    for i in range(len(jobs)):
        if errors[i] is not None:
            continue
        pos_in_job = 0
        for fi, off, n in job_spans[i]:
            r = results[fi]
            if isinstance(r, Exception):
                errors[i] = str(r)
                break
            seg = r[off : off + n]
            if not seg.all():
                errors[i] = f"wrong signature (entry {pos_in_job + int(np.argmin(seg))})"
                break
            pos_in_job += n
    return errors


def verify_headers_pipelined(chain_id: str, trusted_header, headers: Sequence[Tuple[object, object]],
                             verifier: Optional[AsyncBatchVerifier] = None, *,
                             device=None) -> None:
    """Adjacent header-range verification (BASELINE config #5,
    light/verifier.go VerifyAdjacent's checks over a fetched range):
    headers is [(signed_header, validator_set), ...] from
    trusted_header's height + 1, strictly adjacent. The host checks run
    first, in order; then every commit's signatures through
    verify_commits_pipelined. Raises ValueError on the first failure."""
    from ..types.block import BlockID

    prev = trusted_header
    jobs = []
    for sh, vals in headers:
        if sh.header.height != prev.header.height + 1:
            raise ValueError(
                f"headers must be adjacent: {sh.header.height} after {prev.header.height}")
        sh.validate_basic(chain_id)
        if sh.header.validators_hash != vals.hash():
            raise ValueError(
                f"header {sh.header.height} validators_hash does not match supplied set")
        if sh.header.validators_hash != prev.header.next_validators_hash:
            raise ValueError(f"header {sh.header.height} validators_hash breaks continuity")
        jobs.append((vals,
                     BlockID(hash=sh.commit.block_id.hash,
                             part_set_header=sh.commit.block_id.part_set_header),
                     sh.header.height, sh.commit))
        prev = sh
    errors = verify_commits_pipelined(chain_id, jobs, verifier, device=device)
    for (sh, _), err in zip(headers, errors):
        if err is not None:
            raise ValueError(f"header {sh.header.height}: {err}")
