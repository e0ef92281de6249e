"""Input and readback buffers of the asynchronous dispatcher.

Counterpart: tendermint_tpu/ops/device_pool.py (layout_key :74-85,
transfer :87, PoolSlot, DeviceBufferPool). The reference bounds its
in-flight input sets with a slot pool and recycles their pages by
buffer donation. On the card the port keeps real buffers instead:

- a **slot** holds one in-flight batch's buffers for one layout (the
  bucket and every host array's shape and dtype): pinned host staging
  tensors (`torch.empty(..., pin_memory=True)`), the device tensors the
  kernels read, and a pinned readback tensor for the verdicts. Slots
  are made once and reused; at most `depth` of one layout are in flight
  (acquire blocks beyond that).
- `transfer` copies the prepared numpy arrays into the slot's pinned
  staging tensors, issues `copy_(non_blocking=True)` of each into its
  device tensor on the copy stream, and makes the compute stream wait
  for an event recorded after the copies. A copy from pinned memory
  runs beside the kernels of the batch before; from pageable numpy
  memory it would silently synchronise.
- `read_back` copies a batch's device verdicts into the slot's pinned
  readback tensor on the compute stream and returns the event recorded
  after it; the resolver waits on that event, copies the verdicts out
  into a host-owned array, and only then releases the slot.

A slot goes back to the pool when its verdicts have been read back or
its batch has failed; before that neither its staging nor its device
tensors are written again, so no batch reads another's inputs and no
delivered verdict is a view of a recycled buffer.

Every device tensor of a slot is allocated on the copy stream, which
writes it, and marked used by the compute stream, which reads it
(`record_stream`). The caching allocator reuses a freed block only for
an allocation on the stream it was made on, ordered after that stream's
work: a slot made on the compute stream could take the memory of a
tensor the compute stream still uses (the batch before's verdicts, freed
by the dispatcher as soon as their readback is queued), and its copy,
on the copy stream, would overwrite that memory under the running
kernel; a verdict row then reads the next batch's input bytes. Made on
the copy stream, a slot takes only memory the copy stream freed, and
when it is freed its memory waits for the compute stream too.

On the CPU a slot holds CPU tensors, `transfer` is a plain copy and
`read_back` copies at once (no event).

The dispatcher places every batch (sharded.Placement: a mesh
superbatch lane by lane, any other batch as one lane on its own device)
and takes one slot on each distinct device of the placement, from that
device's pool (PlacedSlots): the slot holds the device's lanes'
arguments stacked on a new first axis, is made on that device's copy
stream and filled through it, and reads back the device's verdicts on
its compute stream with an event of its own. The resolver waits on
every device's event, then joins the rows in lane order.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LayoutKey = Tuple


def layout_key(bucket: int, args) -> LayoutKey:
    """The bucket plus every host array's (shape, dtype): a slot only
    ever holds one layout's buffers (cold and warm preps of one bucket
    differ in their arrays, so their keys differ)."""
    return (bucket,) + tuple((a.shape, a.dtype.str) for a in args)


class PoolSlot:
    """One in-flight batch's buffers: `host` (pinned staging, CUDA only),
    `dev` (what the kernels read) and `readback` (the verdicts, made on
    the first read_back)."""

    __slots__ = ("key", "host", "dev", "readback")

    def __init__(self, key: LayoutKey, args, device: torch.device, stream=None):
        self.key = key
        cuda = device.type == "cuda"
        self.host = ([torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True)
                      for a in args] if cuda else None)
        # on the stream that writes them (the module docstring says why)
        on = torch.cuda.stream(stream) if cuda and stream is not None else contextlib.nullcontext()
        with on:
            self.dev = [torch.empty(a.shape, dtype=_torch_dtype(a.dtype), device=device)
                        for a in args]
        self.readback: Optional[torch.Tensor] = None


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def transfer(slot: PoolSlot, args, copy_stream=None, compute_stream=None) -> list:
    """Copy the prepared arrays `args` into the slot's device tensors and
    return them. On the card: into the pinned staging tensors, then
    non-blocking copies on `copy_stream`, then `compute_stream` waits on
    an event recorded after them."""
    if slot.host is None:
        for d, a in zip(slot.dev, args):
            d.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        return slot.dev
    for h, a in zip(slot.host, args):
        np.copyto(h.numpy(), a)
    with torch.cuda.stream(copy_stream):
        for d, h in zip(slot.dev, slot.host):
            d.copy_(h, non_blocking=True)
            d.record_stream(compute_stream)
        copied = torch.cuda.Event()
        copied.record(copy_stream)
    compute_stream.wait_event(copied)
    return slot.dev


def read_back(slot: PoolSlot, out: torch.Tensor, stream=None):
    """Copy the device verdicts `out` into the slot's readback tensor
    (made on first use: a slot's layout fixes the verdicts' shape). On
    the card: a non-blocking copy on `stream` into pinned memory and the
    event recorded after it; on the CPU the copy is done on return and
    there is no event (None)."""
    rb = slot.readback
    if rb is None or rb.shape != out.shape or rb.dtype != out.dtype:
        rb = slot.readback = torch.empty(out.shape, dtype=out.dtype,
                                         pin_memory=out.device.type == "cuda")
    if out.device.type != "cuda":
        rb.copy_(out)
        return None
    rb.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    return done


def owned_verdicts(slot: PoolSlot) -> np.ndarray:
    """The slot's read-back verdicts as a new host-owned array, safe to
    deliver after the slot is reused."""
    return np.array(slot.readback.numpy(), copy=True)


class PlacedSlots:
    """The slots of one placed batch, one on each distinct device of its
    placement (reference transfer :87 with NamedShardings, the arguments
    laid lane per device). `pools` and `streams` map a device
    to its DeviceBufferPool and its (copy, compute) streams ((None, None)
    on the CPU); `host` maps it to the arrays placement.split gave."""

    __slots__ = ("placement", "slots", "_pools")

    def __init__(self, pools: dict, placement, bucket: int, host: dict, streams: dict):
        self.placement = placement
        self._pools = pools
        self.slots: Dict[torch.device, PoolSlot] = {}
        try:
            for dev, arrays in host.items():
                self.slots[dev] = pools[dev].acquire(layout_key(bucket, arrays), arrays,
                                                     streams[dev][0])
        except BaseException:
            self.release()
            raise

    def transfer(self, host: dict, streams: dict) -> dict:
        """Each device's arrays into its slot (transfer); the device
        tensors by device."""
        return {dev: transfer(slot, host[dev], *streams[dev]) for dev, slot in self.slots.items()}

    def read_back(self, outs: dict, streams: dict) -> list:
        """Each device's verdicts into its slot's readback on its compute
        stream; the events to wait on (none on the CPU)."""
        done = [read_back(self.slots[dev], out, streams[dev][1]) for dev, out in outs.items()]
        return [e for e in done if e is not None]

    def owned_verdicts(self) -> np.ndarray:
        """The batch's verdict row in lane order, host-owned."""
        return self.placement.join({dev: owned_verdicts(s) for dev, s in self.slots.items()})

    def release(self) -> None:
        for dev, slot in self.slots.items():
            self._pools[dev].release(slot)
        self.slots = {}


class DeviceBufferPool:
    """Bounded per-layout slot pool (thread-safe): `acquire` blocks while
    `depth` slots of the same layout are in flight. `hits` counts reused
    slots, `misses` slots made."""

    def __init__(self, depth: int, device: torch.device):
        self.depth = max(int(depth), 1)
        self.device = device
        self.hits = 0
        self.misses = 0
        self._cv = threading.Condition()
        self._idle: Dict[LayoutKey, List[PoolSlot]] = {}
        self._in_flight: Dict[LayoutKey, int] = {}

    def acquire(self, key: LayoutKey, args, stream=None) -> PoolSlot:
        """A slot of this layout (reused, or made with its device tensors
        on `stream`, the copy stream that writes them)."""
        with self._cv:
            while self._in_flight.get(key, 0) >= self.depth:
                self._cv.wait()
            self._in_flight[key] = self._in_flight.get(key, 0) + 1
            idle = self._idle.get(key)
            if idle:
                self.hits += 1
                return idle.pop()
            self.misses += 1
        try:
            return PoolSlot(key, args, self.device, stream)
        except BaseException:
            self.release_key(key)
            raise

    def release(self, slot: Optional[PoolSlot]) -> None:
        if slot is None:
            return
        with self._cv:
            self._idle.setdefault(slot.key, []).append(slot)
            self._in_flight[slot.key] -= 1
            self._cv.notify_all()

    def release_key(self, key: LayoutKey) -> None:
        """Give back a reservation whose slot was never made."""
        with self._cv:
            self._in_flight[key] -= 1
            self._cv.notify_all()

    def in_flight(self) -> int:
        with self._cv:
            return sum(self._in_flight.values())

    def close(self) -> None:
        """Drop the idle slots (the caller has waited for every batch)."""
        with self._cv:
            self._idle.clear()
