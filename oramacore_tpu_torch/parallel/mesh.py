"""The port of `jax.sharding.Mesh`, `shard_map` and the `lax` collectives.

JAX runs a doc-sharded search step as one `shard_map` over the local
devices of a `Mesh`, with `lax.psum` / `pmax` / `all_gather` over the
mesh axis `d` inside the step. The port keeps that single-controller
shape in one process:

- `ShardMesh(devices)` holds the axis `d`, one shard a device. A device
  may repeat: `[cuda:0] * 4` runs four shards on one card (every kernel
  is launched once a shard, every collective runs), as JAX's host device
  count runs eight CPU shards on one host.
- `ShardMesh.run(body, *args)` calls `body(axis, *args_of_shard)` once a
  shard, each on its own persistent thread, under
  `torch.cuda.device(dev)` where the shard's device is a card. An
  argument wrapped in `Sharded` (one value a shard) hands shard s its own
  value; any other argument goes to every shard as it is. It returns the
  shards' results, in shard order.
- `ShardAxis.psum`, `.pmax` and `.all_gather` meet at a barrier. The
  first shard reduces the D inputs in shard order, on its own device
  (so a sum is the same, bit for bit, on every run), and every shard
  gets the result back: the same tensor on the first shard's device, a
  copy on another device. Results of a collective are shared: a body
  must not write into them.
- No failure is hidden. A shard's exception aborts the barrier, the
  other shards leave their collectives with `BrokenBarrierError`, and
  `run` raises the first shard's exception in the caller; a shard that
  never reaches a collective breaks it after `timeout` seconds. Nothing
  falls back to a single-device executor.

On distinct cards, a collective's copies to the first shard's device
and back are `Tensor.to` copies, which PyTorch orders after the work
of each source device's current stream. A machine with one card cannot
run that case, so it is untested: the mesh has run only on one card
with its shards on the same device (and on the CPU).

One step runs at a time on a mesh (`run` holds a lock), as the steps of
one XLA device queue do; the shards of a step on one card share its
current stream, so their kernels run in stream order. Within a step the
shards take turns on the host: a shard runs while it holds the mesh's
baton and hands it on only while it waits at a collective, so one shard
thread at a time is runnable (threads that all want the interpreter
lock would trade it every `sys.getswitchinterval()`, 5 ms, apart).
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Any, Callable, List, Sequence

import torch

AXIS = "d"
DEFAULT_TIMEOUT = 600.0   # seconds a shard waits at a collective


class Sharded(tuple):
    """One value a shard, in shard order (a `P("d", ...)` argument)."""


class ShardAxis:
    """The mesh axis as one shard's body sees it: its index (`lax.
    axis_index`), the axis size and the collectives."""

    def __init__(self, mesh: "ShardMesh", index: int):
        self.mesh = mesh
        self.index = index
        self.size = mesh.D

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the shards, in shard order."""
        return self.mesh._collective(
            self.index, x, lambda xs: functools.reduce(torch.add, xs))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the shards."""
        return self.mesh._collective(
            self.index, x, lambda xs: functools.reduce(torch.maximum, xs))

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The shards' tensors stacked along a new axis `axis`
        (`lax.all_gather(x, "d", axis=axis)`)."""
        return self.mesh._collective(
            self.index, x, lambda xs: torch.stack(xs, dim=axis))


def default_devices() -> List[torch.device]:
    """The devices a mesh is built from when none are given: the distinct
    CUDA devices, as `jax.devices()` lists a host's chips, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class ShardMesh:
    """A 1-D mesh of D shards over `devices` (axis `d`)."""

    def __init__(self, devices: Sequence, timeout: float = DEFAULT_TIMEOUT):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.D = len(self.devices)
        self.shape = {AXIS: self.D}
        self._barrier = threading.Barrier(self.D, timeout=timeout)
        self._slots: List[Any] = [None] * self.D
        self._result = None
        self._queues = [queue.SimpleQueue() for _ in range(self.D)]
        self._threads: List[threading.Thread] = []
        self._run_lock = threading.Lock()
        self._baton = threading.Lock()

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]})"

    @property
    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def replicate(self, x) -> Sharded:
        """x (array or tensor) on every shard's device: one copy a
        distinct device, shared by the shards on it."""
        t = torch.as_tensor(x)
        per_dev = {d: t.to(d) for d in self.distinct_devices}
        return Sharded(per_dev[d] for d in self.devices)

    def shard(self, x) -> Sharded:
        """x with a leading axis of D (array or tensor): shard s gets x[s]
        on its device (`P("d", ...)`)."""
        t = torch.as_tensor(x)
        if t.shape[0] != self.D:
            raise ValueError(f"leading axis {t.shape[0]} is not the mesh's "
                             f"{self.D} shards")
        return Sharded(t[s].to(d).contiguous()
                       for s, d in enumerate(self.devices))

    # ------------------------------------------------------------------
    # the step runner
    # ------------------------------------------------------------------

    def _start(self) -> None:
        for s in range(self.D):
            t = threading.Thread(target=self._worker, args=(s,),
                                 name=f"mesh-shard-{s}", daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, sid: int) -> None:
        axis = ShardAxis(self, sid)
        dev = self.devices[sid]
        while True:
            task = self._queues[sid].get()
            if task is None:
                return
            body, args, results, errors, done = task
            self._baton.acquire()
            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        results[sid] = body(axis, *args)
                else:
                    results[sid] = body(axis, *args)
            except BaseException as e:  # noqa: BLE001 - re-raised by run
                errors[sid] = e
                self._barrier.abort()
            finally:
                self._baton.release()
                done.release()

    def run(self, body: Callable, *args) -> Sharded:
        """body(axis, *args of the shard) on every shard; the results in
        shard order. Raises the first shard's exception (in shard order,
        a collective broken by another shard's failure coming last)."""
        with self._run_lock:
            if not self._threads:
                self._start()
            results: List[Any] = [None] * self.D
            errors: List[Any] = [None] * self.D
            done = threading.Semaphore(0)
            for s in range(self.D):
                shard_args = tuple(a[s] if isinstance(a, Sharded) else a
                                   for a in args)
                self._queues[s].put((body, shard_args, results, errors, done))
            for _ in range(self.D):
                done.acquire()
            if any(e is not None for e in errors):
                self._barrier.reset()
                self._slots = [None] * self.D
                self._result = None
                first = next(
                    (e for e in errors if e is not None
                     and not isinstance(e, threading.BrokenBarrierError)),
                    next(e for e in errors if e is not None))
                raise first
            return Sharded(results)

    def close(self) -> None:
        """Stop the shard threads (a later `run` starts new ones)."""
        with self._run_lock:
            for q in self._queues:
                q.put(None)
            for t in self._threads:
                t.join()
            self._threads = []

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def _collective(self, sid: int, x: torch.Tensor, reduce) -> torch.Tensor:
        self._slots[sid] = x
        # the baton goes to the next shard while this one waits
        self._baton.release()
        try:
            self._barrier.wait()
            if sid == 0:
                dev0 = self.devices[0]
                with self._baton:
                    self._result = reduce([
                        t if t.device == dev0 else t.to(dev0)
                        for t in self._slots])
            self._barrier.wait()
        finally:
            self._baton.acquire()
        r = self._result
        dev = self.devices[sid]
        return r if r.device == dev else r.to(dev)
