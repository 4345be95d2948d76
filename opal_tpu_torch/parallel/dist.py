"""The ring of ranks: opal_tpu's device mesh on ``torch.distributed``.

opal_tpu runs one SPMD program over a 1-D device mesh
(``opal_tpu/fields.py:28-43`` ``make_mesh``) and talks between devices
with ``lax.ppermute`` rings, ``psum`` and ``all_gather``.  The port runs
one process per rank and one device per process, and :class:`Ring`
holds what such a process needs to talk to the others: its rank, the
world size, its ``torch.device`` and the process group (NCCL for CUDA
tensors, ``gloo`` for CPU tensors).  It is passed explicitly to
whatever issues a collective.

A ring without a process group is a world of 1 and issues no
collective: the one-device path.  A world of 1 with a group issues its
reductions and gathers (so the group is exercised) but its shift is a
local copy, the reference's self-send shortcut (``yee.rs:365-369``):
torch refuses a send to self.

:func:`launch` starts the ranks of one host as processes, and
:func:`init` joins a process to its group.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import tempfile
import time

import torch
import torch.distributed as dist

from .. import trace

#: how long a collective may wait for the other ranks before it raises
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Ring:
    """One rank's view of the ring: ``rank`` of ``world``, its device,
    and the process group (``None``: a world of 1, no collectives)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: object = None

    def __post_init__(self):
        if self.group is None and self.world != 1:
            raise ValueError("a ring of several ranks needs a process group")

    @property
    def left(self) -> int:
        return (self.rank - 1) % self.world

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.world

    def shift(self, to_right, to_left):
        """The two ring ``ppermute``s of a halo or migration exchange in
        one batch: ``to_right`` goes to the right neighbour and
        ``to_left`` to the left one.  Returns ``(from_left,
        from_right)``, what the neighbours sent this rank.

        At a world of 1 both come back to this rank (a local copy).  At
        a world of 2 both neighbours are the same rank: every rank posts
        its sends and receives in one fixed order (right-flowing data
        first, each with its own tag), so the message that flows right
        is never matched with the receive of the one that flows left."""
        if self.world == 1:
            return to_right, to_left
        to_right, to_left = to_right.contiguous(), to_left.contiguous()
        from_left = torch.empty_like(to_right)
        from_right = torch.empty_like(to_left)
        ops = [
            dist.P2POp(dist.isend, to_right, self.right, self.group, 0),
            dist.P2POp(dist.isend, to_left, self.left, self.group, 1),
            dist.P2POp(dist.irecv, from_left, self.left, self.group, 0),
            dist.P2POp(dist.irecv, from_right, self.right, self.group, 1),
        ]
        # under NCCL, wait() orders the compute stream after the batch
        # and returns at once: the host runs on
        with trace.collective(trace.SHIFT, self.device, to_right, to_left):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return from_left, from_right

    def psum(self, x):
        """The sum of ``x`` over the ranks (``lax.psum``)."""
        if self.group is None:
            return x
        x = x.clone()
        with trace.collective(trace.PSUM, self.device, x):
            dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x):
        """``x`` of every rank, stacked on a new leading axis of
        ``world`` (``lax.all_gather``)."""
        return self._collect(x, everyone=True)

    def gather(self, x):
        """``x`` of every rank stacked as :meth:`all_gather` does, on
        rank 0 alone (``None`` on the others): the gather of what rank 0
        alone writes."""
        return self._collect(x, everyone=False)

    def _collect(self, x, everyone: bool):
        if self.group is None:
            return x[None]
        flag = x.dtype == torch.bool
        x = (x.to(torch.uint8) if flag else x).contiguous()
        out = ([torch.empty_like(x) for _ in range(self.world)]
               if everyone or self.rank == 0 else None)
        with trace.collective(trace.ALL_GATHER if everyone else trace.GATHER,
                              self.device, x):
            if everyone:
                dist.all_gather(out, x, group=self.group)
            else:
                dist.gather(x, out, dst=0, group=self.group)
        if out is None:
            return None
        out = torch.stack(out)
        return out.bool() if flag else out

    def barrier(self):
        """Wait for every rank (a sum of one element, outside the
        collectives that :mod:`trace` times and counts)."""
        if self.group is not None:
            with trace.span(trace.BARRIER):
                dist.all_reduce(torch.zeros((), device=self.device),
                                group=self.group)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)


#: a world of 1 with no process group: what needs no device of its own
#: (the halo and migration functions' default) takes this ring
SOLO = Ring()


def init(rank: int, world: int, init_method: str, device_type: str) -> Ring:
    """Join this process to the group of ``world`` ranks at
    ``init_method`` (``tcp://host:port`` or ``file://path``) as ``rank``:
    NCCL on the card ``rank % device_count`` (``device_type`` "cuda"),
    ``gloo`` on the CPU.  A failed init raises."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an NCCL rank")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device = torch.device("cpu")
        backend = "gloo"
        # the ranks of one host share its cores: one thread pool each of
        # all of them would oversubscribe them world-fold (unless the
        # caller set the pool's size, OMP_NUM_THREADS)
        if "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return Ring(rank=rank, world=world, device=device, group=dist.group.WORLD)


def close(ring: Ring):
    """Leave the process group that :func:`init` joined (if any)."""
    if ring.group is not None:
        dist.destroy_process_group()


def launch(target, world: int, args=(), timeout: float | None = None):
    """Run ``target(rank, world, init_method, *args)`` in ``world`` new
    processes (``spawn``: ``target`` must be importable) and wait for
    them.  ``init_method`` is a ``file://`` rendezvous in a new temporary
    directory, removed when the ranks are done: no port is taken, so
    concurrent launches never meet each other's ranks.  When one rank
    fails, the others are stopped (they would wait on it forever); past
    ``timeout`` seconds all are stopped and TimeoutError is raised.
    Returns the exit codes by rank."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="opal_ranks_") as tmp:
        init_method = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=target,
                             args=(rank, world, init_method, *args))
                 for rank in range(world)]
        for p in procs:
            p.start()
        t0 = time.monotonic()
        try:
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError(
                        f"{world} ranks still running after {timeout:.0f} s")
                for p in procs:
                    p.join(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join()
    return [p.exitcode for p in procs]
