"""Device layouts (from ``repro.launch.mesh``).

``make_production_mesh`` names the reference's production mesh, 16 x 16
chips (``("data", "model")``) or 2 x 16 x 16 (``("pod", "data",
"model")``), as axis sizes and no devices.  Its one use is to fix how
much work one card does, one data-parallel replica's share of a cell
(``launch.dryrun``).

``make_host_mesh`` is the one-process mesh: a device alone on the data
axis.  ``make_process_mesh`` is a mesh of processes, one per rank and
device: axis names and sizes, this rank's coordinates, and one
``torch.distributed`` group per axis of more than one rank.  Ranks
follow ``jax.sharding.Mesh.devices.flat`` order (row-major: rank =
d·M + m on a (data, model) mesh).  The backend is chosen from the device
type and the card count before any collective (:func:`backend_for`):
NCCL when every rank has a card of its own, else gloo (host collectives;
every rank then shares card 0).  :func:`spawn` starts a mesh's processes
through a ``file://`` store and stops them all when one fails or waits
in a collective past ``COLLECTIVE_TIMEOUT_S``.  Nothing here
touches a device when the module is imported.
"""

from __future__ import annotations

import datetime
import itertools
import os
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import (reset_ambient_mesh,
                                           set_ambient_mesh)

# seconds a rank waits in one collective (its peers hung or gone) before
# the collective raises
COLLECTIVE_TIMEOUT_S = 300.0


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """Axis name -> size of the reference's production mesh (its
    ``jax.make_mesh(...).shape``), in its axis order."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


@dataclass(frozen=True)
class HostMesh:
    """An ordered device tuple with named axes; ``shape`` maps each axis
    to its size (``data_parallel_size`` reads it)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1}


def make_host_mesh(device: Union[str, torch.device] = "cuda") -> HostMesh:
    """The one-process mesh: ``device`` alone on the data axis, the model
    axis of size 1."""
    return HostMesh((resolve_device(device),))


def axis_names_for(shape: Sequence[int]) -> Tuple[str, ...]:
    """("data", "model"), or ("pod", "data", "model") for three axes."""
    if len(shape) == 2:
        return ("data", "model")
    if len(shape) == 3:
        return ("pod", "data", "model")
    raise ValueError(f"a mesh has 2 or 3 axes, not {tuple(shape)}")


def backend_for(device: Union[str, torch.device], world: int) -> str:
    """``nccl`` when the ranks are on cards and the host has one for each
    rank, else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


@dataclass
class ProcessMesh:
    """This process's place in a mesh of processes.

    ``shape`` maps axis name -> size in mesh order, ``coords`` this rank's
    index on each axis; ``group(axis)`` is the ``torch.distributed`` group
    of the ranks that differ from this one only along ``axis``.  ``with
    mesh:`` makes it the ambient mesh that the layers and the train step
    read (``parallel.sharding.ambient_mesh``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    backend: str
    device: torch.device
    _groups: Dict[str, object] = field(default_factory=dict, repr=False)
    _tokens: list = field(default_factory=list, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def coords(self) -> Dict[str, int]:
        out, stride = {}, 1
        for a, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[a] = (self.rank // stride) % n
            stride *= n
        return out

    def group(self, axis: str):
        return self._groups[axis]

    def __enter__(self) -> "ProcessMesh":
        self._tokens.append(set_ambient_mesh(self))
        return self

    def __exit__(self, *exc) -> None:
        reset_ambient_mesh(self._tokens.pop())


def _rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + c
    return r


def make_process_mesh(shape: Sequence[int], backend: str, *, rank: int,
                      init_method: str,
                      device: Union[str, torch.device] = "cuda"
                      ) -> ProcessMesh:
    """Join the process group of a ``shape`` mesh as ``rank`` and build
    every axis' group (each process builds all of them, in one order).
    Under NCCL rank r drives card r; under gloo every rank drives the
    same card (or the host).  Every collective times out after
    ``COLLECTIVE_TIMEOUT_S``."""
    import torch.distributed as dist
    sizes = tuple(int(n) for n in shape)
    names = axis_names_for(sizes)
    world = _rank_of([n - 1 for n in sizes], sizes) + 1
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else
                           (dev.index or 0))
        torch.cuda.set_device(dev)
    dev = resolve_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    mesh = ProcessMesh(names, sizes, rank, backend, dev)
    for i, axis in enumerate(names):
        if sizes[i] == 1:
            continue
        others = [range(n) if j != i else [0] for j, n in enumerate(sizes)]
        for fixed in itertools.product(*others):
            ranks = [_rank_of(fixed[:i] + (k,) + fixed[i + 1:], sizes)
                     for k in range(sizes[i])]
            g = dist.new_group(ranks)
            if rank in ranks:
                mesh._groups[axis] = g
    return mesh


# ---------------------------------------------------------------------------
# spawning a mesh of processes
# ---------------------------------------------------------------------------

def _worker(rank, shape, backend, init_method, device, fn, args, out_dir):
    import torch.distributed as dist
    status = os.path.join(out_dir, f"rank{rank}.status")
    try:
        mesh = make_process_mesh(shape, backend, rank=rank,
                                 init_method=init_method, device=device)
        with mesh:
            fn(mesh, *args)
        dist.barrier()
        dist.destroy_process_group()
        with open(status, "w") as f:
            f.write("ok")
    except BaseException:
        with open(status, "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, shape: Sequence[int], args: tuple = (), *,
          device: Union[str, torch.device] = "cuda",
          backend: Optional[str] = None,
          timeout_s: Optional[float] = None) -> str:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh, one
    spawned process each (``fn`` must be importable by name), joined
    through a ``file://`` store.  A rank that fails, or that a collective
    has waited on for ``COLLECTIVE_TIMEOUT_S``, stops the others and
    raises ``RuntimeError`` with its traceback; ``timeout_s``, when
    given, is a deadline on the whole run, past which the same happens.
    Returns the backend (chosen by ``backend_for`` unless given)."""
    import torch.multiprocessing as mp
    sizes = tuple(int(n) for n in shape)
    world = _rank_of([n - 1 for n in sizes], sizes) + 1
    backend = backend or backend_for(device, world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, args=(
            r, sizes, backend, init, str(device), fn, args, tmp))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        failed = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {codes[bad[0]]}"
                    break
                alive = [p for p in procs if p.exitcode is None]
                if not alive:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    failed = f"timed out after {timeout_s} s"
                    break
                alive[0].join(timeout=0.5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        if failed:
            notes = []
            for r in range(world):
                path = os.path.join(tmp, f"rank{r}.status")
                if os.path.exists(path):
                    with open(path) as f:
                        text = f.read()
                    if text != "ok":
                        notes.append(f"rank {r}:\n{text}")
            raise RuntimeError(f"mesh {sizes} over {backend}: {failed}\n"
                               + "\n".join(notes))
    return backend
