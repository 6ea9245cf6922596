"""The serving and training meshes: one process per rank.

PyTorch counterpart of ``repro.launch.mesh``.  The JAX package builds a
``jax.sharding.Mesh`` over the devices of one process and lets GSPMD
place the work; here every rank is a process of its own in a
``torch.distributed`` group and runs the same program on its own slices
(SPMD).  A ``--mesh DxM`` flag names the shape.  Serving puts nothing on
``data`` (the JAX serve rules shard only ``model``), so there D must be 1
(``parse_mesh``): D > 1 ranks would each repeat the whole computation.
Training takes any D x M (``parse_train_mesh``, ``train_mesh``): rank r
sits at (data r // M, model r % M), the row-major layout of
``jax.make_mesh((D, M), ("data", "model"))``, with one process group per
line of each axis.

Backends, chosen by the devices the machine has:

* NCCL, rank r on ``cuda:r``, when the machine has at least M cards;
* gloo otherwise, every rank on the device it was given (``cpu``, or the
  one card, which the ranks then share, with every collective staged
  through host memory: ``sharding.partition.gather_rep``).

A process joins the group in one of two ways: under ``torchrun``
(``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` set) it joins from the
environment; otherwise ``Ranks`` spawns the M ranks with
``torch.multiprocessing`` and a ``file://`` rendezvous in a temporary
directory, so no network is needed.  ``Ranks`` keeps them up between
calls: every call sends one function and its arguments to all ranks and
returns each rank's result.

Importing this module starts nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Optional

import torch
import torch.distributed as dist

# seconds a collective may wait for its peers before it raises (ranks that
# left the same schedule would otherwise wait forever)
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class TP:
    """One rank's handle on the tensor-parallel group (the process's
    default group): what the runner holds and the model layers receive
    (``layers.apply_attention(..., tp=)``).  ``local_heads``: whether
    attention runs on the rank's own heads where the ranks divide them
    (``layers.heads_local``); False gathers q, k and v and attends every
    head on every rank (the escalation lane's runner)."""
    rank: int
    size: int
    backend: str                 # "nccl" | "gloo"
    device: torch.device
    local_heads: bool = True

    @property
    def graphs(self) -> bool:
        """Whether the decode chunk can be a CUDA graph: NCCL collectives
        capture, gloo's (host-staged) cannot."""
        return self.device.type == "cuda" and self.backend == "nccl"

    def broadcast_floats(self, values) -> list[float]:
        """Rank 0's ``values`` on every rank: ONE float64 broadcast, on the
        host for gloo (on a card too: gloo moves host buffers) and on the
        rank's card for NCCL, outside any graph.  Every rank passes as
        many values.  A no-op on one rank (no group)."""
        values = [float(v) for v in values]
        if self.size == 1 or not values:
            return values
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        t = torch.tensor(values, dtype=torch.float64, device=dev)
        dist.broadcast(t, src=0)
        return t.tolist()

    def describe(self) -> str:
        """``result["mesh"]``: ranks, backend, devices (and, on a card,
        whether the chunk is a graph)."""
        if self.device.type != "cuda":
            where = str(self.device)
        elif self.backend == "nccl":
            where = f"cuda:0-{self.size - 1}"
        else:
            where = f"{self.device} shared"
        graphs = "" if self.device.type != "cuda" else \
            f", graphs {'on' if self.graphs else 'off'}"
        return f"{self.size} ranks, {self.backend}, {where}{graphs}"


def parse_mesh(spec: Optional[str]) -> Optional[int]:
    """The model-axis size M of a serving ``--mesh DxM`` flag ("1x4" ->
    4); None,
    "" and "none" mean no mesh.  D > 1 raises: serving shards nothing
    over ``data``, so those ranks would only repeat the model ranks'
    work."""
    if not spec or spec == "none":
        return None
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                  for p in parts):
        raise ValueError(f"--mesh wants DxM (e.g. 1x4), got {spec!r}")
    d, m = int(parts[0]), int(parts[1])
    if d != 1:
        raise ValueError(
            f"--mesh {spec}: serving shards only the model axis (D must be "
            "1); data-parallel ranks would each repeat the whole model's "
            "work (data parallelism is training's: launch.train --mesh "
            "DxM)")
    return m


def backend_for(device, m: int) -> tuple[str, torch.device]:
    """(backend, rank 0's device) of an M-rank group asked on ``device``:
    NCCL over cards 0..M-1 when the machine has M cards, else gloo on the
    device itself (shared by every rank)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= m > 1:
        return "nccl", torch.device("cuda", 0)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return "gloo", dev


def join(m: int, device, *, rank: Optional[int] = None,
         init_method: Optional[str] = None,
         timeout_s: int = TIMEOUT_S) -> TP:
    """Join (or form) the M-rank group and return this rank's ``TP``.
    Without ``rank`` / ``init_method`` the group comes from the
    environment (``torchrun``); a process already in a group reuses it."""
    backend, dev = backend_for(device, m)
    if not dist.is_initialized():
        if rank is None:
            if "RANK" not in os.environ:
                raise RuntimeError(
                    f"a {m}-rank mesh needs {m} rank processes: launch with "
                    "torchrun, or spawn them (mesh.Ranks / mesh.spawn)")
            rank = int(os.environ["RANK"])
            init_method = "env://"
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=m,
            timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_world_size() != m:
        raise ValueError(f"--mesh asks {m} ranks, the group has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    return TP(rank=rank, size=m, backend=backend, device=dev)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the train mesh as a rank sees it: its ``size``, the
    rank's ``index`` along it, and the process group of the rank's line
    along it (None where the axis has one rank, where every collective is
    the identity).  ``staged``: a gloo group on a card, whose collectives
    go through host memory (``sharding.collectives``)."""
    name: str
    size: int
    index: int
    group: object = None
    staged: bool = False
    # bytes this rank has put into the axis' collectives, by axis name
    # (the mesh's ``traffic``; None: not counted)
    traffic: Optional[dict] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """One rank's handle on a D x M train mesh (``train_mesh``): its
    ``data`` and ``model`` axes, and ``world``, every rank of the mesh
    (index = the rank).  ``traffic`` counts the bytes this rank puts into
    each axis' collectives (an all-reduce's tensor, an all-gather's
    slice); the caller may zero it."""
    shape: tuple
    backend: str
    device: torch.device
    data: Axis
    model: Axis
    world: Axis
    traffic: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def rank(self) -> int:
        return self.world.index

    def axis(self, name: str) -> Axis:
        return {"data": self.data, "model": self.model}[name]

    def describe(self) -> str:
        d, m = self.shape
        where = str(self.device) if self.device.type != "cuda" or \
            self.backend == "nccl" else f"{self.device} shared"
        return f"{d}x{m} (data x model), {d * m} ranks, {self.backend}, " \
            f"{where}"


def parse_train_mesh(spec: Optional[str]) -> Optional[tuple[int, int]]:
    """(D, M) of a training ``--mesh DxM`` flag ("2x2" -> (2, 2)); None,
    "", "none" and a 1x1 mesh mean no mesh.  Unlike serving, D > 1 is
    data parallelism (and FSDP where the config asks for it)."""
    if not spec or spec == "none":
        return None
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                  for p in parts):
        raise ValueError(f"--mesh wants DxM (e.g. 2x2), got {spec!r}")
    d, m = int(parts[0]), int(parts[1])
    return None if d * m == 1 else (d, m)


def default_train_mesh(device) -> Optional[tuple[int, int]]:
    """The JAX launcher's ``make_mesh_for_args``: 2 x 2 where the job has
    exactly four ranks (``torchrun``'s ``WORLD_SIZE``) or the machine
    four cards, else no mesh."""
    if "WORLD_SIZE" in os.environ:
        return (2, 2) if int(os.environ["WORLD_SIZE"]) == 4 else None
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available() \
            and torch.cuda.device_count() == 4:
        return (2, 2)
    return None


# (default group, D, M) -> the process's (world, data, model) groups: a
# group lives as long as the process's default group, and creating one is
# collective, so each shape's groups are created once per default group
# and kept (a dry run's fake group drops its own, ``drop_train_meshes``)
_TRAIN_MESHES: dict = {}


def drop_train_meshes() -> None:
    """Forget the train meshes of the current default group (before it is
    destroyed)."""
    world = dist.group.WORLD
    for key in [k for k in _TRAIN_MESHES if k[0] is world]:
        del _TRAIN_MESHES[key]


def train_mesh(tp: TP, d: int, m: int) -> Optional[TrainMesh]:
    """This rank's handle on the D x M train mesh over ranks 0..D·M-1 of
    its group (``tp``, from ``join`` or ``Ranks``), or None for a rank
    past the mesh.  Every rank of the group must call it with the same
    shape, in the same order: it creates the mesh's process groups
    (``dist.new_group``, collective), once per shape."""
    n = d * m
    if n > tp.size:
        raise ValueError(f"a {d}x{m} mesh needs {n} ranks, the group has "
                         f"{tp.size}")
    key = (dist.group.WORLD, d, m)
    if key not in _TRAIN_MESHES:
        def group(ranks):
            # every rank takes part in every group's creation
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            return g if tp.rank in ranks else None

        world = group(list(range(n)))
        data = [group([i * m + j for i in range(d)]) for j in range(m)]
        model = [group([i * m + j for j in range(m)]) for i in range(d)]
        _TRAIN_MESHES[key] = (world, data, model)
    if tp.rank >= n:
        return None
    world, data, model = _TRAIN_MESHES[key]
    i, j = divmod(tp.rank, m)
    staged = tp.backend == "gloo" and tp.device.type == "cuda"
    traffic = dict.fromkeys(("data", "model", "world"), 0)
    return TrainMesh(
        shape=(d, m), backend=tp.backend, device=tp.device,
        data=Axis("data", d, i, data[j], staged, traffic),
        model=Axis("model", m, j, model[i], staged, traffic),
        world=Axis("world", n, tp.rank, world, staged, traffic),
        traffic=traffic)


def in_group() -> bool:
    """Whether this process is already a rank (a group exists, or
    ``torchrun`` set the environment)."""
    return dist.is_initialized() or "RANK" in os.environ


def _rank_main(rank: int, m: int, device: str, init: str, timeout_s: int,
               tasks, results) -> None:
    """A spawned rank: join the group, then run each task ``(fn, args,
    kwargs)`` from ``tasks`` as ``fn(tp, *args, **kwargs)`` and put
    ``(rank, ok, value or traceback)`` on ``results``, until a None
    task."""
    import repro_torch  # noqa: F401  (pins the precision flags)
    # the ranks share the host's cores; one thread each also keeps a CPU
    # GEMM's blocking that of a one-thread unsharded reference
    torch.set_num_threads(1)
    tp = join(m, device, rank=rank, init_method=init, timeout_s=timeout_s)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(tp, *args, **kwargs)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    """M spawned rank processes, kept up between calls.

        with Ranks(2, "cuda") as ranks:   # or "cpu"
            out = ranks.run(fn, a, b=2)   # fn(tp, a, b=2) on every rank

    ``device`` is what the ranks are asked on (``backend_for``); it has
    no default.  ``run`` returns the ranks' results in rank order (rank
    0's first) and raises ``RuntimeError`` with the tracebacks if any
    rank raised or died.  ``fn`` and its arguments and results cross processes by
    pickle: ``fn`` must be importable by name."""

    def __init__(self, m: int, device, timeout_s: int = TIMEOUT_S):
        import torch.multiprocessing as mp

        self.m = m
        self.timeout_s = timeout_s
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="repro_mesh_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._tasks = [ctx.Queue() for _ in range(m)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, m, str(device), init, timeout_s, self._tasks[r],
                  self._results)) for r in range(m)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        for q in self._tasks:
            q.put((fn, args, kwargs))
        got: dict[int, tuple[bool, object]] = {}
        while len(got) < self.m:
            try:
                rank, ok, value = self._results.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in got]
                if dead:
                    self.close()
                    raise RuntimeError(f"rank(s) {dead} died") from None
                if any(not ok for ok, _ in got.values()):
                    # a rank raised; the others wait in a collective until
                    # the timeout: do not wait for them
                    break
                continue
            got[rank] = (ok, value)
        errors = {r: v for r, (ok, v) in got.items() if not ok}
        if errors or len(got) < self.m:
            self.close()
            raise RuntimeError("a rank failed:\n" + "\n".join(
                f"rank {r}:\n{v}" for r, v in sorted(errors.items())))
        return [got[r][1] for r in range(self.m)]

    def close(self) -> None:
        """Stop the ranks (each leaves the group), killing any that does
        not stop within a few seconds, and remove the rendezvous file."""
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn(m: int, device, fn, *args, **kwargs) -> list:
    """``fn(tp, *args, **kwargs)`` on M freshly spawned ranks; the ranks'
    results in rank order."""
    with Ranks(m, device) as ranks:
        return ranks.run(fn, *args, **kwargs)
