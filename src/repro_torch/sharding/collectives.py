"""The train mesh's collectives, as ``torch.autograd.Function``s.

Each takes the ``launch.mesh.Axis`` it runs over and is the identity on
an axis of one rank.  Every collective goes through ``_staged``: on a
gloo group a CUDA tensor is copied to host memory, reduced or gathered
there, and copied back (gloo moves host buffers), as
``sharding.partition.gather_rep`` does for serving.  A failed collective
raises; nothing falls back.

The Functions (Megatron-LM's tensor- and sequence-parallel regions, and
the FSDP parameter gather):

* ``copy``: identity forward, all-reduce of the gradient backward: the
  input of a column-parallel product, whose ranks each give a partial
  gradient of it;
* ``reduce``: all-reduce forward, identity backward: the partial sums of
  a row-parallel product (``wo``, ``w2``) or a vocabulary-parallel lookup;
* ``gather``: all-gather along ``dim`` forward; backward either a
  reduce-scatter (``grad="sum"``: the gathered tensor feeds parallel
  work, so each rank holds a partial gradient of all of it) or the
  rank's slice (``grad="split"``: it feeds work every rank repeats).  It
  enters a column-parallel product from the sequence-parallel stream
  (S), gathers column-sharded q / k / v where the heads do not divide
  the model axis, and gathers a weight over ``data`` (FSDP);
* ``reduce_scatter``: reduce-scatter along ``dim`` forward, all-gather
  backward: a row-parallel product back into the sequence-parallel
  stream;
* ``split``: the rank's slice forward, all-gather backward.

A reduce-scatter is an all-reduce and the rank's slice (gloo has no
reduce-scatter in every PyTorch the port meets), so it moves an
all-reduce's bytes.  Sums of bf16 tensors run in float32.

Every collective tells the ``OBSERVERS`` (a dry run's
``launch.op_cost.OpCost``) its kind and its bytes in and out
(``observe``); with none, that costs a test of an empty list.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# objects with a ``collective(kind, operand_bytes, result_bytes)`` method,
# told of every collective the port issues
OBSERVERS: list = []


def observe(kind: str, operand: int, result: int) -> None:
    """Tell the ``OBSERVERS`` of one collective: its kind (an HLO name:
    "all-reduce", "all-gather", ...) and its bytes in and out on this
    rank."""
    for o in OBSERVERS:
        o.collective(kind, operand, result)


def _staged(axis, x: torch.Tensor, fn, kind: str, in_place: bool = True):
    """``fn(buffer)`` on a contiguous copy of ``x`` (in host memory where
    ``axis.staged`` and ``x`` is on a card); returns the buffer on
    ``x``'s device.  ``fn`` runs the collective ``kind`` in place
    (``in_place``: the buffer is then never ``x`` itself) or returns a
    new tensor."""
    nbytes = x.numel() * x.element_size()
    if axis.traffic is not None:
        axis.traffic[axis.name] += nbytes
    if OBSERVERS:
        observe(kind, nbytes,
                nbytes * axis.size if kind == "all-gather" else nbytes)
    staged = axis.staged and x.device.type == "cuda"
    if staged:
        buf = x.detach().to("cpu", copy=True)
    else:
        buf = x.detach().contiguous()
        if in_place and x.is_contiguous():      # buf is x's memory
            buf = buf.clone()
    out = fn(buf)
    out = buf if out is None else out
    return out.to(x.device) if staged else out


def all_reduce(x: torch.Tensor, axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or ``op``) over ``axis``, a new tensor, identical on
    every rank; ``x`` itself when the axis has one rank.  A bf16 / fp16
    tensor is reduced in float32 and rounded to its dtype once (a
    row-parallel product's partial sums then round as the whole product
    does, up to the order of an f32 sum)."""
    if axis.size == 1:
        return x
    low = x.dtype in (torch.bfloat16, torch.float16)
    out = _staged(axis, x.float() if low else x,
                  lambda b: dist.all_reduce(b, op=op, group=axis.group),
                  "all-reduce")
    return out.to(x.dtype) if low else out


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if axis.size == 1:
        return x

    def run(b):
        parts = [torch.empty_like(b) for _ in range(axis.size)]
        dist.all_gather(parts, b, group=axis.group)
        return torch.cat(parts, dim=dim)

    return _staged(axis, x, run, "all-gather", in_place=False)


def chunk(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The rank's equal slice of ``x`` along ``dim`` (a view)."""
    if axis.size == 1:
        return x
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


def reduce_scatter_(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The rank's slice along ``dim`` of ``x`` summed over ``axis``."""
    if axis.size == 1:
        return x
    return chunk(all_reduce(x, axis), axis, dim).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, grad):
        ctx.axis, ctx.dim, ctx.grad = axis, dim, grad
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            return reduce_scatter_(g, ctx.axis, ctx.dim), None, None, None
        return chunk(g, ctx.axis, ctx.dim).contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return reduce_scatter_(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.axis, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return chunk(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.axis, ctx.dim), None, None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


def copy(x: torch.Tensor, axis) -> torch.Tensor:
    return x if axis.size == 1 else _Copy.apply(x, axis)


def reduce(x: torch.Tensor, axis) -> torch.Tensor:
    return x if axis.size == 1 else _Reduce.apply(x, axis)


def gather(x: torch.Tensor, axis, dim: int, grad: str = "sum"):
    if grad not in ("sum", "split"):
        raise ValueError(f"grad is 'sum' or 'split', got {grad!r}")
    return x if axis.size == 1 else _Gather.apply(x, axis, _dim(x, dim),
                                                  grad)


def reduce_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceScatter.apply(x, axis,
                                                         _dim(x, dim))


def split(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    return x if axis.size == 1 else _Split.apply(x, axis, _dim(x, dim))
