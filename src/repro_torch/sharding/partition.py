"""Serve-time tensor parallelism: the parameter rules and the gather.

PyTorch counterpart of the serving half of ``repro.sharding.partition``
(``_SERVE_RULES``, ``serve_pspecs`` + ``sanitize_pspecs``,
``gather_rep``).  Its training half (FSDP / TP ``param_pspecs``, the
activation constraints ``constrain`` / ``constrain_seq``) is not ported
(ROADMAP.md item 13b).

Serving TP is ALL-GATHER-ONLY.  Only column-parallel weights shard:
``wq wk wv bq bk bv w1 w3`` and the head's vocabulary columns, each on
its last (output) axis.  Every weight whose input axis would shard (``wo``,
``w2``, the embedding, the experts, the router, the shared experts, the
ssm mixers) replicates.  A product over a sharded weight gives each rank
exact full-precision columns; before anything contracts over those
columns they are all-gathered (``gather_rep``), which moves bytes and
never splits a float sum across ranks, so a sharded run reproduces the
unsharded one bit for bit wherever a column slice of a GEMM equals the
same columns of the full GEMM.  Where the attention heads divide the ranks
(``layers.heads_local``), no gather is needed before the attention at
all: each rank attends with its own query-head group against its own kv
heads (a head is a batch axis of the attention, never summed over), and
the (B, S, H·hd) output is gathered before ``wo``.  Elementwise work on
identically sharded operands (a bias add, RoPE, the gated MLP's
``act(g) * u``) is exact per element, so the MLP gathers once, after it.

The mesh handle travels explicitly: the runner holds a ``launch.mesh.TP`` and
every layer that gathers takes it as ``tp=`` (None: no mesh).
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.distributed as dist

# (path regex, ndim -> sharded axis of the trailing ndim axes); paths are
# the parameter tree's keys joined with "/" from a leading "/".  MoE
# experts / router / shared-expert stacks ("shared/w1", not the hybrid's
# "shared/attn" block) and every ssm mixer replicate: their contractions
# (the expert combine over E, the ssm recurrence) would cross ranks.
# Matched FIRST so that the column rules below cannot reach into them.
# The head's serving leaves are mu and sigma (the JAX head's q.mu, q.rho).
_SERVE_RULES: list[tuple[str, dict[int, int]]] = [
    (r"(experts_|router|shared/w|in_proj|out_proj|conv_|A_log|D$|dt_)", {}),
    (r"head.*(mu|rho|sigma|w)$", {2: 1}),           # vocab columns
    (r"(wq|wk|wv)$", {2: 1}),                       # head columns
    (r"(bq|bk|bv)$", {1: 0}),
    (r"(w1|w3)$", {2: 1}),                          # ff columns
    (r".*", {}),
]


def shardable(dim: int, m: int) -> bool:
    """True if ``dim`` divides evenly over ``m`` ranks (the JAX package's
    ``shardable``; its ``spec_if`` applies it axis by axis, and the port
    shards at most one axis of a leaf)."""
    return dim % m == 0 and dim >= m


def _serve_axis(path: str, ndim: int) -> Optional[int]:
    """The axis the serve rules shard for a leaf at ``path`` of ``ndim``
    dims (stacked layers add leading axes), before divisibility."""
    for pat, table in _SERVE_RULES:
        if re.search(pat, path):
            if ndim in table:
                return table[ndim]
            for nd, axis in table.items():
                if nd < ndim:
                    return axis + ndim - nd
            return None
    return None


def serve_dims(params: dict, m: int, path: str = "") -> dict:
    """The tree of ``params`` with each leaf replaced by the axis it
    shards on over ``m`` ranks, or None where it replicates: the serve
    rules, then the divisibility fallback (an axis whose size does not
    divide ``m`` replicates, as ``sanitize_pspecs`` does; e.g. mamba2's
    vocabulary 50280 at M 16)."""
    out = {}
    for k, v in params.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = serve_dims(v, m, p)
            continue
        axis = _serve_axis(p, v.dim())
        out[k] = axis if axis is not None and shardable(v.shape[axis], m) \
            else None
    return out


def shard_params(params: dict, rank: int, m: int,
                 dims: Optional[dict] = None) -> dict:
    """Rank ``rank``'s parameters: each sharded leaf's ``rank``-th of
    ``m`` equal slices along its axis (``dims``, default ``serve_dims``),
    as a tensor of its own, so the full leaf can be freed; every other
    leaf is the SAME tensor."""
    dims = serve_dims(params, m) if dims is None else dims
    out = {}
    for k, v in params.items():
        d = dims[k]
        if isinstance(v, dict):
            out[k] = shard_params(v, rank, m, d)
        elif d is None:
            out[k] = v
        else:
            n = v.shape[d] // m
            out[k] = v.narrow(d, rank * n, n).clone(
                memory_format=torch.contiguous_format)
    return out


def gather_rep(x: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    """All-gather ``x``'s rank slices along ``dim`` into the full tensor,
    identical on every rank: one ``all_gather`` into a buffer allocated
    for it, then a concatenation in rank order.  The identity without a
    group (``tp`` None or one rank).  A gloo group on a card stages the
    slices through host memory (gloo moves host buffers)."""
    if tp is None or tp.size == 1:
        return x
    staged = tp.backend == "gloo" and x.device.type == "cuda"
    src = x.contiguous()
    if staged:
        src = src.cpu()
    buf = src.new_empty((tp.size, *src.shape))
    dist.all_gather(list(buf.unbind(0)), src)
    out = torch.cat(buf.unbind(0), dim=dim)
    return out.to(x.device) if staged else out
