"""Parameter partition rules: the serving half and the training half.

PyTorch counterpart of ``repro.sharding.partition``: the serve rules
(``_SERVE_RULES``, ``serve_pspecs`` + ``sanitize_pspecs``, ``gather_rep``)
below, and the train rules after them (``_RULES``, ``param_pspecs``,
``sanitize_pspecs``, ``state_pspecs``; see "Training" further down).  The
JAX package's activation constraints (``constrain`` / ``constrain_seq``)
become the explicit collectives of ``sharding.collectives`` at the
models' training seams.

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

import math
import re
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import collectives as C

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
    if C.OBSERVERS:
        n = src.numel() * src.element_size()
        C.observe("all-gather", n, n * tp.size)
    if staged:
        src = src.cpu()
    buf = src.new_empty((tp.size, *src.shape))
    dist.all_gather(list(buf.unbind(0)), src)
    out = torch.cat(buf.unbind(0), dim=dim)
    return out.to(x.device) if staged else out


# ---------------------------------------------------------------------------
# Training: FSDP / TP parameter rules over the D x M train mesh
# ---------------------------------------------------------------------------
#
# A spec is a tuple with one entry per axis of the leaf: None (the axis
# is whole on every rank), a mesh axis name, or a tuple of names (the
# axis splits over their product, the first name major: ("data",
# "model") gives rank (d, m) block d·M + m), as a JAX PartitionSpec
# reads.  The rules are the JAX package's, name for name: column-parallel
# ``wq wk wv w1 w3`` and row-parallel ``wo w2`` on ``model``, their other
# axis FSDP-sharded on ``data`` where the config asks (``fsdp_params``);
# the embedding's vocabulary on ``model`` and its width on ``data``
# (FSDP); the head's vocabulary on both axes whatever ``fsdp`` says;
# norms replicated.  Stacked layers add a leading axis that never shards.

_RULES: list[tuple[str, dict[int, tuple]]] = [
    (r"embed.*table$", {2: ("model", "data")}),
    (r"head.*(mu|rho|w)$", {2: (None, ("data", "model"))}),
    (r"(wq|wk|wv)$", {2: ("data", "model")}),
    (r"wo$", {2: ("model", "data")}),
    (r"(bq|bk|bv)$", {1: ("model",)}),
    (r"(w1|w3)$", {2: ("data", "model")}),
    (r"w2$", {2: ("model", "data")}),
    (r"experts_ep.*(w1|w3)$", {3: ("model", None, "data")}),
    (r"experts_ep.*w2$", {3: ("model", "data", None)}),
    (r"experts_tp.*(w1|w3)$", {3: (None, None, ("data", "model"))}),
    (r"experts_tp.*w2$", {3: (None, ("data", "model"), None)}),
    (r"router.*w$", {2: (None, None)}),
    (r"in_proj$", {2: ("data", "model")}),
    (r"out_proj$", {2: ("model", "data")}),
    (r"(conv_w|conv_b|A_log|D|dt_bias)$", {1: ("model",), 2: (None, "model")}),
    (r".*", {}),
]


def _spec_for(path: str, ndim: int, fsdp: bool) -> tuple:
    """The rules' spec of a leaf at ``path`` with ``ndim`` axes (padded
    with None to ``ndim``): the JAX ``_spec_for`` on a (data, model)
    mesh."""
    for pat, table in _RULES:
        if re.search(pat, path):
            dims = table.get(ndim)
            if dims is None:
                for nd, d in table.items():
                    if nd < ndim:
                        dims = (None,) * (ndim - nd) + d
                        break
            if dims is None:
                return (None,) * ndim
            if not fsdp:
                dims = tuple(None if d == "data" else d for d in dims)
            return dims
    return (None,) * ndim


def param_pspecs(params: dict, fsdp: bool = True, path: str = "") -> dict:
    """The spec tree of ``params`` by the train rules, before
    divisibility (``sanitize_pspecs``)."""
    return {k: param_pspecs(v, fsdp, f"{path}/{k}")
            if isinstance(v, dict)
            else _spec_for(f"{path}/{k}", v.dim(), fsdp)
            for k, v in params.items()}


def _names(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name, or names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: tuple) -> set:
    """The mesh axes a leaf of ``spec`` is split over; it is replicated
    over every other axis."""
    return {a for e in spec for a in _names(e)}


def sanitize_pspecs(specs: dict, params: dict, shape: dict) -> dict:
    """``specs`` with every entry whose axes' product does not divide the
    leaf's size dropped to None (replicated), as the JAX
    ``sanitize_pspecs`` does; ``shape`` maps mesh axis names to sizes."""
    out = {}
    for k, spec in specs.items():
        if isinstance(spec, dict):
            out[k] = sanitize_pspecs(spec, params[k], shape)
            continue
        fixed = []
        for size, entry in zip(params[k].shape, spec):
            n = math.prod(shape[a] for a in _names(entry))
            fixed.append(entry if entry is not None and size % n == 0
                         else None)
        out[k] = tuple(fixed)
    return out


def train_dims(cfg, params: dict, shape: tuple) -> dict:
    """The spec tree ``params`` (whole leaves, or tensors of their shape)
    take on a D x M mesh (``shape``): the rules with the config's FSDP
    choice, sanitized."""
    d, m = shape
    return sanitize_pspecs(param_pspecs(params, fsdp=cfg.fsdp_params),
                           params, {"data": d, "model": m})


def state_pspecs(dims: dict, opt: dict) -> dict:
    """The spec tree of a training state ``{"params", "opt"}`` from its
    parameters' (``train_dims``): the AdamW moments and the compression
    error placed like their parameters (ZeRO: the FSDP axis shards them
    too), the step replicated (the JAX ``steps.state_pspecs``)."""
    out_opt = {"mu": dims, "nu": dims, "step": ()}
    if "error" in opt:
        out_opt["error"] = dims
    return {"params": dims, "opt": out_opt}


def _block(spec: tuple, mesh, coord: Optional[dict] = None) -> list:
    """(axis, block index, blocks) of every sharded axis of a leaf of
    ``spec`` on the rank of ``mesh`` at ``coord`` (axis name -> index;
    default this rank)."""
    out = []
    for axis, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        idx, n = 0, 1
        for a in names:
            ax = mesh.axis(a)
            at = ax.index if coord is None else coord[a]
            idx, n = idx * ax.size + at, n * ax.size
        out.append((axis, idx, n))
    return out


def shard_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``spec``, a tensor
    of its own (so that the whole leaf can be freed), or ``x`` itself
    where the spec replicates it."""
    blocks = _block(spec, mesh)
    if not blocks:
        return x
    for axis, idx, n in blocks:
        w = x.shape[axis] // n
        x = x.narrow(axis, idx * w, w)
    return x.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: dict, dims: dict, mesh) -> dict:
    """``shard_leaf`` over a tree (``dims`` of the same structure; a leaf
    whose spec is ``()`` replicates)."""
    return {k: shard_tree(v, dims[k], mesh) if isinstance(v, dict)
            else shard_leaf(v, dims[k], mesh) for k, v in tree.items()}


def shard_state(state: dict, dims: dict, mesh) -> dict:
    """This rank's share of a whole training state ``{"params", "opt"}``
    under ``state_pspecs``."""
    return shard_tree(state, state_pspecs(dims, state["opt"]), mesh)


def gather_leaf(x: torch.Tensor, spec: tuple, mesh,
                host: bool = False) -> torch.Tensor:
    """The whole leaf from every rank's block ``x`` under ``spec`` (one
    all-gather over the mesh), on every rank: on ``x``'s device, or in
    host memory with ``host``.  A replicated leaf comes back as it is (a
    host copy with ``host``)."""
    if not _block(spec, mesh):
        return x.detach().to("cpu", copy=True) if host else x
    src = x.detach()
    if host and mesh.backend == "gloo":
        src = src.cpu()
    parts = C.all_gather(src.unsqueeze(0), mesh.world, 0)
    if host:
        parts = parts.cpu()
    full = parts.new_empty(full_shape(x, spec, mesh))
    m = mesh.shape[1]
    for r in range(mesh.world.size):
        view = full
        for axis, idx, n in _block(spec, mesh, {"data": r // m,
                                                "model": r % m}):
            w = full.shape[axis] // n
            view = view.narrow(axis, idx * w, w)
        view.copy_(parts[r])
    return full


def full_shape(x: torch.Tensor, spec: tuple, mesh) -> tuple:
    """The whole leaf's shape from a rank's block ``x`` of it."""
    shape = list(x.shape)
    for axis, _, n in _block(spec, mesh):
        shape[axis] *= n
    return tuple(shape)


def owned(dims: dict, mesh) -> dict:
    """For each leaf, whether this rank counts it in a sum over the mesh
    (a global norm, a KL): True on exactly one rank of every group of
    ranks holding the same block, the one at index 0 of each axis the
    leaf is replicated over."""
    def one(spec):
        used = spec_axes(spec)
        return all(mesh.axis(a).index == 0 for a in ("data", "model")
                   if a not in used)

    return {k: owned(v, mesh) if isinstance(v, dict) else one(v)
            for k, v in dims.items()}
