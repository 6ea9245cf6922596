"""Model dispatch for the port (dense, vlm, moe, ssm, hybrid and encdec
families) and the weight bridge.

PyTorch counterpart of ``repro.models.registry``'s family table (the
config-less ``audio`` family maps to encdec, as there).  The uniform
serving API:

    init_params(cfg, generator, device) -> params
    params_from_numpy(tree, cfg, device) -> params
    make_cache(cfg, batch, max_len, device=..., layout=...,
               kv_shards=1) -> cache
    prefill(params, cfg, tokens, max_len, modality=None, tp=None)
        -> (hidden, cache)
    prefill_chunk(params, cfg, tokens, cache, slot, offset, new_len, span,
                  tp=None, **family_kw)
    decode_step(params, cfg, token, cache, key, head_noise=None, tp=None)
    decode_hidden(params, cfg, token, cache, tp=None) -> (hidden, cache)
    head_outputs(params, cfg, hidden, cache_len, key, num_samples=None,
                 head_noise=None, tp=None)
    prefill_suffix(params, cfg, tokens, prefix_kv, prefix_len, tp=None)
    write_slot(cfg, cache, slot, sub, block_row=None, offset=0)
    copy_block(cfg, cache, src, dst)

and, for training (every family):

    init_train_params(cfg, generator, device) -> params (head {mu, rho})
    train_params_from_numpy(tree, cfg, device) -> params
    serving_params(train_params) -> params the engine serves
    nll_loss(params, cfg, batch, key, noise=None, mesh=None, dims=None)
        -> (loss, aux)
    check_trains_sharded(cfg, dims, mesh), model_partial(cfg, dims,
        mesh, S)  (under a D x M train mesh: every family)

Caches are slot-indexed and updated in place: every leaf carries the
slot axis at position 1 ((L, B, ...) KV strips, SSM states, conv tails)
except ``len`` (B,).  The ssm family's cache is recurrent state only
(``RECURRENT_LEAVES``), so it has no paged layout, no prompt padding and
no chunked prefill: the engine serves it dense, with batch prefill at
the exact prompt length.  The hybrid family pages the KV planes of its
shared attention (``attn_k``, ``attn_v``) and keeps its recurrent state
per slot; its prompts keep their exact length too.  The encdec family
pages its decoder's self-attention KV and keeps the cross-attention
memory (``ck``, ``cv``) a dense strip a slot; its modality input is the
encoder's frames.  The vlm family is the dense transformer whose
modality input, its prefix embeds, replaces the first prompt positions
at batch prefill; it has no chunked prefill, as in the reference.  Paged
KV pools carry one trailing sink block that no table maps
(``layers.paged_index``); ``kv_bytes`` leaves it out.

``tp`` is a tensor-parallel rank's mesh handle (``launch.mesh.TP``; None
unsharded), passed through to the layers with the rank's parameters
(``sharding.partition.shard_params``).  Its cache holds the rank's kv
heads of every ``KV_HEAD_LEAVES`` leaf where the ranks divide the heads
(``make_cache(kv_shards=M)``); lens, tables and recurrent states
replicate, and the slot writes, copy-on-write and suffix prefill act on
the rank's own pool.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, hybrid, moe, ssm, transformer
from repro_torch.models import layers as L
from repro_torch.models import uncertain_head as U
from repro_torch.models.layers import paged_index, paged_table_width  # noqa: F401

# cache leaves that live in the global block pool under the paged layout
PAGED_KV_LEAVES = ("k", "v", "attn_k", "attn_v")

# cache leaves with a kv-head axis (at -2): the self-attention strips or
# pools, the hybrid family's attention planes, the encdec cross strips;
# the only leaves a serving mesh shards
KV_HEAD_LEAVES = ("k", "v", "attn_k", "attn_v", "ck", "cv")

# per-slot recurrent state leaves (ssm, hybrid): written whole at admission,
# and rewound to the accepted step after a speculative round
# (``steps.build_spec_commit``)
RECURRENT_LEAVES = ("ssm", "conv")

_FAMILIES = {"dense": transformer, "vlm": transformer, "audio": encdec,
             "encdec": encdec, "moe": moe, "ssm": ssm, "hybrid": hybrid}


def module_for(cfg: ArchConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def init_params(cfg: ArchConfig, generator: torch.Generator, device):
    return module_for(cfg).init_params(cfg, generator, device)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # numpy's bf16 extension type
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: dict, cfg: ArchConfig, device) -> dict:
    """The port's parameters from the JAX parameter tree given as nested
    dicts of numpy arrays (``blocks`` stacked on a leading layer axis, the
    head as ``{"q": {"mu", "rho"}}``; the moe router and the ssm
    ``A_log``, ``D`` and ``dt_bias`` in f32 beside the parameter-dtype
    leaves; the hybrid family's ``shared`` block and the encdec family's
    ``encoder``, ``decoder`` and ``enc_norm`` as they come).  Every
    leaf keeps its dtype.  The head's sigma = softplus(rho) is computed
    here, once."""
    module_for(cfg)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, device)

    out = {k: walk(v) for k, v in tree.items() if k != "head"}
    q = tree["head"]["q"]
    out["head"] = {"mu": _tensor(q["mu"], device, torch.float32),
                   "sigma": F.softplus(_tensor(q["rho"], device,
                                               torch.float32))}
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def _check_trains(cfg: ArchConfig) -> None:
    """Every family trains (``TRAIN_FAMILIES``, and "audio" as encdec);
    an unknown family raises ValueError."""
    module_for(cfg)


def init_train_params(cfg: ArchConfig, generator: torch.Generator, device):
    """Random TRAINING parameters: ``init_params``' draws with the head in
    its training form ``{"mu", "rho"}``, both float32."""
    _check_trains(cfg)
    return module_for(cfg).init_params(cfg, generator, device, train=True)


def train_params_from_numpy(tree: dict, cfg: ArchConfig, device) -> dict:
    """``params_from_numpy`` with the head kept in its training form: the
    JAX head's ``{"q": {"mu", "rho"}}`` becomes ``{"mu", "rho"}``, float32;
    every other leaf keeps its dtype."""
    _check_trains(cfg)
    out = params_from_numpy(tree, cfg, device)
    q = tree["head"]["q"]
    out["head"] = {"mu": out["head"]["mu"],
                   "rho": _tensor(q["rho"], device, torch.float32)}
    return out


def serving_params(train_params: dict) -> dict:
    """The tree the serving engine takes, from training parameters: the
    head's sigma = softplus(rho) computed once; every other leaf the SAME
    tensor (a trained state serves without a copy of its body)."""
    return {k: L.serving_head(v) if k == "head" else v
            for k, v in train_params.items()}


# the families whose sharded step keeps the stream whole over ``model``
# (the JAX ssm, hybrid and encdec forwards have no ``constrain_seq``)
NO_SEQ_PARALLEL = ("ssm", "hybrid", "encdec")


def check_trains_sharded(cfg: ArchConfig, dims=None, mesh=None) -> None:
    """Raise ValueError for an unknown family, NotImplementedError for
    ``seq_parallel`` in a family without the S-sharded stream
    (``NO_SEQ_PARALLEL``), and, given the parameters' specs ``dims`` on
    ``mesh``, NotImplementedError where they leave whole a leaf that the
    family's sharded step splits (a width the mesh does not divide: the
    family's ``check_sharded``)."""
    _check_trains(cfg)
    if cfg.seq_parallel and cfg.family in NO_SEQ_PARALLEL:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's sharded step has no "
            "sequence-parallel stream; train it with seq_parallel=False")
    if dims is not None:
        module_for(cfg).check_sharded(cfg, dims, mesh)


def model_partial(cfg: ArchConfig, dims: dict, mesh, S: int) -> dict:
    """For each leaf, whether a model rank's gradient of it, at sequence
    length S, is only its share, to be summed over ``model``: the
    family's rule (``transformer.model_partial``)."""
    return module_for(cfg).model_partial(cfg, dims, mesh, S)


def nll_loss(params, cfg: ArchConfig, batch: dict, key, noise=None,
             mesh=None, dims=None):
    """The family's mean next-token NLL with one weight-space draw of the
    head (``transformer.head_loss``): ``(nll, {"accuracy"})``; the moe
    family adds 0.01 x its Switch aux loss to the first value and
    reports it as ``"aux_loss"``.  The batch carries ``tokens`` and
    ``labels``, plus ``frames`` (encdec) or ``prefix_embeds`` (vlm).
    Under a train ``mesh`` (with the parameters' specs ``dims``) every
    family runs on the rank's shards and returns this data rank's share
    (``transformer.nll_loss``, ``moe.nll_loss``, ...)."""
    _check_trains(cfg)
    return module_for(cfg).nll_loss(params, cfg, batch, key, noise=noise,
                                    mesh=mesh, dims=dims)


def supports_paged(cfg: ArchConfig) -> bool:
    """Every attention-bearing family pages its self-attention KV."""
    return cfg.family != "ssm"


def supports_prompt_padding(cfg: ArchConfig) -> bool:
    """Attention-only prompt state is positional, so junk pad tokens past
    the prompt are causally invisible: prompts bucket to kv_block
    multiples."""
    return cfg.family in ("dense", "vlm", "moe", "encdec", "audio")


def supports_chunked_prefill(cfg: ArchConfig) -> bool:
    return supports_paged(cfg) and cfg.family in ("dense", "moe", "hybrid",
                                                  "encdec")


def supports_prefix_cache(cfg: ArchConfig) -> bool:
    """Whether prompt KV can be shared across requests by token prefix:
    only where per-position prompt state is a pure function of the token
    prefix.  vlm and encdec mix modality inputs into the cache, ssm and
    hybrid carry recurrent state that a KV-block prefix cannot rebuild,
    and moe couples tokens through the expert-capacity cumsum (a
    suffix-only prefill sees another contention set).  That leaves the
    dense family."""
    return cfg.family == "dense"


def supports_spec_decode(cfg: ArchConfig) -> bool:
    """Every family has the ``decode_hidden`` / ``head_outputs`` split, so
    every family speculates.  Losslessness rests on per-slot decode state
    being independent across slots given the fed tokens; the one
    cross-slot coupling is moe's capacity cumsum, which bites only when an
    expert overflows during a one-token decode dispatch."""
    return True


def prefill_suffix(params, cfg: ArchConfig, tokens, prefix_kv: dict,
                   prefix_len: int, tp=None):
    """Prefill only the uncached suffix of a prefix-cache hit
    (``transformer.prefill_suffix``); ``supports_prefix_cache`` gates it."""
    if not supports_prefix_cache(cfg):
        raise ValueError(f"family {cfg.family!r} cannot prefix-share "
                         "prompt KV")
    return module_for(cfg).prefill_suffix(params, cfg, tokens, prefix_kv,
                                          prefix_len, tp=tp)


def make_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               layout: str = "dense", kv_block: int = 16,
               num_blocks: int = 0, kv_shards: int = 1):
    """The family's slot-indexed cache; ``kv_shards`` M > 1 gives its
    ``KV_HEAD_LEAVES`` a tensor-parallel rank's Hkv / M kv heads (the
    caller shards only where M divides Hkv, ``layers.heads_local``)."""
    mod = module_for(cfg)
    if kv_shards > 1:
        cfg = dataclasses.replace(
            cfg, num_kv_heads=cfg.num_kv_heads // kv_shards)
    if layout == "paged" and supports_paged(cfg):
        return mod.make_cache(cfg, batch, max_len, device=device,
                              layout="paged", kv_block=kv_block,
                              num_blocks=num_blocks)
    return mod.make_cache(cfg, batch, max_len, device=device)


def prefill(params, cfg: ArchConfig, tokens, max_len: int, modality=None,
            tp=None):
    """Batch prefill; ``modality`` is the encdec family's encoder frames
    (B, ENC_LEN, d) or the vlm family's prefix embeds (B,
    num_prefix_embeds, d), unused by the others."""
    mod = module_for(cfg)
    if cfg.family == "encdec":
        return mod.prefill(params, cfg, tokens, max_len, frames=modality,
                           tp=tp)
    if cfg.family == "vlm":
        return mod.prefill(params, cfg, tokens, max_len,
                           prefix_embeds=modality, tp=tp)
    return mod.prefill(params, cfg, tokens, max_len, tp=tp)


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, slot: int,
                  offset: int, new_len: int, span: int, tp=None, **kw):
    """One incremental prefill chunk for ``slot`` (paged layout only).
    Family keywords: ``expert_offsets`` (moe, which then returns
    ``(cache, new_offsets)``); ``state`` and ``finalize`` (hybrid: the
    prompt's batch-1 (ssm, conv) state threaded between chunks and
    written into the slot only when ``finalize``, the last chunk; returns
    ``(cache, new_state)``); ``frames`` (encdec, the first chunk only: the
    encoder's input, whose cross K/V it writes into the slot)."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"family {cfg.family!r} has no chunked prefill")
    return module_for(cfg).prefill_chunk(params, cfg, tokens, cache, slot,
                                         offset, new_len, span, tp=tp, **kw)


def decode_step(params, cfg: ArchConfig, token, cache, key, head_noise=None,
                tp=None):
    return module_for(cfg).decode_step(params, cfg, token, cache, key,
                                       head_noise=head_noise, tp=tp)


def decode_hidden(params, cfg: ArchConfig, token, cache, tp=None):
    """The KV-writing decode BODY alone: ``(hidden (B, d), cache)`` with
    the step's cache writes done and ``len`` advanced in place, but no
    head.  ``decode_step`` is exactly this followed by ``head_outputs`` at
    the pre-step depths: the split that speculative decoding builds on
    (the draft runs the body, so its KV writes are plain decode's; the
    verify runs only the head)."""
    return module_for(cfg).decode_hidden(params, cfg, token, cache, tp=tp)


def head_outputs(params, cfg: ArchConfig, hidden, cache_len, key,
                 num_samples=None, head_noise=None, tp=None):
    """The family-shared uncertain head (``uncertain_head.head_outputs``):
    {next_token, H, SE, MI, p_max} from ``num_samples`` (default
    ``cfg.mc_samples``; 0 the mean head) LRT draws over ``hidden`` at
    depth ``cache_len``."""
    return U.head_outputs(params, cfg, hidden, cache_len, key,
                          head_noise=head_noise, num_samples=num_samples,
                          tp=tp)


def copy_block(cfg: ArchConfig, cache, src: int, dst: int):
    """Copy-on-write: duplicate physical block ``src`` into ``dst`` in
    every paged KV leaf, in place over the layer axis (the caller has
    swapped the slot's table entry to ``dst``); other leaves are left
    alone."""
    for name in PAGED_KV_LEAVES:
        if name in cache:
            L.copy_block(cache[name], src, dst)
    return cache


def kv_bytes(cache) -> int:
    """Allocated bytes of the self-attention KV (dense: the strips; paged:
    the whole block pool without its sink block)."""
    total = 0
    for n in PAGED_KV_LEAVES:
        if n in cache:
            c = cache[n]
            nbytes = c.numel() * c.element_size()
            if "block_table" in cache:
                nbytes = nbytes // c.shape[1] * (c.shape[1] - 1)
            total += nbytes
    return total


def write_slot(cfg: ArchConfig, cache, slot: int, sub, block_row=None,
               offset: int = 0):
    """Write a batch-1 request cache ``sub`` into decode slot ``slot``, in
    place, as the reference does.  Dense: EVERY leaf of ``sub`` lands in
    the slot, at the leading corner of its slot row: the (L, 1, max_len,
    ...) strips, the recurrent states and conv tails, and ``len``.
    Paged: ``block_row`` (MB,) is the slot's physical-block row from the
    host allocator; it is installed in the table, the ``PAGED_KV_LEAVES``
    strips are scattered through it from logical position ``offset`` (0;
    a prefix-cache hit passes the matched length, so the suffix lands
    after the shared blocks; strip tokens past the mapped blocks drop into
    the sink), and every other leaf (the
    hybrid family's states and conv tails, the encdec family's ``ck`` /
    ``cv``) takes the dense slot write, an indexed assignment in place."""
    paged = "block_table" in cache
    if paged:
        if block_row is None:
            raise ValueError("paged cache write needs the slot's block_row")
        table = block_row.reshape(1, -1).to(torch.int32)
        cache["block_table"][slot] = table[0]
    for n, s in sub.items():
        if n == "len":
            continue
        if not (paged and n in PAGED_KV_LEAVES):
            corner = tuple(slice(0, w) for w in s.shape[2:])
            cache[n][(slice(None), slot, *corner)] = s[:, 0].to(
                cache[n].dtype)
            continue
        pool = cache[n]
        strip = s[:, 0]                            # (L or A, S, Hkv, hd)
        lens = torch.full((1,), offset, dtype=torch.int32,
                          device=pool.device)
        phys, off = paged_index(pool.shape[1], pool.shape[2], table, lens,
                                strip.shape[1])
        pool[:, phys[0], off[0]] = strip.to(pool.dtype)
    cache["len"][slot] = sub["len"][0]
    return cache
