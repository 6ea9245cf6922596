"""Zamba2-style hybrid (zamba2-7b), serving and training: a Mamba2 backbone
and one SHARED attention + MLP block applied every ``attn_every`` layers.

PyTorch counterpart of ``repro.models.hybrid``.  Application ``a`` of the
shared block (one set of weights) runs before the Mamba group ``[a *
attn_every, min((a + 1) * attn_every, L))``; the reference fires it from
a ``lax.cond`` inside its layer scan, the port loops over the
applications in Python.  Both the shared block's norms take
``rms_norm``'s default eps, as in the reference; the final norm takes
``cfg.norm_eps``.

The cache holds per layer the SSM state (f32) and conv tail of
``models.ssm``, and per APPLICATION a KV plane of the shared attention
(same weights, distinct activations): dense strips (A, B, max_len, Hkv,
D), or under the paged layout pools (A, NB + 1, BS, Hkv, D) behind one
(B, MB) ``block_table`` that every plane shares (the extra block is the
write sink of ``layers.paged_scatter``).  A decode step writes every
leaf IN PLACE, ``len`` included, and builds its RoPE tables and paged
write index once for all A applications, so a CUDA graph captured over
the step replays it on the cache's fixed addresses.

Training (``forward``, ``nll_loss``) walks the same groups with causal
attention over the whole sequence and no cache; the shared block's
gradient is the sum over its applications (autograd adds them, as the
reference's scan does); the shared block is ``transformer._block_fwd``,
the dense block.  Under a train mesh (``mesh=, dims=``) the Mamba2
blocks are ``ssm.apply_block``'s head-parallel blocks, and each
application of the shared attention + MLP block is Megatron over
``model`` (the mesh's model axis as the layers' ``tp``, the stream
through ``layers.enter`` / ``leave``), its weights
FSDP-gathered over ``data`` at each application, so the gradient of
every application reduce-scatters into the rank's block and the sum over
applications is autograd's.  The stream is replicated over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models import uncertain_head as U
from repro_torch.models.transformer import layer, stacked


def n_attn_apps(cfg: ArchConfig) -> int:
    return (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every


def groups(cfg: ArchConfig):
    """(a, lo, hi) per application: the shared block's application ``a``
    and the Mamba layers ``[lo, hi)`` that follow it (the last group is
    short when attn_every does not divide the depth)."""
    for a in range(n_attn_apps(cfg)):
        lo = a * cfg.attn_every
        yield a, lo, min(lo + cfg.attn_every, cfg.num_layers)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                train: bool = False):
    """Random serving parameters with the reference's names and
    distributions: the Mamba blocks stacked on L (``ssm.init_block``, a
    layer at a time), ``shared = {ln1, attn, ln2, mlp}``, the embedding,
    the final norm and the Bayesian head (with ``train``, in its training
    form ``{"mu", "rho"}``)."""
    ones = dict(dtype=L.dtype_of(cfg), device=device)
    return {
        "embed": L.init_embed(gen, cfg, device),
        # a layer at a time: the f32 draw of all 81 layers at once would
        # hold ≈ 34 GB at full width
        "blocks": stacked(lambda: ssm.init_block(gen, cfg, device),
                          cfg.num_layers),
        "shared": {"ln1": torch.ones((cfg.d_model,), **ones),
                   "attn": L.init_attention(gen, cfg, device),
                   "ln2": torch.ones((cfg.d_model,), **ones),
                   "mlp": L.init_mlp(gen, cfg, device)},
        "final_norm": torch.ones((cfg.d_model,), **ones),
        "head": L.init_head(gen, cfg, device, train=train),
    }


def _shared_fwd(sp, cfg: ArchConfig, x: torch.Tensor, attend, tp=None):
    """One application of the shared block: ``attend(attn_params,
    normed_x) -> (out, kv)`` (prefill, decode or a prompt chunk), then the
    MLP.  Returns (x, kv).  Under a serving mesh (``tp``) the shared
    block's attention and MLP shard; the Mamba mixers replicate."""
    h, kv = attend(sp["attn"], L.rms_norm(x, sp["ln1"]))
    x = x + h
    x = x + L.apply_mlp(sp["mlp"], cfg, L.rms_norm(x, sp["ln2"]), tp)
    return x, kv


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, tokens: torch.Tensor, mesh=None,
            dims=None) -> torch.Tensor:
    """tokens: (B, S) -> hidden (B, S, d).  Layer i runs the shared block
    first where i opens a group (``i % attn_every == 0``, causal over
    positions [0, S)), then its Mamba block in the chunked form from a
    zero state: the reference's ``lax.cond`` inside its layer scan.  With
    ``cfg.remat`` under autograd each layer, the shared application with
    it, is recomputed in the backward pass (``transformer.rematted``).
    Under a train ``mesh`` the tokens are the data rank's rows and the
    blocks run sharded (the module docstring)."""
    x = T.embed(params, tokens, mesh, dims)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    sp = params["shared"]
    spec = shared_spec = None
    if mesh is not None:
        spec, shared_spec = T.layer_specs(dims["blocks"]), dims["shared"]
    remat = T.remats(cfg)
    for i, bp in enumerate(T.unstacked(params["blocks"])):
        def fwd(xx, bp=bp, opens=i % cfg.attn_every == 0):
            if opens:
                xx, _ = T._block_fwd(sp, cfg, xx, rot, mesh=mesh,
                                     spec=shared_spec)
            return ssm.apply_block(bp, cfg, xx, mesh=mesh, spec=spec)[0]
        x = T.rematted(fwd, x) if remat else fwd(x)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def nll_loss(params, cfg: ArchConfig, batch: dict, key, noise=None,
             mesh=None, dims=None):
    """Mean next-token NLL with one weight-space draw of the head
    (``transformer.head_loss``): ``(nll, {"accuracy"})``, as
    ``repro.models.hybrid.nll_loss``; under a train ``mesh`` this data
    rank's share."""
    hidden = forward(params, cfg, batch["tokens"], mesh, dims)
    return T.head_loss(params, cfg, hidden, batch["labels"], key, noise,
                       mesh=mesh, dims=dims)


def check_sharded(cfg: ArchConfig, dims: dict, mesh) -> None:
    """The shared block's Megatron leaves (``transformer.check_sharded``)
    and the Mamba2 blocks' head-parallel ones (``ssm.check_sharded``)."""
    T.check_sharded(cfg, dims, mesh)
    ssm.check_sharded(cfg, dims, mesh)


model_partial = ssm.model_partial


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               dtype=None, layout: str = "dense", kv_block: int = 16,
               num_blocks: int = 0):
    """Per-layer Mamba state (``ssm.make_cache``) plus one KV plane per
    application of the shared attention; only the planes page."""
    dt = dtype or L.dtype_of(cfg)
    cache = ssm.make_cache(cfg, batch, max_len, device=device, dtype=dt)
    A, Hkv, hd = n_attn_apps(cfg), cfg.num_kv_heads, cfg.head_dim
    if layout == "paged":
        nb = num_blocks or batch * L.paged_table_width(max_len, kv_block)
        shape = (A, nb + 1, kv_block, Hkv, hd)
        cache["block_table"] = L.init_block_table(batch, max_len, kv_block,
                                                  device)
    else:
        shape = (A, batch, max_len, Hkv, hd)
    cache["attn_k"] = torch.zeros(shape, dtype=dt, device=device)
    cache["attn_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, max_len: int,
            tp=None):
    """Run the full prompt (its exact length: the recurrent state would
    fold in pad tokens); returns (hidden_last, cache) with (A, B,
    max_len, Hkv, hd) strips, every layer's state and ``len``."""
    x = L.apply_embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    pad = (0, 0, 0, 0, 0, max_len - S)
    ks, vs, hs, cs = [], [], [], []
    for _, lo, hi in groups(cfg):
        x, (k, v) = _shared_fwd(params["shared"], cfg, x, lambda p, u:
                                L.apply_attention(p, cfg, u, rot=rot,
                                                  tp=tp), tp)
        ks.append(F.pad(k, pad))
        vs.append(F.pad(v, pad))
        for i in range(lo, hi):
            x, h, c = ssm.apply_block(layer(params["blocks"], i), cfg, x)
            hs.append(h)
            cs.append(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = {"ssm": torch.stack(hs), "conv": torch.stack(cs),
             "attn_k": torch.stack(ks), "attn_v": torch.stack(vs),
             "len": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)}
    return x[:, -1], cache


def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                  slot: int, offset: int, new_len: int, span: int,
                  state: dict, finalize: bool, tp=None):
    """One chunk of an incremental prompt prefill for ``slot`` (see
    ``transformer.prefill_chunk``); returns ``(cache, new_state)``.

    The Mamba state is not positional, so the in-flight prompt's (ssm,
    conv) states ride ENGINE-side in ``state`` (batch-1 leaves (L, 1,
    ...), zeros before the first chunk: a zero conv tail is the fresh
    path's left zero pad) and reach the slot's cache only on the
    ``finalize`` chunk: decode replays between chunks run over every slot
    and advance a prefilling slot's cache state with junk.  Chunks are
    multiples of ``cfg.ssm_chunk`` (an exact tail allowed), walked with
    ``force_chunked`` so that they decompose as the batch prefill does.
    ``span`` is the exact prompt length: hybrid prompts are never padded.
    Each application's K/V go into its own pool plane; ``len`` is pinned
    to ``new_len`` on every chunk."""
    row = cache["block_table"][slot:slot + 1]
    x = L.apply_embed(params["embed"], tokens)
    S = tokens.shape[1]
    # shared by every application: the chunk's RoPE tables and write index
    positions = offset + torch.arange(S, device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    at = torch.full((1,), offset, dtype=torch.int32, device=x.device)
    kv_index = L.paged_index(cache["attn_k"].shape[1],
                             cache["attn_k"].shape[2], row, at, S)
    hs, cs = [], []
    for a, lo, hi in groups(cfg):
        pools = (cache["attn_k"][a], cache["attn_v"][a])
        x, _ = _shared_fwd(params["shared"], cfg, x, lambda p, u:
                           L.apply_attention_chunk(
                               p, cfg, u, kv_pools=pools, block_row=row,
                               offset=offset, span=span, rot=rot,
                               kv_index=kv_index, tp=tp), tp)
        for i in range(lo, hi):
            x, h, c = ssm.apply_block(layer(params["blocks"], i), cfg, x,
                                      ssm_state=state["ssm"][i],
                                      conv_state=state["conv"][i],
                                      force_chunked=True)
            hs.append(h)
            cs.append(c)
    state = {"ssm": torch.stack(hs), "conv": torch.stack(cs)}
    cache["len"][slot].fill_(new_len)  # item assignment would sync the host
    if finalize:
        for n in ("ssm", "conv"):
            cache[n][:, slot].copy_(state[n][:, 0])
    return cache, state


def decode_hidden(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                  tp=None):
    """The state- and KV-writing decode body: each application writes its
    K/V into its own plane at the slot's pre-step depth, each layer its
    SSM state and conv tail, all IN PLACE; ``len`` advances by one in
    place.  Returns ``(hidden (B, d), cache)``."""
    x = L.apply_embed(params["embed"], token[:, None])
    lens = cache["len"]
    table = cache.get("block_table")
    # shared by every application: the RoPE tables at each slot's depth
    # and, when paged, the pool positions this step writes
    rot = L.rope_tables(lens.reshape(-1, 1), cfg.head_dim, cfg.rope_theta)
    kv_index = None if table is None else L.paged_index(
        cache["attn_k"].shape[1], cache["attn_k"].shape[2], table, lens, 1)
    for a, lo, hi in groups(cfg):
        kv = (cache["attn_k"][a], cache["attn_v"][a])
        x, _ = _shared_fwd(params["shared"], cfg, x, lambda p, u:
                           L.apply_attention(
                               p, cfg, u, rot=rot, kv_cache=kv,
                               cache_len=lens, block_table=table,
                               kv_index=kv_index, tp=tp), tp)
        for i in range(lo, hi):
            x, h, c = ssm.apply_block(layer(params["blocks"], i), cfg, x,
                                      ssm_state=cache["ssm"][i],
                                      conv_state=cache["conv"][i])
            cache["ssm"][i].copy_(h)
            cache["conv"][i].copy_(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lens.add_(1)
    return x[:, 0], cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                key: tuple, head_noise=None, tp=None):
    """One uncertain decode step (see ``transformer.decode_step``)."""
    lens0 = cache["len"].clone()        # the body advances len in place
    hidden, cache = decode_hidden(params, cfg, token, cache, tp)
    return U.head_outputs(params, cfg, hidden, lens0, key,
                          head_noise=head_noise, tp=tp), cache
