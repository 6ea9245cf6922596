"""Encoder-decoder transformer (seamless-m4t-medium backbone): serving and
training.

PyTorch counterpart of ``repro.models.encdec``.  The modality frontend is
a stub, as in the reference: the encoder consumes precomputed frame
embeddings (B, ENC_LEN, d).  The encoder is bidirectional self-attention
with RoPE; each decoder layer runs causal self-attention (KV-cached at
decode), cross-attention over the encoder memory (its query takes no
RoPE; its K/V are computed once, at prefill) and the MLP.  Layers are
stacked on a leading axis, ``encoder`` and ``decoder`` each, and looped
over in Python.

The cache holds the decoder's self-attention K/V (dense strips (L, B,
max_len, Hkv, D), or pools (L, NB + 1, BS, Hkv, D) behind a (B, MB)
``block_table`` under the paged layout, the extra block the write sink of
``layers.paged_scatter``) and the cross-attention memory ``ck`` / ``cv``,
a dense (L, B, ENC_LEN, Hkv, D) strip a slot: always exactly ENC_LEN
deep, so paging it would save nothing.  Every write lands IN PLACE
(prefill chunks, slot writes, decode steps), so a CUDA graph captured
over a decode step replays it on the cache's fixed addresses.

Training (``encode``, ``decode_train``, ``nll_loss``) runs the encoder
over the batch's ``frames`` and the decoder over its tokens with each
layer's cross K/V built from the encoder output inside the layer, as in
the reference; under ``cfg.remat`` every layer of both stacks is
recomputed in the backward pass.  Under a train mesh (``mesh=, dims=``)
the encoder and decoder blocks are Megatron over ``model`` as the dense
blocks are (``layers.enter`` / ``leave``, weights FSDP-gathered where the
config asks), with the stream whole on every model rank (the JAX encdec
has no sequence-parallel constraint).  The encoder memory enters each
decoder layer's cross-attention K / V through ``collectives.copy``: a
rank builds only its heads' K / V from it, so its gradient of the memory
is partial and the copy's backward sums it over ``model``.  The head of
seamless-m4t-medium's 256206 ids is whole where the mesh's D·M does not
divide it, and its embedding's vocabulary where M does not
(``transformer.head_loss``, ``transformer.embed``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import uncertain_head as U
from repro_torch.models.transformer import layer, stacked

# encoder frames a request carries (speech encoders emit a near-constant
# count); the serving length applies to the decoder
ENC_LEN = 1024


def n_enc(cfg: ArchConfig) -> int:
    return cfg.encoder_layers or cfg.num_layers


def n_dec(cfg: ArchConfig) -> int:
    return cfg.decoder_layers or cfg.num_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_enc_block(gen, cfg: ArchConfig, device):
    ones = dict(dtype=L.dtype_of(cfg), device=device)
    return {"ln1": torch.ones((cfg.d_model,), **ones),
            "attn": L.init_attention(gen, cfg, device),
            "ln2": torch.ones((cfg.d_model,), **ones),
            "mlp": L.init_mlp(gen, cfg, device)}


def init_dec_block(gen, cfg: ArchConfig, device):
    ones = dict(dtype=L.dtype_of(cfg), device=device)
    return {"ln1": torch.ones((cfg.d_model,), **ones),
            "self_attn": L.init_attention(gen, cfg, device),
            "ln_x": torch.ones((cfg.d_model,), **ones),
            "cross_attn": L.init_attention(gen, cfg, device),
            "ln2": torch.ones((cfg.d_model,), **ones),
            "mlp": L.init_mlp(gen, cfg, device)}


def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                train: bool = False):
    """Random serving parameters with the reference's names and
    distributions: ``encoder`` ({ln1, attn, ln2, mlp}) and ``decoder``
    ({ln1, self_attn, ln_x, cross_attn, ln2, mlp}) stacked on their layer
    axes, drawn a layer at a time; the embedding, ``enc_norm``, the final
    norm and the Bayesian head (with ``train``, in its training form
    ``{"mu", "rho"}``)."""
    ones = dict(dtype=L.dtype_of(cfg), device=device)
    return {
        "embed": L.init_embed(gen, cfg, device),
        "encoder": stacked(lambda: init_enc_block(gen, cfg, device),
                           n_enc(cfg)),
        "decoder": stacked(lambda: init_dec_block(gen, cfg, device),
                           n_dec(cfg)),
        "enc_norm": torch.ones((cfg.d_model,), **ones),
        "final_norm": torch.ones((cfg.d_model,), **ones),
        "head": L.init_head(gen, cfg, device, train=train),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(params, cfg: ArchConfig, frames: torch.Tensor,
           tp=None, mesh=None, dims=None) -> torch.Tensor:
    """frames: (B, S_enc, d) stub frontend embeddings -> encoder memory
    (B, S_enc, d) in the parameter dtype: bidirectional self-attention
    with RoPE at positions [0, S_enc), then ``enc_norm``.  Under autograd
    with ``cfg.remat`` each layer is recomputed in the backward pass;
    under a train ``mesh`` each is Megatron over ``model``."""
    x = frames.to(L.dtype_of(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    remat = T.remats(cfg)
    spec = None if mesh is None else T.layer_specs(dims["encoder"])
    for bp in T.unstacked(params["encoder"]):
        def fwd(xx, bp=bp, tp=tp):
            if mesh is not None:
                bp, tp = L.gathered(bp, spec, mesh), mesh.model
            h, _ = L.apply_attention(bp["attn"], cfg, L.enter(
                L.rms_norm(xx, bp["ln1"]), mesh, False), rot=rot,
                causal=False, tp=tp)
            xx = xx + L.leave(h, mesh, False)
            return xx + L.leave(L.apply_mlp(bp["mlp"], cfg, L.enter(
                L.rms_norm(xx, bp["ln2"]), mesh, False), tp), mesh, False)
        x = T.rematted(fwd, x) if remat else fwd(x)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(bp, cfg: ArchConfig, x, self_attend, cross_kv, tp=None,
               mesh=None):
    """One decoder layer: ``self_attend(attn_params, normed_x) -> (out,
    kv)`` (prefill, decode or a prompt chunk), cross-attention over
    ``cross_kv``, the MLP.  Returns (x, kv).  Under a train ``mesh`` the
    stream enters and leaves each product through the mesh's
    collectives."""
    h, kv = self_attend(bp["self_attn"], L.enter(L.rms_norm(x, bp["ln1"]),
                                                 mesh, False))
    x = x + L.leave(h, mesh, False)
    hc, _ = L.apply_attention(bp["cross_attn"], cfg, L.enter(
        L.rms_norm(x, bp["ln_x"]), mesh, False), cross_kv=cross_kv, tp=tp)
    x = x + L.leave(hc, mesh, False)
    x = x + L.leave(L.apply_mlp(bp["mlp"], cfg, L.enter(
        L.rms_norm(x, bp["ln2"]), mesh, False), tp), mesh, False)
    return x, kv


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def decode_train(params, cfg: ArchConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor, mesh=None,
                 dims=None) -> torch.Tensor:
    """tokens: (B, S), enc_out: (B, S_enc, d) -> hidden (B, S, d): each
    decoder layer's causal self-attention over positions [0, S), then
    cross-attention over ``layers.make_cross_kv`` of ``enc_out`` (built
    inside the layer), then the MLP; layers from
    ``transformer.unstacked``, each recomputed in the backward pass under
    ``cfg.remat``.  Under a train ``mesh`` each layer is Megatron over
    ``model`` and ``enc_out`` enters its cross K / V through
    ``collectives.copy`` (``layers.enter``)."""
    x = T.embed(params, tokens, mesh, dims)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    remat = T.remats(cfg)
    spec = None if mesh is None else T.layer_specs(dims["decoder"])
    for bp in T.unstacked(params["decoder"]):
        def fwd(xx, mem, bp=bp):
            tp = None
            if mesh is not None:
                bp, tp = L.gathered(bp, spec, mesh), mesh.model
            ckv = L.make_cross_kv(bp["cross_attn"], cfg,
                                  L.enter(mem, mesh, False), tp)
            return _dec_block(bp, cfg, xx, lambda p, u: L.apply_attention(
                p, cfg, u, rot=rot, tp=tp), ckv, tp, mesh)[0]
        x = T.rematted(fwd, x, enc_out) if remat else fwd(x, enc_out)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def nll_loss(params, cfg: ArchConfig, batch: dict, key, noise=None,
             mesh=None, dims=None):
    """batch: ``frames`` (B, S_enc, d), ``tokens`` (B, S), ``labels`` (B,
    S).  The mean next-token NLL of the decoder's output under one
    weight-space draw of the head (``transformer.head_loss``): ``(nll,
    {"accuracy"})``, as ``repro.models.encdec.nll_loss``; under a train
    ``mesh`` the batch is the data rank's rows and the value its
    share."""
    enc_out = encode(params, cfg, batch["frames"], mesh=mesh, dims=dims)
    hidden = decode_train(params, cfg, batch["tokens"], enc_out, mesh, dims)
    return T.head_loss(params, cfg, hidden, batch["labels"], key, noise,
                       mesh=mesh, dims=dims)


# the dense rule, over both stacks
check_sharded = T.check_sharded


# nothing is model-partial: the stream is whole on every model rank (no
# seq_parallel, ``registry.check_trains_sharded``), and the memory's
# partial gradient is summed by its copy
model_partial = T.model_partial


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               dtype=None, layout: str = "dense", kv_block: int = 16,
               num_blocks: int = 0):
    """Self-attention KV (strips or pages) plus the dense per-slot
    cross-attention memory ``ck`` / ``cv`` (see the module docstring)."""
    dt = dtype or L.dtype_of(cfg)
    Ld, Hkv, hd = n_dec(cfg), cfg.num_kv_heads, cfg.head_dim
    cross = (Ld, batch, ENC_LEN, Hkv, hd)
    cache = {"ck": torch.zeros(cross, dtype=dt, device=device),
             "cv": torch.zeros(cross, dtype=dt, device=device),
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if layout == "paged":
        nb = num_blocks or batch * L.paged_table_width(max_len, kv_block)
        shape = (Ld, nb + 1, kv_block, Hkv, hd)
        cache["block_table"] = L.init_block_table(batch, max_len, kv_block,
                                                  device)
    else:
        shape = (Ld, batch, max_len, Hkv, hd)
    cache["k"] = torch.zeros(shape, dtype=dt, device=device)
    cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, max_len: int,
            frames: torch.Tensor, tp=None):
    """Encode ``frames``, compute every layer's cross K/V, run the decoder
    over the prompt; returns (hidden_last, cache) with (L, B, max_len,
    Hkv, hd) self-attention strips, (L, B, ENC_LEN, Hkv, hd) ``ck`` /
    ``cv`` and ``len``."""
    if frames is None:
        raise ValueError("encdec prefill needs the encoder frames")
    enc_out = encode(params, cfg, frames, tp)
    x = L.apply_embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    pad = (0, 0, 0, 0, 0, max_len - S)
    ks, vs, cks, cvs = [], [], [], []
    for i in range(n_dec(cfg)):
        bp = layer(params["decoder"], i)
        ckv = L.make_cross_kv(bp["cross_attn"], cfg, enc_out, tp)
        x, (k, v) = _dec_block(bp, cfg, x, lambda p, u:
                               L.apply_attention(p, cfg, u, rot=rot, tp=tp),
                               ckv, tp)
        ks.append(F.pad(k, pad))
        vs.append(F.pad(v, pad))
        cks.append(ckv[0])
        cvs.append(ckv[1])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "ck": torch.stack(cks), "cv": torch.stack(cvs),
             "len": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)}
    return x[:, -1], cache


def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                  slot: int, offset: int, new_len: int, span: int,
                  frames: Optional[torch.Tensor] = None, tp=None) -> dict:
    """One chunk of an incremental prompt prefill for ``slot`` (see
    ``transformer.prefill_chunk``).

    The FIRST chunk passes ``frames`` (1, ENC_LEN, d): it runs the
    encoder and writes every layer's cross K/V into the slot's ``ck`` /
    ``cv`` strips in place.  Later chunks read those strips back (cross
    attention is non-causal over a fixed extent and row-independent, so
    per-chunk rows give the batch prefill's).  The decoder's
    self-attention pages through the pool as the dense family's does,
    with the chunk's RoPE tables and write index built once."""
    row = cache["block_table"][slot:slot + 1]
    x = L.apply_embed(params["embed"], tokens)
    S = tokens.shape[1]
    positions = offset + torch.arange(S, device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    at = torch.full((1,), offset, dtype=torch.int32, device=x.device)
    kv_index = L.paged_index(cache["k"].shape[1], cache["k"].shape[2], row,
                             at, S)
    enc_out = None if frames is None else encode(params, cfg, frames, tp)
    for i in range(n_dec(cfg)):
        bp = layer(params["decoder"], i)
        ck, cv = cache["ck"][i, slot:slot + 1], cache["cv"][i, slot:slot + 1]
        if enc_out is not None:
            k, v = L.make_cross_kv(bp["cross_attn"], cfg, enc_out, tp)
            ck.copy_(k)
            cv.copy_(v)
        pools = (cache["k"][i], cache["v"][i])
        x, _ = _dec_block(bp, cfg, x, lambda p, u: L.apply_attention_chunk(
            p, cfg, u, kv_pools=pools, block_row=row, offset=offset,
            span=span, rot=rot, kv_index=kv_index, tp=tp), (ck, cv), tp)
    cache["len"][slot].fill_(new_len)  # item assignment would sync the host
    return cache


def decode_hidden(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                  tp=None):
    """The KV-writing decode body (see ``transformer.decode_hidden``): each
    layer writes its self-attention K/V at the slot's pre-step depth, IN
    PLACE, and reads its ``ck`` / ``cv`` untouched; ``len`` advances by
    one in place.  Returns ``(hidden (B, d), cache)``."""
    x = L.apply_embed(params["embed"], token[:, None])
    lens = cache["len"]
    table = cache.get("block_table")
    rot = L.rope_tables(lens.reshape(-1, 1), cfg.head_dim, cfg.rope_theta)
    kv_index = None if table is None else L.paged_index(
        cache["k"].shape[1], cache["k"].shape[2], table, lens, 1)
    for i in range(n_dec(cfg)):
        bp = layer(params["decoder"], i)
        kv = (cache["k"][i], cache["v"][i])
        x, _ = _dec_block(bp, cfg, x, lambda p, u: L.apply_attention(
            p, cfg, u, rot=rot, kv_cache=kv, cache_len=lens,
            block_table=table, kv_index=kv_index, tp=tp),
            (cache["ck"][i], cache["cv"][i]), tp)
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
