"""Dense decoder-only transformer (qwen2*, codeqwen, nemotron,
phi-3-vision), serving path.

PyTorch counterpart of ``repro.models.transformer``; it covers the
``dense`` and ``vlm`` families.  The vlm frontend is a stub, as in the
JAX package: ``prefix_embeds`` (precomputed patch embeddings, (B, P, d))
replace the first P positions of the embedded prompt at prefill; the
positions stay ``arange(S)``, and decode reads only the cache.  Layers
are stacked on a leading L axis exactly as in the JAX parameter tree;
where the JAX package scans over that axis, the port loops over it in
Python (each layer's weights are views of the stacked tensors).

Caches are slot-indexed dicts: ``len`` (B,) int32 per-slot depths plus
either dense strips (L, B, max_len, Hkv, hd) or, under the paged layout,
block pools (L, NB + 1, BS, Hkv, hd) behind a (B, MB) ``block_table``
(the extra block is the write sink of ``layers.paged_scatter``).  Every
step writes the cache in place, ``len`` included, and returns the same
dict holding the same tensors, so a CUDA graph captured over a decode
step replays it on the cache's fixed addresses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import keys as K
from repro_torch.models import layers as L
from repro_torch.models import uncertain_head as U


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstacked(tree) -> list:
    """Every layer of a layer-stacked parameter tree, views from one
    ``torch.unbind`` a leaf.  Under autograd its backward is one stack a
    leaf; indexing layer by layer (``layer``) would give each layer's
    gradient the full stacked shape, L zero-filled copies summed."""
    if isinstance(tree, dict):
        per = {k: unstacked(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


def stacked(init, n: int):
    """``init()``'s tree drawn ``n`` times, a layer at a time, into
    tensors stacked on a leading layer axis (a full-width draw of every
    layer at once would hold them all in f32)."""
    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    def empty(tree):
        return {k: empty(v) if isinstance(v, dict)
                else v.new_empty((n, *v.shape)) for k, v in tree.items()}

    out = None
    for i in range(n):
        tree = init()
        if out is None:
            out = empty(tree)
        put(out, tree, i)
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                train: bool = False):
    """Random serving parameters with the JAX package's distributions
    (he_init weights, ones for the norms, zero QKV biases, N(0,1)/sqrt(d)
    head mean and sigma = softplus(inv_softplus(head_init_sigma))); with
    ``train`` the head in its training form ``{"mu", "rho"}`` (the same
    draws)."""
    dt = L.dtype_of(cfg)
    lead = (cfg.num_layers,)
    ones = dict(dtype=dt, device=device)
    return {
        "embed": L.init_embed(gen, cfg, device),
        "blocks": {
            "ln1": torch.ones((*lead, cfg.d_model), **ones),
            "attn": L.init_attention(gen, cfg, device, lead),
            "ln2": torch.ones((*lead, cfg.d_model), **ones),
            "mlp": L.init_mlp(gen, cfg, device, lead),
        },
        "final_norm": torch.ones((cfg.d_model,), **ones),
        "head": L.init_head(gen, cfg, device, train=train),
    }


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def splice_prefix(x: torch.Tensor, prefix_embeds: torch.Tensor):
    """The embedded prompt x (B, S, d) with its first P rows replaced by
    ``prefix_embeds`` (B, P, d) cast to x's dtype, as a new tensor."""
    P = prefix_embeds.shape[1]
    if P > x.shape[1]:
        raise ValueError(f"a prompt of {x.shape[1]} tokens cannot hold the "
                         f"{P} prefix embeds")
    return torch.cat([prefix_embeds.to(x.dtype), x[:, P:]], dim=1)


def _block_fwd(bp, cfg: ArchConfig, x, rot):
    h, kv = L.apply_attention(bp["attn"], cfg, L.rms_norm(x, bp["ln1"]),
                              rot=rot)
    x = x + h
    x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]))
    return x, kv


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None,
            return_kv: bool = False):
    """tokens: (B, S) -> hidden (B, S, d); optionally the per-layer (k, v)
    stacked to (L, B, S, Hkv, hd).  ``prefix_embeds`` (B, P, d), P <= S,
    take the place of the first P embedded tokens, cast to the body's
    dtype (the tokens under them are ignored).  Under autograd with
    ``cfg.remat`` each layer is recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's per-layer
    ``jax.checkpoint``): the same numbers, only layer inputs kept."""
    x = L.apply_embed(params["embed"], tokens)
    if prefix_embeds is not None:
        x = splice_prefix(x, prefix_embeds)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled() and not return_kv
    ks, vs = [], []
    for bp in unstacked(params["blocks"]):
        if remat:
            x = checkpoint(lambda xx, bp=bp: _block_fwd(bp, cfg, xx, rot)[0],
                           x, use_reentrant=False, preserve_rng_state=False)
            continue
        x, (k, v) = _block_fwd(bp, cfg, x, rot)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x, None


def nll_loss(params, cfg: ArchConfig, batch: dict, key: K.Key,
             noise=None):
    """Mean next-token NLL with one weight-space draw of the Bayesian head
    (``repro.models.transformer.nll_loss``): w = mu + softplus(rho)·eps,
    eps of mu's shape from ``noise(key, shape, device)`` (default
    ``keys.normal``; tests inject the JAX package's draw), and logits =
    hidden @ w cast to the body's dtype, accumulated and returned in
    float32; the head is in its training form ``{"mu", "rho"}``.
    batch: ``tokens`` (B, S), ``labels`` (B, S)
    (shifted; labels < 0 are padding), optional ``prefix_embeds``.
    Returns (nll, {"accuracy"}), both 0-d float32."""
    hidden, _ = forward(params, cfg, batch["tokens"],
                        prefix_embeds=batch.get("prefix_embeds"))
    mu, rho = params["head"]["mu"], params["head"]["rho"]
    eps = (noise or K.normal)(key, tuple(mu.shape), mu.device)
    w = mu + F.softplus(rho) * eps
    # bf16 operands, float32 products and output: the reference's
    # preferred_element_type=f32 (a bf16 matmul would round its output)
    logits = hidden.float() @ w.to(hidden.dtype).float()
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    labels = batch["labels"].long()
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    # gather, not nll_loss: its backward has a deterministic CUDA form
    tok_nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    tok_nll = torch.where(valid, tok_nll, torch.zeros_like(tok_nll))
    count = torch.clamp(valid.sum(), min=1).float()
    nll = tok_nll.sum() / count
    acc = ((logits.argmax(-1) == labels) & valid).sum().float() / count
    return nll, {"accuracy": acc}


def make_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               dtype=None, layout: str = "dense", kv_block: int = 16,
               num_blocks: int = 0):
    """Slot-indexed KV cache (see the module docstring for the layouts)."""
    dt = dtype or L.dtype_of(cfg)
    lens = torch.zeros((batch,), dtype=torch.int32, device=device)
    if layout == "paged":
        nb = num_blocks or batch * L.paged_table_width(max_len, kv_block)
        shape = (cfg.num_layers, nb + 1, kv_block, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "len": lens,
                "block_table": L.init_block_table(batch, max_len, kv_block,
                                                  device)}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device), "len": lens}


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, max_len: int,
            prefix_embeds: torch.Tensor | None = None):
    """Run the full prompt (its first positions ``prefix_embeds``, if
    given); returns (hidden_last, cache) with (L, B, max_len, Hkv, hd)
    strips and ``len`` = prompt length."""
    hidden, (k, v) = forward(params, cfg, tokens, prefix_embeds,
                             return_kv=True)
    B, S = tokens.shape
    pad = (0, 0, 0, 0, 0, max_len - S)
    cache = {"k": torch.nn.functional.pad(k, pad),
             "v": torch.nn.functional.pad(v, pad),
             "len": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)}
    return hidden[:, -1], cache


def prefill_suffix(params, cfg: ArchConfig, tokens: torch.Tensor,
                   prefix_kv: dict, prefix_len: int):
    """Prefill ONLY the uncached suffix of a prefix-cache hit.

    tokens: (B, S) the suffix at absolute positions ``prefix_len + [0,
    S)``; ``prefix_kv``: {"k", "v"} logical strips (L, B, W, Hkv, hd)
    gathered from the pool, W >= ``prefix_len``.  Returns (hidden_last,
    sub) where sub holds the SUFFIX-ONLY K/V strips (L, B, S, Hkv, hd),
    which the caller scatters at logical offset ``prefix_len``
    (``registry.write_slot(..., offset=prefix_len)``), and the slot's
    depth ``len = prefix_len + S``.  Bit for bit against the cold prefill
    of the whole prompt (``layers.apply_attention_suffix``)."""
    prefix_len = int(prefix_len)
    x = L.apply_embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = prefix_len + torch.arange(S, device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        h, (k, v) = L.apply_attention_suffix(
            bp["attn"], cfg, L.rms_norm(x, bp["ln1"]),
            prefix_kv=(prefix_kv["k"][i, :, :prefix_len],
                       prefix_kv["v"][i, :, :prefix_len]),
            prefix_len=prefix_len, rot=rot)
        x = x + h
        x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]))
        ks.append(k)
        vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lens = torch.full((B,), prefix_len + S, dtype=torch.int32,
                      device=tokens.device)
    return x[:, -1], {"k": torch.stack(ks), "v": torch.stack(vs),
                      "len": lens}


def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                  slot: int, offset: int, new_len: int, span: int) -> dict:
    """One chunk of an incremental prompt prefill for ``slot``.

    tokens: (1, S) chunk at absolute positions ``offset + [0, S)``;
    ``span``: the whole prompt's attention extent.  Writes the chunk's K/V
    into the slot's pool blocks and pins the slot's ``len`` to ``new_len``
    (healing the +1/step drift of interleaved decode steps).  Hidden
    outputs are discarded: the engine re-feeds the prompt's last token at
    activation, as with batch prefill."""
    row = cache["block_table"][slot:slot + 1]
    x = L.apply_embed(params["embed"], tokens)
    S = tokens.shape[1]
    # shared by every layer: the chunk's RoPE tables and pool write index
    positions = offset + torch.arange(S, device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    at = torch.full((1,), offset, dtype=torch.int32, device=x.device)
    kv_index = L.paged_index(cache["k"].shape[1], cache["k"].shape[2], row,
                             at, S)
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        h, _ = L.apply_attention_chunk(
            bp["attn"], cfg, L.rms_norm(x, bp["ln1"]),
            kv_pools=(cache["k"][i], cache["v"][i]), block_row=row,
            offset=offset, span=span, rot=rot, kv_index=kv_index)
        x = x + h
        x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]))
    cache["len"][slot].fill_(new_len)  # item assignment would sync the host
    return cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_hidden(params, cfg: ArchConfig, token: torch.Tensor, cache: dict):
    """The KV-writing decode body: embed -> blocks -> final norm.

    token: (B,).  Writes each slot's K/V at its PRE-step depth and returns
    ``(hidden (B, d), cache)`` with ``len`` advanced by one IN PLACE: a
    caller that needs the pre-step depths copies them first."""
    x = L.apply_embed(params["embed"], token[:, None])
    lens = cache["len"]
    table = cache.get("block_table")
    # shared by every layer: the RoPE tables at each slot's depth and, when
    # paged, the pool positions this step writes
    rot = L.rope_tables(lens.reshape(-1, 1), cfg.head_dim, cfg.rope_theta)
    kv_index = None if table is None else L.paged_index(
        cache["k"].shape[1], cache["k"].shape[2], table, lens, 1)
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        h, _ = L.apply_attention(
            bp["attn"], cfg, L.rms_norm(x, bp["ln1"]), rot=rot,
            kv_cache=(cache["k"][i], cache["v"][i]), cache_len=lens,
            block_table=table, kv_index=kv_index)
        x = x + h
        x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lens.add_(1)
    return x[:, 0], cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                key: tuple, head_noise=None):
    """One uncertain decode step: (outputs, cache) with outputs =
    {next_token, H, SE, MI, p_max} per slot from ``cfg.mc_samples`` LRT
    head draws (``uncertain_head``); ``key`` is (seed, step) or (seed,
    step, offset) of the head stream."""
    lens0 = cache["len"].clone()        # the body advances len in place
    hidden, cache = decode_hidden(params, cfg, token, cache)
    return U.head_outputs(params, cfg, hidden, lens0, key,
                          head_noise=head_noise), cache
