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

The serving functions take ``tp``, a tensor-parallel rank's mesh handle
(``launch.mesh.TP``; None unsharded), and hand it to the layers; the
cache then holds the rank's kv heads where they shard.  The training
functions (``forward``, ``nll_loss``, ``head_loss``) take ``mesh``
(``launch.mesh.TrainMesh``) and ``dims`` (the parameters' specs,
``sharding.partition.train_dims``) and run on the rank's shards.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import keys as K
from repro_torch.core import tree as T
from repro_torch.models import layers as L
from repro_torch.models import uncertain_head as U
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as P


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


def remats(cfg: ArchConfig) -> bool:
    """Whether a training forward recomputes its layers in the backward
    pass: ``cfg.remat`` with autograd on."""
    return cfg.remat and torch.is_grad_enabled()


def rematted(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's per-layer
    ``jax.checkpoint``): the same numbers, only the inputs kept."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


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


def _block_fwd(bp, cfg: ArchConfig, x, rot, tp=None, mesh=None, spec=None,
               sp: bool = False):
    """A block.  Under a train ``mesh`` (``spec``: the layer's specs) the
    weights are FSDP-gathered first, the model axis is the layers' ``tp``
    and the stream enters and leaves each product through the mesh's
    collectives (``layers.enter`` / ``leave``; ``sp``: S-sharded)."""
    if mesh is not None:
        bp, tp = L.gathered(bp, spec, mesh), mesh.model
    h, kv = L.apply_attention(bp["attn"], cfg,
                              L.enter(L.rms_norm(x, bp["ln1"]), mesh, sp),
                              rot=rot, tp=tp)
    x = x + L.leave(h, mesh, sp)
    h = L.apply_mlp(bp["mlp"], cfg, L.enter(L.rms_norm(x, bp["ln2"]), mesh,
                                            sp), tp)
    return x + L.leave(h, mesh, sp), kv


def seq_parallel(cfg: ArchConfig, mesh, S: int) -> bool:
    """Whether a train ``mesh``'s residual stream is S-sharded over
    ``model``: the config asks (``seq_parallel``) and S divides the model
    ranks (the JAX ``constrain_seq`` is a no-op otherwise)."""
    if mesh is None:
        return False
    m = mesh.model.size
    return cfg.seq_parallel and m > 1 and S % m == 0


def layer_specs(dims: dict) -> dict:
    """A layer's specs from the stacked leaves' (the layer axis dropped)."""
    return {k: layer_specs(v) if isinstance(v, dict) else v[1:]
            for k, v in dims.items()}


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None,
            return_kv: bool = False, tp=None, mesh=None, dims=None):
    """tokens: (B, S) -> hidden (B, S, d); optionally the per-layer (k, v)
    stacked to (L, B, S, Hkv, hd).  ``prefix_embeds`` (B, P, d), P <= S,
    take the place of the first P embedded tokens, cast to the body's
    dtype (the tokens under them are ignored).  Under autograd with
    ``cfg.remat`` each layer is recomputed in the backward pass
    (``rematted``).  Under a train ``mesh`` the parameters are the
    rank's shards (``dims``), the tokens the data rank's rows, the
    embedding vocabulary-parallel, and the hidden state (b, S / M, d)
    where ``seq_parallel``, else (b, S, d) on every model rank; the
    prefix embeds are spliced into the whole rows before the stream is
    split."""
    spec = None if mesh is None else layer_specs(dims["blocks"])
    x = embed(params, tokens, mesh, dims)
    if prefix_embeds is not None:
        x = splice_prefix(x, prefix_embeds)
    sp = seq_parallel(cfg, mesh, tokens.shape[1])
    if sp:
        x = C.split(x, mesh.model, 1)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    remat = remats(cfg) and not return_kv
    ks, vs = [], []
    for bp in unstacked(params["blocks"]):
        if remat:
            x = rematted(lambda xx, bp=bp: _block_fwd(
                bp, cfg, xx, rot, tp, mesh, spec, sp)[0], x)
            continue
        x, (k, v) = _block_fwd(bp, cfg, x, rot, tp, mesh, spec, sp)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x, None


def embed(params, tokens: torch.Tensor, mesh=None, dims=None):
    """The tokens' rows of ``params["embed"]``.  Under a train ``mesh``
    the table is FSDP-gathered over ``data`` and looked up
    vocabulary-parallel over ``model`` where its spec splits the
    vocabulary there; a vocabulary the rules leave whole (one that the
    model ranks do not divide) is looked up whole on every model rank."""
    emb, axis = params["embed"], None
    if mesh is not None:
        emb = L.gathered(emb, dims["embed"], mesh)
        if "model" in P.spec_axes(dims["embed"]["table"]):
            axis = mesh.model
    return L.apply_embed(emb, tokens, axis)


def nll_loss(params, cfg: ArchConfig, batch: dict, key: K.Key,
             noise=None, mesh=None, dims=None):
    """Mean next-token NLL with one weight-space draw of the Bayesian head
    (``repro.models.transformer.nll_loss``; ``head_loss``).  batch:
    ``tokens`` (B, S), ``labels`` (B, S) (shifted; labels < 0 are
    padding), optional ``prefix_embeds``.  Returns (nll, {"accuracy"}),
    both 0-d float32.  Under a train ``mesh`` the batch is the data
    rank's rows and the parameters its shards (``dims``): the value is
    this data rank's share of the global mean."""
    hidden, _ = forward(params, cfg, batch["tokens"],
                        prefix_embeds=batch.get("prefix_embeds"),
                        mesh=mesh, dims=dims)
    return head_loss(params, cfg, hidden, batch["labels"], key, noise,
                     mesh=mesh, dims=dims)


def head_loss(params, cfg: ArchConfig, hidden: torch.Tensor,
              labels: torch.Tensor, key: K.Key, noise=None, mesh=None,
              dims=None):
    """The NLL of ``labels`` under one weight-space draw of the head, the
    tail every family's ``nll_loss`` shares: w = mu + softplus(rho)·eps,
    eps of mu's shape from ``noise(key, shape, device)`` (default
    ``keys.normal``; tests inject the JAX package's draw), and logits =
    hidden @ w cast to the body's dtype, accumulated and returned in
    float32, soft-capped where ``cfg.logits_softcap`` is set; the head is
    in its training form ``{"mu", "rho"}``.  Returns (nll,
    {"accuracy"}), both 0-d float32.

    Under a train ``mesh`` (``dims``: the parameters' specs) the head is
    vocabulary-parallel.  The eps of the whole head is drawn as the
    unsharded loss draws it (a (d, V) float32 tensor, 0.93 GB at
    qwen2-1.5B's width on every rank) and the rank keeps its block, so
    every weight is the one the unsharded draw gives; w on the block is
    gathered over ``data``.  The head shards its vocabulary on ("data",
    "model"), so once gathered model rank m holds blocks m, M + m, ...
    of V / (D·M) ids each (``_vocab_parallel``).  A vocabulary that D·M
    does not divide (seamless-m4t-medium's 256206 at D·M = 4) stays
    whole, as the JAX rules replicate it: every model rank then computes
    the whole logits of the data rank's rows (the S-sharded stream
    gathered, each rank keeping its slice of the gradient), so the
    head's gradient is whole on every model rank.  The value is this
    data rank's NLL sum over the GLOBAL count of valid tokens (the data
    ranks' values sum to the unsharded mean); the accuracy is the global
    one."""
    mu, rho = params["head"]["mu"], params["head"]["rho"]
    shape, split = tuple(mu.shape), False
    if mesh is not None:
        spec = dims["head"]["mu"]
        shape = P.full_shape(mu, spec, mesh)
        split = "model" in P.spec_axes(spec)
    eps = (noise or K.normal)(key, shape, mu.device)
    if mesh is not None:
        eps = P.shard_leaf(eps, spec, mesh)
    w = mu + F.softplus(rho) * eps
    del eps
    if mesh is not None:
        w = L.gathered({"w": w}, {"w": spec}, mesh)["w"]
        sp = seq_parallel(cfg, mesh, labels.shape[1])
        if split:
            hidden = L.enter(hidden, mesh, sp)
        elif sp:
            hidden = C.gather(hidden, mesh.model, 1, grad="split")
    # bf16 operands, float32 products and output: the reference's
    # preferred_element_type=f32 (a bf16 matmul would round its output)
    logits = hidden.float() @ w.to(hidden.dtype).float()
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    labels = labels.long()
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels))
    if not split or mesh.model.size == 1:
        logp = torch.log_softmax(logits.float(), dim=-1)
        # gather, not nll_loss: its backward has a deterministic CUDA form
        tok_nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
        pred = logits.argmax(-1)
    else:
        tok_nll, pred = _vocab_parallel(logits, lab, cfg.vocab_size, mesh)
    tok_nll = torch.where(valid, tok_nll, torch.zeros_like(tok_nll))
    count, hits = valid.sum(), ((pred == labels) & valid).sum()
    if mesh is not None:
        count, hits = (C.all_reduce(t, mesh.data) for t in (count, hits))
    count = torch.clamp(count, min=1).float()
    return tok_nll.sum() / count, {"accuracy": hits.float() / count}


def _vocab_parallel(logits: torch.Tensor, lab: torch.Tensor, V: int, mesh):
    """(-log softmax at ``lab``, argmax) of the logits the model ranks
    hold in column blocks (``head_loss``): the log-softmax from the
    all-reduced max and sum of exponentials, the target's logit from the
    rank that holds it, and the argmax over the ranks (the first of
    equal maxima, as ``argmax``)."""
    m, j = mesh.model.size, mesh.model.index
    n = V // (mesh.data.size * m)              # ids a block
    gmax = C.all_reduce(logits.detach().amax(-1), mesh.model,
                        op=torch.distributed.ReduceOp.MAX)
    sumexp = C.reduce(torch.exp(logits - gmax[..., None]).sum(-1),
                      mesh.model)
    mine = (lab // n) % m == j
    pos = torch.where(mine, lab // n // m * n + lab % n,
                      torch.zeros_like(lab))
    tl = torch.gather(logits, -1, pos[..., None])[..., 0]
    tl = C.reduce(torch.where(mine, tl, torch.zeros_like(tl)), mesh.model)
    val, idx = logits.detach().max(-1)
    vals = C.all_gather(val[None], mesh.model, 0)
    ids = C.all_gather(((idx // n * m + j) * n + idx % n)[None], mesh.model,
                       0)
    best = vals.max(0).values
    pred = torch.where(vals == best, ids, V).min(0).values
    return gmax + torch.log(sumexp) - tl, pred


# the leaves whose products the model axis must split (Megatron's column-
# and row-parallel weights; the embedding and the head may stay whole)
_MODEL_SPLIT = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "bq", "bk", "bv")


def check_sharded(cfg: ArchConfig, dims: dict, mesh,
                  names: tuple = _MODEL_SPLIT) -> None:
    """Raise NotImplementedError where ``dims`` (``train_dims``) leaves a
    leaf named in ``names`` whole over ``model`` while the sharded
    forward splits its product there: a width that does not divide the
    model ranks (the JAX package replicates such a leaf).  The embedding
    and the head may stay whole (``embed``, ``head_loss``)."""
    if mesh.model.size == 1:
        return
    for path, spec in T.items(dims):
        if path.rsplit("/", 1)[-1] in names \
                and "model" not in P.spec_axes(spec):
            raise NotImplementedError(
                f"{cfg.name} at {mesh.describe()}: {path} does not shard "
                "over model (its width does not divide the mesh); the "
                "sharded train step needs it split")


def model_partial(cfg: ArchConfig, dims: dict, mesh, S: int,
                  also=()) -> dict:
    """For each leaf, whether a model rank's gradient of it is only its
    share: under the sequence-parallel stream every leaf the model axis
    does not split (the norms) sees only the rank's positions, but for
    the embedding and the head, which see every position on every model
    rank whether split or whole.  (A leaf split over ``model`` gets its
    whole gradient on its rank; without the S-sharded stream every model
    rank sees every position.)  A path ending in one of ``also`` is
    partial whatever the stream: a family's replicated leaf that each
    model rank uses only a share of (the moe router, the Mamba2 gate
    norm)."""
    sp = seq_parallel(cfg, mesh, S)

    def one(path, spec):
        if path.endswith(also):
            return True
        return sp and "model" not in P.spec_axes(spec) \
            and not path.startswith(("head/", "embed/"))

    return T.unflatten(dims, [one(p, s) for p, s in T.items(dims)])


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
            prefix_embeds: torch.Tensor | None = None, tp=None):
    """Run the full prompt (its first positions ``prefix_embeds``, if
    given); returns (hidden_last, cache) with (L, B, max_len, Hkv, hd)
    strips and ``len`` = prompt length."""
    hidden, (k, v) = forward(params, cfg, tokens, prefix_embeds,
                             return_kv=True, tp=tp)
    B, S = tokens.shape
    pad = (0, 0, 0, 0, 0, max_len - S)
    cache = {"k": torch.nn.functional.pad(k, pad),
             "v": torch.nn.functional.pad(v, pad),
             "len": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)}
    return hidden[:, -1], cache


def prefill_suffix(params, cfg: ArchConfig, tokens: torch.Tensor,
                   prefix_kv: dict, prefix_len: int, tp=None):
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
            prefix_len=prefix_len, rot=rot, tp=tp)
        x = x + h
        x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]), tp)
        ks.append(k)
        vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lens = torch.full((B,), prefix_len + S, dtype=torch.int32,
                      device=tokens.device)
    return x[:, -1], {"k": torch.stack(ks), "v": torch.stack(vs),
                      "len": lens}


def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                  slot: int, offset: int, new_len: int, span: int,
                  tp=None) -> dict:
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
            offset=offset, span=span, rot=rot, kv_index=kv_index, tp=tp)
        x = x + h
        x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]), tp)
    cache["len"][slot].fill_(new_len)  # item assignment would sync the host
    return cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_hidden(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                  tp=None):
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
            block_table=table, kv_index=kv_index, tp=tp)
        x = x + h
        x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]), tp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    lens.add_(1)
    return x[:, 0], cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                key: tuple, head_noise=None, tp=None):
    """One uncertain decode step: (outputs, cache) with outputs =
    {next_token, H, SE, MI, p_max} per slot from ``cfg.mc_samples`` LRT
    head draws (``uncertain_head``); ``key`` is (seed, step) or (seed,
    step, offset) of the head stream."""
    lens0 = cache["len"].clone()        # the body advances len in place
    hidden, cache = decode_hidden(params, cfg, token, cache, tp)
    return U.head_outputs(params, cfg, hidden, lens0, key,
                          head_noise=head_noise, tp=tp), cache
