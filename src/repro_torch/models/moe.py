"""Mixture-of-Experts transformer (deepseek-moe-16b, grok-1-314b): serving
and training.

PyTorch counterpart of ``repro.models.moe``.  Routing is softmax top-k
with capacity dispatch: a (token, k) assignment's queue position in its
expert comes from a cumsum over the flat (T·K, E) routing one-hot (no
sort; in int32, whose CUDA cumsum is deterministic where the float one
is not, and exact as the reference's f32 counts are), kept assignments
are scattered into an (E, C + 1, d) buffer whose last bin C takes every
dropped one, the experts run as one batched gated MLP over ``[:, :C]``,
and the combine weights gather the results back (GShard semantics:
capacity overflow drops the assignment).  The
shared experts (DeepSeekMoE) see every token.

The dispatch runs in ``groups`` G (the JAX package's ``_dispatch_groups``,
1 without a mesh: serving and the unsharded step): the B·S tokens split
B-major into G groups of Tg, each routed against its own capacity C =
max(⌊Tg·K / E · capacity_factor⌋, 8), and the aux loss is the mean over
the groups.  Under a tensor-parallel serving mesh the experts, the router
and the shared experts replicate (the serve rules), so every rank runs
the whole dispatch; only the attention and the head take ``tp``.  Every
step
is a fixed-shape tensor op with integer indices — no boolean-mask
indexing, no one-hot of unknown width, no host read — so a decode step
captures in a CUDA graph.  Inactive
decode slots are dispatched too, as in the reference: they take capacity
like any token.

Blocks are stacked on a leading layer axis with the reference's names:
``router.w`` (f32), ``experts_ep`` or ``experts_tp`` (by
``cfg.expert_sharding``; ``w1``, ``w3``, ``w2``) and ``shared``.

Training (``forward``, ``nll_loss``) runs the same dispatch under
autograd: the gradient reaches the router through the renormalised
top-k gates and the Switch aux loss only (the routing itself is
discrete), and the capacity is computed per dispatch, so a micro-batch
routes against its own capacity, as in the reference.

Under a train mesh (``mesh=, dims=``; ``launch.mesh.TrainMesh``) the JAX
rule table decides the layout.  Its first matching rule gives
``experts_ep``'s and ``experts_tp``'s w1 / w3 / w2, and ``shared``'s, the
dense MLP's spec (ff over ``model``, d FSDP over ``data``): the rules'
expert lines (E over ``model`` for ``experts_ep``) come after the
``(w1|w3)$`` and ``w2$`` lines and never match, in the JAX package too.
So both layouts run Megatron over every expert's ff: each data rank is
one dispatch group over its own rows; every model rank routes the data
rank's whole token set (the stream enters through ``layers.enter``,
gathered along S under grok's sequence-parallel stream), scatters it
into its own buffer, runs all E experts on its ff columns and combines
its partial outputs, the shared experts' too, into a partial y that
``layers.leave`` sums over ``model``.  The router and the aux loss are
computed identically on every model rank, while the combine's gradient
reaches ``router/w`` and the stream as model-partial sums: the aux
term's gradient is scaled by 1/M (``_grad_scaled``) so that the sums
over ``model`` count it once, and ``model_partial`` marks ``router/w``.
A data rank's share of the loss carries aux_weight · aux_d / D, so the
data ranks' shares sum to the JAX value (the mean over the D groups);
the reported ``aux_loss`` is that global mean.  The sharded step is held
to the unsharded step with ``groups=D``: capacity per group is a
different function from capacity over the whole batch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import uncertain_head as U
from repro_torch.sharding import collectives as C

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_experts(gen, cfg: ArchConfig, num: int, d_ff: int, device):
    """(L, num, ...) expert stacks of N(0, 1) / sqrt(fan_in), drawn in f32
    one layer at a time: a whole stacked f32 leaf at deepseek's width is
    20.7 GB beside the bf16 parameters being built."""
    dt = L.dtype_of(cfg)
    d, n_layers = cfg.d_model, cfg.num_layers

    def stack(shape, fan):
        out = torch.empty((n_layers, num, *shape), dtype=dt, device=device)
        for i in range(n_layers):
            w = torch.randn((num, *shape), generator=gen,
                            dtype=torch.float32, device=device)
            out[i] = w / math.sqrt(float(fan))
        return out

    return {"w1": stack((d, d_ff), d), "w3": stack((d, d_ff), d),
            "w2": stack((d_ff, d), d_ff)}


def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                train: bool = False):
    """Random serving parameters with the JAX package's distributions: the
    dense transformer's attention, norms, embedding and head, a router of
    N(0, 1) · 0.02 in f32, and experts of N(0, 1) / sqrt(fan_in); with
    ``train`` the head in its training form ``{"mu", "rho"}``."""
    dt = L.dtype_of(cfg)
    lead = (cfg.num_layers,)
    ones = dict(dtype=dt, device=device)
    eff = cfg.moe_d_ff or cfg.d_ff
    ename = "experts_ep" if cfg.expert_sharding == "ep" else "experts_tp"
    blocks = {
        "ln1": torch.ones((*lead, cfg.d_model), **ones),
        "attn": L.init_attention(gen, cfg, device, lead),
        "ln2": torch.ones((*lead, cfg.d_model), **ones),
        "router": {"w": torch.randn((*lead, cfg.d_model, cfg.num_experts),
                                    generator=gen, dtype=torch.float32,
                                    device=device) * 0.02},
        ename: _init_experts(gen, cfg, cfg.num_experts, eff, device),
    }
    if cfg.num_shared_experts:
        blocks["shared"] = _init_experts(gen, cfg, cfg.num_shared_experts,
                                         eff, device)
    return {
        "embed": L.init_embed(gen, cfg, device),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), **ones),
        "head": L.init_head(gen, cfg, device, train=train),
    }


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------

def _expert_ffn(ep, x: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d), the gated MLP of each expert over its
    rows (SiLU whatever ``cfg.mlp_activation`` says, as in the reference);
    outputs in the activation dtype, f32 accumulation inside the GEMMs."""
    g = torch.matmul(x, ep["w1"])
    u = torch.matmul(x, ep["w3"])
    return torch.matmul(F.silu(g) * u, ep["w2"])


def route(bp, cfg: ArchConfig, xt: torch.Tensor, capacity: int,
          expert_offsets: Optional[torch.Tensor] = None) -> dict:
    """The routing of tokens xt (..., T, d) against capacity C, each
    leading index a dispatch group of its own: renormalised top-k gates
    ``topv`` and experts ``topi`` (..., T, K), each assignment's queue
    position ``pos`` in its expert within its group and whether it is
    kept (``keep``), the (..., E) assignment ``counts`` (dropped ones
    included) and the aux loss of each group (...,).  With
    ``expert_offsets`` (E,) the global position ``pos +
    expert_offsets[topi]`` decides ``keep``; ``pos`` stays local."""
    lead, T = xt.shape[:-2], xt.shape[-2]
    E, K = cfg.num_experts, cfg.top_k
    gates = torch.softmax(xt.float() @ bp["router"]["w"], dim=-1)  # (T, E)
    topv, topi = torch.topk(gates, K, dim=-1)                  # (T, K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e.  The one-hot
    # by comparison: F.one_hot reads the indices' range on the host
    experts = torch.arange(E, device=xt.device)
    onehot = (topi[..., None] == experts).float()              # (T, K, E)
    aux = E * torch.sum(onehot.sum(-2).mean(-2) * gates.mean(-2), dim=-1)

    # position of each (token, k) in its expert's queue: counts are small
    # integers, exact in f32; the cumsum runs in int32, which has a
    # deterministic CUDA form (the float one refuses the deterministic mode)
    oh_flat = onehot.reshape(*lead, T * K, E)
    oh_int = oh_flat.to(torch.int32)
    pos = torch.sum((torch.cumsum(oh_int, dim=-2, dtype=torch.int32) - 1)
                    * oh_int, dim=-1).reshape(*lead, T, K).float()
    if expert_offsets is None:
        keep = pos < capacity
    else:
        # the local position still indexes the buffer: it is < C wherever
        # keep holds, as offsets are >= 0
        keep = (pos + expert_offsets[topi]) < capacity
    return {"topv": topv, "topi": topi, "pos": pos, "keep": keep,
            "counts": oh_flat.sum(-2), "aux": aux}


def moe_ffn(bp, cfg: ArchConfig, x: torch.Tensor,
            expert_offsets: Optional[torch.Tensor] = None,
            capacity: Optional[int] = None, groups: int = 1):
    """x: (B, S, d) -> (y, aux_loss), top-k capacity dispatch in
    ``groups`` groups (the module docstring).

    The expert weights may be a model rank's ff columns (w1 / w3) and
    rows (w2), as under a train mesh: y is then the rank's partial sum,
    the combine being linear in the experts' outputs.

    ``expert_offsets`` (E,) f32 and ``capacity`` serve chunked prefill
    (one group):
    each expert's running assignment count, threaded across the prompt's
    chunks by the caller, is added to a token's local queue position, so
    its keep/drop decision is made against its place in the whole
    prompt, with C pinned to what the whole prompt computes.  The return
    then gains the updated offsets (the counts include dropped
    assignments, as the batch cumsum does)."""
    B, S, d = x.shape
    Tn = B * S
    E, K, G = cfg.num_experts, cfg.top_k, groups
    if Tn % G or (G > 1 and expert_offsets is not None):
        raise ValueError(f"{Tn} tokens do not split into {G} dispatch "
                         "groups (chunked prefill takes one)")
    Tg = Tn // G
    C = capacity if capacity is not None else \
        max(int(Tg * K / E * cfg.capacity_factor), 8)
    xt = x.reshape(Tn, d)                                      # B-major
    r = route(bp, cfg, xt if G == 1 else xt.reshape(G, Tg, d), C,
              expert_offsets)

    # flat bin (g * E + e) * (C + 1) + c; every dropped assignment lands in
    # its group's bin C of its expert, and kept (g, e, c) triples are
    # unique, so the add writes each kept bin once
    cid = torch.where(r["keep"], r["pos"], float(C)).long()
    flat = r["topi"] * (C + 1) + cid
    if G > 1:
        flat = flat + torch.arange(G, device=x.device)[:, None, None] \
            * (E * (C + 1))
    flat = flat.reshape(Tn * K)
    tok_rep = xt[:, None, :].expand(Tn, K, d).reshape(Tn * K, d)
    buf = torch.zeros((G * E * (C + 1), d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, flat, tok_rep)
    ep = bp["experts_ep"] if "experts_ep" in bp else bp["experts_tp"]
    shape = (E, C + 1, d) if G == 1 else (G, E, C + 1, d)
    out = _expert_ffn(ep, buf.reshape(shape)[..., :C, :])
    out = F.pad(out, (0, 0, 0, 1)).reshape(G * E * (C + 1), d)  # bin C: 0

    w = (r["topv"] * r["keep"]).to(x.dtype).reshape(Tn * K, 1)
    y = (out.index_select(0, flat) * w).reshape(Tn, K, d).sum(1)

    if cfg.num_shared_experts:
        sh = _expert_ffn(bp["shared"], xt[None].expand(
            cfg.num_shared_experts, Tn, d))
        y = y + sh.sum(0)
    y = y.reshape(B, S, d)
    aux = r["aux"] if G == 1 else r["aux"].mean()
    if expert_offsets is not None:
        return y, aux, expert_offsets + r["counts"]
    return y, aux


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _block_fwd(bp, cfg: ArchConfig, x, rot, mesh=None, spec=None,
               sp: bool = False, groups: int = 1):
    """A block; under a train ``mesh`` (``spec``: the layer's specs) the
    weights FSDP-gathered, the attention Megatron as the dense block's,
    and the MoE on the rank's ff columns of every expert, its partial y
    leaving through ``layers.leave`` (``sp``: the S-sharded stream)."""
    tp = None
    if mesh is not None:
        bp, tp = L.gathered(bp, spec, mesh), mesh.model
    h, _ = L.apply_attention(bp["attn"], cfg,
                             L.enter(L.rms_norm(x, bp["ln1"]), mesh, sp),
                             rot=rot, tp=tp)
    x = x + L.leave(h, mesh, sp)
    y, aux = moe_ffn(bp, cfg, L.enter(L.rms_norm(x, bp["ln2"]), mesh, sp),
                     groups=groups)
    return x + L.leave(y, mesh, sp), aux


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, mesh=None,
            dims=None, groups: int = 1):
    """tokens: (B, S) -> (hidden (B, S, d), aux): the mean over layers of
    the Switch aux loss, each layer's dispatched in ``groups`` groups.
    Layers come from ``transformer.unstacked``; with ``cfg.remat`` under
    autograd each is recomputed in the backward pass
    (``transformer.rematted``).  Under a train ``mesh`` the tokens are
    the data rank's rows, one dispatch group, and the hidden state is
    (b, S / M, d) where ``transformer.seq_parallel``, else (b, S, d);
    the aux is this data rank's group's."""
    x = T.embed(params, tokens, mesh, dims)
    sp = T.seq_parallel(cfg, mesh, tokens.shape[1])
    spec = None
    if mesh is not None:
        spec = T.layer_specs(dims["blocks"])
        if sp:
            x = C.split(x, mesh.model, 1)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    remat = T.remats(cfg)
    auxes = []
    for bp in T.unstacked(params["blocks"]):
        def fwd(xx, bp=bp):
            return _block_fwd(bp, cfg, xx, rot, mesh, spec, sp, groups)
        x, aux = T.rematted(fwd, x) if remat else fwd(x)
        auxes.append(aux)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.stack(auxes).mean()


def _grad_scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x``'s value with its gradient scaled by ``s`` (the difference
    ``x - x.detach()`` is exactly 0)."""
    return x.detach() + (x - x.detach()) * s


def nll_loss(params, cfg: ArchConfig, batch: dict, key, noise=None,
             aux_weight: float = 0.01, mesh=None, dims=None,
             groups: int = 1):
    """The mean next-token NLL with one weight-space draw of the head
    (``transformer.head_loss``, soft-capped for grok) plus ``aux_weight``
    times the aux loss: ``(nll + aux_weight * aux, {"accuracy",
    "aux_loss"})``, as ``repro.models.moe.nll_loss`` (``groups``: its
    dispatch groups).  Under a train ``mesh`` the value is this data
    rank's share, aux_weight · aux_d / D with its gradient scaled by 1/M
    (the module docstring), and ``aux_loss`` the global mean."""
    hidden, aux = forward(params, cfg, batch["tokens"], mesh, dims, groups)
    nll, metrics = T.head_loss(params, cfg, hidden, batch["labels"], key,
                               noise, mesh=mesh, dims=dims)
    if mesh is None:
        return nll + aux_weight * aux, {**metrics, "aux_loss": aux}
    d = mesh.data.size
    share = _grad_scaled(aux / d, 1.0 / mesh.model.size)
    return nll + aux_weight * share, {
        **metrics, "aux_loss": C.all_reduce(aux.detach(), mesh.data) / d}


# the dense rule: the attention's and every expert's w1 / w3 / w2 split
# over ``model``
check_sharded = T.check_sharded


def model_partial(cfg: ArchConfig, dims: dict, mesh, S: int) -> dict:
    """The dense rule, and ``router/w`` partial whatever the stream: the
    combine's gradient reaches it through the rank's partial expert
    outputs."""
    return T.model_partial(cfg, dims, mesh, S, also=("router/w",))


# ---------------------------------------------------------------------------
# serving (decode with per-token MoE routing)
# ---------------------------------------------------------------------------

make_cache = T.make_cache  # the dense transformer's KV layouts


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, max_len: int,
            tp=None):
    """Run the full prompt; returns (hidden_last, cache) with (L, B,
    max_len, Hkv, hd) strips and ``len`` = prompt length.  All B prompts
    share one dispatch, as in the reference."""
    x = L.apply_embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        bp = T.layer(params["blocks"], i)
        h, (k, v) = L.apply_attention(bp["attn"], cfg,
                                      L.rms_norm(x, bp["ln1"]), rot=rot,
                                      tp=tp)
        x = x + h
        y, _ = moe_ffn(bp, cfg, L.rms_norm(x, bp["ln2"]))
        x = x + y
        ks.append(k)
        vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    pad = (0, 0, 0, 0, 0, max_len - S)
    cache = {"k": F.pad(torch.stack(ks), pad),
             "v": F.pad(torch.stack(vs), pad),
             "len": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)}
    return x[:, -1], cache


def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                  slot: int, offset: int, new_len: int, span: int,
                  expert_offsets: torch.Tensor, tp=None):
    """One chunk of an incremental prompt prefill for ``slot`` (see
    ``transformer.prefill_chunk``).

    ``expert_offsets``: (L, E) f32 per-layer running expert assignment
    counts, threaded by the engine across the prompt's chunks so that the
    capacity drops match the one batch dispatch bit for bit; the capacity
    is pinned to what the whole ``span``-token prompt computes.  Returns
    ``(cache, new_expert_offsets)``."""
    E, K = cfg.num_experts, cfg.top_k
    C = max(int(span * K / E * cfg.capacity_factor), 8)
    row = cache["block_table"][slot:slot + 1]
    x = L.apply_embed(params["embed"], tokens)
    S = tokens.shape[1]
    positions = offset + torch.arange(S, device=x.device)[None, :]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    at = torch.full((1,), offset, dtype=torch.int32, device=x.device)
    kv_index = L.paged_index(cache["k"].shape[1], cache["k"].shape[2], row,
                             at, S)
    offs = []
    for i in range(cfg.num_layers):
        bp = T.layer(params["blocks"], i)
        h, _ = L.apply_attention_chunk(
            bp["attn"], cfg, L.rms_norm(x, bp["ln1"]),
            kv_pools=(cache["k"][i], cache["v"][i]), block_row=row,
            offset=offset, span=span, rot=rot, kv_index=kv_index, tp=tp)
        x = x + h
        y, _, off = moe_ffn(bp, cfg, L.rms_norm(x, bp["ln2"]),
                            expert_offsets=expert_offsets[i], capacity=C)
        x = x + y
        offs.append(off)
    cache["len"][slot].fill_(new_len)  # item assignment would sync the host
    return cache, torch.stack(offs)


def decode_hidden(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                  tp=None):
    """The KV-writing decode body (see ``transformer.decode_hidden``):
    ``len`` advances by one IN PLACE."""
    x = L.apply_embed(params["embed"], token[:, None])
    lens = cache["len"]
    table = cache.get("block_table")
    rot = L.rope_tables(lens.reshape(-1, 1), cfg.head_dim, cfg.rope_theta)
    kv_index = None if table is None else L.paged_index(
        cache["k"].shape[1], cache["k"].shape[2], table, lens, 1)
    for i in range(cfg.num_layers):
        bp = T.layer(params["blocks"], i)
        h, _ = L.apply_attention(
            bp["attn"], cfg, L.rms_norm(x, bp["ln1"]), rot=rot,
            kv_cache=(cache["k"][i], cache["v"][i]), cache_len=lens,
            block_table=table, kv_index=kv_index, tp=tp)
        x = x + h
        y, _ = moe_ffn(bp, cfg, L.rms_norm(x, bp["ln2"]))
        x = x + y
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
