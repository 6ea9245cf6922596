"""Mamba2 state-space duality (SSD) blocks (mamba2-370m): serving and
training.

PyTorch counterpart of ``repro.models.ssm``.  Block: in_proj -> (z gate,
x, B, C, dt) -> causal depthwise conv on (x, B, C) -> SSD mixing -> gated
RMSNorm -> out_proj.  SSD with a scalar decay per head:

    h_t = exp(A * dt_t) h_{t-1} + dt_t * B_t (outer) x_t
    y_t = C_t . h_t + D * x_t

Prefill runs the chunked dual form (a masked intra-chunk product and a
recurrence over chunks); decode runs the O(1) recurrence.  Both are
plain PyTorch (einsums and elementwise ops): the JAX package computes
them in jnp too, outside any Pallas kernel.  Every reduction is f32.

The cache holds no KV strips: per layer an f32 SSM state (B, H, P, N)
and the conv tail (B, W - 1, d_in + 2N), stacked on a leading layer
axis.  A decode step writes both IN PLACE and advances ``len`` in
place, so a CUDA graph captured over the step replays on the cache's
fixed addresses.  Training (``forward``, ``nll_loss``) runs the chunked
form with no state given, so none of those in-place writes lies on the
autograd path.

Under a train mesh (``mesh=, dims=``) the blocks are head-parallel: the
JAX rules split ``A_log``, ``D``, ``dt_bias`` (H,) and ``out_proj``'s
rows (d_in = H·P) over ``model``, which align with the heads, but also
the columns of ``in_proj`` (2·d_in + 2N + H) and the channels of
``conv_w`` / ``conv_b`` (d_in + 2N) in equal blocks that cut across the
z | x | B | C | dt split (mamba2-370m at M 2: 4384 / 2 = 2192 columns a
rank, while z ends at 2048).  So a rank cannot compute its heads from its
own block: it gathers ``in_proj``, ``conv_w`` and ``conv_b`` over
``model`` at use (``layers.gathered_model``, the backward
reduce-scattering the gradient: the ranks use other ranks' columns, and
all of them use B and C), takes its H/M heads' z, x and dt and the whole
B and C, runs the SSD on its heads and leaves through ``out_proj``'s
rows (``layers.leave``).  The stream is replicated over ``model`` (the
JAX ssm has no sequence-parallel constraint).  The gate norm's RMS runs
over the whole d_in: each rank's sum of squares is all-reduced over
``model`` before it divides (forward and backward), and ``gate_ln``'s
gradient, the rank's slice of it, is model-partial.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import uncertain_head as U
from repro_torch.sharding.partition import spec_axes


def dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ArchConfig, device, lead=()):
    """SSD block parameters with the JAX package's names and
    distributions; ``lead`` prepends a stacking shape (layers)."""
    d = cfg.d_model
    d_in, H, P, N = dims(cfg)
    dt = L.dtype_of(cfg)
    W = cfg.ssm_conv_width
    proj_out = 2 * d_in + 2 * N + H          # z, x, B, C, dt (one group)
    conv_ch = d_in + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "ln": torch.ones((*lead, d), dtype=dt, device=device),
        "in_proj": L.he_init(gen, (*lead, d, proj_out), d, dt, device),
        "conv_w": L.he_init(gen, (*lead, W, conv_ch), W, dt, device),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dt, device=device),
        "A_log": a_log.expand(*lead, H).clone(),
        "D": torch.ones((*lead, H), **f32),
        "dt_bias": torch.full((*lead, H), -2.0, **f32),  # softplus^-1(~0.12)
        "gate_ln": torch.ones((*lead, d_in), dtype=dt, device=device),
        "out_proj": L.he_init(gen, (*lead, d_in, d), d_in, dt, device),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                train: bool = False):
    """Random serving parameters: blocks stacked on a leading L axis, the
    embedding and the Bayesian head as in the dense transformer (with
    ``train``, in its training form ``{"mu", "rho"}``)."""
    return {"embed": L.init_embed(gen, cfg, device),
            "blocks": init_block(gen, cfg, device, (cfg.num_layers,)),
            "final_norm": torch.ones((cfg.d_model,), dtype=L.dtype_of(cfg),
                                     device=device),
            "head": L.init_head(gen, cfg, device, train=train)}


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def chunk_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The cumsum of x (B, nc, Q, H) over its chunk axis.  Under the
    deterministic mode (the train step turns it on on CUDA, where PyTorch
    has no deterministic float cumsum) it is a product with the
    lower-triangular ones, a deterministic GEMM; otherwise
    ``torch.cumsum``, whose sequential sums are those of the reference's
    cumsum on the CPU."""
    if not torch.are_deterministic_algorithms_enabled():
        return torch.cumsum(x, dim=2)
    Q = x.shape[2]
    tri = torch.tril(torch.ones((Q, Q), dtype=x.dtype, device=x.device))
    return torch.einsum("ij,bcjh->bcih", tri, x)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H); A: (H,) negative; Bm/Cm: (B, S, N);
    D: (H,).  Returns (y (B, S, H, P) in x's dtype, h_final (B, H, P, N)
    f32).  Q is always ``chunk``: a sequence shorter than a chunk pads up
    like the tail chunk of a longer one, with dt = 0 (exact zeros) on the
    padded rows, so every S decomposes into the same per-chunk reductions.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // Q
    xc = x.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()

    loga = dtc * A[None, None, None, :]               # (B,nc,Q,H) negative
    cum = chunk_cumsum(loga)                          # within-chunk cumsum
    total = cum[:, :, -1:]                            # (B,nc,1,H)

    # intra-chunk: y[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j.
    # Above the diagonal cum_i - cum_j > 0 can overflow exp, so the mask
    # goes in as -inf BEFORE exp (exp(dec) * 0 would turn inf into NaN)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B,nc,Q,Q)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    dec = torch.where(mask[None, None, :, :, None], dec, -math.inf)
    w = scores[..., None] * torch.exp(dec)            # (B,nc,Q,Q,H)
    xdt = xc * dtc[..., None]                         # (B,nc,Q,H,P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xdt)

    # chunk states: S_c = sum_j exp(total - cum_j) dt_j B_j (x) x_j
    sdec = torch.exp(total - cum)                     # (B,nc,Q,H)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", sdec * dtc, Bc, xc)

    # inter-chunk recurrence: H_c = exp(total_c) H_{c-1} + S_c; chunk c
    # reads the state BEFORE it (h0 for the first)
    decay_c = torch.exp(total[:, :, 0])               # (B,nc,H)
    h = h0 if h0 is not None else torch.zeros((Bsz, H, P, N),
                                              dtype=torch.float32,
                                              device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * decay_c[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)               # (B,nc,H,P,N)

    # inter contribution: y[i] += C_i . (exp(cum_i) * H_{c-1})
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, h_prev,
                           torch.exp(cum))
    y = y_intra + y_inter + D[None, None, None, :, None] * xc
    y = y.reshape(Bsz, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_step(h, x, dt, A, Bm, Cm, D):
    """One-token recurrence.  h: (B, H, P, N) f32; x: (B, H, P); dt:
    (B, H) f32; Bm/Cm: (B, N) f32.  ``D * x`` promotes to f32; y returns
    in x's dtype."""
    a = torch.exp(dt * A[None, :])                    # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, x.float())
    h = h * a[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, h) + D[None, :, None] * x
    return h, y.to(x.dtype)


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def _causal_conv(u, w, b):
    """u: (B, S, C); w: (W, C) depthwise causal; left-pad W - 1.  The W
    shifted products add in the reference's order, 0 + t0 + t1 + ..., in
    the parameter dtype."""
    W = w.shape[0]
    S = u.shape[1]
    up = F.pad(u, (0, 0, W - 1, 0))
    out = sum(up[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out + b)


def _own(w: torch.Tensor, parts: tuple, m: int, M: int) -> torch.Tensor:
    """Model rank m's columns of ``w``'s last axis, laid out as ``parts``
    (width, split): a part that is split gives the rank its m-th of M
    blocks, the others come whole; ``w`` itself where M is 1."""
    if M == 1:
        return w
    out, at = [], 0
    for width, split in parts:
        c = width // M if split else width
        out.append(w[..., at + m * c:at + (m + 1) * c] if split
                   else w[..., at:at + width])
        at += width
    return torch.cat(out, dim=-1)


def apply_block(bp, cfg: ArchConfig, x: torch.Tensor,
                ssm_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                force_chunked: bool = False, mesh=None, spec=None):
    """x: (B, S, d) -> (x + out, h_last, new_conv_state).

    Three modes: prefill (no state); decode (states given, S == 1: the
    O(1) ``ssd_step``); the chunked form threading ``ssm_state`` as h0
    (states given with S > 1, or ``force_chunked``, which keeps an S == 1
    input on ``ssd_chunked``: the two associate their f32 reductions
    differently, and a chunked prefill whose tail chunk is one token must
    match the batch prefill's decomposition).  Returns new tensors; the
    caller writes the cache.

    Under a train ``mesh`` (no state; ``spec``: the layer's specs) the
    block is head-parallel over ``model`` (the module docstring): x is
    whole on every model rank, the rank runs its H/M heads and returns
    x + out summed over ``model``; h_last and the conv tail are its
    heads' and channels'.  Without one every seam is the identity."""
    d_in, H, P, N = dims(cfg)
    W = cfg.ssm_conv_width
    m, M = (0, 1) if mesh is None else (mesh.model.index, mesh.model.size)
    h, c = H // M, d_in // M                  # heads and channels a rank
    if mesh is not None:
        bp = L.gathered(bp, spec, mesh)
        bp = {**bp, **{k: L.gathered_model(bp[k], spec[k], mesh)
                       for k in ("in_proj", "conv_w", "conv_b")}}
    # the rank's columns: z and x of its heads, all of B and C, its dt
    w_in = _own(bp["in_proj"], ((d_in, True), (d_in, True), (2 * N, False),
                                (H, True)), m, M)
    conv_w, conv_b = (_own(bp[k], ((d_in, True), (2 * N, False)), m, M)
                      for k in ("conv_w", "conv_b"))
    u = L.enter(L.rms_norm(x, bp["ln"], cfg.norm_eps), mesh, False)
    proj = L._mm(u, w_in)
    # x, B and C lie side by side in proj: their concatenation is a view
    z, conv_in, dtp = torch.split(proj, [c, c + 2 * N, h], dim=-1)

    if conv_state is None:
        conv = _causal_conv(conv_in, conv_w, conv_b)
        new_conv_state = conv_in[:, -(W - 1):]
    else:
        # decode: prepend the cached inputs
        full = torch.cat([conv_state, conv_in], dim=1)
        conv = _causal_conv(full, conv_w, conv_b)
        conv = conv[:, conv_state.shape[1]:]
        new_conv_state = full[:, -(W - 1):]

    xr, B_, C_ = torch.split(conv, [c, N, N], dim=-1)
    Bsz, S = x.shape[0], x.shape[1]
    xh = xr.reshape(Bsz, S, h, P)
    # torch's softplus returns its input above threshold 20 where jax's
    # computes log1p(exp(x)); the two differ by < 1e-8 there, and dt_bias
    # -2 keeps the served values far below it
    dt = F.softplus(dtp.float() + bp["dt_bias"])
    A = -torch.exp(bp["A_log"])

    if ssm_state is None:
        y, h_last = ssd_chunked(xh, dt, A, B_, C_, bp["D"], cfg.ssm_chunk)
    elif S == 1 and not force_chunked:
        h_last, y1 = ssd_step(ssm_state, xh[:, 0], dt[:, 0], A,
                              B_[:, 0].float(), C_[:, 0].float(), bp["D"])
        y = y1[:, None]
    else:
        y, h_last = ssd_chunked(xh, dt, A, B_, C_, bp["D"], cfg.ssm_chunk,
                                h0=ssm_state)
    y = y.reshape(Bsz, S, c)
    # the gated RMSNorm over the whole d_in: under a mesh the ranks' sums
    # of squares all-reduced forward and backward
    y = L.rms_norm(y * F.silu(z), bp["gate_ln"][m * c:(m + 1) * c],
                   cfg.norm_eps, None if mesh is None else mesh.model)
    out = L.leave(L._mm(y, bp["out_proj"]), mesh, False)
    return x + out, h_last, new_conv_state


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, tokens: torch.Tensor, mesh=None,
            dims=None) -> torch.Tensor:
    """tokens: (B, S) -> hidden (B, S, d): every block in its chunked
    form from a zero state (``apply_block`` with no state), layers from
    ``transformer.unstacked``, each recomputed in the backward pass under
    ``cfg.remat`` (``transformer.rematted``).  Under a train ``mesh`` the
    tokens are the data rank's rows and each block head-parallel."""
    x = T.embed(params, tokens, mesh, dims)
    spec = None if mesh is None else T.layer_specs(dims["blocks"])
    remat = T.remats(cfg)
    for bp in T.unstacked(params["blocks"]):
        def fwd(xx, bp=bp):
            return apply_block(bp, cfg, xx, mesh=mesh, spec=spec)[0]
        x = T.rematted(fwd, x) if remat else fwd(x)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def nll_loss(params, cfg: ArchConfig, batch: dict, key, noise=None,
             mesh=None, dims=None):
    """Mean next-token NLL with one weight-space draw of the head
    (``transformer.head_loss``): ``(nll, {"accuracy"})``, as
    ``repro.models.ssm.nll_loss``; under a train ``mesh`` this data
    rank's share."""
    hidden = forward(params, cfg, batch["tokens"], mesh, dims)
    return T.head_loss(params, cfg, hidden, batch["labels"], key, noise,
                       mesh=mesh, dims=dims)


# the leaves the head-parallel block needs split over ``model``
SHARDED_NAMES = ("A_log", "D", "dt_bias", "out_proj")
# the replicated leaves a model rank holds only a share of the gradient of
# (in_proj / conv where the rules leave them whole: no gather's backward
# sums them)
_PARTIAL = ("gate_ln", "in_proj", "conv_w", "conv_b")


def check_sharded(cfg: ArchConfig, dims: dict, mesh) -> None:
    """Raise NotImplementedError where the model ranks do not divide the
    SSM heads (``SHARDED_NAMES`` left whole by the rules)."""
    T.check_sharded(cfg, dims, mesh, SHARDED_NAMES)


def model_partial(cfg: ArchConfig, dims: dict, mesh, S: int) -> dict:
    """``gate_ln`` (each rank's gate-norm slice), and ``in_proj`` /
    ``conv_w`` / ``conv_b`` where their spec leaves them whole; nothing
    else (the stream is whole on every model rank)."""
    def one(path, spec):
        name = path.rsplit("/", 1)[-1]
        return name == "gate_ln" or (
            name in _PARTIAL and "model" not in spec_axes(spec))

    return tree.unflatten(dims, [one(p, s) for p, s in tree.items(dims)])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_cache(cfg: ArchConfig, batch: int, max_len: int, *, device,
               dtype=None):
    """Recurrent cache, O(1) in context: per layer the SSM state (f32)
    and the conv tail (parameter dtype), plus ``len``.  No KV strips, so
    there is no paged layout (``registry.supports_paged`` is False)."""
    d_in, H, P, N = dims(cfg)
    dt = dtype or L.dtype_of(cfg)
    Lh = cfg.num_layers
    return {
        "ssm": torch.zeros((Lh, batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((Lh, batch, cfg.ssm_conv_width - 1, d_in + 2 * N),
                            dtype=dt, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, max_len: int,
            tp=None):
    """Run the full prompt (its exact length: recurrent state would fold
    in pad tokens); returns (hidden_last, cache) with ``len`` = prompt
    length.  ``max_len`` is unused: the state does not grow; so is ``tp``:
    no leaf of the ssm body shards under a serving mesh (the head does,
    in ``decode_step``)."""
    x = L.apply_embed(params["embed"], tokens)
    hs, cs = [], []
    for i in range(cfg.num_layers):
        x, h, c = apply_block(T.layer(params["blocks"], i), cfg, x)
        hs.append(h)
        cs.append(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    B, S = tokens.shape
    cache = {"ssm": torch.stack(hs), "conv": torch.stack(cs),
             "len": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)}
    return x[:, -1], cache


def decode_hidden(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                  tp=None):
    """The state-advancing decode body: pure recurrence, no KV strips.
    Writes each layer's SSM state and conv tail IN PLACE and advances
    ``len`` by one in place; returns ``(hidden (B, d), cache)``.  ``tp``
    is unused (see ``prefill``)."""
    x = L.apply_embed(params["embed"], token[:, None])
    for i in range(cfg.num_layers):
        x, h, c = apply_block(T.layer(params["blocks"], i), cfg, x,
                              ssm_state=cache["ssm"][i],
                              conv_state=cache["conv"][i])
        cache["ssm"][i].copy_(h)
        cache["conv"][i].copy_(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["len"].add_(1)
    return x[:, 0], cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: dict,
                key: tuple, head_noise=None, tp=None):
    """One uncertain decode step (see ``transformer.decode_step``)."""
    lens0 = cache["len"].clone()        # the body advances len in place
    hidden, cache = decode_hidden(params, cfg, token, cache)
    return U.head_outputs(params, cfg, hidden, lens0, key,
                          head_noise=head_noise, tp=tp), cache
