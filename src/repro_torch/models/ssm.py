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

def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    """(z, x, B, C, dt) views of in_proj's output."""
    d_in, H, P, N = dims(cfg)
    return torch.split(proj, [d_in, d_in, N, N, H], dim=-1)


def _causal_conv(u, w, b):
    """u: (B, S, C); w: (W, C) depthwise causal; left-pad W - 1.  The W
    shifted products add in the reference's order, 0 + t0 + t1 + ..., in
    the parameter dtype."""
    W = w.shape[0]
    S = u.shape[1]
    up = F.pad(u, (0, 0, W - 1, 0))
    out = sum(up[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out + b)


def apply_block(bp, cfg: ArchConfig, x: torch.Tensor,
                ssm_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                force_chunked: bool = False):
    """x: (B, S, d) -> (x + out, h_last, new_conv_state).

    Three modes: prefill (no state); decode (states given, S == 1: the
    O(1) ``ssd_step``); the chunked form threading ``ssm_state`` as h0
    (states given with S > 1, or ``force_chunked``, which keeps an S == 1
    input on ``ssd_chunked``: the two associate their f32 reductions
    differently, and a chunked prefill whose tail chunk is one token must
    match the batch prefill's decomposition).  Returns new tensors; the
    caller writes the cache."""
    d_in, H, P, N = dims(cfg)
    W = cfg.ssm_conv_width
    u = L.rms_norm(x, bp["ln"], cfg.norm_eps)
    proj = L._mm(u, bp["in_proj"])
    z, _, _, _, dtp = _split_proj(cfg, proj)
    # x, B and C lie side by side in proj: their concatenation is a view
    conv_in = proj[..., d_in:2 * d_in + 2 * N]

    if conv_state is None:
        conv = _causal_conv(conv_in, bp["conv_w"], bp["conv_b"])
        new_conv_state = conv_in[:, -(W - 1):]
    else:
        # decode: prepend the cached inputs
        full = torch.cat([conv_state, conv_in], dim=1)
        conv = _causal_conv(full, bp["conv_w"], bp["conv_b"])
        conv = conv[:, conv_state.shape[1]:]
        new_conv_state = full[:, -(W - 1):]

    xr, B_, C_ = torch.split(conv, [d_in, N, N], dim=-1)
    Bsz, S = x.shape[0], x.shape[1]
    xh = xr.reshape(Bsz, S, H, P)
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
    y = y.reshape(Bsz, S, d_in)
    y = L.rms_norm(y * F.silu(z), bp["gate_ln"], cfg.norm_eps)
    out = L._mm(y, bp["out_proj"])
    return x + out, h_last, new_conv_state


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> hidden (B, S, d): every block in its chunked
    form from a zero state (``apply_block`` with no state), layers from
    ``transformer.unstacked``, each recomputed in the backward pass under
    ``cfg.remat`` (``transformer.rematted``)."""
    x = L.apply_embed(params["embed"], tokens)
    remat = T.remats(cfg)
    for bp in T.unstacked(params["blocks"]):
        def fwd(xx, bp=bp):
            return apply_block(bp, cfg, xx)[0]
        x = T.rematted(fwd, x) if remat else fwd(x)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def nll_loss(params, cfg: ArchConfig, batch: dict, key, noise=None):
    """Mean next-token NLL with one weight-space draw of the head
    (``transformer.head_loss``): ``(nll, {"accuracy"})``, as
    ``repro.models.ssm.nll_loss``."""
    hidden = forward(params, cfg, batch["tokens"])
    return T.head_loss(params, cfg, hidden, batch["labels"], key, noise)


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
