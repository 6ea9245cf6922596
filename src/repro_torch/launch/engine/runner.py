"""Device-facing model runner (the serving engine's execution layer).

Counterpart of ``repro.launch.engine.runner``, rewritten for PyTorch
device placement: the engine above it is host-side policy, and this is
the only module that moves data between the host and the device.  The
JAX runner jit-compiles each callable and donates the cache to it; the
port updates the KV cache IN PLACE (the same memory the donation
reuses), so every method here mutates the cache dict it is given and
returns it.

The decode chunk (``steps.build_scan_decode``) is the JAX runner's
``jax.jit(scan_decode, donate_argnums=(2,))``.  Its PyTorch form is a
CUDA graph: the runner owns the decode carry (token, cache, active mask,
flag counters), the chunk's step and its output buffer, allocated once,
and on a CUDA device captures the chunk over them when it is built.  A
chunk is then one graph replay; between replays the engine writes the
carry in place (``start``, ``write_table``, slot writes, prefill).  On
the CPU the chunk runs eagerly on the same buffers.  Prefill chunks run
eagerly between replays.  The mesh (tensor-parallel) mode of the JAX
runner is not ported yet.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.entropy import KernelEntropy
from repro_torch.kernels import launches
from repro_torch.launch import steps as S
from repro_torch.models import registry as M

FLAGS = ("epistemic", "aleatoric")


class ModelRunner:
    """Parameters, the decode carry and the callables for one engine
    config.  Receives the engine's policy-resolved knobs (kv_layout after
    the family fallback, cfg with ``decode_attn`` substituted).

    The carry's addresses never change: ``start`` resets it in place for
    each run, and on CUDA the chunk's graph, captured once here, replays
    over it.  The graph is fixed by (num_slots, chunk, table width,
    layout, decode_attn, head_entropy), all fixed for the runner
    (``graph_key``).  A failed capture raises: there is no eager fallback
    on CUDA."""

    def __init__(self, params, cfg, *, num_slots: int, max_len: int,
                 chunk: int, entropy: Optional[KernelEntropy],
                 mi_threshold: float, se_threshold: float, kv_layout: str,
                 kv_block: int, kv_blocks: int, device: torch.device,
                 head_noise=None):
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.chunk = chunk
        self.kv_layout = kv_layout
        self.kv_block = kv_block
        self.kv_blocks = kv_blocks
        self.device = device
        self._scan = S.build_scan_decode(cfg, entropy=entropy, chunk=chunk,
                                         mi_threshold=mi_threshold,
                                         se_threshold=se_threshold,
                                         head_noise=head_noise)
        dev = device
        self.tok = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        self.cache = self.make_cache(num_slots)
        self.active = torch.zeros((num_slots,), dtype=torch.bool, device=dev)
        self.flags = {n: torch.zeros((num_slots,), dtype=torch.int32,
                                     device=dev) for n in FLAGS}
        self.step0 = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.ys = torch.zeros((chunk, len(S.OUTPUTS), num_slots),
                              dtype=torch.float32, device=dev)
        self.graph_key = (num_slots, chunk,
                          M.paged_table_width(max_len, kv_block),
                          kv_layout, cfg.decode_attn, cfg.head_entropy)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured: dict[str, int] = {}     # kernel launches a replay
        self.capture_s = 0.0
        if dev.type == "cuda":
            self._capture()

    def _args(self):
        return (self.params, self.tok, self.cache, self.step0, self.active,
                self.flags, self.ys)

    def _capture(self) -> None:
        """Warm the chunk up once on a side stream (kernel builds, cuBLAS
        handles, the decode kernel's workspace), then capture it, on the
        carry with every slot inactive; ``start`` resets what the warm-up
        wrote.  The warm-up's launches are counted; the capture's are
        recorded, not launched, and ``scan`` counts them per replay."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._scan(*self._args())
            torch.cuda.current_stream(self.device).wait_stream(side)
            before = launches.snapshot()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._scan(*self._args())
            after = launches.snapshot()
        launches.COUNTS.update(before)
        self.captured = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.start()

    def start(self):
        """The decode carry ``(tok, cache, active, flags)``, reset IN PLACE
        to a fresh engine's state (an empty cache, unmapped tables, no
        active slot, zero counters).  The paged decode kernel needs no
        reset: every call leaves its counters at 0."""
        self.tok.zero_()
        self.active.zero_()
        for v in self.flags.values():
            v.zero_()
        for name, t in self.cache.items():
            if name == "block_table":
                t.fill_(-1)
            else:
                t.zero_()
        return self.tok, self.cache, self.active, self.flags

    def make_cache(self, num_slots: int) -> dict:
        return M.make_cache(self.cfg, num_slots, self.max_len,
                            device=self.device, layout=self.kv_layout,
                            kv_block=self.kv_block,
                            num_blocks=self.kv_blocks)

    def _staged(self, a: np.ndarray) -> torch.Tensor:
        """A copy of a host array to send to the device without a host
        sync: in pinned memory on CUDA, copied asynchronously from there
        (the caching host allocator keeps it until the copy has run)."""
        t = torch.from_numpy(np.array(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return self._staged(a).to(self.device, non_blocking=True)

    def tokens(self, toks: np.ndarray) -> torch.Tensor:
        """A host (S,) prompt slice as a (1, S) device batch."""
        return self._to_device(np.asarray(toks, np.int64))[None]

    def place_table(self, table: np.ndarray) -> torch.Tensor:
        return self._to_device(np.asarray(table, np.int32))

    def write_table(self, cache: dict, table: np.ndarray) -> None:
        """Copy the host block tables into the cache's table in place (the
        graph reads it at its fixed address)."""
        cache["block_table"].copy_(self._staged(np.asarray(table, np.int32)),
                                   non_blocking=True)

    def prefill(self, cache: dict, slot: int, toks: np.ndarray,
                row: Optional[np.ndarray], modality=None) -> dict:
        """Batch prefill of one prompt (bucketed width W) into ``slot``:
        paged prefill builds a W-token strip that the slot write pages
        out; dense builds the engine-wide max_len strip.  ``modality``:
        the encdec family's (1, ENC_LEN, d) encoder frames or the vlm
        family's (1, num_prefix_embeds, d) prefix embeds."""
        paged = self.kv_layout == "paged"
        width = len(toks) if paged else self.max_len
        _, sub = M.prefill(self.params, self.cfg, self.tokens(toks), width,
                           modality)
        return M.write_slot(self.cfg, cache, slot, sub,
                            self.place_table(row) if paged else None)

    def prefill_chunk(self, cache: dict, slot: int, toks: np.ndarray,
                      offset: int, new_len: int, span: int,
                      expert_offsets: Optional[torch.Tensor] = None,
                      state: Optional[dict] = None, finalize: bool = False,
                      frames: Optional[torch.Tensor] = None):
        """One prompt chunk into ``slot``; returns the cache, or for the
        moe family ``(cache, new_expert_offsets)`` from the (L, E) running
        expert load it is given, or for the hybrid family ``(cache,
        new_state)`` from the prompt's (ssm, conv) state, which reaches
        the slot only when ``finalize``.  ``frames`` (encdec, the first
        chunk): the encoder's input, whose cross K/V the chunk writes
        into the slot's ``ck`` / ``cv`` in place."""
        kw = {}
        if expert_offsets is not None:
            kw["expert_offsets"] = expert_offsets
        if state is not None:
            kw.update(state=state, finalize=finalize)
        if frames is not None:
            kw["frames"] = frames
        return M.prefill_chunk(self.params, self.cfg, self.tokens(toks),
                               cache, slot, offset, new_len, span, **kw)

    def expert_offsets(self) -> torch.Tensor:
        """A moe prompt's running expert load before its first chunk:
        (L, E) f32 zeros on the device."""
        return torch.zeros((self.cfg.num_layers, self.cfg.num_experts),
                           dtype=torch.float32, device=self.device)

    def prefill_state(self) -> dict:
        """A hybrid prompt's recurrent state before its first chunk, on the
        device: ``ssm`` (L, 1, H, P, N) f32 and ``conv`` (L, 1, W - 1,
        d_in + 2N) in the cache's conv dtype, zeros."""
        return {n: torch.zeros_like(self.cache[n][:, :1])
                for n in ("ssm", "conv")}

    def set_len(self, cache: dict, slot: int, n: int) -> dict:
        cache["len"][slot].fill_(n)      # no host copy (see engine.py)
        return cache

    def scan(self, tok, cache, step0: int, active, flags):
        """One decode chunk from global step ``step0`` over the runner's
        carry (``start``): a graph replay on CUDA, the eager chunk on the
        CPU.  Returns ``(tok, cache, flags, ys)``, the same tensors, with
        ``ys`` valid until the next chunk."""
        if tok is not self.tok or cache is not self.cache \
                or active is not self.active or flags is not self.flags:
            raise ValueError("scan runs on the runner's own carry "
                             "(ModelRunner.start)")
        if not (0 <= step0 and step0 + self.chunk <= 2 ** 31):
            raise ValueError(f"step0 {step0} out of the int32 step range")
        self.step0.fill_(step0)
        if self.graph is None:
            return self._scan(*self._args())
        self.graph.replay()
        for name, n in self.captured.items():
            launches.COUNTS[name] += n
        return self.tok, self.cache, self.flags, self.ys

    @staticmethod
    def fetch(ys: torch.Tensor) -> dict[str, np.ndarray]:
        """The chunk's outputs on the host, each (chunk, B): ONE
        device-to-host copy."""
        host = ys.cpu().numpy()
        out = {name: host[:, i] for i, name in enumerate(S.OUTPUTS)}
        out["token"] = out["token"].astype(np.int32)
        out["epistemic"] = out["epistemic"] > 0.5
        out["aleatoric"] = out["aleatoric"] > 0.5
        return out

    def sync(self) -> None:
        """Wait for the device (timing boundaries only)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# ---------------------------------------------------------------------------
# per-token reference loop (parity oracle + benchmark baseline)
# ---------------------------------------------------------------------------

def decode_loop_reference(params, cfg, tokens, gen_len: int, *,
                          entropy: Optional[KernelEntropy] = None,
                          max_len: Optional[int] = None,
                          modality=None, decode_fn=None) -> dict:
    """The pre-engine decode loop: one eager step and one host sync per
    token over a statically batched (B, P) prompt matrix, on the device
    of the parameters.  Scan decode must reproduce this loop's token
    stream exactly in operand-entropy mode for requests admitted at
    engine start (the noise is keyed by (seed, slot, depth)).  Step i of
    the head stream is global step i, as in the JAX package.

    ``decode_fn`` (a ``steps.build_decode_step`` step) lets a caller pass
    its own step, e.g. with a ``head_noise`` provider.  ``modality`` is
    the encdec family's (B, ENC_LEN, d) encoder frames or the vlm
    family's (B, num_prefix_embeds, d) prefix embeds; another family
    given one raises ``ValueError``.
    """
    if modality is not None and cfg.family not in ("encdec", "vlm"):
        raise ValueError(f"family {cfg.family!r} takes no modality input")
    dev = params["head"]["mu"].device
    with torch.inference_mode():
        tokens = torch.as_tensor(np.asarray(tokens, np.int32), device=dev)
        B, P = tokens.shape
        max_len = max_len or P + gen_len
        if modality is not None:
            modality = torch.as_tensor(modality, device=dev)
        _, cache = M.prefill(params, cfg, tokens, max_len, modality)
        decode = decode_fn or S.build_decode_step(cfg, entropy=entropy)
        tok = tokens[:, -1]
        names = ("token", "H", "SE", "MI", "p_max")
        rows = []
        t0 = time.perf_counter()
        for i in range(gen_len):
            out, cache = decode(params, tok, cache, i)
            tok = out["next_token"]
            rows.append(torch.stack([tok.float(), out["H"], out["SE"],
                                     out["MI"], out["p_max"]])
                        .cpu().numpy())                  # per-token sync
        decode_s = time.perf_counter() - t0
    host = np.stack(rows, axis=1)                        # (5, gen_len, B)
    res = {name: host[i] for i, name in enumerate(names)}
    res["token"] = res["token"].astype(np.int32)
    return res | {"decode_s": decode_s,
                  "decode_tok_per_s": gen_len * B / max(decode_s, 1e-9)}
