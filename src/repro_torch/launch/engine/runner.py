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
carry in place (``start``, ``write_table``, slot writes, prefill, the
copy-on-write of a shared prefix block, the suffix prefill of a prefix
hit).  On the CPU the chunk runs eagerly on the same buffers.  Prefill
chunks run eagerly between replays.

Speculative decoding (``spec_decode``): the JAX runner jit-compiles one
draft and one verify per draft depth k (``spec_fns(k)``).  Here a round's
draft + verify of depth k is ONE CUDA graph over the carry and the
round's own buffers (the stacked hiddens, the (k, 1 + outputs, B) ``ys``
and the stacked recurrent states), captured lazily at the first round of
that depth, whose eager run is that round's result; every depth's graph
allocates from one shared memory pool.  The commit writes the carry in
place between replays.

Mesh mode (``tp``, a ``launch.mesh.TP``; the JAX runner's ``mesh=``)
serves tensor-parallel, one runner per rank process, every rank on the
same requests: the runner keeps the rank's parameters
(``sharding.partition.shard_params`` by the serve rules; in kernel
entropy the head stays whole, see ``models.uncertain_head``), builds the
rank's cache (its kv heads where the ranks divide them, lens, tables and
recurrent states whole) and passes ``tp`` to every model call, whose
layers all-gather the sharded columns.  The outputs the engine reads
are whole on every rank, so every rank's scheduler takes the same
decisions.  Under NCCL the chunk's graph captures its collectives; gloo
collectives (host-staged) cannot be captured, so a gloo group on a card
runs the chunk eagerly (``TP.graphs``; the result's ``mesh`` field says
so).  A speculative round follows the chunk: its draft and verify pass
``tp`` to the model, its buffers keep their whole shapes (the hiddens,
the proposals and outputs, the recurrent leaves are whole on every
rank), and it is eager under gloo and one graph a depth, its collectives
captured, under NCCL (written, not yet run with a card a rank).  The escalation lane's runner takes the main runner's share as it
is (``sharded``), so a rank holds one copy of its parameters.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.entropy import KernelEntropy
from repro_torch.kernels import launches
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.sharding.partition import serve_dims, shard_params

FLAGS = ("epistemic", "aleatoric")


class ModelRunner:
    """Parameters, the decode carry and the callables for one engine
    config.  Receives the engine's policy-resolved knobs (kv_layout after
    the family fallback, cfg with ``decode_attn`` substituted).

    The carry's addresses never change: ``start`` resets it in place for
    each run, and on CUDA the chunk's graph, captured once here, replays
    over it.  The graph is fixed by (num_slots, chunk, table width,
    layout, decode_attn, head_entropy) (``graph_key``).  The table width
    alone moves during a run: when the scheduler widens its host tables
    (a request needing more than ``ceil(max_len / kv_block)`` blocks),
    ``write_table`` points the carry at a device table of the new width
    and, on CUDA, captures the chunk again over it (``set_width``); the
    tables and graphs stay cached by width, and ``start`` returns to the
    build width.  A failed capture raises: there is no eager fallback on
    CUDA.  ``spec_k_max`` (speculative decoding on) sizes the spec
    round's buffers for the deepest draft; ``spec_draft_s`` is the draft
    head's sample count.  ``tp``: the rank's mesh handle (see the module
    docstring); ``params`` are then the whole model's, and the runner
    keeps the rank's share, or with ``sharded`` already the rank's share
    (another runner's of the same ``head_entropy``), kept as they are:
    the same tensors, no second copy."""

    def __init__(self, params, cfg, *, num_slots: int, max_len: int,
                 chunk: int, entropy: Optional[KernelEntropy],
                 mi_threshold: float, se_threshold: float, kv_layout: str,
                 kv_block: int, kv_blocks: int, device: torch.device,
                 head_noise=None, spec_k_max: int = 0,
                 spec_draft_s: int = 1, tp=None, sharded: bool = False):
        self.tp = tp
        if tp is not None and not sharded:
            dims = serve_dims(params, tp.size)
            if cfg.head_entropy == "kernel":       # the fused head: whole
                dims["head"] = dict.fromkeys(dims["head"])
            params = shard_params(params, tp.rank, tp.size, dims)
        self.params = params
        self.kv_shards = tp.size if L.heads_local(cfg, tp) else 1
        # a CUDA graph per chunk, unless the collectives cannot be captured
        self.graphed = device.type == "cuda" and (tp is None or tp.graphs)
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
                                         head_noise=head_noise, tp=tp)
        dev = device
        self.tok = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
        self.cache = self.make_cache(num_slots)
        self.active = torch.zeros((num_slots,), dtype=torch.bool, device=dev)
        self.flags = {n: torch.zeros((num_slots,), dtype=torch.int32,
                                     device=dev) for n in FLAGS}
        self.step0 = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.ys = torch.zeros((chunk, len(S.OUTPUTS), num_slots),
                              dtype=torch.float32, device=dev)
        # the build width; the paged layout's device tables and the chunk
        # graphs over them are cached by width (``set_width``)
        self.table_width0 = M.paged_table_width(max_len, kv_block)
        self.graph_key = self._graph_key(self.table_width0)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured: dict[str, int] = {}     # kernel launches a replay
        self.capture_s = 0.0
        self.width_capture_s: dict[int, float] = {}
        self._graphs: dict[int, tuple] = {}
        self._tables: dict[int, torch.Tensor] = {}
        if "block_table" in self.cache:
            self._tables[self.table_width0] = self.cache["block_table"]
        self._entropy = entropy
        self._mi_threshold = mi_threshold
        self._se_threshold = se_threshold
        self._head_noise = head_noise
        self.spec_draft_s = spec_draft_s
        self.spec_k_max = spec_k_max
        self._spec_k_fns: dict[int, tuple] = {}
        self._spec_commit = S.build_spec_commit(cfg)
        # a spec round's graphs read the table too: one set a table width,
        # the current width's in these three dicts (keyed by depth)
        self._spec_by_width: dict[int, tuple] = {}
        self.spec_graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.spec_captured: dict[int, dict[str, int]] = {}
        self.spec_capture_s: dict[int, float] = {}
        self._spec_by_width[self.table_width0] = (
            self.spec_graphs, self.spec_captured, self.spec_capture_s)
        self._spec_pool = None
        if spec_k_max:
            # the round's own buffers, sized for the deepest draft: the
            # draft hiddens, the proposals + verify outputs (row 0 the
            # proposal, then OUTPUTS), the pre-round depths, and the
            # post-step recurrent leaves for rollback
            self.spec_hid = torch.zeros((spec_k_max, num_slots, cfg.d_model),
                                        dtype=L.dtype_of(cfg), device=dev)
            self.spec_ys = torch.zeros(
                (spec_k_max, 1 + len(S.OUTPUTS), num_slots),
                dtype=torch.float32, device=dev)
            self.spec_lens0 = torch.zeros((num_slots,), dtype=torch.int32,
                                          device=dev)
            self.spec_states = {
                leaf: torch.zeros((spec_k_max, *self.cache[leaf].shape),
                                  dtype=self.cache[leaf].dtype, device=dev)
                for leaf in M.RECURRENT_LEAVES if leaf in self.cache}
        if self.graphed:
            self._capture()

    def _args(self):
        return (self.params, self.tok, self.cache, self.step0, self.active,
                self.flags, self.ys)

    def _graph_key(self, width: int) -> tuple:
        return (self.num_slots, self.chunk, width, self.kv_layout,
                self.cfg.decode_attn, self.cfg.head_entropy)

    def table_width(self) -> int:
        """The width of the carry's device block table (the build width
        without a paged layout)."""
        t = self.cache.get("block_table")
        return self.table_width0 if t is None else t.shape[1]

    def set_width(self, width: int) -> None:
        """Point the carry at the device block table of ``width`` blocks a
        slot (allocated all -1 the first time) and, on CUDA, at the chunk
        graph captured over it (captured the first time, mid-run: see
        ``_capture``) and that width's spec-round graphs.  The caller then
        writes the table's contents (``write_table``)."""
        if "block_table" not in self.cache or width == self.table_width():
            return
        if width not in self._tables:
            self._tables[width] = torch.full(
                (self.num_slots, width), -1, dtype=torch.int32,
                device=self.device)
        self.cache["block_table"] = self._tables[width]
        self.graph_key = self._graph_key(width)
        (self.spec_graphs, self.spec_captured, self.spec_capture_s) = \
            self._spec_by_width.setdefault(width, ({}, {}, {}))
        if not self.graphed:
            return
        if width not in self._graphs:
            self._capture(keep_carry=True)
        self.graph, self.captured = self._graphs[width]

    def _capture(self, keep_carry: bool = False) -> None:
        """Warm the chunk up once on a side stream (kernel builds, cuBLAS
        handles, the decode kernel's workspace, which grows with the table
        width), then capture it.  At build the carry has every slot
        inactive and ``start`` resets what the warm-up wrote.  Mid-run
        (``keep_carry``, a widened table) the warm-up runs over the new
        table while it is still all -1 and with every depth at 0, the
        build's state, so its KV writes all land in the sink block; every
        other leaf it writes (tokens, depths, flags, recurrent state) is
        restored from a copy afterwards.  The
        warm-up's launches are counted; the capture's are recorded, not
        launched, and ``scan`` counts them per replay."""
        t0 = time.perf_counter()
        saved = None
        if keep_carry:
            if bool((self.cache["block_table"] >= 0).any()):
                raise RuntimeError("a mid-run capture needs an unmapped "
                                   "table (its warm-up writes the pools)")
            saved = [(t, t.clone()) for t in self._carry_leaves()]
            self.cache["len"].zero_()
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
        width = self.table_width()
        self._graphs[width] = (graph, self.captured)
        if saved is not None:
            for t, copy in saved:
                t.copy_(copy)
        torch.cuda.synchronize(self.device)
        self.width_capture_s[width] = time.perf_counter() - t0
        if saved is None:
            self.capture_s = self.width_capture_s[width]
            self.start()

    def _carry_leaves(self) -> list:
        """Every carry tensor a chunk writes except the KV pools and the
        table: the tokens, the flag counters and the other cache leaves
        (depths, recurrent state)."""
        return [self.tok, *self.flags.values()] + [
            t for n, t in self.cache.items()
            if n not in M.PAGED_KV_LEAVES and n != "block_table"]

    def start(self):
        """The decode carry ``(tok, cache, active, flags)``, reset IN PLACE
        to a fresh engine's state (an empty cache, unmapped tables, no
        active slot, zero counters) at the build table width.  The paged
        decode kernel needs no reset: every call leaves its counters at
        0."""
        self.set_width(self.table_width0)
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
                            num_blocks=self.kv_blocks,
                            kv_shards=self.kv_shards)

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
        graph reads it at its fixed address); a host table the scheduler
        has widened moves the carry to a device table of its width first
        (``set_width``)."""
        if cache is not self.cache:
            raise ValueError("write_table writes the runner's own carry")
        self.set_width(table.shape[1])
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
                           modality, tp=self.tp)
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
                               cache, slot, offset, new_len, span,
                               tp=self.tp, **kw)

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

    def copy_block(self, cache: dict, src: int, dst: int) -> dict:
        """The copy-on-write of a shared prefix block: ``src`` into
        ``dst`` in every pool, in place."""
        return M.copy_block(self.cfg, cache, src, dst)

    def prefill_suffix(self, cache: dict, slot: int, toks: np.ndarray,
                       row: np.ndarray, hit_len: int) -> dict:
        """Batch prefill of a prefix hit's suffix ``toks`` (padded to the
        cold bucket) into ``slot``: gather the slot's cached strips over
        the blocks the hit spans, run ``registry.prefill_suffix`` against
        them, and scatter the suffix K/V through the slot's table row
        from logical offset ``hit_len``."""
        table = self.place_table(row)
        nb = -(-hit_len // self.kv_block)
        idx = table[:nb].long()
        strips = {}
        for n in M.PAGED_KV_LEAVES:
            if n in cache:
                pool = cache[n]                  # (L, NB + 1, BS, Hkv, D)
                strips[n] = pool[:, idx].reshape(
                    pool.shape[0], 1, nb * pool.shape[2], *pool.shape[3:])
        _, sub = M.prefill_suffix(self.params, self.cfg, self.tokens(toks),
                                  strips, hit_len, tp=self.tp)
        return M.write_slot(self.cfg, cache, slot, sub, table,
                            offset=hit_len)

    def spec_fns(self, k: int):
        """(draft, verify) of draft depth ``k`` (``steps.build_spec_draft``
        / ``build_spec_verify``), built once per depth."""
        if k not in self._spec_k_fns:
            if not 1 <= k <= self.spec_k_max:
                raise ValueError(f"draft depth {k} outside the runner's "
                                 f"buffers (1..{self.spec_k_max})")
            self._spec_k_fns[k] = (
                S.build_spec_draft(self.cfg, entropy=self._entropy, k=k,
                                   draft_samples=self.spec_draft_s,
                                   head_noise=self._head_noise, tp=self.tp),
                S.build_spec_verify(self.cfg, entropy=self._entropy, k=k,
                                    mi_threshold=self._mi_threshold,
                                    se_threshold=self._se_threshold,
                                    head_noise=self._head_noise, tp=self.tp))
        return self._spec_k_fns[k]

    def _spec_body(self, k: int) -> None:
        draft, verify = self.spec_fns(k)
        draft(self.params, self.tok, self.cache, self.spec_hid, self.spec_ys,
              self.spec_states)
        verify(self.params, self.spec_hid, self.spec_lens0, self.spec_ys)

    def spec_round(self, k: int, lens0: np.ndarray) -> torch.Tensor:
        """One speculative round of depth ``k`` on the runner's carry:
        ``lens0`` (B,) the pre-round depths, staged to the device; returns
        ``spec_ys[:k]``, valid until the next round.  On CUDA the round is
        a replay of depth k's graph; the first round of a depth runs
        eagerly on a side stream (its result is the round's) and then
        captures the graph, whose launches each replay adds to
        ``launches.COUNTS``; a gloo mesh runs every round eagerly
        (``graphed``)."""
        self.spec_lens0.copy_(self._staged(np.asarray(lens0, np.int32)),
                              non_blocking=True)
        if not self.graphed:
            self._spec_body(k)
        elif k in self.spec_graphs:
            self.spec_graphs[k].replay()
            for name, n in self.spec_captured[k].items():
                launches.COUNTS[name] += n
        else:
            self._spec_capture(k)
        return self.spec_ys[:k]

    def _spec_capture(self, k: int) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._spec_body(k)
        cur.wait_stream(side)
        if self._spec_pool is None:
            self._spec_pool = torch.cuda.graph_pool_handle()
        before = launches.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._spec_pool):
            self._spec_body(k)
        after = launches.snapshot()
        launches.COUNTS.update(before)
        self.spec_captured[k] = {n: after[n] - before[n] for n in after
                                 if after[n] != before[n]}
        self.spec_graphs[k] = graph
        torch.cuda.synchronize(self.device)
        self.spec_capture_s[k] = time.perf_counter() - t0

    def spec_commit(self, mask: np.ndarray, new_tok: np.ndarray,
                    new_len: np.ndarray, idx: np.ndarray,
                    epi_add: np.ndarray, alea_add: np.ndarray) -> None:
        """Commit a round in place: the ``mask``ed slots' carry token,
        depth and recurrent state (``steps.build_spec_commit``), and the
        emitted positions' flags added to the device counters.  The six
        (B,) vectors travel in ONE staged host-to-device copy."""
        packed = np.stack([np.asarray(v, np.int32) for v in
                           (mask, new_tok, new_len, idx, epi_add, alea_add)])
        dev = self._to_device(packed)
        self._spec_commit(self.cache, self.tok, dev[0] > 0, dev[1], dev[2],
                          self.spec_states, dev[3])
        self.flags["epistemic"].add_(dev[4])
        self.flags["aleatoric"].add_(dev[5])

    @staticmethod
    def fetch_spec(ys: torch.Tensor) -> dict[str, np.ndarray]:
        """A round's proposals and verify outputs on the host, each (k,
        B): ONE device-to-host copy."""
        host = ys.cpu().numpy()
        out = {name: host[:, 1 + i] for i, name in enumerate(S.OUTPUTS)}
        out["draft"] = host[:, 0].astype(np.int32)
        out["token"] = out["token"].astype(np.int32)
        out["epistemic"] = out["epistemic"] > 0.5
        out["aleatoric"] = out["aleatoric"] > 0.5
        return out

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
