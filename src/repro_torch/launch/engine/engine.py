"""The continuous-batching serving engine (policy + chunk loop).

Counterpart of ``repro.launch.engine.engine``.  ``ServeEngine`` resolves
the serving POLICY (layout / read-path / prefill-mode fallbacks), then
drives the per-chunk loop: admit via ``scheduler.SlotScheduler``,
prefill through ``runner.ModelRunner``, grant or preempt against the
block pool, decode ``chunk`` steps, harvest the chunk's outputs with one
host transfer, account into ``stats.ServeStats``.  On CUDA a decode chunk
is one replay of the runner's CUDA graph: every write between chunks
(token carry, active mask, flag counters, block table, depths, prefill
KV) lands in place in the tensors the graph was captured over.

The prefix cache, speculative decoding, the priority policy, the MI
escalation lane and the tensor-parallel mesh are not ported yet
(ROADMAP.md); the port's CLI refuses their flags.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.entropy import KernelEntropy
from repro_torch.kernels.paged_attention import kv_blocks_read
from repro_torch.launch.engine.block_pool import BlockAllocator
from repro_torch.launch.engine.runner import ModelRunner
from repro_torch.launch.engine.scheduler import Request, SlotScheduler
from repro_torch.launch.engine.stats import ServeStats
from repro_torch.models import registry as M


class ServeEngine:
    """Continuous-batching uncertainty engine on one device.

    ``num_slots`` concurrent decode slots over one slot-indexed KV cache;
    ``chunk`` decode steps per host round-trip.  ``entropy`` (a
    ``KernelEntropy``) seeds the kernel-mode head stream.  ``kv_layout``
    ``'dense'`` (the reference) gives each slot a max_len strip;
    ``'paged'`` backs the KV with a pool of ``kv_blocks`` blocks of
    ``kv_block`` tokens behind per-slot block tables.  ``decode_attn``
    (paged only) picks the decode read: ``'gather'`` (the reference) or
    ``'kernel'``, the block-sparse CUDA kernel, which with chunked
    prefill also runs the paged prefill kernel.  ``prefill_mode``
    ``'chunked'`` (paged only) interleaves ``prefill_chunk``-token prompt
    chunks with decode; ``'batch'`` prefills whole prompts at admission.

    ``device`` defaults to CUDA and raises when no GPU is present; the
    parameters must already live there.  ``head_noise`` replaces the
    operand-mode noise provider (``layers.decode_head_noise``), e.g. to
    feed another implementation's variates in a parity test.
    """

    def __init__(self, params, cfg, *, num_slots: int, max_len: int,
                 chunk: int = 8, entropy: Optional[KernelEntropy] = None,
                 mi_threshold: float = 0.05, se_threshold: float = 1.0,
                 eos_id: Optional[int] = None, kv_layout: str = "dense",
                 kv_block: int = 16, kv_blocks: Optional[int] = None,
                 decode_attn: str = "gather", prefill_mode: str = "batch",
                 prefill_chunk: int = 32, trace_every: int = 1,
                 device="cuda", head_noise=None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        if decode_attn not in ("gather", "kernel"):
            raise ValueError(f"unknown decode_attn {decode_attn!r}")
        if decode_attn == "kernel" and kv_layout != "paged":
            raise ValueError("the block-sparse decode kernel reads "
                             "through the paged block table; run with "
                             "kv_layout='paged'")
        if prefill_mode not in ("batch", "chunked"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if prefill_mode == "chunked" and kv_layout != "paged":
            raise ValueError("chunked prefill scatters prompt chunks "
                             "into pool blocks; run with "
                             "kv_layout='paged'")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        if trace_every < 1:
            raise ValueError(f"trace_every must be >= 1, got {trace_every}")
        self.device = resolve_device(device)
        if params["head"]["mu"].device != self.device:
            raise ValueError(f"params live on {params['head']['mu'].device},"
                             f" the engine runs on {self.device}")
        self.num_slots = num_slots
        self.max_len = max_len
        self.chunk = chunk
        self.eos_id = eos_id
        self.mi_threshold = mi_threshold
        self.trace_every = trace_every
        self.kv_layout = kv_layout if M.supports_paged(cfg) else "dense"
        self.decode_attn = decode_attn if self.kv_layout == "paged" \
            else "gather"
        # decode_attn rides the config so the model layers see it
        self.cfg = cfg = dataclasses.replace(cfg,
                                             decode_attn=self.decode_attn)
        self.kv_block = kv_block
        self.table_width = M.paged_table_width(max_len, kv_block)
        self.kv_blocks = (kv_blocks if kv_blocks is not None
                          else num_slots * self.table_width)
        if self.kv_blocks < 1:
            raise ValueError(f"kv_blocks must be >= 1, got {kv_blocks}")
        paged = self.kv_layout == "paged"
        # padding-safe families right-pad prompts to a kv_block multiple
        self.pad_prompts = M.supports_prompt_padding(cfg)
        self.prefill_mode = prefill_mode if paged \
            and M.supports_chunked_prefill(cfg) else "batch"
        self.prefill_chunk = prefill_chunk
        if self.prefill_mode == "chunked" and cfg.family == "hybrid":
            # hybrid chunks walk the SSM in ssm_chunk segments: round the
            # knob up so that every full chunk is a whole number of them
            sc = cfg.ssm_chunk
            self.prefill_chunk = -(-prefill_chunk // sc) * sc
        # allocates the decode carry and, on CUDA, captures the chunk
        self.runner = ModelRunner(
            params, cfg, num_slots=num_slots, max_len=max_len, chunk=chunk,
            entropy=entropy, mi_threshold=mi_threshold,
            se_threshold=se_threshold,
            kv_layout=self.kv_layout, kv_block=kv_block,
            kv_blocks=self.kv_blocks, device=self.device,
            head_noise=head_noise)
        self.params = params
        self._modalities: dict[int, torch.Tensor] = {}

    def _modality(self, batch: int) -> Optional[torch.Tensor]:
        """The modality input of a ``batch``-prompt prefill: the encdec
        family's encoder frames, (batch, ENC_LEN, d), or the vlm family's
        prefix embeds, (batch, num_prefix_embeds, d); f32 zeros on the
        engine's device (the frontends are stubs, as in the reference),
        allocated once per engine and batch size; None for the other
        families."""
        if self.cfg.family == "encdec":
            from repro_torch.models.encdec import ENC_LEN
            rows = ENC_LEN
        elif self.cfg.family == "vlm":
            rows = self.cfg.num_prefix_embeds
        else:
            return None
        if batch not in self._modalities:
            self._modalities[batch] = torch.zeros(
                (batch, rows, self.cfg.d_model), dtype=torch.float32,
                device=self.device)
        return self._modalities[batch]

    def _bucket(self, n: int) -> int:
        """Prompt-length bucket: next kv_block multiple (dense strips
        clamp to max_len) — the static attention span of the prompt."""
        if not self.pad_prompts:
            return n
        w = -(-n // self.kv_block) * self.kv_block
        return min(w, self.max_len) if self.kv_layout == "dense" else w

    def _start_job(self, req: Request) -> dict:
        """Open a chunked-prefill walk over ``req``'s prompt: the walk
        offset, plus what the family's ``prefill_chunk`` threads between
        chunks: ``ex_off``, the running expert load (moe), or ``state``,
        the prompt's zero (ssm, conv) recurrent state (hybrid); ``first``
        marks the walk's first chunk (encdec: it runs the encoder)."""
        P = len(req.prompt)
        job = {"req": req, "P": P, "span": self._bucket(P), "off": 0,
               "first": True}
        if self.cfg.family == "moe":
            job["ex_off"] = self.runner.expert_offsets()
        elif self.cfg.family == "hybrid":
            job["state"] = self.runner.prefill_state()
        return job

    def _run_chunk(self, cache, slot: int, job: dict):
        """Advance ``job`` by one prompt chunk (padded to exactly
        ``prefill_chunk`` tokens where prompts may be padded; hybrid walks
        exact ``ssm_chunk``-multiple segments, its last chunk the
        ``"final"`` variant that writes the state; an encdec walk's first
        chunk is the ``"first"`` variant that runs the encoder); returns
        ``(cache, done, shape_key)``."""
        off, P, W = job["off"], job["P"], job["span"]
        pc = self.prefill_chunk
        real = min(pc, P - off)
        S_len = pc if self.pad_prompts else real
        toks = np.zeros((S_len,), np.int32)
        toks[:real] = job["req"].prompt[off:off + real]
        new_len = off + real
        done = new_len >= P
        variant = ""
        if "ex_off" in job:
            cache, job["ex_off"] = self.runner.prefill_chunk(
                cache, slot, toks, off, new_len, W,
                expert_offsets=job["ex_off"])
        elif "state" in job:
            cache, job["state"] = self.runner.prefill_chunk(
                cache, slot, toks, off, new_len, W, state=job["state"],
                finalize=done)
            variant = "final" if done else ""
        elif self.cfg.family == "encdec" and job["first"]:
            cache = self.runner.prefill_chunk(cache, slot, toks, off,
                                              new_len, W,
                                              frames=self._modality(1))
            variant = "first"
        else:
            cache = self.runner.prefill_chunk(cache, slot, toks, off,
                                              new_len, W)
        job["first"] = False
        job["off"] = new_len
        return cache, done, ("chunk", S_len, W, variant)

    def run(self, requests: list[Request]) -> dict:
        """Serve ``requests`` to completion; returns engine metrics.

        One host sync per admission (prefill timing) and one per decoded
        chunk (the stacked (chunk, B) outputs) — never per token."""
        with torch.inference_mode():
            return self._run(requests)

    def _run(self, requests: list[Request]) -> dict:
        paged = self.kv_layout == "paged"
        for r in requests:
            if len(r.prompt) == 0:
                raise ValueError(f"request {r.rid}: empty prompt")
            if r.max_new_tokens < 1:
                raise ValueError(
                    f"request {r.rid}: max_new_tokens must be >= 1")
            if not paged and len(r.prompt) + r.max_new_tokens \
                    > self.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.prompt)} + "
                    f"max_new_tokens {r.max_new_tokens} exceeds the "
                    f"slot capacity max_len={self.max_len}")
        alloc = None
        if paged:
            alloc = BlockAllocator(self.kv_blocks, self.kv_block)
            for r in requests:
                need = alloc.blocks_for(len(r.prompt) + r.max_new_tokens)
                if need > self.kv_blocks:
                    raise ValueError(
                        f"request {r.rid}: needs {need} KV blocks but the "
                        f"pool only has {self.kv_blocks}")
        sched = SlotScheduler(self.num_slots, allocator=alloc,
                              table_width=self.table_width)
        self._last_alloc = alloc
        stats = ServeStats(trace_every=self.trace_every)
        pending = collections.deque(
            sorted((r for r in requests if r.arrival_step > 0),
                   key=lambda r: r.arrival_step))
        for r in requests:
            if r.arrival_step <= 0:
                sched.submit(r)

        runner = self.runner
        tok, cache, active, flags = runner.start()
        step0 = 0
        table_synced = -1
        # chunked-prefill bookkeeping: slot -> in-flight prompt walk, FIFO
        # order of the walks, and the slots currently DECODING
        prefilling: dict[int, dict] = {}
        jobs: collections.deque[int] = collections.deque()
        decoding: set[int] = set()

        # per-slot writes into the graph's carry go through fill_, whose
        # scalar rides in the kernel's arguments: item assignment would
        # stage it through a host-to-device copy that synchronises
        def activate(slot, req):
            req.transition("decoding")
            tok[slot].fill_(int(req.prompt[-1]))
            active[slot].fill_(True)
            for v in flags.values():
                v[slot].fill_(0)
            decoding.add(slot)

        def sync_table():
            nonlocal table_synced
            if sched.table_version != table_synced:
                runner.write_table(cache, sched.block_tables)
                table_synced = sched.table_version

        try:
            while sched.has_work() or pending:
                fired = 0
                while pending \
                        and pending[0].arrival_step <= stats.steps_run:
                    sched.submit(pending.popleft())
                    fired += 1
                if not fired and pending and not sched.has_work():
                    nxt = pending[0].arrival_step
                    while pending and pending[0].arrival_step == nxt:
                        sched.submit(pending.popleft())
                        fired += 1
                admitted = sched.admit()
                if paged:
                    sync_table()
                for slot, req in admitted:
                    t0 = time.perf_counter()
                    P = len(req.prompt)
                    W = self._bucket(P)
                    if self.prefill_mode == "chunked":
                        # pin the depth now: interleaved decode steps write
                        # junk at [len, len + chunk) for every slot
                        runner.set_len(cache, slot, 0)
                        prefilling[slot] = self._start_job(req)
                        jobs.append(slot)
                        continue
                    toks = np.zeros((W,), np.int32)
                    toks[:P] = req.prompt
                    runner.prefill(cache, slot, toks,
                                   sched.block_tables[slot] if paged
                                   else None, self._modality(1))
                    if W > P:
                        # junk pad KV stays masked above the true len
                        runner.set_len(cache, slot, P)
                    activate(slot, req)
                    runner.sync()
                    stats.classify(("cold", W), time.perf_counter() - t0)

                if jobs:
                    # at most ONE prompt chunk per iteration, then the
                    # decode chunk below runs for every active slot
                    slot = jobs[0]
                    job = prefilling[slot]
                    t0 = time.perf_counter()
                    cache, done, shape_key = self._run_chunk(cache, slot,
                                                             job)
                    stats.prefill_chunks += 1
                    runner.sync()
                    stats.classify(shape_key, time.perf_counter() - t0)
                    if done:
                        jobs.popleft()
                        del prefilling[slot]
                        activate(slot, job["req"])

                if paged:
                    # map the blocks the coming chunk can write, on demand
                    for slot, req in sched.active():
                        if slot in prefilling:
                            continue     # prompt blocks mapped at admission
                        ids = sched.grant(slot, len(req.prompt)
                                          + min(len(req.tokens) + self.chunk,
                                                req.max_new_tokens))
                        if ids is None:
                            sched.preempt(slot)
                            decoding.discard(slot)
                            active[slot].fill_(False)
                    sync_table()

                stats.trace(sched)
                if not decoding:
                    if not jobs and not admitted and not fired:
                        raise RuntimeError(
                            "scheduler stalled: queued requests, no "
                            "admission, nothing prefilling or decoding")
                    continue             # prefill-only iteration
                if paged:
                    MB = sched.block_tables.shape[1]
                    stats.attn_blocks_span += self.num_slots * MB * self.chunk
                    if self.decode_attn == "kernel":
                        for slot, occupant in sched.active():
                            if slot in prefilling:
                                continue
                            len0 = len(occupant.prompt) \
                                + len(occupant.tokens)
                            mapped = sched.mapped_blocks(slot)
                            stats.attn_blocks_read += sum(
                                kv_blocks_read(len0 + t + 1, mapped,
                                               self.kv_block, MB)
                                for t in range(self.chunk))

                stats.chunks_run += 1
                stats.steps_run += self.chunk
                t0 = time.perf_counter()
                tok, cache, flags, ys = runner.scan(tok, cache, step0,
                                                    active, flags)
                ys = runner.fetch(ys)            # the chunk's single sync
                stats.arrivals.append(time.perf_counter())
                stats.decode_s += time.perf_counter() - t0
                step0 += self.chunk

                for slot, req in sched.active():
                    if slot in prefilling:
                        continue         # mid-prefill: junk steps
                    for t in range(self.chunk):
                        tk = int(ys["token"][t, slot])
                        req.tokens.append(tk)
                        for name in ("H", "SE", "MI", "p_max"):
                            getattr(req, name).append(
                                float(ys[name][t, slot]))
                        req.epistemic_flags += int(ys["epistemic"][t, slot])
                        req.aleatoric_flags += int(ys["aleatoric"][t, slot])
                        done_eos = self.eos_id is not None \
                            and tk == self.eos_id
                        if done_eos or len(req.tokens) >= req.max_new_tokens:
                            req.transition(
                                "finished",
                                reason="eos" if done_eos else "length")
                            sched.evict(slot)
                            decoding.discard(slot)
                            active[slot].fill_(False)
                            break
        except BaseException:
            # slots mid-decode still hold blocks: release them so the pool
            # balances even when the run dies
            for slot, _ in list(sched.active()):
                sched.evict(slot)
            raise
        finally:
            if alloc is not None and (alloc._reserved or alloc.in_use):
                raise RuntimeError(
                    f"block leak after drain: {alloc.in_use} in use, "
                    f"{alloc._reserved} reserved")

        return stats.results(self, requests, sched=sched, alloc=alloc,
                             cache=cache, flags=flags)
