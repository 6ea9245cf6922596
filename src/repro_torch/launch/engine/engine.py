"""The continuous-batching serving engine (policy + chunk loop).

Counterpart of ``repro.launch.engine.engine``.  ``ServeEngine`` resolves
the serving POLICY (layout / read-path / prefill-mode fallbacks), then
drives the per-chunk loop: admit via ``scheduler.SlotScheduler``,
prefill through ``runner.ModelRunner``, grant or preempt against the
block pool, decode ``chunk`` steps, harvest the chunk's outputs with one
host transfer, account into ``stats.ServeStats``.  On CUDA a decode chunk
is one replay of the runner's CUDA graph: every write between chunks
(token carry, active mask, flag counters, block table, depths, prefill
KV, copy-on-write block copies, a speculative round's commit) lands in
place in the tensors the graph was captured over.

With ``prefix_cache`` a radix tree over the block pool
(``launch.prefix_cache``) lets admissions map a cached prompt prefix and
prefill only the suffix; with ``spec_decode`` the loop runs
uncertainty-gated speculative rounds (a k-step draft, a full-S verify at
each draft position, acceptance of the longest agreeing prefix) in place
of decode chunks, whose accepted stream equals spec-decode off bit for
bit in operand-entropy mode.  With ``policy="priority"`` a better class
preempts a worse decoding slot at admission (the victim replays from its
prompt), and with ``escalate_mi`` a slot whose carried MI reaches the
threshold finishes on a one-slot high-S lane (``escalate.EscalationLane``)
whose decode chunk is a CUDA graph of its own.  With ``mesh`` (a
``launch.mesh.TP``) the engine is one rank of a tensor-parallel group:
every rank runs this same host-side loop on the same requests over its
own ``ModelRunner`` share, and reads the same (gathered) outputs, so the
ranks take the same schedule: speculative rounds and the escalation lane
included, and the priority policy's SLO deadlines, which read rank 0's
submission stamps on every rank.
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
from repro_torch.launch.engine.escalate import EscalationLane
from repro_torch.launch.engine.policy import SchedPolicy, get_policy
from repro_torch.launch.engine.runner import ModelRunner
from repro_torch.launch.prefix_cache import RadixPrefixCache
from repro_torch.launch.engine.scheduler import Request, SlotScheduler
from repro_torch.launch.engine.stats import ServeStats
from repro_torch.models import registry as M


class ServeEngine:
    """Continuous-batching uncertainty engine on one device, or on one rank
    of a tensor-parallel mesh.

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

    ``prefix_cache`` (paged only) walks a radix tree of cached prompt
    prefixes at admission: the matched blocks are mapped read-only into
    the slot's table, a partially matched tail block is copied first
    (copy-on-write), and prefill runs on the suffix only; a whole-prompt
    hit runs none.  Families whose prompt KV is not a pure function of
    the tokens (``registry.supports_prefix_cache``) serve cold.
    ``spec_decode`` (operand entropy only) replaces a decode chunk with a
    speculative round whenever a decoding slot's carried MI lies strictly
    below ``spec_mi_threshold`` (default ``mi_threshold``): a
    ``spec_k``-step draft with a ``spec_draft_s``-draw head, the full-S
    verify at each position, and each slot keeps its longest agreeing
    prefix plus the verified correction; ``spec_k_min`` /
    ``spec_k_max`` let a per-slot acceptance EMA walk each slot's depth.

    ``policy`` (a name or a ``policy.SchedPolicy``) ranks the queue:
    ``'fifo'`` (the reference) or ``'priority'`` (class, SLO deadline,
    order; a better class preempts a worse DECODING slot when no slot or
    not enough pool is free, and the victim replays from its prompt).
    ``escalate_mi`` hands a decoding slot whose carried MI reaches it to
    the escalation lane, which finishes the request at ``escalate_s`` MC
    samples (default 4x the serving S) on a one-slot dense runner over
    the same parameter tensors (``escalation_runner``, one per S).

    ``mesh`` (a ``launch.mesh.TP``, the JAX engine's ``mesh=``) serves
    tensor-parallel: the runner shards the parameters by the serve rules
    and the KV cache on its kv-head axis where the ranks divide the
    heads, and each rank's paged decode and prefill kernels read its own
    heads (no gather read in their place, unlike the JAX engine, whose
    GSPMD cannot partition a Pallas body).  Every feature serves under
    it: a speculative round's draft and verify gather as a chunk's step
    does; the escalation lane's runner takes the rank's share of the
    same parameter tensors (in kernel entropy its head whole, as the
    main head; in operand entropy the head's columns, gathered) and
    attends every head (``escalation_runner``); and
    ``run`` broadcasts rank 0's ``t_submit`` stamps of every arrival wave
    (one float64 broadcast), so every rank ranks SLO deadlines by one
    clock.

    ``device`` defaults to CUDA and raises when no GPU is present; the
    parameters must already live there (under a mesh, on the rank's
    device).  ``head_noise`` replaces the
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
                 device="cuda", head_noise=None, prefix_cache: bool = False,
                 spec_decode: bool = False, spec_k: int = 4,
                 spec_mi_threshold: Optional[float] = None,
                 spec_draft_s: int = 1, spec_k_min: Optional[int] = None,
                 spec_k_max: Optional[int] = None, policy="fifo",
                 escalate_mi: Optional[float] = None,
                 escalate_s: Optional[int] = None, mesh=None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_block < 1:
            raise ValueError(f"kv_block must be >= 1, got {kv_block}")
        if prefix_cache and kv_layout != "paged":
            raise ValueError("prefix cache shares blocks of the paged "
                             "pool; run with kv_layout='paged'")
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
        self.mesh = mesh
        if spec_decode:
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if spec_draft_s < 0:
                raise ValueError(
                    f"spec_draft_s must be >= 0, got {spec_draft_s}")
            # losslessness needs head noise that is a pure function of
            # (slot, depth): the kernel stream keys the global step, so a
            # verify at the same depth but another step draws otherwise
            if entropy is not None or cfg.head_entropy == "kernel":
                raise ValueError(
                    "speculative decoding requires the operand entropy "
                    "mode (depth-keyed head noise); the kernel stream "
                    "keys the global step and cannot replay plain "
                    "decode's draws at draft positions")
            if not M.supports_spec_decode(cfg):
                raise ValueError(f"family {cfg.family!r} does not support "
                                 "speculative decoding")
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.spec_mi_threshold = mi_threshold if spec_mi_threshold is None \
            else spec_mi_threshold
        self.spec_draft_s = spec_draft_s
        # adaptive depth: each slot's acceptance EMA walks its k inside
        # [k_min, k_max]; the defaults pin both to spec_k (fixed depth)
        self.spec_k_min = spec_k if spec_k_min is None else spec_k_min
        self.spec_k_max = spec_k if spec_k_max is None else spec_k_max
        if spec_decode and not (1 <= self.spec_k_min <= spec_k
                                <= self.spec_k_max):
            raise ValueError(
                f"adaptive spec-k bounds must satisfy 1 <= k_min <= k "
                f"<= k_max, got k_min={self.spec_k_min} k={spec_k} "
                f"k_max={self.spec_k_max}")
        # the admission / eviction decision layer: a --policy name or a
        # ready instance
        self.policy = policy if isinstance(policy, SchedPolicy) \
            else get_policy(policy)
        if escalate_mi is not None and escalate_mi < 0:
            raise ValueError(f"escalate_mi must be >= 0, got {escalate_mi}")
        self.escalate_mi = escalate_mi
        self.escalate_s = escalate_s if escalate_s is not None \
            else 4 * cfg.mc_samples
        if self.escalate_s < 1:
            raise ValueError(f"escalate_s must be >= 1, got {self.escalate_s}")
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
        # unsupported families serve cold, silently, like the ssm family's
        # dense fallback
        self.prefix_cache = (prefix_cache and self.kv_layout == "paged"
                             and M.supports_prefix_cache(cfg))
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
            head_noise=head_noise,
            spec_k_max=self.spec_k_max if spec_decode else 0,
            spec_draft_s=spec_draft_s, tp=self.mesh)
        # the runner's parameters (under a mesh the rank's share: the whole
        # tensors are not kept)
        self.params = self.runner.params
        self._modalities: dict[int, torch.Tensor] = {}
        # the escalation lane's runners, one per verify S, built on demand
        self._esc_runners: dict[int, ModelRunner] = {}

    def escalation_runner(self, s: int) -> ModelRunner:
        """The escalation lane's runner at ``s`` head samples, built (and
        on CUDA its decode chunk captured) the first time it is asked
        for, then kept: a one-slot dense ``ModelRunner`` on the engine's
        own parameter tensors, the gather read, batch prefill, and the
        engine's entropy, thresholds and operand-noise provider.  S
        changes the head's draws only, so the cheap layout serves.  Under
        a mesh it is the rank's lane runner on the rank's share, taken as
        it is (``sharded``: no second copy), its chunk eager under gloo
        as the main chunk is, and its attention over every head
        (``TP.local_heads`` off: q, k and v gathered, the one-slot cache
        whole): its dense read and batch prefill are plain einsums
        batched over the heads, whose GEMMs a rank's share of the heads
        would change (the paged kernels take their split from the
        model's head count instead)."""
        if s not in self._esc_runners:
            main = self.runner
            cfg = dataclasses.replace(self.cfg, mc_samples=s,
                                      decode_attn="gather")
            self._esc_runners[s] = ModelRunner(
                self.params, cfg, num_slots=1, max_len=self.max_len,
                chunk=self.chunk, entropy=main._entropy,
                mi_threshold=main._mi_threshold,
                se_threshold=main._se_threshold, kv_layout="dense",
                kv_block=self.kv_block, kv_blocks=self.table_width,
                device=self.device, head_noise=main._head_noise,
                tp=None if self.mesh is None else dataclasses.replace(
                    self.mesh, local_heads=False), sharded=True)
        return self._esc_runners[s]

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

    def _start_job(self, req: Request, hit_len: int) -> dict:
        """Open a chunked-prefill walk over ``req``'s prompt from offset
        ``hit_len`` (a prefix hit's resident span), plus what the
        family's ``prefill_chunk`` threads between chunks: ``ex_off``,
        the running expert load (moe), or ``state``, the prompt's zero
        (ssm, conv) recurrent state (hybrid); ``first`` marks the walk's
        first chunk (encdec: it runs the encoder)."""
        P = len(req.prompt)
        job = {"req": req, "P": P, "span": self._bucket(P), "off": hit_len,
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

    def _spec_round(self, sched, stats, decoding, k: int,
                    escalate) -> None:
        """One uncertainty-gated speculative round in place of a decode
        chunk: a k-step draft on the full model body proposes cheap-head
        tokens for every slot, the full-S head verifies each position at
        the same (slot, depth) noise sites, and each drafting slot keeps
        its longest agreeing prefix plus the first verified correction
        (the runner's graph of depth k, one host transfer).  Since the
        draft runs plain decode's body and the verify plain decode's head,
        the accepted stream is plain decode's bit for bit.  A slot whose
        carried MI sits at or above the gate emits position 1's verified
        token only.  A rejected tail rolls back on the host
        (``scheduler.rollback`` frees the decode blocks past the kept
        depth) and on the device (the commit pins token, depth and
        recurrent state in place).  A slot that ``escalate`` hands to the
        lane after its emitted tokens is evicted (the rejected tail's
        blocks with it) and gets no commit pin."""
        runner = self.runner
        stats.record_round_k(k)
        parts = [(slot, req) for slot, req in sched.active()
                 if slot in decoding]
        B = self.num_slots
        lens0 = np.zeros((B,), np.int32)
        for slot, req in parts:
            lens0[slot] = len(req.prompt) + len(req.tokens)
        t0 = time.perf_counter()
        host = runner.fetch_spec(runner.spec_round(k, lens0))  # one sync
        stats.arrivals.append(time.perf_counter())
        stats.decode_s += time.perf_counter() - t0
        stats.spec_rounds += 1
        stats.full_model_calls += 1          # ONE verify dispatch a round
        stats.steps_run += k
        commit = {n: np.zeros((B,), np.int32) for n in
                  ("mask", "tok", "len", "idx", "epi", "alea")}
        for slot, req in parts:
            if req.last_mi < self.spec_mi_threshold:
                a = 0
                while a < k and host["draft"][a, slot] \
                        == host["token"][a, slot]:
                    a += 1
                stats.spec_drafted += k
                stats.spec_accepted += a
                # adaptive depth: the acceptance EMA walks the slot's k
                # inside [k_min, k_max]; pinned bounds make it inert
                rate = a / k
                req.spec_ema = rate if req.spec_ema is None \
                    else 0.5 * req.spec_ema + 0.5 * rate
                cur = req.spec_k_cur or self.spec_k
                if req.spec_ema >= 0.8 and cur < self.spec_k_max:
                    req.spec_k_cur = cur + 1
                    stats.spec_k_up += 1
                elif req.spec_ema <= 0.4 and cur > self.spec_k_min:
                    req.spec_k_cur = cur - 1
                    stats.spec_k_down += 1
                else:
                    req.spec_k_cur = cur
            else:
                # carried MI at or above the gate: no drafting credit,
                # position 1's verified token only (one plain step)
                a = 0
                stats.spec_gated += 1
            emitted, finished = 0, False
            for j in range(min(a + 1, k)):
                tk = int(host["token"][j, slot])
                req.tokens.append(tk)
                for name in ("H", "SE", "MI", "p_max"):
                    getattr(req, name).append(float(host[name][j, slot]))
                epi = int(host["epistemic"][j, slot])
                alea = int(host["aleatoric"][j, slot])
                req.epistemic_flags += epi
                req.aleatoric_flags += alea
                commit["epi"][slot] += epi
                commit["alea"][slot] += alea
                req.last_mi = float(host["MI"][j, slot])
                emitted = j + 1
                done_eos = self.eos_id is not None and tk == self.eos_id
                if done_eos or len(req.tokens) >= req.max_new_tokens:
                    req.transition("finished",
                                   reason="eos" if done_eos else "length")
                    sched.evict(slot)
                    decoding.discard(slot)
                    runner.active[slot].fill_(False)
                    finished = True
                    break
            stats.spec_emitted += emitted
            if finished or escalate(slot, req):
                continue
            # keep depth lens0 + emitted: free the decode blocks the
            # rejected tail grew into (host) and pin the slot's carry
            # token, depth and recurrent state (device).  emitted == k
            # commits too: the carry token must be the VERIFIED token,
            # not the draft's last proposal
            if emitted < k:
                stats.spec_rollbacks += 1
                sched.rollback(slot, int(lens0[slot]) + emitted)
            commit["mask"][slot] = 1
            commit["tok"][slot] = host["token"][emitted - 1, slot]
            commit["len"][slot] = lens0[slot] + emitted
            commit["idx"][slot] = emitted - 1
        runner.spec_commit(commit["mask"], commit["tok"], commit["len"],
                           commit["idx"], commit["epi"], commit["alea"])

    def run(self, requests: list[Request]) -> dict:
        """Serve ``requests`` to completion; returns engine metrics.

        One host sync per admission (prefill timing) and one per decoded
        chunk or speculative round (its stacked outputs) — never per
        token."""
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
        alloc = pcache = None
        if paged:
            alloc = BlockAllocator(self.kv_blocks, self.kv_block)
            for r in requests:
                need = alloc.blocks_for(len(r.prompt) + r.max_new_tokens)
                if need > self.kv_blocks:
                    raise ValueError(
                        f"request {r.rid}: needs {need} KV blocks but the "
                        f"pool only has {self.kv_blocks}")
            if self.prefix_cache:
                pcache = RadixPrefixCache(alloc, self.kv_block)
        sched = SlotScheduler(self.num_slots, allocator=alloc,
                              table_width=self.table_width,
                              prefix_cache=pcache, policy=self.policy)
        self._last_alloc, self._last_pcache = alloc, pcache
        stats = ServeStats(trace_every=self.trace_every)
        pending = collections.deque(
            sorted((r for r in requests if r.arrival_step > 0),
                   key=lambda r: r.arrival_step))

        def submit(wave: list) -> int:
            """Queue an arrival wave; under a mesh every rank then takes
            rank 0's submission stamps (one broadcast a wave), which the
            priority policy's deadlines read."""
            for r in wave:
                sched.submit(r)
            if self.mesh is not None and wave:
                stamps = self.mesh.broadcast_floats([r.t_submit
                                                     for r in wave])
                for r, t in zip(wave, stamps):
                    r.t_submit = t
            return len(wave)

        submit([r for r in requests if r.arrival_step <= 0])

        runner = self.runner
        # the MI escalation lane (None keeps every escalation branch dead)
        lane = None
        if self.escalate_mi is not None:
            lane = EscalationLane(
                self.escalation_runner(self.escalate_s), chunk=self.chunk,
                eos_id=self.eos_id,
                pad_to=self.kv_block if self.pad_prompts else None,
                modality=self._modality(1))
        esc_skipped: set[int] = set()
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
            req.spec_k_cur = self.spec_k
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

        def maybe_escalate(slot, req) -> bool:
            """Hand a decoding slot whose carried MI reached the threshold
            to the lane: evict it (its blocks return to the pool) and
            clear its lane in the carry.  A request the lane cannot hold
            keeps decoding here, counted once."""
            if lane is None or req.last_mi < self.escalate_mi:
                return False
            if not lane.fits(req):
                if req.rid not in esc_skipped:
                    esc_skipped.add(req.rid)
                    stats.esc_skipped += 1
                return False
            req.transition("escalated")
            sched.evict(slot)
            decoding.discard(slot)
            active[slot].fill_(False)
            lane.submit(req)
            stats.escalations += 1
            stats.esc_by_class[req.priority] += 1
            return True

        def lane_busy() -> bool:
            return lane is not None and lane.has_work()

        try:
            while sched.has_work() or pending or lane_busy():
                wave = []
                while pending \
                        and pending[0].arrival_step <= stats.steps_run:
                    wave.append(pending.popleft())
                if not wave and pending and not sched.has_work() \
                        and not lane_busy():
                    nxt = pending[0].arrival_step
                    while pending and pending[0].arrival_step == nxt:
                        wave.append(pending.popleft())
                fired = submit(wave)
                admitted = sched.admit()
                # the priority policy's victims are requeued already: take
                # their slots out of the decode set and the carry before
                # the new admissions (maybe into the same slots) arm them
                for slot, _ in sched.take_preempted():
                    decoding.discard(slot)
                    active[slot].fill_(False)
                if paged:
                    sync_table()
                for slot, req in admitted:
                    t0 = time.perf_counter()
                    info = sched.prefix_admit(slot) if paged else None
                    hit_len = info.tokens if info is not None else 0
                    P = len(req.prompt)
                    W = self._bucket(P)
                    if info is not None and info.cow is not None:
                        # the shared tail block is about to be written at
                        # the divergence point: copy it on the device into
                        # the block already in the table, then drop this
                        # slot's reference on the original
                        runner.copy_block(cache, *info.cow)
                        sched.finish_cow(slot)
                        stats.pc_cow += 1
                    if info is not None:
                        stats.record_admission(P, hit_len)
                    if hit_len == P:
                        # the whole prompt is resident: no prefill at all
                        runner.set_len(cache, slot, P)
                        activate(slot, req)
                        shape_key = ("hit",)
                    elif self.prefill_mode == "chunked":
                        # pin the depth to the resident span now:
                        # interleaved decode steps write junk at [len,
                        # len + chunk) for every slot, and a stale len
                        # would point into shared prefix blocks
                        runner.set_len(cache, slot, hit_len)
                        prefilling[slot] = self._start_job(req, hit_len)
                        jobs.append(slot)
                        continue
                    elif hit_len:
                        # the suffix padded to the cold bucket: the same
                        # attention extent as the cold path keeps a hit
                        # and a miss bit-identical
                        stoks = np.zeros((W - hit_len,), np.int32)
                        stoks[:P - hit_len] = req.prompt[hit_len:]
                        runner.prefill_suffix(cache, slot, stoks,
                                              sched.block_tables[slot],
                                              hit_len)
                        if W > P:
                            runner.set_len(cache, slot, P)
                        activate(slot, req)
                        shape_key = ("suffix", hit_len, W - hit_len)
                    else:
                        toks = np.zeros((W,), np.int32)
                        toks[:P] = req.prompt
                        runner.prefill(cache, slot, toks,
                                       sched.block_tables[slot] if paged
                                       else None, self._modality(1))
                        if W > P:
                            # junk pad KV stays masked above the true len
                            runner.set_len(cache, slot, P)
                        activate(slot, req)
                        shape_key = ("cold", W)
                    runner.sync()
                    stats.classify(shape_key, time.perf_counter() - t0)

                # every slot in the decode set holds a decoding request
                stale = [slot for slot in decoding
                         if getattr(sched.slots[slot], "state", None)
                         != "decoding"]
                if stale:
                    raise RuntimeError(
                        f"slots {stale} decode without a decoding request "
                        "(a preempted or escalated slot left in the carry)")

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

                # a speculative round replaces this iteration's chunk when
                # any decoding slot's carried MI lies strictly below the
                # gate (threshold 0 never drafts: the loop is then the
                # plain chunk path); decided before the grants, which map
                # the k positions a round writes.  The round drafts at the
                # drafting slots' smallest current depth
                drafting = [req for slot, req in sched.active()
                            if slot in decoding
                            and req.last_mi < self.spec_mi_threshold]
                run_spec = self.spec_decode and bool(drafting)
                k_round = min(req.spec_k_cur or self.spec_k
                              for req in drafting) if run_spec \
                    else self.spec_k
                ahead = k_round if run_spec else self.chunk
                if paged:
                    # map the blocks the coming chunk or round can write,
                    # on demand
                    for slot, req in sched.active():
                        if slot in prefilling:
                            continue     # prompt blocks mapped at admission
                        ids = sched.grant(slot, len(req.prompt)
                                          + min(len(req.tokens) + ahead,
                                                req.max_new_tokens))
                        if ids is None:
                            sched.preempt(slot)
                            decoding.discard(slot)
                            active[slot].fill_(False)
                    sync_table()

                stats.trace(sched)
                # ONE unit of lane work an iteration (an admission or a
                # chunk at the verify S) beside the main pool's chunk
                lane_ran = lane.step(stats) if lane is not None else False
                if not decoding:
                    if not jobs and not admitted and not fired \
                            and not lane_ran:
                        raise RuntimeError(
                            "scheduler stalled: queued requests, no "
                            "admission, nothing prefilling or decoding")
                    continue             # prefill-only iteration
                if paged:
                    MB = sched.block_tables.shape[1]
                    stats.attn_blocks_span += self.num_slots * MB * ahead
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
                                for t in range(ahead))

                if run_spec:
                    self._spec_round(sched, stats, decoding, k_round,
                                     maybe_escalate)
                    continue

                stats.chunks_run += 1
                stats.full_model_calls += self.chunk
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
                        req.last_mi = float(ys["MI"][t, slot])
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
                    # the slot's carried (chunk-end) MI decides whether an
                    # unfinished request finishes on the lane
                    if req.state == "decoding":
                        maybe_escalate(slot, req)
        except BaseException:
            # slots mid-decode still hold blocks: release them so the pool
            # balances even when the run dies (eviction also settles a
            # pending CoW reference and gives the prompt blocks to the tree)
            for slot, _ in list(sched.active()):
                sched.evict(slot)
            raise
        finally:
            # every block is free or held by the prefix cache, and no
            # reservation is outstanding
            if alloc is not None:
                cached = pcache.cached_blocks() if pcache else 0
                if alloc._reserved or alloc.in_use != cached:
                    raise RuntimeError(
                        f"block leak after drain: {alloc.in_use} in use vs "
                        f"{cached} cached, {alloc._reserved} reserved")
        # a drained run leaves no lane armed in either carry
        for r_ in [runner] + ([lane.runner] if lane is not None else []):
            if bool(r_.active.any()):
                raise RuntimeError("a slot is left active in the decode "
                                   "carry after the drain")

        return stats.results(self, requests, sched=sched, alloc=alloc,
                             pcache=pcache, cache=cache, flags=flags)
