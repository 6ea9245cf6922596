"""Per-run serving telemetry (the engine's observability layer).

Counterpart of ``repro.launch.engine.stats``.  ``ServeStats`` owns the
counters one ``ServeEngine.run`` accumulates — prefill first-vs-repeat
shape timing, prefix-cache hit accounting, speculative rounds, the
decode-attention block tally, the escalation lane's counters, the
downsampled scheduler trace, decode arrival times — and builds the
results dict.  The payload keeps the JAX engine's schema key for key (the
CLI's ``--stats-json``).
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np

from repro_torch.models import registry as M


def _pcts(values) -> tuple[float, float]:
    """(p50, p99) with nearest-rank p99 — at small N an interpolated p99
    fabricates a latency no request experienced."""
    arr = np.array(values) if len(values) else np.zeros((1,))
    return (float(np.percentile(arr, 50)),
            float(np.percentile(arr, 99, method="higher")))


class ServeStats:
    """Counters for one ``ServeEngine.run`` + the results-dict builder."""

    def __init__(self, *, trace_every: int):
        self.trace_every = trace_every
        self.t_start = time.perf_counter()
        self.decode_s = 0.0
        # a prefill shape seen for the first time vs a repeat: the JAX
        # engine separates compile from steady time this way; eager
        # PyTorch compiles nothing, but a first shape still pays the
        # allocator's and the kernels' first-use cost
        self.compile_times: list[float] = []
        self.steady_times: list[float] = []
        self.seen_prefill_shapes: set[tuple] = set()
        # prefix cache: admissions that hit / missed, prompt tokens and
        # those already resident, copy-on-write block copies
        self.pc_hits = self.pc_misses = self.pc_cow = 0
        self.pc_tokens = self.pc_saved = 0
        self.sched_trace: list[dict] = []
        self.chunks_run = 0
        # decode-attention block accounting (paged): blocks the selected
        # read path touches vs the full logical span gather materializes
        self.attn_blocks_read = 0
        self.attn_blocks_span = 0
        self.prefill_chunks = 0
        # speculative decoding: rounds, proposals drafted / accepted,
        # tokens emitted, rounds a slot rolled back, MI-gated slot-rounds,
        # the adaptive depth's grow / shrink events and the range of round
        # depths.  full_model_calls counts full-S head dispatches (chunk
        # per decode chunk, one per round); steps_run the KV-advancing
        # steps either path ran
        self.spec_rounds = self.spec_drafted = self.spec_accepted = 0
        self.spec_emitted = self.spec_rollbacks = self.spec_gated = 0
        self.spec_k_up = self.spec_k_down = 0
        self.spec_round_k_min: Optional[int] = None
        self.spec_round_k_max: Optional[int] = None
        self.full_model_calls = 0
        self.steps_run = 0
        # the escalation lane: requests handed to it when their carried MI
        # reached escalate_mi (in all and by class), the tokens it
        # finished for them, the requests it could not hold (counted
        # once), and its decode seconds and steps
        self.escalations = 0
        self.esc_by_class: collections.Counter = collections.Counter()
        self.esc_tokens = self.esc_skipped = self.esc_steps = 0
        self.esc_decode_s = 0.0
        # one timestamp per decode chunk that served a decoding slot
        self.arrivals: list[float] = []

    def classify(self, shape_key: tuple, dt: float) -> None:
        if shape_key in self.seen_prefill_shapes:
            self.steady_times.append(dt)
        else:
            self.seen_prefill_shapes.add(shape_key)
            self.compile_times.append(dt)

    def record_round_k(self, k: int) -> None:
        """Track the range of draft depths the rounds used."""
        self.spec_round_k_min = k if self.spec_round_k_min is None \
            else min(self.spec_round_k_min, k)
        self.spec_round_k_max = k if self.spec_round_k_max is None \
            else max(self.spec_round_k_max, k)

    def record_admission(self, prompt_len: int, hit_len: int) -> None:
        """Prefix-cache hit accounting for one paged admission."""
        self.pc_hits += bool(hit_len)
        self.pc_misses += not hit_len
        self.pc_tokens += prompt_len
        self.pc_saved += hit_len

    def trace(self, sched) -> None:
        """Downsampled pool/queue snapshot."""
        if self.chunks_run % self.trace_every == 0:
            self.sched_trace.append(sched.pool_stats())

    def results(self, engine, requests, *, sched, alloc, pcache, cache,
                flags) -> dict:
        paged = engine.kv_layout == "paged"
        total_s = time.perf_counter() - self.t_start
        gen_tokens = sum(len(r.tokens) for r in requests)
        kv_alloc_bytes = M.kv_bytes(cache)
        if paged:
            token_bytes = kv_alloc_bytes / (engine.kv_blocks
                                            * engine.kv_block)
            block_bytes = kv_alloc_bytes // engine.kv_blocks
            kv_stats = {
                "layout": "paged",
                "block_tokens": engine.kv_block,
                "blocks_total": engine.kv_blocks,
                "blocks_peak": alloc.peak_in_use,
                "bytes_in_use_peak": alloc.peak_in_use * block_bytes,
                "bytes_dense_equiv": int(token_bytes * engine.num_slots
                                         * engine.max_len),
            }
            read_blocks = self.attn_blocks_read \
                if engine.decode_attn == "kernel" else self.attn_blocks_span
            steps = max(self.steps_run, 1)
            decode_attn_stats = {
                "mode": engine.decode_attn,
                "kv_bytes_read_per_step": read_blocks * block_bytes / steps,
                "kv_bytes_span_per_step": self.attn_blocks_span
                * block_bytes / steps,
                "kv_blocks_read": read_blocks,
                "kv_blocks_span": self.attn_blocks_span,
            }
        else:
            kv_stats = {"layout": "dense",
                        "bytes_in_use_peak": kv_alloc_bytes,
                        "bytes_dense_equiv": kv_alloc_bytes}
            decode_attn_stats = {"mode": "gather"}
        lat = np.array([r.latency_s for r in requests]) if requests \
            else np.zeros((1,))
        queue_p50, queue_p99 = _pcts([r.queue_time_s for r in requests])
        svc_p50, svc_p99 = _pcts([r.service_time_s for r in requests])
        per_class = {}
        for cls in sorted({r.priority for r in requests}):
            group = [r for r in requests if r.priority == cls]
            c_lat = _pcts([r.latency_s for r in group])
            c_queue = _pcts([r.queue_time_s for r in group])
            c_svc = _pcts([r.service_time_s for r in group])
            per_class[cls] = {
                "num_requests": len(group),
                "latency_p50_s": c_lat[0], "latency_p99_s": c_lat[1],
                "queue_p50_s": c_queue[0], "queue_p99_s": c_queue[1],
                "service_p50_s": c_svc[0], "service_p99_s": c_svc[1],
                "escalations": sum(r.was_escalated for r in group),
                "preemptions": sum(r.preempt_count for r in group),
            }
        epi = sum(r.epistemic_flags for r in requests)
        alea = sum(r.aleatoric_flags for r in requests)
        return {
            "requests": requests,
            "num_requests": len(requests),
            "gen_tokens": gen_tokens,
            "total_s": total_s,
            "decode_s": self.decode_s,
            "prefill_compile_s": float(np.sum(self.compile_times)),
            "prefill_steady_s": float(np.mean(self.steady_times))
            if self.steady_times else 0.0,
            "decode_tok_per_s": gen_tokens / max(self.decode_s, 1e-9),
            "e2e_tok_per_s": gen_tokens / max(total_s, 1e-9),
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99, method="higher")),
            "latency_max_s": float(lat.max()),
            "queue_time_p50_s": queue_p50,
            "queue_time_p99_s": queue_p99,
            "service_time_p50_s": svc_p50,
            "service_time_p99_s": svc_p99,
            "policy": sched.policy.name,
            "per_class": per_class,
            "kv": kv_stats,
            "decode_attn": decode_attn_stats,
            "prefix_cache": {
                "enabled": engine.prefix_cache,
                "hits": self.pc_hits,
                "misses": self.pc_misses,
                "hit_rate": self.pc_hits / max(self.pc_hits
                                               + self.pc_misses, 1),
                "prompt_tokens": self.pc_tokens,
                "prompt_tokens_saved": self.pc_saved,
                "saved_frac": self.pc_saved / max(self.pc_tokens, 1),
                "cow_copies": self.pc_cow,
                "cache_evictions": pcache.evictions if pcache else 0,
                "blocks_cached_end": (pcache.cached_blocks()
                                      if pcache else 0),
            },
            "sched_trace": self.sched_trace,
            "sched_trace_every": self.trace_every,
            "chunks_run": self.chunks_run,
            "prefill_mode": engine.prefill_mode,
            "prefill_chunk": engine.prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
            "prefill_compiles": len(self.seen_prefill_shapes),
            "table_growths": sched.table_growths,
            "preemptions": sched.preemptions,
            "escalation": {
                "enabled": engine.escalate_mi is not None,
                "mi_threshold": engine.escalate_mi,
                "verify_samples": engine.escalate_s,
                "escalations": self.escalations,
                "by_class": dict(self.esc_by_class),
                "tokens": self.esc_tokens,
                "skipped_too_long": self.esc_skipped,
                "decode_s": self.esc_decode_s,
                "steps": self.esc_steps,
            },
            "spec_decode": {
                "enabled": engine.spec_decode,
                "k": engine.spec_k,
                "mi_threshold": engine.spec_mi_threshold,
                "draft_samples": engine.spec_draft_s,
                "rounds": self.spec_rounds,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "acceptance_rate": self.spec_accepted
                / max(self.spec_drafted, 1),
                "emitted": self.spec_emitted,
                "tokens_per_round": self.spec_emitted
                / max(self.spec_rounds, 1),
                "rollbacks": self.spec_rollbacks,
                "gated_slot_rounds": self.spec_gated,
                "full_model_calls": self.full_model_calls,
                "k_min": engine.spec_k_min, "k_max": engine.spec_k_max,
                "k_up": self.spec_k_up, "k_down": self.spec_k_down,
                "round_k_min": self.spec_round_k_min,
                "round_k_max": self.spec_round_k_max,
            },
            "decode_interarrival_p99_s": float(np.percentile(
                np.diff(self.arrivals), 99, method="higher"))
            if len(self.arrivals) >= 2 else 0.0,
            "epistemic_flags": int(epi),
            "aleatoric_flags": int(alea),
            "flags_per_1k_tokens": {
                "epistemic": 1000.0 * epi / max(gen_tokens, 1),
                "aleatoric": 1000.0 * alea / max(gen_tokens, 1),
            },
            # device-side flag counters from the decode carry (upper-bound
            # the host accounting: a finished slot counts to the chunk end)
            "device_flag_counters": {
                k: v.cpu().tolist() for k, v in flags.items()
            },
        }
