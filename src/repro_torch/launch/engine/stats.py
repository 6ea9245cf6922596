"""Per-run serving telemetry (the engine's observability layer).

Counterpart of ``repro.launch.engine.stats``.  ``ServeStats`` owns the
counters one ``ServeEngine.run`` accumulates — prefill first-vs-repeat
shape timing, the decode-attention block tally, the downsampled
scheduler trace, decode-chunk arrival times — and builds the results
dict.  The payload keeps the JAX engine's schema key for key (the CLI's
``--stats-json``); features the port does not have yet (prefix cache,
escalation, speculative decoding) report as disabled with zero counts.
"""

from __future__ import annotations

import time

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
        self.sched_trace: list[dict] = []
        self.chunks_run = 0
        # decode-attention block accounting (paged): blocks the selected
        # read path touches vs the full logical span gather materializes
        self.attn_blocks_read = 0
        self.attn_blocks_span = 0
        self.prefill_chunks = 0
        self.steps_run = 0
        # one timestamp per decode chunk that served a decoding slot
        self.arrivals: list[float] = []

    def classify(self, shape_key: tuple, dt: float) -> None:
        if shape_key in self.seen_prefill_shapes:
            self.steady_times.append(dt)
        else:
            self.seen_prefill_shapes.add(shape_key)
            self.compile_times.append(dt)

    def trace(self, sched) -> None:
        """Downsampled pool/queue snapshot."""
        if self.chunks_run % self.trace_every == 0:
            self.sched_trace.append(sched.pool_stats())

    def results(self, engine, requests, *, sched, alloc, cache,
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
                "escalations": 0,
                "preemptions": sum(r.preempt_count for r in group),
            }
        epi = sum(r.epistemic_flags for r in requests)
        alea = sum(r.aleatoric_flags for r in requests)
        S = engine.cfg.mc_samples
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
                "enabled": False, "hits": 0, "misses": 0, "hit_rate": 0.0,
                "prompt_tokens": 0, "prompt_tokens_saved": 0,
                "saved_frac": 0.0, "cow_copies": 0, "cache_evictions": 0,
                "blocks_cached_end": 0,
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
                "enabled": False, "mi_threshold": None,
                "verify_samples": 4 * S, "escalations": 0, "by_class": {},
                "tokens": 0, "skipped_too_long": 0, "decode_s": 0.0,
                "steps": 0,
            },
            "spec_decode": {
                "enabled": False, "k": 4,
                "mi_threshold": engine.mi_threshold, "draft_samples": 1,
                "rounds": 0, "drafted": 0, "accepted": 0,
                "acceptance_rate": 0.0, "emitted": 0,
                "tokens_per_round": 0.0, "rollbacks": 0,
                "gated_slot_rounds": 0,
                "full_model_calls": self.steps_run,
                "k_min": 4, "k_max": 4, "k_up": 0, "k_down": 0,
                "round_k_min": None, "round_k_max": None,
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
