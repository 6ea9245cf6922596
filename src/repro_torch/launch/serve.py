"""Continuous-batching uncertainty serving engine on a GPU (or several,
tensor-parallel) — CLI.

PyTorch counterpart of ``repro.launch.serve``: the same flags, defaults
and ``--stats-json`` schema, plus ``--device`` (default ``cuda``; a
missing GPU raises, ``--device cpu`` runs the plain PyTorch paths).
``--prefix-cache on`` adds the copy-on-write radix prefix cache over the
paged pool (the dense family; the others serve cold), and ``--spec-decode
on`` runs uncertainty-gated speculative rounds, whose accepted stream
equals spec-decode off bit for bit (it needs ``--entropy operand``).
``--policy priority`` ranks the queue by ``--priorities`` class, SLO
deadline (``--slo-ms``) and order, and preempts a worse decoding slot for
a better class; ``--escalate-mi X`` finishes a request whose carried MI
reaches X on a one-slot lane at ``--escalate-s`` head samples (default
4x S).  ``--mesh 1xM`` serves tensor-parallel over M ranks
(``launch.mesh``): the CLI spawns them (or joins ``torchrun``'s), NCCL
with one card a rank where the machine has M cards, else gloo with every
rank on ``--device`` (the CPU, or one shared card with the decode chunk
run eagerly); every rank serves the same trace on its share of the
parameters and KV heads, and rank 0's result is reported, with
``result["mesh"]`` naming ranks, backend and devices.  Every flag of
the unsharded engine serves under ``--mesh``: ``--spec-decode on``
(each rank drafts and verifies on its share, gathering as a decode step
does), ``--escalate-mi`` (each rank's lane runs on the same parameter
tensors as its main runner) and ``--policy priority`` with ``--slo-ms``
(every rank ranks deadlines by rank 0's submission stamps, broadcast
once an arrival wave).  Every ``--arch`` is served.
The ssm family (``mamba2_370m``) keeps no KV: ``--kv-layout paged``,
``--decode-attn kernel`` and ``--prefill chunked`` fall back silently to
the dense layout, the gather read and batch prefill at the exact prompt
length, as in the JAX engine; the stats report the layout served.  The
hybrid family (``zamba2_7b``) pages the KV of its shared attention and
prefills in chunks rounded up to ``ssm_chunk``, its prompts at their
exact length.  The encdec family (``seamless_m4t_medium``) feeds its
encoder zero frames (the frontend is a stub, as in the JAX engine) at
each prompt's first chunk, which writes the cross-attention K/V.  The
vlm family (``phi_3_vision_4_2b``) feeds zero prefix embeds (a stub
frontend too) in place of each prompt's first ``num_prefix_embeds``
positions (576; 8 reduced), so a prompt needs at least 577 tokens (9
reduced), and takes batch prefill whatever ``--prefill`` asks, as in the
JAX engine.

``--reduced`` is ``store_true`` with ``default=True``, as in the JAX
CLI, so the CLI always serves the reduced config; the full-width model
is served from Python with ``args.reduced = False`` (``chip_smoke.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1_5b \
      --slots 4 --num-requests 8 --prompt-len 32 --gen-len 16 --chunk 8 \
      --kv-layout paged --decode-attn kernel --prefill chunked
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --kv-layout paged --prefill chunked --shared-prefix 20 \
      --prefix-cache on --entropy operand --spec-decode on --spec-k 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --kv-layout paged --num-requests 4 --policy priority \
      --priorities 2,2,2,0 --arrivals 0,0,0,4 --escalate-mi 0.5
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek_moe_16b --device cpu --kv-layout paged \
      --decode-attn kernel --prefill chunked
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m \
      --device cpu --kv-layout paged --decode-attn kernel --prefill chunked
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \
      --device cpu --kv-layout paged --decode-attn kernel --prefill chunked
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless_m4t_medium --device cpu --kv-layout paged \
      --decode-attn kernel --prefill chunked
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi_3_vision_4_2b --device cpu --kv-layout paged \
      --decode-attn kernel --prefill chunked
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --mesh 1x2 --kv-layout paged --decode-attn kernel --prefill chunked
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --mesh 1x2 --kv-layout paged --entropy operand --spec-decode on
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --mesh 1x2 --kv-layout paged --num-requests 4 --policy priority \
      --priorities 2,2,2,0 --slo-ms 0,0,0,500 --arrivals 0,0,0,4 \
      --escalate-mi 0.5
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.entropy import KernelEntropy
from repro_torch.data.synthetic import TokenStreamState, token_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.models import registry as M


def make_requests(args, cfg) -> list[Request]:
    stream = TokenStreamState(seed=args.seed, host=0, num_hosts=1)
    toks, _ = token_batch(stream, args.num_requests, args.prompt_len,
                          cfg.vocab_size)
    toks = np.asarray(toks, np.int32).copy()
    if args.shared_prefix:
        n = min(args.shared_prefix, args.prompt_len)
        toks[:, :n] = toks[0, :n]
    # comma lists cycle across the request indices
    prios = [int(x) for x in args.priorities.split(",")] \
        if args.priorities else [0]
    slos = [float(x) / 1e3 if float(x) > 0 else None
            for x in args.slo_ms.split(",")] if args.slo_ms else [None]
    arrivals = [int(x) for x in args.arrivals.split(",")] \
        if args.arrivals else [0]
    reqs = [Request(rid=i, prompt=toks[i], max_new_tokens=args.gen_len,
                    priority=prios[i % len(prios)],
                    slo_s=slos[i % len(slos)],
                    arrival_step=arrivals[i % len(arrivals)])
            for i in range(args.num_requests)]
    if args.long_prompt:
        long_toks, _ = token_batch(TokenStreamState(seed=args.seed + 1,
                                                    host=0, num_hosts=1),
                                   1, args.long_prompt, cfg.vocab_size)
        reqs[0] = Request(rid=0,
                          prompt=np.asarray(long_toks, np.int32)[0],
                          max_new_tokens=args.gen_len,
                          priority=reqs[0].priority, slo_s=reqs[0].slo_s,
                          arrival_step=reqs[0].arrival_step)
    return reqs


def build_engine(args, params=None, head_noise=None,
                 cfg: ArchConfig | None = None, tp=None
                 ) -> tuple[ServeEngine, ArchConfig]:
    """The engine the CLI serves with, and its config: random weights
    from ``--seed`` on ``--device``, or ``params`` already there (another
    engine's, so that two engines of one model hold one copy; or a
    trained state's ``registry.serving_params``).  ``head_noise``: an
    operand-noise provider for the engine (tests inject the JAX xi).
    ``cfg``: the model's config where it is not ``--arch``'s own (a
    training state cut in depth, ``launch.train.train_config``).  On
    CUDA this captures the decode chunk's graph (``ModelRunner``); the
    engine serves any number of ``run`` calls with it.  ``tp``: this
    rank's ``launch.mesh.TP`` under ``--mesh`` (the engine then runs on
    its device and keeps its share of the parameters)."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, head_entropy=args.entropy)
    device = resolve_device(args.device if tp is None else tp.device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = M.init_params(cfg, gen, device)

    entropy = KernelEntropy(seed=args.seed) \
        if args.entropy == "kernel" else None
    max_len = args.prompt_len + args.gen_len + args.chunk
    kv_blocks = args.kv_blocks
    if args.long_prompt and kv_blocks is None and args.kv_layout == "paged":
        bf = -(-(args.long_prompt + args.gen_len + args.chunk)
               // args.kv_block)
        kv_blocks = args.slots * -(-max_len // args.kv_block) + bf
    engine = ServeEngine(
        params, cfg, num_slots=args.slots, max_len=max_len,
        chunk=args.chunk, entropy=entropy,
        mi_threshold=args.mi_threshold, se_threshold=args.se_threshold,
        eos_id=args.eos_id, kv_layout=args.kv_layout,
        kv_block=args.kv_block, kv_blocks=kv_blocks,
        decode_attn=args.decode_attn, prefill_mode=args.prefill,
        prefill_chunk=args.prefill_chunk, trace_every=args.trace_every,
        device=device, prefix_cache=args.prefix_cache == "on",
        spec_decode=args.spec_decode == "on", spec_k=args.spec_k,
        spec_mi_threshold=args.spec_mi_threshold,
        spec_draft_s=args.spec_draft_s, spec_k_min=args.spec_k_min,
        spec_k_max=args.spec_k_max, policy=args.policy,
        escalate_mi=args.escalate_mi, escalate_s=args.escalate_s,
        head_noise=head_noise, mesh=tp)
    return engine, cfg


def serve_rank(tp, args) -> dict:
    """One rank of a ``--mesh`` serve (``launch.mesh.spawn`` runs it):
    build this rank's engine and serve the trace."""
    return serve(args, build_engine(args, tp=tp))


def serve(args, built=None) -> dict:
    """Serve ``args``' request trace; ``built`` is a ``build_engine(args)``
    pair to serve with again (a new engine without it).  Under ``--mesh
    1xM`` (M > 1) and outside a process group this spawns the M ranks
    (``serve_rank``) and returns rank 0's result; a process that already
    is a rank (``torchrun``) joins the group and serves its share."""
    m = meshlib.parse_mesh(args.mesh)
    if built is None and m is not None and m > 1:
        if not meshlib.in_group():
            resolve_device(args.device)   # no GPU raises before a rank starts
            return meshlib.spawn(m, args.device, serve_rank, args)[0]
        built = build_engine(args, tp=meshlib.join(m, args.device))
    engine, cfg = built or build_engine(args)
    device = engine.device
    result = engine.run(make_requests(args, cfg))

    # randomness crossing device memory per decoded token: the operand xi
    # is (S, B, V) f32 per step, S*V*4 per token; 0 when the CUDA head
    # kernel draws it in place (its plain CPU version materializes it)
    in_kernel = args.entropy == "kernel" and device.type == "cuda"
    result["entropy_mode"] = args.entropy
    result["entropy_hbm_bytes_per_token"] = 0 if in_kernel else \
        cfg.mc_samples * cfg.vocab_size * 4
    result["mesh"] = "none" if engine.mesh is None \
        else engine.mesh.describe()
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; raises "
                         "without a GPU — 'cpu' runs the plain PyTorch "
                         "paths)")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots (the decode batch)")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16,
                    help="max new tokens per request")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per host round-trip")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--mi-threshold", type=float, default=0.05)
    ap.add_argument("--se-threshold", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--entropy", choices=("operand", "kernel"),
                    default="kernel",
                    help="'kernel': head draws from the Philox stream "
                         "inside the fused CUDA head (0 bytes of "
                         "randomness in memory); 'operand': an explicit "
                         "(slot, depth)-keyed xi tensor")
    ap.add_argument("--kv-layout", choices=("dense", "paged"),
                    default="dense",
                    help="'paged': KV in a global pool of --kv-block-token "
                         "blocks behind per-slot block tables; 'dense': one "
                         "max_len strip per slot, the reference layout")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="tokens per KV block (paged layout)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="pool size in blocks (default: full dense "
                         "capacity, slots * ceil(max_len / kv_block))")
    ap.add_argument("--decode-attn", choices=("kernel", "gather"),
                    default="gather",
                    help="paged attention read path: 'kernel' runs the "
                         "block-sparse CUDA kernels over the pool; "
                         "'gather' materializes the logical span, the "
                         "reference")
    ap.add_argument("--prefill", choices=("batch", "chunked"),
                    default="batch",
                    help="'chunked': interleave --prefill-chunk prompt "
                         "tokens of one admitting request with every "
                         "decode chunk (needs --kv-layout paged); 'batch': "
                         "whole-prompt prefill at admission, the reference")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per interleaved prefill chunk "
                         "(rounded up to ssm_chunk on hybrid)")
    ap.add_argument("--long-prompt", type=int, default=0,
                    help="give request 0 a prompt of N tokens (block "
                         "tables grow on demand)")
    ap.add_argument("--trace-every", type=int, default=1,
                    help="record the scheduler/pool snapshot every N "
                         "chunks")
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="off",
                    help="'on': radix prefix cache over the paged pool — "
                         "prompts sharing a cached prefix map its blocks "
                         "read-only (no prefill for the hit span, "
                         "copy-on-write at divergence); needs --kv-layout "
                         "paged")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="make the first N prompt tokens identical "
                         "across requests")
    ap.add_argument("--spec-decode", choices=("on", "off"), default="off",
                    help="'on': uncertainty-gated speculative decoding — a "
                         "k-step draft on the full body with a cheap head, "
                         "the full-sample head verifying each position at "
                         "the same (slot, depth) noise, only slots whose "
                         "carried MI lies below --spec-mi-threshold "
                         "drafting; the stream equals spec-decode off bit "
                         "for bit (needs --entropy operand)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft positions per speculative round")
    ap.add_argument("--spec-mi-threshold", type=float, default=None,
                    help="MI gate for drafting (default: --mi-threshold); "
                         "0 never speculates")
    ap.add_argument("--spec-draft-s", type=int, default=1,
                    help="head samples of the draft proposals (0 = the "
                         "mean head)")
    ap.add_argument("--spec-k-min", type=int, default=None,
                    help="adaptive draft-depth floor: a per-slot "
                         "acceptance EMA walks k between --spec-k-min and "
                         "--spec-k-max (default: both --spec-k)")
    ap.add_argument("--spec-k-max", type=int, default=None,
                    help="adaptive draft-depth ceiling (see --spec-k-min)")
    ap.add_argument("--policy", choices=("fifo", "priority"),
                    default="fifo",
                    help="scheduling policy: 'fifo' admits in submission "
                         "order (the reference); 'priority' ranks by "
                         "(--priorities class, SLO deadline, order) and "
                         "preempts a decoding slot of a worse class under "
                         "pressure")
    ap.add_argument("--priorities", default="",
                    help="comma list of priority classes cycled across "
                         "requests (reported per class)")
    ap.add_argument("--slo-ms", default="",
                    help="comma list of SLO deadlines in ms cycled across "
                         "requests (0 = none)")
    ap.add_argument("--arrivals", default="",
                    help="comma list of arrival steps cycled across "
                         "requests (empty = all at 0)")
    ap.add_argument("--escalate-mi", type=float, default=None,
                    help="hand a decoding request to the high-S escalation "
                         "lane when its carried MI reaches this threshold; "
                         "default: off")
    ap.add_argument("--escalate-s", type=int, default=None,
                    help="MC head samples of the escalation lane (default: "
                         "4x the serving S); each S builds its own lane "
                         "runner once")
    ap.add_argument("--mesh", default=None,
                    help="serve tensor-parallel over 1xM ranks (spawned, "
                         "or torchrun's): NCCL with a card a rank where "
                         "the machine has M cards, else gloo on --device")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="also dump the run's stats dict (counters only, "
                         "no per-request streams) as JSON")
    return ap


def main():
    args = build_parser().parse_args()
    r = serve(args)
    print(f"served {r['num_requests']} requests / {r['gen_tokens']} tokens "
          f"in {r['total_s']:.2f}s on {args.device}")
    print(f"prefill first-shape {r['prefill_compile_s']:.2f}s  "
          f"steady {r['prefill_steady_s'] * 1e3:.1f}ms  "
          f"({r['prefill_compiles']} shapes)")
    print(f"prefill: {r['prefill_mode']} mode"
          + (f", {r['prefill_chunks']} chunks of {r['prefill_chunk']}"
             if r['prefill_mode'] == "chunked" else "")
          + f"  decode inter-arrival p99 "
            f"{r['decode_interarrival_p99_s'] * 1e3:.1f}ms")
    if r["kv"]["layout"] == "paged":
        print(f"tables: {r['table_growths']} growths")
    print(f"policy: {r['policy']}  preemptions {r['preemptions']}")
    if r["mesh"] != "none":
        print(f"mesh: {r['mesh']}")
    print(f"decode {r['decode_tok_per_s']:.1f} tok/s "
          f"(e2e {r['e2e_tok_per_s']:.1f})  "
          f"latency p50 {r['latency_p50_s']:.2f}s "
          f"p99 {r['latency_p99_s']:.2f}s "
          f"max {r['latency_max_s']:.2f}s")
    print(f"latency split: queue p99 {r['queue_time_p99_s']:.2f}s  "
          f"service p99 {r['service_time_p99_s']:.2f}s")
    if len(r["per_class"]) > 1:
        for cls, c in sorted(r["per_class"].items()):
            print(f"  class {cls}: {c['num_requests']} reqs  "
                  f"latency p50 {c['latency_p50_s']:.2f}s "
                  f"p99 {c['latency_p99_s']:.2f}s  "
                  f"queue p99 {c['queue_p99_s']:.2f}s  "
                  f"{c['escalations']} escalations  "
                  f"{c['preemptions']} preemptions")
    esc = r["escalation"]
    if esc["enabled"]:
        print(f"escalation: {esc['escalations']} requests at MI >= "
              f"{esc['mi_threshold']} finished at S={esc['verify_samples']} "
              f"({esc['tokens']} tokens, {esc['skipped_too_long']} "
              f"skipped too-long)")
    print(f"epistemic flags {r['epistemic_flags']}  "
          f"aleatoric flags {r['aleatoric_flags']}")
    print(f"entropy: {r['entropy_mode']} path, "
          f"{r['entropy_hbm_bytes_per_token'] / 1e6:.2f} MB/token "
          f"of randomness in device memory")
    kv = r["kv"]
    if kv["layout"] == "paged":
        da = r["decode_attn"]
        print(f"kv: paged, {kv['blocks_peak']}/{kv['blocks_total']} blocks "
              f"peak; decode attn {da['mode']} — "
              f"{da['kv_bytes_read_per_step'] / 1e3:.1f} KB KV read/step "
              f"vs {da['kv_bytes_span_per_step'] / 1e3:.1f} KB span")
    else:
        print(f"kv: dense strips, {kv['bytes_in_use_peak'] / 1e6:.2f} MB")
    sd = r["spec_decode"]
    if sd["enabled"]:
        print(f"spec decode: k={sd['k']}, {sd['rounds']} rounds, "
              f"{sd['accepted']}/{sd['drafted']} proposals accepted "
              f"({sd['acceptance_rate']:.0%}), "
              f"{sd['tokens_per_round']:.2f} tokens/round, "
              f"{sd['rollbacks']} rollbacks, "
              f"{sd['gated_slot_rounds']} MI-gated slot-rounds, "
              f"{sd['full_model_calls']} full-model calls for "
              f"{r['gen_tokens']} tokens")
        if sd["k_min"] != sd["k_max"]:
            print(f"  adaptive k in [{sd['k_min']}, {sd['k_max']}]: "
                  f"round depths {sd['round_k_min']}-{sd['round_k_max']}, "
                  f"{sd['k_up']} grows / {sd['k_down']} shrinks")
    pc = r["prefix_cache"]
    if pc["enabled"]:
        print(f"prefix cache: {pc['hits']}/{pc['hits'] + pc['misses']} "
              f"admissions hit ({pc['hit_rate']:.0%}), "
              f"{pc['prompt_tokens_saved']}/{pc['prompt_tokens']} prefill "
              f"tokens saved ({pc['saved_frac']:.0%}), "
              f"{pc['cow_copies']} CoW copies, "
              f"{pc['cache_evictions']} LRU evictions, "
              f"{pc['blocks_cached_end']} blocks cached at exit")
    print("MI per request:")
    for r_ in r["requests"]:
        print(f"  #{r_.rid} ({r_.finish_reason}): "
              + np.array2string(np.asarray(r_.MI), precision=4))
    if args.stats_json:
        payload = {k: v for k, v in r.items() if k != "requests"}
        with open(args.stats_json, "w") as f:
            json.dump(payload, f, indent=2, default=float)
        print(f"stats written to {args.stats_json}")


if __name__ == "__main__":
    main()
