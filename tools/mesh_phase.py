"""Phase 17 of ``chip_smoke.py``: serve tensor parallelism on the card.

    python3 tools/mesh_phase.py

runs the phase alone in a fresh process (it builds the kernels first).
qwen2-1.5B at full width (d 1536, H 12, Hkv 2, hd 128, ff 8960,
V 151936), cut in depth to ``LAYERS`` = 4 of its 28 layers for the
script's time, serves the first wave of ``chip_smoke.SERVE_FLAGS``' trace
(``WAVE``: 4 requests of 16 generated tokens, where phase 4 serves 8 of
32) on the kernel path (paged KV, the paged decode and prefill kernels,
chunked prefill) unsharded in this process (the decode chunk a CUDA graph) and at
``--mesh 1x2`` in two spawned ranks, in operand and in kernel entropy.
The card machine has one card, so the two ranks form a gloo group, both
on ``cuda:0``, every collective staged through host memory and the
decode chunk run eagerly: this shows the sharded layout, each rank's
kernel calls, parity and the per-rank memory, and says nothing of
tensor-parallel speed.  The phase

  (a) prints, as a diagnostic, how column slices of the served GEMMs'
      shapes (cuBLAS, bf16 body and f32 head) compare with the full
      products' columns, and the plain attention reads (einsums over
      the heads) on one rank's heads with the same heads of the whole
      call: bit for bit, or the max difference;
  (b) asserts each rank's streams equal the unsharded run's: tokens
      exactly, H / SE / MI / p_max bit for bit, the flag counts equal,
      and both ranks equal (a backend that breaks bit equality fails
      here, whatever (a) printed);
  (c) counts, with torch.profiler in each rank, the ``paged_decode_mma``
      and ``paged_prefill_mma`` launches of a short serve and asserts
      every one ran on one kv head (decode grid (B, Hkv, splits), prefill
      grid (Hkv, row blocks));
  (d) prints each rank's parameter and KV bytes and its peak device
      memory while serving, beside the prediction (``PREDICTED_GB``) and
      the card's name and power limit;
  (e) serves the same first wave with speculative decoding in operand
      entropy (k 4, a one-draw draft head, the gate open:
      ``chip_smoke.SPEC_FORCED``) at ``--mesh 1x2`` and asserts both
      ranks equal, bit for bit, the unsharded spec-on engine in this
      process (its rounds graphed) in streams and schedule, and the
      unsharded spec-off run of (b); prints rounds, acceptance,
      rollbacks and full-model calls; and profiles each rank's first
      spec round, whose ``paged_decode_mma`` launches (``LAYERS`` x k)
      must each run on one kv head;
  (f) serves phase 15's priority burst (``chip_smoke.BURST_FLAGS``, three
      class-0 requests with SLO 0.5 s) under the priority policy with
      the escalation lane armed at S 40 by phase 15's rule (the upper
      quartile of an unsharded fifo run's chunk-end MI), kernel entropy,
      at ``--mesh 1x2``, against the unsharded engine in this process
      (graphed): admission order, preemptions, escalations and the
      lane's requests, and every stream, bit for bit on both ranks; each
      rank's fused head launched at S 40 (the lane, the head whole) and
      the lane's runner on the main runner's parameter storage.  (e) and
      (f) print each rank's peak memory beside ``PREDICTED_PEAK_GB``.

All of it runs in one spawn of the two ranks.  Returns the serving
kernels' launches over both ranks' measured runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402

MESH = 2
# layers served (of 28): every serve of the phase, the unsharded ones
# too, is cut in depth for the script's time; the widths stay whole.
# Eager serves on gloo cost in proportion to the depth
LAYERS = 4
# the trace's first wave only, 16 tokens a request: phase 4 serves all 8
# requests at 32
WAVE = ["--num-requests", "4", "--gen-len", "16"]
FLAGS = C.SERVE_FLAGS + C.KERNEL_PATH + WAVE
# the profiled serve of (c): 4 prompts of 64 tokens (one prefill chunk
# each), 4 tokens each (one decode chunk)
PROFILE = ["--num-requests", "4", "--prompt-len", "64", "--gen-len", "4"]
STREAMS = ("tokens", "H", "SE", "MI", "p_max", "epistemic_flags",
           "aleatoric_flags")
# per-rank parameter GB predicted from the shapes at ``LAYERS`` (PERF.md):
# the bf16 body at M 2 (62.9 MB a layer: wq, wk, wv, w1, w3 halved, wo
# and w2 whole), the embedding (0.467 GB), the f32 head half (operand
# entropy, 0.934 GB) or whole (kernel entropy, 1.867 GB); unsharded the
# body 93.6 MB a layer
PREDICTED_GB = {"operand": 1.652, "kernel": 2.586, "none": 2.708}
# a rank's peak while serving (e) and (f), predicted before the run
# (PERF.md): the parameters above plus what the 28-layer runs held above
# theirs, which does not grow with the depth (0.83 GB in (e): the
# operand head's f32 temporaries and the round's buffers; 0.05 GB in
# (f): the pool and the lane's one-slot dense cache, whose parameters are
# the main runner's: a second copy would add 2.59 GB)
PREDICTED_PEAK_GB = {"spec": (2.3, 2.8), "burst": (2.55, 2.9)}
SERVING = ("paged_decode_attention", "paged_prefill_attention",
           "uncertainty_head")
SPEC = C.SPEC_FORCED


def mesh_config():
    """qwen2-1.5B at full width, cut to ``LAYERS`` layers."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("qwen2_1_5b"), num_layers=LAYERS)


def args_for(entropy: str, extra=()):
    return C.serve_args(FLAGS + ["--entropy", entropy, *extra])


def burst_args(thr: float):
    """Phase 15's priority engine: the burst's flags, the priority policy
    and the lane at ``thr`` and S 40 (kernel entropy)."""
    return C.serve_args(C.BURST_FLAGS + [
        "--policy", "priority", "--escalate-mi", repr(thr), "--escalate-s",
        str(C.ESCALATE_S)], [])


def column_slices(dev) -> list[str]:
    """(a): the served products' column halves against the full product's
    columns on the card: (rows, K, N, dtype) of the decode step's q / k /
    v and gate projections at the main pool's 4 and 2 slots and the
    lane's 1, a prefill chunk's, the lane's batch prefill (48 rows), and
    the head's mean."""
    g = torch.Generator(device=dev).manual_seed(3)
    lines = []
    for rows, K, N, dt in ((1, 1536, 1536, torch.bfloat16),
                           (2, 1536, 1536, torch.bfloat16),
                           (4, 1536, 1536, torch.bfloat16),
                           (1, 1536, 256, torch.bfloat16),
                           (4, 1536, 256, torch.bfloat16),
                           (1, 1536, 8960, torch.bfloat16),
                           (4, 1536, 8960, torch.bfloat16),
                           (48, 1536, 1536, torch.bfloat16),
                           (48, 1536, 256, torch.bfloat16),
                           (48, 1536, 8960, torch.bfloat16),
                           (64, 1536, 8960, torch.bfloat16),
                           (1, 1536, 151936, torch.float32),
                           (2, 1536, 151936, torch.float32),
                           (4, 1536, 151936, torch.float32)):
        x = torch.randn((rows, K), generator=g, device=dev).to(dt)
        w = (torch.randn((K, N), generator=g, device=dev) / K ** 0.5).to(dt)
        full = x @ w
        n = N // MESH
        part = torch.cat([x @ w[:, r * n:(r + 1) * n].contiguous()
                          for r in range(MESH)], dim=1)
        diff = (part.float() - full.float()).abs().max().item()
        lines.append(f"({rows}, {K}) @ ({K}, {N}) {str(dt)[6:]}: "
                     + ("bit for bit" if diff == 0.0 else f"max diff {diff}"))
        del x, w, full, part
    return lines


def head_slices(dev) -> list[str]:
    """(a): the plain attention reads on one rank's heads (6 query heads of
    one kv head) against the same heads of the call on all 12 / 2, on the
    card: the dense decode read (``layers.decode_attention``, one slot
    over an 80-token strip, at two depths) and the batch prefill
    (``layers.flash_attention``, at the lane's re-prefill widths):
    einsums batched over the heads, which the escalation lane runs; bit
    for bit or the max difference."""
    from repro_torch.models import layers as L

    g = torch.Generator(device=dev).manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def line(label, full, part):
        diff = (part.float() - full.float()).abs().max().item()
        return f"{label}: " + ("bit for bit" if diff == 0.0
                               else f"max diff {diff}")

    lines = []
    q, k, v = rnd(1, 1, 12, 128), rnd(1, 80, 2, 128), rnd(1, 80, 2, 128)
    for depth in (25, 61):
        lens = torch.tensor([depth], dtype=torch.int32, device=dev)
        lines.append(line(
            f"decode read, 1 slot, depth {depth} of 80",
            L.decode_attention(q, k, v, lens)[:, :, :6],
            L.decode_attention(q[:, :, :6], k[:, :, :1], v[:, :, :1],
                               lens)))
    for rows in (16, 32, 48, 64, 80):
        q, k, v = (rnd(1, rows, 12, 128), rnd(1, rows, 2, 128),
                   rnd(1, rows, 2, 128))
        lines.append(line(
            f"batch prefill, {rows} rows", L.flash_attention(q, k, v)[
                :, :, :6],
            L.flash_attention(q[:, :, :6], k[:, :, :1], v[:, :, :1])))
    return lines


def streams(r: dict) -> list[dict]:
    return [{k: getattr(q, k) for k in STREAMS} for q in r["requests"]]


def served(engine, args, cfg, requests=None) -> tuple[dict, float]:
    """One measured run of ``requests`` (``args``' trace by default): the
    launch counts zeroed just before it and read just after it, its
    seconds and the peak device memory while it served."""
    from repro_torch.kernels import launches
    from repro_torch.launch.engine import mesh_check as MC
    from repro_torch.launch.serve import make_requests

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    r = engine.run(requests or make_requests(args, cfg))
    torch.cuda.synchronize()
    r["seconds"] = time.perf_counter() - t0
    r["launches"] = launches.snapshot()
    r["schedule"] = MC.schedule(r)
    return r, torch.cuda.max_memory_allocated() / 1e9


def head_samples():
    """Wrap ``ops.uncertainty_head_sampled`` (the fused head's entry): a
    dict {S: fused-head launches at S}, each counted by the launch
    counter around the call; the caller restores the entry with the
    returned function."""
    from repro_torch.kernels import launches, ops

    real = ops.uncertainty_head_sampled
    by_s: dict = {}

    def counted(*a, num_samples, **kw):
        before = launches.COUNTS["uncertainty_head"]
        out = real(*a, num_samples=num_samples, **kw)
        by_s[num_samples] = by_s.get(num_samples, 0) \
            + launches.COUNTS["uncertainty_head"] - before
        return out

    ops.uncertainty_head_sampled = counted

    def restore():
        ops.uncertainty_head_sampled = real

    return by_s, restore


def grids(fn, rank: int) -> dict:
    """``fn()`` under torch.profiler: each ``paged_decode_mma`` /
    ``paged_prefill_mma`` kernel's launches and the set of their grids."""
    from torch.profiler import ProfilerActivity, profile

    trace = C.ROOT / "build" / f"mesh_rank{rank}_trace.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for kind in ("paged_decode_mma", "paged_prefill_mma"):
            if kind in e["name"]:
                row = out.setdefault(kind, {"launches": 0, "grids": set()})
                row["launches"] += 1
                row["grids"].add(tuple(e.get("args", {}).get("grid", ())))
    return {k: {"launches": v["launches"], "grids": sorted(v["grids"])}
            for k, v in out.items()}


def rank_run(tp, entropy: str, profile: bool, mode: str = "plain",
             thr: float = 0.0) -> dict:
    """One rank: build its engine at ``--mesh 1x2`` (full parameters drawn
    from the seed, then its share kept) and serve once (launches
    counted): ``mode`` "plain" the trace, with ``profile`` also a short
    serve under the profiler; "spec" the trace with ``SPEC``, its first
    spec round under the profiler; "burst" phase 15's burst on
    ``burst_args(thr)``, the fused head's launches counted by S."""
    from repro_torch.launch.engine import mesh_check as MC
    from repro_torch.launch.serve import build_engine, make_requests
    from repro_torch.models import registry as M

    args = burst_args(thr) if mode == "burst" \
        else args_for(entropy, SPEC if mode == "spec" else ())
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine, cfg = build_engine(args, tp=tp, cfg=mesh_config())
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    extra, requests, restore = {}, None, None
    if mode == "spec":
        # the first round of the measured run, under the profiler
        runner, real = engine.runner, engine.runner.spec_round

        def first_profiled(k, lens0):
            if "profile" in extra:
                return real(k, lens0)
            got = []
            extra["profile"] = grids(lambda: got.append(real(k, lens0)),
                                     tp.rank)
            extra["profile_k"] = k
            return got[0]

        runner.spec_round = first_profiled
    elif mode == "burst":
        requests = C.burst_requests(cfg.vocab_size)
        extra["heads_by_s"], restore = head_samples()
        lane = engine.escalation_runner(engine.escalate_s)
        extra["lane_shares_params"] = MC.shares_storage(
            lane.params, engine.runner.params)
        extra["lane_graphed"] = lane.graphed
    try:
        r, peak = served(engine, args, cfg, requests)
    finally:
        if restore is not None:
            restore()
        if mode == "spec":
            del engine.runner.spec_round
    out = {"rank": tp.rank, "mesh": engine.mesh.describe(),
           "graphed": engine.runner.graphed, "build_s": build_s,
           "seconds": r["seconds"], "gen_tokens": r["gen_tokens"],
           "streams": streams(r), "launches": r["launches"],
           "schedule": r["schedule"],
           "param_gb": C.tree_bytes(engine.params) / 1e9,
           "kv_gb": M.kv_bytes(engine.runner.cache) / 1e9,
           "pool_heads": engine.runner.cache["k"].shape[-2],
           "build_peak_gb": build_peak, "serve_peak_gb": peak, **extra}
    if profile:
        short = args_for(entropy, PROFILE)
        out["profile"] = grids(
            lambda: engine.run(make_requests(short, cfg)), tp.rank)
    return out


def reference(entropy: str, extra=()) -> dict:
    """The unsharded run in this process (the chunk a CUDA graph; with
    ``extra`` ``SPEC`` the spec rounds too)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import registry as M

    args = args_for(entropy, extra)
    engine, cfg = build_engine(args, cfg=mesh_config())
    r, peak = served(engine, args, cfg)
    out = {"streams": streams(r), "launches": r["launches"],
           "schedule": r["schedule"], "spec": r["spec_decode"],
           "seconds": r["seconds"], "gen_tokens": r["gen_tokens"],
           "param_gb": C.tree_bytes(engine.params) / 1e9,
           "kv_gb": M.kv_bytes(engine.runner.cache) / 1e9,
           "serve_peak_gb": peak}
    del engine
    torch.cuda.empty_cache()
    return out


def burst_reference() -> dict:
    """(f)'s unsharded runs in this process, graphed: the burst under fifo
    (kernel entropy), whose chunk-end MI gives the lane's threshold, then
    under the priority engine with the lane (``burst_args``)."""
    from repro_torch.launch.engine.mesh_check import lane_threshold
    from repro_torch.launch.serve import build_engine

    t0 = time.perf_counter()
    args = C.serve_args(C.BURST_FLAGS, [])
    fifo, cfg = build_engine(args, cfg=mesh_config())
    r_fifo = fifo.run(C.burst_requests(cfg.vocab_size))
    thr, ends = lane_threshold(r_fifo, args.chunk)
    p_args = burst_args(thr)
    prio, _ = build_engine(p_args, fifo.params, cfg=mesh_config())
    del fifo
    r, peak = served(prio, p_args, cfg, C.burst_requests(cfg.vocab_size))
    C.check_risk_run("mesh burst (unsharded)", prio, r)
    out = {"thr": thr, "ends": len(ends), "streams": streams(r),
           "schedule": r["schedule"], "seconds": r["seconds"],
           "gen_tokens": r["gen_tokens"], "serve_peak_gb": peak,
           "lane_graphed": prio.escalation_runner(C.ESCALATE_S).graphed,
           "escalation": {k: r["escalation"][k] for k in
                          ("escalations", "tokens", "steps")},
           "built_s": time.perf_counter() - t0}
    del prio
    torch.cuda.empty_cache()
    return out


def same_schedule(label: str, want: dict, got: dict) -> None:
    """The admission order, slots, preemptions, escalated requests, the
    lane's and the spec rounds' counts of two runs equal."""
    diff = [k for k in want if want[k] != got[k]]
    if diff:
        C.fail(f"mesh {label}: the schedule differs in "
               + "; ".join(f"{k} ({want[k]} vs {got[k]})" for k in diff))


def compare(label: str, want: list, got: list) -> None:
    """(b) for one run: tokens, flags and floats bit for bit."""
    if len(want) != len(got):
        C.fail(f"mesh {label}: {len(got)} requests, unsharded {len(want)}")
    for i, (a, b) in enumerate(zip(want, got)):
        for k in ("tokens", "epistemic_flags", "aleatoric_flags"):
            if a[k] != b[k]:
                C.fail(f"mesh {label}: request {i} {k} differ "
                       f"({a[k]} vs {b[k]})")
        for k in ("H", "SE", "MI", "p_max"):
            if len(a[k]) != len(b[k]):
                C.fail(f"mesh {label}: request {i} {k} lengths differ")
            d = max((abs(x - y) for x, y in zip(a[k], b[k])), default=0.0)
            if d != 0.0:
                C.fail(f"mesh {label}: request {i} {k} differs by {d} "
                       "(bit for bit asked)")


def references() -> dict:
    """(a)'s diagnostics, then the unsharded runs in this process: both
    entropy modes, (e)'s spec-on run held to spec off, (f)'s burst."""
    dev = torch.device("cuda")
    print("mesh: cuBLAS column halves vs the full product's columns "
          "(diagnostic): " + "; ".join(column_slices(dev)), flush=True)
    print("mesh: plain attention on one rank's heads vs the same heads of "
          "the whole call (diagnostic; the lane attends every head): "
          + "; ".join(head_slices(dev)), flush=True)
    torch.cuda.empty_cache()
    refs = {}
    for entropy in ("operand", "kernel"):
        t0 = time.perf_counter()
        refs[entropy] = reference(entropy)
        print(f"mesh: unsharded {entropy} entropy, "
              f"{refs[entropy]['gen_tokens']} tokens, serve "
              f"{refs[entropy]['seconds']:.2f}s, built + "
              f"served {time.perf_counter() - t0:.1f}s", flush=True)
    # (e)'s unsharded spec-on run, held to the spec-off run first
    t0 = time.perf_counter()
    refs["spec"] = reference("operand", SPEC)
    compare("unsharded spec on vs off", refs["operand"]["streams"],
            refs["spec"]["streams"])
    if refs["spec"]["spec"]["rounds"] == 0:
        C.fail("mesh spec: the unsharded engine ran no spec round")
    print(f"mesh: unsharded spec on (k 4, rounds graphed), "
          f"{refs['spec']['gen_tokens']} tokens, bit for bit against spec "
          f"off; serve {refs['spec']['seconds']:.2f}s, built + served "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    refs["burst"] = burst_reference()
    b = refs["burst"]
    print(f"mesh: unsharded priority burst, escalate-mi {b['thr']:.6g} (the "
          f"upper quartile of {b['ends']} chunk-end MIs of the fifo run), "
          f"{b['gen_tokens']} tokens, escalations {b['escalation']}, "
          f"admissions {b['schedule']['admissions']}, preemptions "
          f"{b['schedule']['preemptions']}; serve {b['seconds']:.2f}s, both "
          f"engines built + served {b['built_s']:.1f}s", flush=True)
    return refs


def mesh_phase(smi: str) -> dict:
    from repro_torch.launch import mesh as meshlib

    counts = dict.fromkeys(SERVING, 0)
    # the ranks start first: they reach the card and join their group
    # while this process runs the unsharded references
    with meshlib.Ranks(MESH, "cuda", timeout_s=300) as ranks:
        refs = references()
        for entropy in ("operand", "kernel"):
            ref = refs[entropy]
            t0 = time.perf_counter()
            outs = ranks.run(rank_run, entropy, entropy == "kernel")
            for o in outs:
                compare(f"{entropy} rank {o['rank']}", ref["streams"],
                        o["streams"])
                if o["graphed"] or o["pool_heads"] != 1:
                    C.fail(f"mesh: rank {o['rank']} graphed {o['graphed']},"
                           f" pool heads {o['pool_heads']}")
                # operand entropy takes the plain head tail, no kernel
                for name in SERVING[:2 if entropy == "operand" else 3]:
                    if o["launches"][name] == 0:
                        C.fail(f"mesh {entropy}: rank {o['rank']} launched "
                               f"no {name}")
                for name in SERVING:
                    counts[name] += o["launches"][name]
                prof = o.get("profile")
                if prof is not None:
                    dec, pre = prof.get("paged_decode_mma"), \
                        prof.get("paged_prefill_mma")
                    if not dec or not pre \
                            or any(g[1] != 1 for g in dec["grids"]) \
                            or any(g[0] != 1 for g in pre["grids"]):
                        C.fail(f"mesh: rank {o['rank']} profile: decode "
                               f"{dec}, prefill {pre}: not one kv head")
                    print(f"mesh: rank {o['rank']} profile (short serve): "
                          f"paged_decode_mma {dec['launches']} launches, "
                          f"grids {dec['grids']}; paged_prefill_mma "
                          f"{pre['launches']} launches, grids "
                          f"{pre['grids']}", flush=True)
            want = PREDICTED_GB[entropy]
            for o in outs:
                print(f"mesh: {entropy} entropy rank {o['rank']} "
                      f"({o['mesh']}): streams vs unsharded bit for bit; "
                      f"{o['gen_tokens']} tokens (4 requests of 16, the "
                      f"trace cut to its first wave) in {o['seconds']:.2f}s "
                      f"(eager, host-staged gathers: not a TP speed); "
                      f"params {o['param_gb']:.3f} GB (predicted {want}), "
                      f"KV pool {o['kv_gb'] * 1e3:.1f} MB, peak "
                      f"{o['serve_peak_gb']:.3f} GB serving, "
                      f"{o['build_peak_gb']:.3f} GB building (the whole "
                      f"parameters drawn before the share is kept); "
                      f"launches "
                      f"{dict((k, o['launches'][k]) for k in SERVING)}",
                      flush=True)
            print(f"mesh: {entropy} entropy unsharded: params "
                  f"{ref['param_gb']:.3f} GB (predicted "
                  f"{PREDICTED_GB['none']}), KV pool "
                  f"{ref['kv_gb'] * 1e3:.1f} MB, peak "
                  f"{ref['serve_peak_gb']:.3f} GB serving; {smi}; ranks "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        spec_phase(ranks, refs, counts, smi)
        burst_phase(ranks, refs["burst"], counts, smi)
    return counts


def peak_line(o: dict, key: str) -> str:
    lo, hi = PREDICTED_PEAK_GB[key]
    ok = "inside" if lo <= o["serve_peak_gb"] <= hi else "OUTSIDE"
    return (f"peak {o['serve_peak_gb']:.3f} GB serving (predicted {lo}-{hi},"
            f" {ok})")


def spec_phase(ranks, refs: dict, counts: dict, smi: str) -> None:
    """(e): speculative decoding at 1x2 on both ranks."""
    t0 = time.perf_counter()
    ref = refs["spec"]
    outs = ranks.run(rank_run, "operand", False, "spec")
    for o in outs:
        label = f"spec rank {o['rank']}"
        compare(label, ref["streams"], o["streams"])
        compare(f"{label} vs spec off", refs["operand"]["streams"],
                o["streams"])
        same_schedule(label, ref["schedule"], o["schedule"])
        for name in SERVING[:2]:
            if o["launches"][name] == 0:
                C.fail(f"mesh {label}: launched no {name}")
        for name in SERVING:
            counts[name] += o["launches"][name]
        dec, k = o["profile"].get("paged_decode_mma"), o["profile_k"]
        if not dec or dec["launches"] != LAYERS * k \
                or any(g[1] != 1 for g in dec["grids"]):
            C.fail(f"mesh {label}: its first spec round (k {k}) launched "
                   f"paged_decode_mma {dec}, expected {LAYERS * k} launches "
                   "on one kv head")
        sd = o["schedule"]["spec"]
        print(f"mesh: spec rank {o['rank']} ({o['mesh']}): streams and "
              f"schedule bit for bit against the unsharded spec-on engine "
              f"(graphed) and the streams against spec off; "
              f"{o['gen_tokens']} tokens in {o['seconds']:.2f}s (eager); "
              f"{sd['rounds']} rounds, {sd['accepted']}/{sd['drafted']} "
              f"drafts accepted ({sd['accepted'] / max(sd['drafted'], 1):.3f}"
              f"), {sd['rollbacks']} rollbacks, {sd['full_model_calls']} "
              f"full-model calls for {o['gen_tokens']} tokens (spec off: "
              f"{refs['operand']['spec']['full_model_calls']}); the "
              f"first round (k {k}) under the profiler: paged_decode_mma "
              f"{dec['launches']} launches, grids {dec['grids']}; "
              f"{peak_line(o, 'spec')}; launches "
              f"{dict((n, o['launches'][n]) for n in SERVING)}; {smi}",
              flush=True)
    print(f"mesh: spec ranks {time.perf_counter() - t0:.1f}s", flush=True)


def burst_phase(ranks, ref: dict, counts: dict, smi: str) -> None:
    """(f): phase 15's priority burst with the lane at 1x2."""
    t0 = time.perf_counter()
    outs = ranks.run(rank_run, "kernel", False, "burst", ref["thr"])
    for o in outs:
        label = f"burst rank {o['rank']}"
        compare(label, ref["streams"], o["streams"])
        same_schedule(label, ref["schedule"], o["schedule"])
        sc = o["schedule"]
        if sc["preemptions"] < 1 or not sc["escalated"]:
            C.fail(f"mesh {label}: {sc['preemptions']} preemptions, "
                   f"escalated {sc['escalated']}")
        if o["lane_shares_params"] is not True or o["lane_graphed"]:
            C.fail(f"mesh {label}: the lane shares the parameters "
                   f"{o['lane_shares_params']}, graphed {o['lane_graphed']}")
        by_s = o["heads_by_s"]
        if by_s.get(C.ESCALATE_S, 0) < 1 or by_s.get(C.ESCALATE_S) \
                != sc["lane"]["steps"]:
            C.fail(f"mesh {label}: fused head launches by S {by_s}, the "
                   f"lane ran {sc['lane']['steps']} steps at S "
                   f"{C.ESCALATE_S}")
        for name in SERVING:
            if o["launches"][name] == 0:
                C.fail(f"mesh {label}: launched no {name}")
            counts[name] += o["launches"][name]
        print(f"mesh: burst rank {o['rank']} ({o['mesh']}): streams, "
              f"admissions {sc['admissions']}, {sc['preemptions']} "
              f"preemptions, escalated {sc['escalated']} (lane "
              f"{sc['lane']['tokens']} tokens in {sc['lane']['steps']} steps)"
              f" bit for bit against the unsharded engine (graphed, lane "
              f"graphed {ref['lane_graphed']}); {o['gen_tokens']} tokens in "
              f"{o['seconds']:.2f}s (eager); fused head launches by S "
              f"{by_s}; the lane's runner on the main runner's parameter "
              f"storage (params {o['param_gb']:.3f} GB); "
              f"{peak_line(o, 'burst')}; launches "
              f"{dict((n, o['launches'][n]) for n in SERVING)}; {smi}",
              flush=True)
    print(f"mesh: burst ranks {time.perf_counter() - t0:.1f}s", flush=True)


def main():
    if not torch.cuda.is_available():
        C.fail("no CUDA device: this script runs on a GPU")
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    print(f"mesh launches {mesh_phase(smi)}", flush=True)
    print(f"phase mesh: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
