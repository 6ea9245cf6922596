"""Phase 17 of ``chip_smoke.py``: serve tensor parallelism on the card.

    python3 tools/mesh_phase.py

runs the phase alone in a fresh process (it builds the kernels first).
qwen2-1.5B at full width (28 layers, d 1536, H 12, Hkv 2, hd 128, ff
8960, V 151936) serves the first wave of ``chip_smoke.SERVE_FLAGS``'
trace (4 requests of 16 generated tokens, ``DEPTH``: cut in depth from
8 of 32 to make room for phases 18-19 within the script's time) on the kernel path (paged KV, the paged decode and prefill kernels, chunked prefill)
unsharded in this process (the decode chunk a CUDA graph) and at
``--mesh 1x2`` in two spawned ranks, in operand and in kernel entropy.
The card machine has one card, so the two ranks form a gloo group, both
on ``cuda:0``, every collective staged through host memory and the
decode chunk run eagerly: this shows the sharded layout, each rank's
kernel calls, parity and the per-rank memory, and says nothing of
tensor-parallel speed.  The phase

  (a) prints, as a diagnostic, how column slices of the served GEMMs'
      shapes (cuBLAS, bf16 body and f32 head) compare with the full
      products' columns: bit for bit, or the max difference;
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
      the card's name and power limit.

Returns the serving kernels' launches over both ranks' measured runs.
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
# the trace's first wave only, 16 tokens a request: phase 4 serves all 8
# requests at 32, and phases 18-19 need the time this saves
DEPTH = ["--num-requests", "4", "--gen-len", "16"]
FLAGS = C.SERVE_FLAGS + C.KERNEL_PATH + DEPTH
# the profiled serve of (c): 4 prompts of 64 tokens (one prefill chunk
# each), 4 tokens each (one decode chunk)
PROFILE = ["--num-requests", "4", "--prompt-len", "64", "--gen-len", "4"]
STREAMS = ("tokens", "H", "SE", "MI", "p_max", "epistemic_flags",
           "aleatoric_flags")
# per-rank parameter GB predicted from the shapes (PERF.md): the bf16 body
# at M 2 (0.88 B parameters), the embedding (0.47 GB), the f32 head half
# (operand entropy) or whole (kernel entropy); unsharded 4.95 GB
PREDICTED_GB = {"operand": 3.16, "kernel": 4.09, "none": 4.95}
SERVING = ("paged_decode_attention", "paged_prefill_attention",
           "uncertainty_head")


def args_for(entropy: str, extra=()):
    return C.serve_args(FLAGS + ["--entropy", entropy, *extra])


def column_slices(dev) -> list[str]:
    """(a): the served products' column halves against the full product's
    columns on the card: (rows, K, N, dtype) of the decode step's q / k /
    v and gate projections, a prefill chunk's, and the head's mean."""
    g = torch.Generator(device=dev).manual_seed(3)
    lines = []
    for rows, K, N, dt in ((4, 1536, 1536, torch.bfloat16),
                           (4, 1536, 256, torch.bfloat16),
                           (4, 1536, 8960, torch.bfloat16),
                           (64, 1536, 8960, torch.bfloat16),
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


def streams(r: dict) -> list[dict]:
    return [{k: getattr(q, k) for k in STREAMS} for q in r["requests"]]


def served(engine, args, cfg) -> tuple[dict, float]:
    from repro_torch.kernels import launches
    from repro_torch.launch.serve import make_requests

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    r = engine.run(make_requests(args, cfg))
    torch.cuda.synchronize()
    r["seconds"] = time.perf_counter() - t0
    r["launches"] = launches.snapshot()
    return r, torch.cuda.max_memory_allocated() / 1e9


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


def rank_run(tp, entropy: str, profile: bool) -> dict:
    """One rank: build its engine at ``--mesh 1x2`` (full parameters drawn
    from the seed, then its share kept), serve the trace once (launches
    counted), and with ``profile`` a short serve under the profiler."""
    from repro_torch.launch.serve import build_engine, make_requests
    from repro_torch.models import registry as M

    args = args_for(entropy)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine, cfg = build_engine(args, tp=tp)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    r, peak = served(engine, args, cfg)
    out = {"rank": tp.rank, "mesh": engine.mesh.describe(),
           "graphed": engine.runner.graphed, "build_s": build_s,
           "seconds": r["seconds"], "gen_tokens": r["gen_tokens"],
           "streams": streams(r), "launches": r["launches"],
           "param_gb": C.tree_bytes(engine.params) / 1e9,
           "kv_gb": M.kv_bytes(engine.runner.cache) / 1e9,
           "pool_heads": engine.runner.cache["k"].shape[-2],
           "build_peak_gb": build_peak, "serve_peak_gb": peak}
    if profile:
        short = args_for(entropy, PROFILE)
        out["profile"] = grids(
            lambda: engine.run(make_requests(short, cfg)), tp.rank)
    return out


def reference(entropy: str) -> dict:
    """The unsharded run in this process (the chunk a CUDA graph)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import registry as M

    args = args_for(entropy)
    engine, cfg = build_engine(args)
    r, peak = served(engine, args, cfg)
    out = {"streams": streams(r), "launches": r["launches"],
           "seconds": r["seconds"], "gen_tokens": r["gen_tokens"],
           "param_gb": C.tree_bytes(engine.params) / 1e9,
           "kv_gb": M.kv_bytes(engine.runner.cache) / 1e9,
           "serve_peak_gb": peak}
    del engine
    torch.cuda.empty_cache()
    return out


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


def mesh_phase(smi: str) -> dict:
    from repro_torch.launch import mesh as meshlib

    dev = torch.device("cuda")
    print("mesh: cuBLAS column halves vs the full product's columns "
          "(diagnostic): " + "; ".join(column_slices(dev)), flush=True)
    torch.cuda.empty_cache()
    refs = {}
    for entropy in ("operand", "kernel"):
        t0 = time.perf_counter()
        refs[entropy] = reference(entropy)
        print(f"mesh: unsharded {entropy} entropy, "
              f"{refs[entropy]['gen_tokens']} tokens, serve "
              f"{refs[entropy]['seconds']:.2f}s, built + "
              f"served {time.perf_counter() - t0:.1f}s", flush=True)
    counts = dict.fromkeys(SERVING, 0)
    t0 = time.perf_counter()
    with meshlib.Ranks(MESH, "cuda", timeout_s=300) as ranks:
        print(f"mesh: {MESH} ranks spawned in {time.perf_counter() - t0:.1f}s",
              flush=True)
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
    return counts


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
