"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving path's shapes, with the stated tolerances; the kernel's
     and the library yardstick's device times (CUDA graph replay), the
     plain version's wall time, and the least time the card could take.
  4. serve: qwen2-1.5B at full width (28 layers, d 1536, bf16 body, f32
     Bayesian head over V = 151936, S = 10 draws), random weights from a
     seed, paged KV + kernel decode attention + chunked prefill + kernel
     entropy; the kernels' launch counts are zeroed before and read after.
  5. profile: a shorter serve of the same path under torch.profiler:
     device busy and idle time, kernels by kind (reported).
  6. compare: the same trace in operand-entropy mode through the kernel
     path and through the gather / batch-prefill reference (reported).
  7. one JSON line of per-kernel numbers, the card's nvidia-smi line, then
     the result line.

Imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# peak rates of one H100 SXM (NVIDIA data sheet, dense): memory, f32 on the
# CUDA cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

SERVE_FLAGS = ["--arch", "qwen2_1_5b", "--slots", "4", "--num-requests", "8",
               "--prompt-len", "256", "--gen-len", "32", "--chunk", "8",
               "--kv-layout", "paged", "--kv-block", "16",
               "--prefill-chunk", "64", "--seed", "0"]


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Wall time per call between CUDA events, the host's launch cost
    included (what the plain versions cost a caller)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, calls: int, rounds: int = 5) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``rounds`` times between CUDA events, so the host's
    per-launch cost (which can exceed a small kernel's run time) stays
    out of the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(rounds):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (rounds * calls)


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def same_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.isnan(a.float()), torch.isnan(b.float())))


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def check_head(dev) -> dict:
    from repro_torch.kernels import ref, rng
    from repro_torch.kernels import uncertainty_head as UH

    K, V, S = 1536, 151936, 10
    g = torch.Generator(device=dev).manual_seed(1)
    mu = torch.randn((K, V), generator=g, device=dev) / math.sqrt(K)
    sigma = 0.01 + 0.05 * torch.rand((K, V), generator=g, device=dev)
    worst, rows = 0.0, {}
    for M in (4, 16):
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        xi = torch.randn((S, M, V), generator=g, device=dev)
        # f32 reductions over K = 1536 and V = 151936 in another order:
        # H and SE (~log V ~ 12) agree to ~1e-5, MI is their difference
        tol = {"H": 2e-4, "SE": 2e-4, "MI": 2e-4, "p_max": 1e-6}
        for mode, kw in (("xi", {"xi": xi}), ("philox",
                                              {"seed": 7, "step": 3})):
            got = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, **kw)
            want = UH.uncertainty_head_plain(x, mu, sigma, num_samples=S,
                                             **kw)
            torch.cuda.synchronize()
            for k, t in tol.items():
                e = max_err(got[k], want[k])
                worst = max(worst, e)
                if not e <= t or not same_nan(got[k], want[k]):
                    fail(f"head M={M} {mode}: {k} max |err| {e:.3g} > {t}")
            # pred must match wherever the top-2 gap of p-bar is resolvable
            xi_full = xi if mode == "xi" else rng.head_normal(
                7, 3, S, M, torch.arange(V, device=dev))
            pbar = torch.softmax(ref.lrt_matmul(x, mu, sigma, xi_full),
                                 dim=-1).mean(0)
            top = pbar.topk(2, dim=-1).values
            clear = (top[:, 0] - top[:, 1]) > 1e-6
            bad = (got["pred"] != want["pred"]) & clear
            if bad.any():
                fail(f"head M={M} {mode}: pred differs on {int(bad.sum())} "
                     "rows with a clear argmax")
            print(f"  head M={M} {mode}: ok (max |err| "
                  f"{max(max_err(got[k], want[k]) for k in tol):.3g})",
                  flush=True)
        a = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, seed=7,
                                     step=3)
        b = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, seed=7,
                                     step=3)
        c = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, seed=8,
                                     step=3)
        if not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"head M={M}: same seed is not bitwise deterministic")
        if torch.equal(a["H"], c["H"]):
            fail(f"head M={M}: different seeds gave the same H")
        if M == 4:   # the serving path's slot count
            run = lambda: UH.uncertainty_head_cuda(  # noqa: E731
                x, mu, sigma, num_samples=S, seed=7, step=3)
            plain = lambda: UH.uncertainty_head_plain(  # noqa: E731
                x, mu, sigma, num_samples=S, seed=7, step=3)
            nbytes = M * K * 2 + 2 * K * V * 4 + 5 * M * 4
            flops = 4.0 * M * K * V
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
            # no single PyTorch call computes the fused head: no library time
            rows = {"ms": device_ms(run, 10),
                    "plain_ms": time_ms(plain, 1, 0),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    rows["max_abs_err"] = worst
    return rows


def _pool(dev, g, NB, BS, Hkv, D):
    return (torch.randn((NB, BS, Hkv, D), generator=g, device=dev)
            .to(torch.bfloat16))


def check_decode(dev) -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import layers as L

    B, H, Hkv, D, BS = 4, 12, 2, 128, 16
    lens_l = [288, 150, 17, 0]           # staggered; slot 3 fully masked
    MB = 19
    NB = B * MB
    g = torch.Generator(device=dev).manual_seed(2)
    k_pool = _pool(dev, g, NB, BS, Hkv, D)
    v_pool = _pool(dev, g, NB, BS, Hkv, D)
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(torch.bfloat16)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(3))
    table = torch.full((B, MB), -1, dtype=torch.int32)
    for b, n in enumerate(lens_l):
        nb = -(-n // BS)
        table[b, :nb] = perm[b * MB:b * MB + nb].to(torch.int32)
    table = table.to(dev)                # shuffled blocks, -1 tails
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    got = PA.paged_decode_attention_cuda(q, k_pool, v_pool, table, lens)
    want = PA.paged_decode_attention_plain(q, k_pool, v_pool, table, lens)
    eff = L.mapped_span(table, BS, lens)
    gather = L.decode_attention(q, L.paged_gather(k_pool, table),
                                L.paged_gather(v_pool, table), eff)
    # the library yardstick: SDPA over the slots' K/V gathered and expanded
    # to the query heads beforehand (that copy is not timed), masked by the
    # readable depth; the fully masked slot is left out
    kx, vx = (L.paged_gather(p, table).repeat_interleave(H // Hkv, dim=2)
              .transpose(1, 2).contiguous() for p in (k_pool, v_pool))
    qx = q.transpose(1, 2).contiguous()
    live = slice(0, 3)
    mask = (torch.arange(kx.shape[2], device=dev)[None, :]
            < eff[:, None])[live, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qx[live], kx[live], vx[live], attn_mask=mask)
    lib_out = lib().transpose(1, 2)
    torch.cuda.synchronize()
    # bf16 outputs of f32 sums taken in another order: one bf16 ulp
    # (2^-8 relative) of O(1) values
    tol = 2e-2
    e = max(max_err(got, want), max_err(got, gather))
    if not e <= tol or not same_nan(got, want) or not same_nan(got, gather):
        fail(f"decode attention: max |err| {e:.3g} > {tol} or NaN mismatch")
    if not torch.isnan(got[3]).all() or torch.isnan(got[:3]).any():
        fail("decode attention: NaN must mark exactly the masked slot")
    e_lib = max_err(got[live], lib_out)
    if not e_lib <= tol:
        fail(f"decode attention: the SDPA yardstick differs by {e_lib:.3g}")
    print(f"  decode attention: ok (max |err| {e:.3g}; SDPA {e_lib:.3g})",
          flush=True)
    cached = sum(lens_l)
    nbytes = q.numel() * 2 * 2 + cached * Hkv * D * 2 * 2 + B * 4
    flops = 4.0 * cached * H * D
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    return {"max_abs_err": e,
            "ms": device_ms(lambda: PA.paged_decode_attention_cuda(
                q, k_pool, v_pool, table, lens), 100),
            "plain_ms": time_ms(lambda: PA.paged_decode_attention_plain(
                q, k_pool, v_pool, table, lens), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lib, 100)}


def check_prefill(dev) -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import layers as L

    S, H, Hkv, D, BS, span = 64, 12, 2, 128, 16, 256
    nblk = span // BS
    NB = 4 * 19
    g = torch.Generator(device=dev).manual_seed(4)
    k_pool = _pool(dev, g, NB, BS, Hkv, D)
    v_pool = _pool(dev, g, NB, BS, Hkv, D)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(5))
    row = perm[:nblk].to(torch.int32).reshape(1, nblk).to(dev)
    worst, timed = 0.0, {}
    for offset in (0, 64, 192):
        q = torch.randn((1, S, H, D), generator=g,
                        device=dev).to(torch.bfloat16)
        for kc in (1024, 64):
            got = PA.paged_prefill_attention_cuda(q, k_pool, v_pool, row,
                                                  offset, span, kc)
            want = PA.paged_prefill_attention_plain(q, k_pool, v_pool, row,
                                                    offset, span, kc)
            ref = L.flash_attention(q, L.paged_gather(k_pool, row)[:, :span],
                                    L.paged_gather(v_pool, row)[:, :span],
                                    causal=True, kv_chunk=kc,
                                    q_offset=offset)
            torch.cuda.synchronize()
            tol = 2e-2               # one bf16 ulp of O(1) outputs
            e = max(max_err(got, want), max_err(got, ref))
            worst = max(worst, e)
            if not e <= tol or not same_nan(got, want) \
                    or torch.isnan(got).any():
                fail(f"prefill attention offset={offset} kv_chunk={kc}: "
                     f"max |err| {e:.3g} > {tol}")
            print(f"  prefill attention offset={offset} kv_chunk={kc}: ok "
                  f"(max |err| {e:.3g})", flush=True)
            if offset == 192 and kc == 1024:   # the serving path's last chunk
                pairs = sum(min(offset + i + 1, span) for i in range(S))
                nbytes = 2 * q.numel() * 2 + span * Hkv * D * 2 * 2
                flops = 4.0 * pairs * H * D
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
                # library yardstick: SDPA over the span gathered and
                # expanded to the query heads beforehand (not timed)
                kx, vx = (L.paged_gather(p, row)[:, :span]
                          .repeat_interleave(H // Hkv, dim=2)
                          .transpose(1, 2).contiguous()
                          for p in (k_pool, v_pool))
                qx = q.transpose(1, 2).contiguous()
                mask = (torch.arange(span, device=dev)[None, :]
                        <= offset + torch.arange(S, device=dev)[:, None])
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qx, kx, vx, attn_mask=mask)
                e_lib = max_err(got, lib().transpose(1, 2))
                if not e_lib <= tol:
                    fail(f"prefill attention: the SDPA yardstick differs by "
                         f"{e_lib:.3g}")
                timed = {
                    "ms": device_ms(lambda: PA.paged_prefill_attention_cuda(
                        q, k_pool, v_pool, row, offset, span, kc), 50),
                    "plain_ms": time_ms(
                        lambda: PA.paged_prefill_attention_plain(
                            q, k_pool, v_pool, row, offset, span, kc), 5),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": device_ms(lib, 50)}
    return dict(timed, max_abs_err=worst)


# --------------------------------------------------------------------------
# phases 4-6: serving at full width
# --------------------------------------------------------------------------

def serve_full(extra: list[str]) -> dict:
    from repro_torch.launch.serve import build_parser, serve

    args = build_parser().parse_args(SERVE_FLAGS + extra)
    args.reduced = False                  # full width, from Python
    torch.cuda.synchronize()
    return serve(args)


def check_serve(r: dict, counts: dict) -> None:
    steps, chunks = r["spec_decode"]["full_model_calls"], r["prefill_chunks"]
    want = {"paged_decode_attention": 28 * steps,
            "paged_prefill_attention": 28 * chunks,
            "uncertainty_head": steps}
    for name, n in want.items():
        if counts[name] != n or n == 0:
            fail(f"serve: {name} launched {counts[name]} times, expected "
                 f"{n} (> 0)")
    for req in r["requests"]:
        if req.state != "finished" or len(req.tokens) != 32:
            fail(f"serve: request {req.rid} did not finish "
                 f"({req.state}, {len(req.tokens)} tokens)")
        u = torch.tensor([req.H, req.SE, req.MI])
        if not torch.isfinite(u).all() or (u[2] < 0).any():
            fail(f"serve: request {req.rid} has non-finite H/SE/MI or MI < 0")


KINDS = (("paged_decode", "decode-attn kernel"),
         ("paged_prefill", "prefill-attn kernel"),
         ("head_", "head kernel"),
         ("gemm", "matmul"), ("gemv", "matmul"), ("cutlass", "matmul"),
         ("xmma", "matmul"), ("nvjet", "matmul"),
         ("index", "index/scatter"), ("scatter", "index/scatter"),
         ("gather", "index/scatter"))


def profile_serve() -> str:
    """A short kernel-path serve under torch.profiler (1 prefill chunk per
    request, 2 decode chunks each): device time by kind of kernel, and how
    much of the traced window the device sits idle.  The profiler slows
    the host, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    trace = ROOT / "build" / "serve_trace.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = serve_full(["--decode-attn", "kernel", "--prefill", "chunked",
                        "--entropy", "kernel", "--num-requests", "4",
                        "--prompt-len", "64", "--gen-len", "16"])
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    kern = sorted((e["ts"], e["dur"], e["name"]) for e in events
                  if e.get("cat") == "kernel")
    if not kern:
        fail("profile: the trace holds no device kernel")
    busy, end = 0.0, -math.inf
    by_kind: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for ts, dur, name in kern:
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
        kind = next((k for key, k in KINDS if key in name.lower()),
                    "elementwise/other")
        for table, key in ((by_kind, kind), (by_name, name[:70])):
            acc = table.setdefault(key, [0.0, 0])
            acc[0] += dur
            acc[1] += 1
    window = end - kern[0][0]
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and "Synchronize" in e.get("name", ""))
    steps = r["spec_decode"]["full_model_calls"]
    def top(table, n):
        return ", ".join(f"{k} {v[0] / 1e3:.2f} ms ({v[1]})" for k, v in
                         sorted(table.items(), key=lambda kv: -kv[1][0])[:n])

    return (f"profile, kernel path, {steps} decode steps + "
            f"{r['prefill_chunks']} prefill chunks: device busy "
            f"{busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms window (idle "
            f"{1 - busy / window:.1%}), {len(kern)} kernels, {syncs} "
            f"host syncs\n  by kind: {top(by_kind, len(by_kind))}\n"
            f"  top kernels: {top(by_name, 8)}")


def compare_plain(kernel_run: dict, ref_run: dict) -> str:
    equal = total = 0
    dmi = 0.0
    for a, b in zip(kernel_run["requests"], ref_run["requests"]):
        diverged = False
        for t, (ta, tb) in enumerate(zip(a.tokens, b.tokens)):
            total += 1
            equal += ta == tb
            if not diverged:
                dmi = max(dmi, abs(a.MI[t] - b.MI[t]))
            diverged = diverged or ta != tb
    return (f"operand mode, kernel path vs gather/batch reference: "
            f"{equal}/{total} tokens equal ({equal / max(total, 1):.1%}), "
            f"max |dMI| before the first divergence {dmi:.3g}")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on a GPU")
    dev = torch.device("cuda")
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.kernels import build, launches

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s "
          + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in report.items()),
          flush=True)
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    print("kernels vs plain versions:", flush=True)
    rows = {"uncertainty_head": check_head(dev),
            "paged_decode_attention": check_decode(dev),
            "paged_prefill_attention": check_prefill(dev)}
    print(f"phase kernels: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    launches.reset()
    r = serve_full(["--decode-attn", "kernel", "--prefill", "chunked",
                    "--entropy", "kernel"])
    counts = launches.snapshot()
    check_serve(r, counts)
    steps = r["spec_decode"]["full_model_calls"]
    print(f"serve qwen2-1.5b full width: {r['gen_tokens']} tokens, decode "
          f"{r['decode_tok_per_s']:.1f} tok/s, e2e {r['e2e_tok_per_s']:.1f} "
          f"tok/s, {r['prefill_chunks']} prefill chunks, {steps} decode "
          f"steps ({r['decode_s'] / steps * 1e3:.2f} ms each), latency p50 "
          f"{r['latency_p50_s']:.2f}s p99 {r['latency_p99_s']:.2f}s, "
          f"launches {counts}", flush=True)
    print(f"phase serve: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    print(profile_serve(), flush=True)
    print(f"phase profile: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    a = serve_full(["--decode-attn", "kernel", "--prefill", "chunked",
                    "--entropy", "operand"])
    b = serve_full(["--decode-attn", "gather", "--prefill", "batch",
                    "--entropy", "operand"])
    print(compare_plain(a, b), flush=True)
    print(f"phase compare: {time.perf_counter() - t0:.1f}s", flush=True)

    meta = {
        "uncertainty_head": ("src/repro_torch/kernels/csrc/uncertainty_head.cu",
                             "src/repro/kernels/uncertainty_head.py:291"),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:121"),
        "paged_prefill_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:243"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": counts[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for name, row in rows.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
