"""Drive the PyTorch port's serving path and the paper's photonic /
Bayesian path on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes, with the stated tolerances; the kernel's and the
     library yardstick's device times (CUDA graph replay), the plain
     version's wall time, and the least time the card could take.
  4. serve: qwen2-1.5B at full width (28 layers, d 1536, bf16 body, f32
     Bayesian head over V = 151936, S = 10 draws), random weights from a
     seed, paged KV + kernel decode attention + chunked prefill + kernel
     entropy; the kernels' launch counts are zeroed before and read after.
  5. profile: a shorter serve of the same path under torch.profiler:
     device busy and idle time, kernels by kind (reported).
  6. compare: the same trace in operand-entropy mode through the kernel
     path and through the gather / batch-prefill reference (reported).
  7. paper: the machine primitive three ways (PRNG in the path, a stream
     drawn beforehand, entropy drawn in the kernel), the Bayesian layers
     (a seeded dense layer, the im2col probabilistic conv with S seeded
     draws and with one explicit draw) and the blood-cell BNN's MC
     prediction, through the port's entry points; the four paper
     kernels' launch counts are zeroed before each path call and read
     just after it (the checks and timing replays are not counted).
  8. one JSON line of per-kernel numbers, the card's nvidia-smi line, then
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
# 32-bit integer and special-function (log, sqrt, sin, cos, int->float)
# rates: 64 and 16 operations per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x the 1,980 MHz boost clock (H100 SXM data sheet)
INT32_OPS = 132 * 64 * 1.98e9
SFU_OPS = 132 * 16 * 1.98e9
# one Philox4x32-10 call and its four Box-Muller normals: 10 rounds of two
# 32x32->64 products (4 integer multiplies), 4 xors and 2 key adds; then
# 4 int->float conversions, 2 logs, 2 square roots, 2 sines, 2 cosines
PHILOX_INT_OPS = 100
PHILOX_SFU_OPS = 12
ADC_STEP = 4.0 / 127
PAPER_KERNELS = ("photonic_conv", "photonic_conv_sampled", "bayes_matmul",
                 "bayes_matmul_sampled")

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


def bound(nbytes: float, flops: float, peak_flops: float,
          philox_calls: float = 0.0) -> tuple[float, str]:
    """The least time in ms: the larger of the bytes over the memory rate
    and each kind of operation over its peak rate (f32 or bf16 flops, and
    the Philox draws' integer and special-function operations)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / peak_flops,
                philox_calls * PHILOX_INT_OPS / INT32_OPS,
                philox_calls * PHILOX_SFU_OPS / SFU_OPS) * 1e3
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
# phase 3 (paper kernels): photonic conv and the sampled-weight GEMM
# --------------------------------------------------------------------------

def conv_case(dev, B, T, seed=5):
    """bench_throughput.py's machine program: mu = linspace(-0.5, 0.5, 9),
    sigma = 0.2 |mu|, x uniform in [-1, 1]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((B, T), generator=g, device=dev) * 2 - 1
    mu = torch.linspace(-0.5, 0.5, 9, device=dev)
    return x, mu, 0.2 * mu.abs(), g


def adc_check(name: str, got, want) -> float:
    """Photonic outputs: bit-equal, or at most 0.1% of them one ADC step
    (4/127) apart (Box-Muller's libm calls may round an ulp apart between
    the kernel and PyTorch's CUDA ops, and a sum can then cross a level)."""
    d = (got - want).abs()
    flips = int((d > 0).sum())
    if flips > 0.001 * d.numel() or not torch.allclose(
            d[d > 0], torch.full_like(d[d > 0], ADC_STEP), rtol=1e-4):
        fail(f"{name}: {flips} of {d.numel()} outputs differ, or by more "
             f"than one ADC step (max {float(d.max()):.3g})")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite outputs")
    return float(d.max())


def check_photonic(dev) -> tuple[dict, dict]:
    from repro_torch.kernels import photonic_conv as PC
    from repro_torch.kernels import ref

    rows = {}
    for T in (256, 4096):      # bench_throughput's shape; the kernel's regime
        B, C = 1024, 9
        To = T - C + 1
        x, mu, sg, g = conv_case(dev, B, T)
        eps = torch.randn((B, To, C), generator=g, device=dev)
        e1 = adc_check(f"photonic_conv T={T}", PC.photonic_conv_cuda(
            x, mu, sg, eps), PC.photonic_conv_plain(x, mu, sg, eps))
        got = PC.photonic_conv_sampled_cuda(x, mu, sg, 7)
        e2 = adc_check(f"photonic_conv_sampled T={T}", got,
                       PC.photonic_conv_plain(x, mu, sg, seed=7))
        torch.cuda.synchronize()
        if not torch.equal(got, PC.photonic_conv_sampled_cuda(x, mu, sg, 7)) \
                or torch.equal(got, PC.photonic_conv_sampled_cuda(x, mu, sg,
                                                                  8)):
            fail(f"photonic_conv_sampled T={T}: not a function of the seed")
        # library yardstick: one einsum over taps and per-symbol weights
        # formed beforehand (quantization left out)
        idx = (torch.arange(To, device=dev)[:, None]
               + torch.arange(C, device=dev)[None, :])
        taps = ref.quantize(x, 8, 1.0)[:, idx].contiguous()
        w = (mu + sg * eps).flip(-1).contiguous()
        lib = lambda: torch.einsum("btc,btc->bt", taps, w)  # noqa: E731
        n_out = B * To
        calls = 20 if T == 256 else 4
        b1 = bound((B * T + B * To * C + B * To) * 4, 4.0 * n_out * C,
                   F32_FLOPS)
        b2 = bound((B * T + B * To) * 4, 4.0 * n_out * C, F32_FLOPS,
                   philox_calls=n_out * -(-C // 4))
        lib_ms = device_ms(lib, calls)
        for name, err, run, plain, (b_ms, b_by) in (
                ("photonic_conv", e1,
                 lambda: PC.photonic_conv_cuda(x, mu, sg, eps),
                 lambda: PC.photonic_conv_plain(x, mu, sg, eps), b1),
                ("photonic_conv_sampled", e2,
                 lambda: PC.photonic_conv_sampled_cuda(x, mu, sg, 7),
                 lambda: PC.photonic_conv_plain(x, mu, sg, seed=7), b2)):
            row = {"max_abs_err": err, "ms": device_ms(run, calls),
                   "plain_ms": time_ms(plain, 3), "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": lib_ms}
            print(f"  {name} B={B} T={T}: ok (max |err| {err:.3g}), "
                  f"{row['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"plain {row['plain_ms']:.3f} ms, einsum {lib_ms:.4f} ms, "
                  f"{n_out / row['ms'] / 1e6:.3f} Gconv/s", flush=True)
            if T == 256:          # the paper phase's shape
                rows[name] = row
    return rows["photonic_conv"], rows["photonic_conv_sampled"]


def rel_check(name: str, got, want, tol: float = 1e-4) -> float:
    """GEMM outputs: f32 sums in another order, within tol of max |y|."""
    e = max_err(got, want)
    if not e <= tol * float(want.abs().max()) or not torch.isfinite(
            got).all():
        fail(f"{name}: max |err| {e:.3g} > {tol} x max |y|")
    return e


def gemm_case(dev, M, K, N, seed=6):
    """bench_kernels.py's weights: mu ~ 0.02 N(0, 1), sigma ~ 0.01
    |N(0, 1)|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev)
    mu = 0.02 * torch.randn((K, N), generator=g, device=dev)
    sg = 0.01 * torch.randn((K, N), generator=g, device=dev).abs()
    return x, mu, sg, g


def check_gemms(dev, M, K, N, S, r0, r1, seed) -> tuple[float, float]:
    """Both GEMM kernels against their plain versions at one shape: the
    single draw, the S-sample GEMM with an explicit (S, K, N) eps and with
    the seeded stream; rows r0 and r1 (in different 64-row blocks) hold
    the same x, so they must see the same W_s.  Returns the worst errors
    of the single draw and of the sampled GEMM."""
    from repro_torch.kernels import bayes_matmul as BM
    from repro_torch.kernels import ref

    x, mu, sg, g = gemm_case(dev, M, K, N, seed)
    x[r1] = x[r0]
    eps = torch.randn((K, N), generator=g, device=dev)
    eps_s = torch.randn((S, K, N), generator=g, device=dev)
    e1 = rel_check(f"bayes_matmul M={M}", BM.bayes_matmul_cuda(
        x, mu, sg, eps), ref.bayes_matmul(x, mu, sg, eps))
    e2 = rel_check(f"bayes_matmul_sampled eps M={M}",
                   BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=S,
                                                eps=eps_s),
                   BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=S,
                                                 eps=eps_s))
    got = BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=S, seed=11)
    e3 = rel_check(f"bayes_matmul_sampled seeded M={M}", got,
                   BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=S,
                                                 seed=11))
    if not torch.equal(got[:, r0], got[:, r1]):
        fail(f"bayes_matmul_sampled M={M}: identical rows {r0} and {r1} saw "
             "different W_s")
    print(f"  bayes GEMMs M={M} K={K} N={N} S={S}: ok (max |err| {e1:.3g}, "
          f"{e2:.3g}, {e3:.3g}; rows {r0} and {r1} share W_s)", flush=True)
    return e1, max(e2, e3)


def check_bayes(dev) -> tuple[dict, dict]:
    from repro_torch.kernels import bayes_matmul as BM
    from repro_torch.kernels import ref

    M, K, N, S = 128, 1024, 4096, 10
    e1, e2 = check_gemms(dev, M, K, N, S, 5, 77, seed=7)
    # the im2col shape of the paper phase: 2,450 row blocks, ragged K
    Mi, Ki, Ni = 800 * 14 * 14, 19 * 9, 32
    e1i, e2i = check_gemms(dev, Mi, Ki, Ni, S, 5, 100_005, seed=9)
    x, mu, sg, g = gemm_case(dev, M, K, N)
    eps = torch.randn((K, N), generator=g, device=dev)
    eps_s = torch.randn((S, K, N), generator=g, device=dev)
    w = mu + sg * eps
    w_s = mu + sg * eps_s
    b1 = bound((M * K + 3 * K * N + M * N) * 4, 2.0 * M * K * N + 2.0 * K * N,
               F32_FLOPS)
    b2 = bound((M * K + 2 * K * N + S * M * N) * 4,
               2.0 * S * M * K * N + 2.0 * S * K * N, F32_FLOPS,
               philox_calls=K * N * -(-S // 4))
    rows = (
        {"max_abs_err": max(e1, e1i),
         "ms": device_ms(lambda: BM.bayes_matmul_cuda(x, mu, sg, eps), 10),
         "plain_ms": time_ms(lambda: ref.bayes_matmul(x, mu, sg, eps), 3),
         "bound_ms": b1[0], "bound_by": b1[1],
         "library_ms": device_ms(lambda: torch.matmul(x, w), 10)},
        {"max_abs_err": max(e2, e2i),
         "ms": device_ms(lambda: BM.bayes_matmul_sampled_cuda(
             x, mu, sg, num_samples=S, seed=11), 10),
         "plain_ms": time_ms(lambda: BM.bayes_matmul_sampled_plain(
             x, mu, sg, num_samples=S, seed=11), 1, 0),
         "bound_ms": b2[0], "bound_by": b2[1],
         "library_ms": device_ms(lambda: torch.matmul(x, w_s), 10)})
    eps_ms = device_ms(lambda: BM.bayes_matmul_sampled_cuda(
        x, mu, sg, num_samples=S, eps=eps_s), 10)
    for name, row in zip(("bayes_matmul", "bayes_matmul_sampled"), rows):
        print(f"  {name}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}), plain {row['plain_ms']:.2f} ms, "
              f"torch.matmul {row['library_ms']:.4f} ms", flush=True)
    print(f"  bayes_matmul_sampled with the explicit (S, K, N) eps: "
          f"{eps_ms:.4f} ms", flush=True)
    # the im2col shape: 64-row blocks redraw every variate M/64 times
    xi, mui, sgi, gi = gemm_case(dev, Mi, Ki, Ni, seed=8)
    eps_i = torch.randn((S, Ki, Ni), generator=gi, device=dev)
    t_seed = device_ms(lambda: BM.bayes_matmul_sampled_cuda(
        xi, mui, sgi, num_samples=S, seed=3), 5)
    t_eps = device_ms(lambda: BM.bayes_matmul_sampled_cuda(
        xi, mui, sgi, num_samples=S, eps=eps_i), 5)
    blocks = -(-Mi // 64)
    bi = bound((Mi * Ki + 2 * Ki * Ni + S * Mi * Ni) * 4,
               2.0 * S * Mi * Ki * Ni, F32_FLOPS,
               philox_calls=Ki * Ni * -(-S // 4))
    redraw = blocks * Ki * Ni * -(-S // 4)
    print(f"  bayes_matmul_sampled im2col shape M={Mi} K={Ki} N={Ni}: "
          f"in-kernel {t_seed:.4f} ms, explicit eps {t_eps:.4f} ms, bound "
          f"{bi[0]:.4f} ms ({bi[1]}); {blocks} row blocks redraw "
          f"{redraw:.3g} Philox calls = "
          f"{redraw * PHILOX_INT_OPS / INT32_OPS * 1e3:.4f} ms of integer "
          f"work at peak", flush=True)
    return rows


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


def device_trace(fn, name: str) -> dict:
    """``fn()`` under torch.profiler: the device's busy time and the traced
    window (first kernel start to last kernel end, in ms), the kernels,
    the host syncs, and device time by kind and by name.  The profiler
    slows the host, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    trace = ROOT / "build" / f"{name}_trace.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    kern = sorted((e["ts"], e["dur"], e["name"]) for e in events
                  if e.get("cat") == "kernel")
    if not kern:
        fail(f"profile {name}: the trace holds no device kernel")
    busy, end = 0.0, -math.inf
    by_kind: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for ts, dur, kname in kern:
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
        kind = next((k for key, k in KINDS if key in kname.lower()),
                    "elementwise/other")
        for table, key in ((by_kind, kind), (by_name, kname[:70])):
            acc = table.setdefault(key, [0.0, 0])
            acc[0] += dur
            acc[1] += 1
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and "Synchronize" in e.get("name", ""))
    return {"out": out, "busy_ms": busy / 1e3,
            "window_ms": (end - kern[0][0]) / 1e3, "kernels": len(kern),
            "syncs": syncs, "by_kind": by_kind, "by_name": by_name}


def top(table: dict, n: int) -> str:
    return ", ".join(f"{k} {v[0] / 1e3:.2f} ms ({v[1]})" for k, v in
                     sorted(table.items(), key=lambda kv: -kv[1][0])[:n])


def profile_serve() -> str:
    """A short kernel-path serve under torch.profiler (1 prefill chunk per
    request, 2 decode chunks each): device time by kind of kernel, and how
    much of the traced window the device sits idle."""
    t = device_trace(lambda: serve_full(
        ["--decode-attn", "kernel", "--prefill", "chunked", "--entropy",
         "kernel", "--num-requests", "4", "--prompt-len", "64",
         "--gen-len", "16"]), "serve")
    r = t["out"]
    steps = r["spec_decode"]["full_model_calls"]
    return (f"profile, kernel path, {steps} decode steps + "
            f"{r['prefill_chunks']} prefill chunks: device busy "
            f"{t['busy_ms']:.2f} ms of a {t['window_ms']:.2f} ms window (idle "
            f"{1 - t['busy_ms'] / t['window_ms']:.1%}), {t['kernels']} "
            f"kernels, {t['syncs']} host syncs\n"
            f"  by kind: {top(t['by_kind'], len(t['by_kind']))}\n"
            f"  top kernels: {top(t['by_name'], 8)}")


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


# --------------------------------------------------------------------------
# phase 7: the paper's path through the port's entry points
# --------------------------------------------------------------------------

def moments_check(name: str, y, mean, std, S: int) -> str:
    """The mean over S draws lies within the MC error std/sqrt(S) of the
    mean output: the standardized residual is ~N(0, 1) per element (mean
    |z| = 0.80); a biased or mis-scaled stream moves it."""
    if not torch.isfinite(y).all():
        fail(f"{name}: non-finite outputs")
    z = (y.mean(0) - mean) / torch.clamp(std / math.sqrt(S), min=1e-12)
    mz, xz = float(z.abs().mean()), float(z.abs().max())
    if not (0.6 < mz < 1.0 and xz < 8.0):
        fail(f"{name}: sample mean off by mean |z| {mz:.3f}, max {xz:.2f}")
    return f"mean |z| {mz:.3f}, max |z| {xz:.2f}"


def on_path(counts: dict, fn):
    """One call of the paper path: the launch counts are zeroed just
    before it and read just after, and added to ``counts``.  The checks'
    reference calls and the timing replays run outside it."""
    from repro_torch.kernels import launches

    launches.reset()
    out = fn()
    for name, n in launches.snapshot().items():
        if name in counts:
            counts[name] += n
    return out


def paper_machine(dev, counts: dict) -> None:
    """bench_throughput.py's three ways to feed the machine primitive."""
    from repro_torch.core.entropy import EntropyStream, PRNGEntropy
    from repro_torch.core.photonic import conv_throughput_estimate
    from repro_torch.kernels import ops, ref

    B, T, C = 1024, 256, 9
    To = T - C + 1
    x, mu, sg, g = conv_case(dev, B, T, seed=9)
    stream = EntropyStream.create(g, B * To * C, source=PRNGEntropy())
    eps, _ = stream.draw((B, To, C))
    paths = {
        "naive (torch.randn in the path)": lambda: ops.photonic_conv(
            x, mu, sg, torch.randn((B, To, C), device=dev)),
        "fused (stream drawn beforehand)": lambda: ops.photonic_conv(
            x, mu, sg, eps),
        "seeded (drawn in the kernel)": lambda: ops.photonic_conv_sampled(
            x, mu, sg, 7),
    }
    # the spread of each path's outputs around the mean conv must be the
    # machine's: var = sum_k (xq_k sigma_k)^2 plus the ADC's step^2 / 12
    y0 = ref.photonic_conv(x, mu, sg, torch.zeros((B, To, C), device=dev))
    idx = (torch.arange(To, device=dev)[:, None]
           + torch.arange(C, device=dev)[None, :])
    taps = ref.quantize(x, 8, 1.0)[:, idx]
    var = float(((taps * sg.flip(0)) ** 2).sum(-1).mean()) + ADC_STEP ** 2 / 6
    for name, fn in paths.items():
        y = on_path(counts, fn)
        r = float(((y - y0) ** 2).mean()) / var
        if y.shape != (B, To) or not torch.isfinite(y).all() or \
                not 0.9 < r < 1.1:
            fail(f"machine primitive {name}: shape {tuple(y.shape)}, "
                 f"variance ratio {r:.3f}")
        ms = device_ms(fn, 20)
        print(f"  machine primitive B={B} T={T}, {name}: {ms:.4f} ms, "
              f"{B * To / ms * 1e3:.4g} conv/s (variance ratio {r:.3f})",
              flush=True)
    est = conv_throughput_estimate()
    print(f"  the paper's rated analog figure (not a measurement): "
          f"{est['conv_per_s']:.4g} conv/s, {est['latency_ps']} ps per "
          f"convolution", flush=True)


def paper_layers(dev, counts: dict) -> None:
    from repro_torch.core.bayesian import (GaussianVariational,
                                           bayes_dense_sampled, inv_softplus)
    from repro_torch.core.entropy import KernelEntropy
    from repro_torch.kernels import ops

    M, K, N, S = 128, 1024, 4096, 10
    x, mu, sg, _ = gemm_case(dev, M, K, N, seed=12)
    q = GaussianVariational(mu=mu, rho=inv_softplus(sg))
    src = KernelEntropy(seed=3)
    y = on_path(counts, lambda: bayes_dense_sampled(x, q, src, S))
    if y.shape != (S, M, N):
        fail(f"bayes_dense_sampled: shape {tuple(y.shape)}")
    # the moments of the plain GEMMs (f32, TF32 off), not of the kernels
    sigma = q.sigma
    note = moments_check("bayes_dense_sampled", y, x @ mu,
                         torch.sqrt((x * x) @ sigma ** 2), S)
    ms = device_ms(lambda: bayes_dense_sampled(x, q, src, S), 10)
    print(f"  bayes_dense_sampled M={M} K={K} N={N} S={S}: {ms:.4f} ms, "
          f"{note}", flush=True)

    # the BNN's block-1 input widths at bench_bloodcell's 800 test images,
    # run as a full 3x3 probabilistic conv: S seeded draws, and one draw
    # with an explicit eps
    g = torch.Generator(device=dev).manual_seed(13)
    xc = torch.randn((800, 19, 14, 14), generator=g, device=dev)
    wm = 0.2 * torch.randn((32, 19, 3, 3), generator=g, device=dev)
    ws = 0.05 * torch.randn((32, 19, 3, 3), generator=g, device=dev).abs()
    ec = torch.randn((32, 19, 3, 3), generator=g, device=dev)
    yc = on_path(counts, lambda: ops.bayes_conv2d_im2col_sampled(
        xc, wm, ws, 5, num_samples=S))
    y1 = on_path(counts, lambda: ops.bayes_conv2d_im2col(xc, wm, ws, ec))
    if yc.shape != (S, 800, 32, 14, 14) or y1.shape != (800, 32, 14, 14):
        fail(f"bayes_conv2d_im2col(_sampled): shapes {tuple(yc.shape)}, "
             f"{tuple(y1.shape)}")
    note = moments_check(
        "bayes_conv2d_im2col_sampled", yc, F.conv2d(xc, wm, padding=1),
        torch.sqrt(F.conv2d(xc * xc, ws * ws, padding=1)), S)
    e1 = rel_check("bayes_conv2d_im2col", y1,
                   F.conv2d(xc, wm + ws * ec, padding=1))
    ms = device_ms(lambda: ops.bayes_conv2d_im2col_sampled(
        xc, wm, ws, 5, num_samples=S), 5)
    ms1 = device_ms(lambda: ops.bayes_conv2d_im2col(xc, wm, ws, ec), 5)
    print(f"  bayes_conv2d_im2col_sampled x (800, 19, 14, 14), w (32, 19, "
          f"3, 3), S={S}: {ms:.4f} ms (im2col included), {note}",
          flush=True)
    print(f"  bayes_conv2d_im2col, one draw, explicit eps: {ms1:.4f} ms "
          f"(im2col included), max |err| vs F.conv2d {e1:.3g}", flush=True)


def paper_bnn(dev) -> None:
    import numpy as np
    from repro_torch.configs.registry import get_bnn_config
    from repro_torch.core.uncertainty import auroc, predictive_moments
    from repro_torch.data.synthetic import blood_cells, blood_cells_ood
    from repro_torch.models import bnn_cnn as B

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, B.GaussianVariational):
            return B.GaussianVariational(tree.mu.to(device),
                                         tree.rho.to(device))
        return tree.to(device)

    cfg = get_bnn_config("bloodcell")
    pc = B.init_params(torch.Generator().manual_seed(0), cfg)
    params = to(pc, dev)
    rng = np.random.default_rng(0)
    x_id = torch.from_numpy(blood_cells(rng, 800)[0]).to(dev)
    x_ood = torch.from_numpy(blood_cells_ood(rng, 800)[0]).to(dev)

    # the card against the CPU on a small input: mean mode, and machine
    # mode with the same Gamma draws fed to both
    draws = {}

    def noise(s, block, m):
        if s not in draws:
            g = torch.Generator().manual_seed(100 + s)
            draws[s] = torch._standard_gamma(m.cpu(), generator=g)
        return draws[s].to(m.device)

    for mode in ("mean", "machine"):
        a = B.mc_predict(params, cfg, x_id[:16], mode=mode, noise=noise)
        b = B.mc_predict(pc, cfg, x_id[:16].cpu(), mode=mode, noise=noise)
        e = max_err(a.cpu(), b)
        # machine mode: the ADC after the depthwise conv can move one
        # level where cuDNN and the CPU sum in another order
        if not e < (1e-4 if mode == "mean" else 1e-3):
            fail(f"BNN {mode} mode: the card and the CPU differ by {e:.3g}")
        print(f"  BNN {mode} mode, 16 images: card vs CPU max |dp| "
              f"{e:.3g}", flush=True)

    for mode in ("machine", "mean"):
        # host-timed and host-bound: five rounds, the median and the range
        times = []
        for r in range(5):
            gen = torch.Generator(device=dev).manual_seed(100 + r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_id = B.mc_predict(params, cfg, x_id, gen, mode)
            p_ood = B.mc_predict(params, cfg, x_ood, gen, mode)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        for name, p in (("ID", p_id), ("OOD", p_ood)):
            m = predictive_moments(p)
            u = torch.stack([m["H"], m["SE"], m["MI"]])
            if p.shape != (10, 800, 7) or not torch.isfinite(p).all() or \
                    max_err(p.sum(-1), torch.ones_like(p[..., 0])) > 1e-5 \
                    or not torch.isfinite(u).all() or (m["MI"] < 0).any():
                fail(f"BNN {mode} {name}: bad probabilities or H/SE/MI")
        a = float(auroc(predictive_moments(p_ood)["MI"],
                        predictive_moments(p_id)["MI"]))
        t = sorted(times)
        print(f"  BNN bloodcell {mode} mode, N=10: 1600 images in "
              f"{t[2] * 1e3:.1f} ms (median of 5; {t[0] * 1e3:.1f}-"
              f"{t[4] * 1e3:.1f}) = {1600 / t[2]:.1f} images/s; OOD AUROC of "
              f"MI {a:.3f} (reported only: the weights are untrained)",
              flush=True)
        gen = torch.Generator(device=dev).manual_seed(100)
        tr = device_trace(lambda: B.mc_predict(params, cfg, x_id, gen, mode),
                          f"bnn_{mode}")
        print(f"    traced, 800 images: device busy {tr['busy_ms']:.2f} ms "
              f"of a {tr['window_ms']:.2f} ms window, {tr['kernels']} "
              f"kernels, {tr['syncs']} host syncs; top kernels: "
              f"{top(tr['by_name'], 4)}", flush=True)


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
    rows["photonic_conv"], rows["photonic_conv_sampled"] = \
        check_photonic(dev)
    rows["bayes_matmul"], rows["bayes_matmul_sampled"] = check_bayes(dev)
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

    t0 = time.perf_counter()
    paper_counts = dict.fromkeys(PAPER_KERNELS, 0)
    paper_machine(dev, paper_counts)
    paper_layers(dev, paper_counts)
    paper_bnn(dev)
    for name in PAPER_KERNELS:
        if paper_counts[name] == 0:
            fail(f"paper: {name} was not launched")
        counts[name] = paper_counts[name]
    print(f"paper launches {dict((k, counts[k]) for k in PAPER_KERNELS)}",
          flush=True)
    print(f"phase paper: {time.perf_counter() - t0:.1f}s", flush=True)

    meta = {
        "uncertainty_head": ("src/repro_torch/kernels/csrc/uncertainty_head.cu",
                             "src/repro/kernels/uncertainty_head.py:291"),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:121"),
        "paged_prefill_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:243"),
        "photonic_conv": ("src/repro_torch/kernels/csrc/photonic_conv.cu",
                          "src/repro/kernels/photonic_conv.py:56"),
        "photonic_conv_sampled": (
            "src/repro_torch/kernels/csrc/photonic_conv.cu",
            "src/repro/kernels/photonic_conv.py:109"),
        "bayes_matmul": ("src/repro_torch/kernels/csrc/bayes_matmul.cu",
                         "src/repro/kernels/bayes_matmul.py:80"),
        "bayes_matmul_sampled": (
            "src/repro_torch/kernels/csrc/bayes_matmul.cu",
            "src/repro/kernels/bayes_matmul.py:199"),
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
