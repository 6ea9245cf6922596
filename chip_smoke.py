"""Drive the PyTorch port's serving path, the paper's photonic / Bayesian
path and the LM-side kernels' library surface on one NVIDIA GPU and check
them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes, with the stated tolerances; the kernel's and the
     library yardstick's device times (CUDA graph replay), the plain
     version's wall time, and the least time the card could take.  The
     tensor-core and SIMT kernels of flash attention, decode and prefill
     attention, the LRT GEMMs and the weight-space GEMMs are each
     checked, the route of every case asserted, with route sweeps for the
     two GEMM families and a split sweep for decode attention (whose
     served case is also timed with the L2 cold; prefill also at a prefix
     hit's mid-block offsets, 200 and 264, and a hit's rows against the
     cold walk's bit for bit).  The photonic convs
     also print their conversion and MUFU counts from the SASS, and one
     Philox call's instructions (a probe built beside the kernels), which
     ``PHILOX_INT_OPS`` in every seeded row's bound is taken from.  Each
     head time is printed beside its stream plan (``head_plan``) and a
     yardstick that is not its library time: two cuBLAS f32 GEMVs that
     read the same mu and sigma bytes.  The
     three serving kernels are also held and timed at deepseek-moe-16b's
     shapes (MHA at H = Hkv = 16; the head at K 2048, V 102400);
     zamba2-7b's come with phase 11, seamless-m4t-medium's with 12,
     phi-3-vision-4.2b's with 13, nemotron-4-15b's, codeqwen1.5-7b's and
     qwen2-7b's with 21.
  4. serve: qwen2-1.5B at full width (28 layers, d 1536, bf16 body, f32
     Bayesian head over V = 151936, S = 10 draws), random weights from a
     seed, paged KV + kernel decode attention + chunked prefill + kernel
     entropy.  One engine, whose decode chunk is one CUDA graph replay
     (its warm-up and capture time printed), serves the trace three
     times; the kernels' launch counts are zeroed before each run and
     read after it (a replay counts the launches its capture recorded);
     decode ms a step and tok/s as median and range, beside the per-token
     loop (``decode_loop_reference``) on the same prompts.  Then every
     chunk of a serve run as the graph replays it against the eager chunk
     (``steps.build_scan_decode``) on a copy of its carry, bit for bit,
     on the kernel path with kernel entropy and on the gather path with
     operand entropy.
  5. profile: a shorter serve of the same path under torch.profiler,
     in a fresh process (``--trace serve``; late in a long process the
     profiler can drop kernels; the traces of phases 5-13 take processes
     started a phase ahead, which import the port, load the kernels and
     open their CUDA context before they wait for their trace's kind),
     the engine built before the window:
     device busy and idle time,
     kernels by kind and a decode step, host syncs by cause and a decode
     step (reported); the served bf16 prefill and decode must run their
     tensor-core kernels and not the SIMT ones, the decode one launch a
     layer a step.
  6. compare: the same trace in operand-entropy mode through the kernel
     path and through the gather / batch-prefill reference (reported).
  7. paper: the machine primitive three ways (PRNG in the path, a stream
     drawn beforehand, entropy drawn in the kernel), the Bayesian layers
     (a seeded dense layer, the im2col probabilistic conv with S seeded
     draws and with one explicit draw) and the blood-cell BNN's MC
     prediction, through the port's entry points; the four paper
     kernels' launch counts are zeroed before each path call and read
     just after it (the checks and timing replays are not counted).
  8. lm kernels: the four LM-side entry points of ``repro_torch.kernels``
     (``lrt_matmul``, ``lrt_matmul_sampled``, ``uncertainty_head`` (the
     two-pass head), ``flash_attention``) at bench_kernels' shape and
     qwen2-1.5B's widths, each call's launches counted around it alone
     (its own kernel, no other), checked against plain f32 GEMMs, the
     fused head and the models' attention, and timed.
  9. moe: deepseek-moe-16b at full width (d 2048, 64 routed experts
     top-6 + 2 shared), cut in depth to ``MOE_DEPTH`` = 4 of its 28
     layers for the script's time, on phase 4's trace through the kernel path,
     served three times by one graphed engine (``serve_arch``, as phase
     21's archs: parameter bytes and the draw's peak against the
     meta-device reckoning, init and capture time, peak memory, decode
     ms a step against its bytes floor and tok/s as median and range, the
     launch counts checked per run), every chunk of a fourth run against
     the eager chunk bit for bit, then operand entropy through the kernel
     path against the gather / batch-prefill path (whose chunks are held
     against the eager chunk too), on the same parameters; then phase
     5's profile of a short moe serve in a fresh process.
 10. ssm: mamba2-370m at full width (d 1024, N 128, V 50280), cut in
     depth to ``SSM_DEPTH`` = 12 of its 48 SSD blocks for the script's
     time, on phase 4's trace and flags, which fall back to the dense
     layout, gather read and batch prefill (asserted): the fused head at
     K 1024, V 50280 (a ragged last tile) against its plain version and
     its bound; one graphed engine serving the trace three times (decode
     ms a step against the step's bytes floor, tok/s, p99, capture time,
     peak memory; the head the only launch); every chunk against the
     eager chunk bit for bit, state included, in kernel and operand
     entropy; one request of 8192 prompt tokens and its decode step;
     phase 5's profile of a short ssm serve in a fresh process.
 11. hybrid: zamba2-7b at full width, cut in depth to ``HYBRID_DEPTH``
     = 13 of its 81 Mamba2 blocks for the script's time (d 3584, one
     shared attention + MLP block applied 3 times, 32 MHA heads of
     D 112, V 32000) on phase 4's trace through the kernel path (paged,
     one pool plane an application; chunked prefill rounded up to
     ssm_chunk 256, asserted): the three serving kernels at its shapes
     (``check_hybrid_shapes``: decode at the served depths and at depth
     8192, prefill of 256-token chunks and a ragged 37-token tail, the
     head at K 3584, V 32000); one graphed engine serving the trace three
     times (3 decode launches and one head a step; decode ms a step
     against the step's bytes floor, tok/s, e2e, p99, capture time, peak
     memory); every chunk against the eager chunk bit for bit, state and
     pools included, in kernel and operand entropy; one request of 8192
     prompt tokens (32 chunks) and its decode step; phase 5's profile of
     a short hybrid serve at the same depth in a fresh process, which
     must name paged_decode_mma<112>, paged_prefill_mma<112> and the
     fused head.
 12. encdec: seamless-m4t-medium at full width (d 1024, 16 MHA heads
     of D 64, ff 4096, V 256206), cut in depth to ``ENCDEC_DEPTH`` = 4
     encoder and 4 decoder layers of its 12 and 12, on phase 4's trace through the kernel path: the three serving kernels at its
     shapes (``check_encdec_shapes``: decode at the served depths, prefill
     S 64 at offsets 0 and 192 of span 256, the head at K 1024, V 256206,
     whose last tile is ragged); one graphed engine serving the trace
     three times (4 decode launches and one head a step; decode ms a step
     against the step's bytes floor, tok/s, e2e, p99, capture time, peak
     memory); every chunk against the eager chunk bit for bit, the cross
     strips ``ck`` / ``cv`` and the pools included, in kernel entropy on
     the kernel path and operand entropy on the gather / batch path; one
     256-token prompt walked in four chunks with random frames (the served
     trace feeds zeros: the frontend is a stub) against batch prefill with
     the same frames; phase 5's profile of a short encdec serve in a
     fresh process, which must name paged_decode_mma<64>,
     paged_prefill_mma<64> and the fused head.
 13. vlm: phi-3-vision-4.2b at full width (d 3072, 32 MHA heads of
     D 96, ff 8192, V 32064, 576 prefix embeds), cut in depth to
     ``VLM_DEPTH`` = 8 of its 32 layers, on phase 4's
     trace at prompt 640 through the kernel path's flags, where the engine
     takes batch prefill (the family has no chunked prefill; asserted):
     the decode kernel and the head at its shapes (``check_vlm_shapes``:
     decode at the served depths, the head at K 3072, V 32064 with an
     argmax planted in the ragged last tile; no prefill kernel on this
     path); one graphed engine serving the trace three times (8 decode
     launches and one head a step, no prefill launch; decode ms a step
     against the step's bytes floor, tok/s, e2e, p99, prefill ms a
     request, init and capture time, peak memory); every chunk against
     the eager chunk bit for bit, pools included, in kernel entropy on
     the kernel path and operand entropy on the gather / batch path; one
     640-token prompt with random prefix embeds (the served trace feeds
     zeros: the frontend is a stub) admitted through ``runner.prefill``
     and held against ``registry.prefill`` and, for four decode steps,
     the kernel read against the gather read; phase 5's profile of a
     short vlm serve in a fresh process, which must name
     paged_decode_mma<96> and the fused head.
 14. prefix cache and speculative decoding: qwen2-1.5B at full width,
     cut in depth to ``SPEC_LAYERS`` = 4 of its 28 layers, on phase 4's
     trace with a 200-token shared prefix through the kernel
     path, six engines on one copy of the parameters (``spec_phase``):
     the prefix cache in kernel entropy (4 hits, 4 misses, 800 of 2,048
     prompt tokens saved, 4 copy-on-write copies, the pool balanced, the
     prefill kernel launched at the hits' offset 200), beside the cache
     off; the operand streams with the cache on and off bit for bit;
     speculative decoding over the cache, k 4 forced and adaptive k 2-6,
     bit for bit against spec off (rounds, acceptance, rollbacks,
     full-model calls, graph capture time, ms a step and tok/s printed,
     none claimed); every replayed spec round against the eager round.
 15. priority scheduling and the escalation lane: qwen2-1.5B at full
     width (``risk_phase``) on the priority burst of
     ``benchmarks/bench_serve.py`` (2 slots, chunk 8, max_len 80, six
     class-2 and three class-0 requests), kernel path and kernel entropy,
     each engine serving it twice and the second run measured: fifo, then
     priority with the escalation lane armed at the upper quartile of the
     fifo run's chunk-end carried MI and S 40 (class latency, queue and
     service time, preemptions, escalations, the lane's steps, seconds and
     graph capture printed; every request at full length, preemptions > 0,
     1 to 8 escalations, finite H / SE / MI, the pool balanced); every
     lane chunk replayed from its graph against the eager chunk bit for
     bit; preempt-and-restore in operand entropy (one slot, a 256-token
     class-2 request preempted at step 8) bit for bit against the solo
     runs; the fused head at S 40, M 1 and 4, against its plain version.
 16. training (``tools/train_phase.py``): every family's SVI train
     steps at full width (deepseek-moe-16b and zamba2-7b cut in depth),
     ms a step, tokens/s and peak memory; each trained state served on
     the kernel path with its launches counted; two phi-3-vision-4.2b
     steps; card against CPU at the reduced configs; the train CLI's
     crash and resume; the blood-cell BNN's paper bars.
 17. mesh (``tools/mesh_phase.py``): qwen2-1.5B at full width, cut in
     depth to 4 of its 28 layers for the script's time, on the first wave
     of phase 4's trace through the kernel path, unsharded (graphed) against
     ``--mesh 1x2``: two spawned ranks, a gloo group on the one card
     (collectives staged through host memory, the chunk eager), in
     operand and kernel entropy; cuBLAS column halves of the served
     products against the full products' columns; tokens, H / SE / MI /
     p_max and flag counts bit for bit on both ranks; each rank's
     ``paged_decode_mma`` / ``paged_prefill_mma`` launches of a short
     serve under torch.profiler on one kv head; each rank's parameter,
     KV and peak bytes against the prediction.  Then, on the same two
     ranks: speculative decoding at ``--mesh 1x2`` (operand entropy, k 4,
     the first wave), both ranks bit for bit against the unsharded
     spec-on engine (graphed) in streams and schedule and against spec
     off in streams, rounds, acceptance, rollbacks and full-model calls
     printed, each rank's first spec round under torch.profiler
     (``paged_decode_mma`` 4 x k launches on one kv head); and phase
     15's priority burst at ``--mesh 1x2`` under priority with the lane
     at S 40 (kernel entropy, phase 15's threshold rule) against the
     unsharded engine: admission order, preemptions, escalations, the
     lane's requests and every stream bit for bit on both ranks, each
     rank's fused head launched at S 40, the lane's runner on the main
     runner's parameter storage, each rank's peak against the
     prediction.
 18. train mesh (``tools/train_mesh_phase.py``): qwen2-1.5B at full
     width, cut in depth to 4 of its 28 layers for the script's time, at
     ``--mesh 2x2`` (data parallel 2 x tensor parallel 2 with
     the sequence-parallel stream; four spawned gloo ranks on the one
     card, collectives staged through host memory), two steps of 8 x 256
     against the unsharded step on the same batches and keys, step 1's
     loss, nll, kl and grad norm within the predicted tolerance; each
     rank's parameter, gradient and moment bytes, peak and collective
     bytes a step against the prediction; qwen2-7b reduced with FSDP at
     2x2, saved and restored at 1x2 bit for bit, a third step against
     the unsharded one; the trained parameters gathered whole and served
     on the kernel path in rank 0 (launches counted).
 19. train mesh families (``tools/train_mesh_phase.py``, on phase 18's
     four ranks): at ``--mesh 2x2`` and full width, seamless-m4t-medium
     whole (its 256206-id head whole on every rank), mamba2-370m whole
     (head-parallel Mamba2 blocks), zamba2-7b cut to 7 of 81 blocks (the
     shared block twice, FSDP) and deepseek-moe-16b cut to 2 of 28 layers
     (FSDP, every expert Megatron over ff, one dispatch group a data
     rank): one step each against the unsharded step at the same depth
     (moe in D groups), loss, nll, kl, grad norm (and aux loss) within
     the stated tolerances; each rank's block of chosen gradients no
     farther from the unsharded float32 step's (same weights) than twice
     the unsharded bf16 step's distance from it; the four at their
     reduced configs in float32, every gradient leaf held; each rank's
     bytes, peak and collective bytes against the prediction; the
     deepseek state gathered whole and served on the kernel path in rank
     0 (launches counted).
 20. dry run (``tools/dryrun_phase.py``): phase 18 (a)'s cell reckoned
     by ``repro_torch.launch.dryrun`` in the main process (rank 0 of a
     fake group of four, fake tensors on cuda, nothing allocated): its
     parameter, gradient and moment bytes and the bytes a rank puts into
     each axis' collectives equal to every rank's measured ones, its
     MemTracker peak within the predicted band of each rank's allocator
     peak, no process group left; its FLOPs printed beside the measured
     step's time.
 21. archs (``tools/arch_phase.py``), with the card's memory freed
     first: the four configs no other phase serves, at full width, cut
     in depth (``chip_smoke.CUTS``): nemotron-4-15b (4 of 32 layers),
     codeqwen1.5-7b (4 of 32), qwen2-7b (4 of 28) and grok-1-314b (2 of
     64).  The three dense archs' serving kernels at their shapes
     (``check_shapes``: decode at 48 over 8, 32 over 32 and 28 over 4
     kv heads of D 128, prefill S 64 at offsets 0 and 192, the head at
     K 6144 x V 256000, 4096 x 92416 and 3584 x 152064 with argmaxes
     planted in the last tile); then each arch served on phase 4's trace
     by one graphed engine (parameter bytes and the draw's peak against
     the meta-device reckoning, launches a replay asserted: grok's
     soft-capped head takes the plain path, no fused head), every chunk
     of a second serve against the eager chunk bit for bit, and operand
     entropy through the kernel path against the gather / batch path
     (its chunks against the eager chunk too; grok's routing flips).
 22. one JSON line of per-kernel numbers (eleven kernels; the serving
     kernels' launches are phase 4's first run plus phases 9's, 11's,
     12's, 13's, 14's, 15's, 16's, 17's (both ranks: the trace in both
     entropy modes, the spec serve and the priority burst), 18's, 19's
     and 21's, and phase 10's for the head), the card's nvidia-smi line,
     then the result line.

Imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# peak rates of one H100 SXM (NVIDIA data sheet, dense): memory, f32 on the
# CUDA cores, bf16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
# 32-bit integer and special-function (log, sqrt, sin, cos, int->float)
# rates: 64 and 16 operations per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x the 1,980 MHz boost clock (H100 SXM data sheet)
INT32_OPS = 132 * 64 * 1.98e9
SFU_OPS = 132 * 16 * 1.98e9
# one Philox4x32-10 call and its four Box-Muller normals: 39 integer-pipe
# instructions in the sm_90a SASS (a round is two IMAD.WIDE.U32, each a
# 32x32->64 product, and two LOP3 three-way xors; the key adds run once a
# thread on the uniform datapath), as ``philox_sass`` prints them; then
# 4 int->float conversions, 2 logs, 2 square roots, 2 sines, 2 cosines
PHILOX_INT_OPS = 39
PHILOX_SFU_OPS = 12
ADC_STEP = 4.0 / 127
PAPER_KERNELS = ("photonic_conv", "photonic_conv_sampled", "bayes_matmul",
                 "bayes_matmul_sampled")

SERVE_FLAGS = ["--arch", "qwen2_1_5b", "--slots", "4", "--num-requests", "8",
               "--prompt-len", "256", "--gen-len", "32", "--chunk", "8",
               "--kv-layout", "paged", "--kv-block", "16",
               "--prefill-chunk", "64", "--seed", "0"]


def kernel_module(name: str):
    """The submodule ``repro_torch.kernels.<name>``: the package exports
    the ops functions of the same names, which shadow the submodules as
    its attributes."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


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


def gemm_bound(nbytes: float, flops: float,
               philox_calls: float = 0.0) -> tuple[float, str, str]:
    """``bound`` of an f32-accurate GEMM: its flops take the lesser of f32
    on the CUDA cores and three TF32 products on the tensor cores (each
    operand split into two tf32 parts, hi*hi + hi*lo + lo*hi: the same
    accuracy), whatever implements them.  Returns (ms, "bytes" or
    "operations", what sets it)."""
    gemm = {"3xTF32 tensor cores": 3 * flops / TF32_FLOPS,
            "f32 CUDA cores": flops / F32_FLOPS}
    kind = min(gemm, key=gemm.get)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, kind: gemm[kind],
             "Philox int32": philox_calls * PHILOX_INT_OPS / INT32_OPS,
             "Philox SFU": philox_calls * PHILOX_SFU_OPS / SFU_OPS}
    what = max(terms, key=terms.get)   # "bytes" on a tie, as in bound
    return (terms[what] * 1e3, "bytes" if what == "bytes" else "operations",
            what)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def same_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.isnan(a.float()), torch.isnan(b.float())))


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

# f32 reductions over K = 1536 and V = 151936 in another order: H and SE
# (~log V ~ 12) agree to ~1e-5, MI is their difference
HEAD_TOL = {"H": 2e-4, "SE": 2e-4, "MI": 2e-4, "p_max": 1e-6}


def compare_heads(tag: str, got: dict, want: dict, x, mu, sigma, xi) -> float:
    """H, SE, MI and p_max within HEAD_TOL, NaN where ``want`` has NaN;
    pred equal wherever the top-2 gap of p-bar (from the full (S, M, V)
    logits of ``xi``) is resolvable.  Returns the worst error."""
    from repro_torch.kernels import ref

    torch.cuda.synchronize()
    worst = 0.0
    for k, t in HEAD_TOL.items():
        e = max_err(got[k], want[k])
        worst = max(worst, e)
        if not e <= t or not same_nan(got[k], want[k]):
            fail(f"{tag}: {k} max |err| {e:.3g} > {t}")
    pbar = torch.softmax(ref.lrt_matmul(x, mu, sigma, xi), dim=-1).mean(0)
    top = pbar.topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > 1e-6
    bad = (got["pred"] != want["pred"]) & clear
    if bad.any():
        fail(f"{tag}: pred differs on {int(bad.sum())} rows with a clear "
             "argmax")
    return worst


def head_case(dev, seed, K=1536, V=151936):
    """The head at qwen2-1.5B's widths (K 1536, V 151936) or others; mu ~
    N(0, 1/K), sigma in [0.01, 0.06)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((K, V), generator=g, device=dev) / math.sqrt(K)
    sigma = 0.01 + 0.05 * torch.rand((K, V), generator=g, device=dev)
    return mu, sigma, g


def gemv_ms(x, mu, sigma) -> float:
    """A yardstick for the head's stream, not its library time: two cuBLAS
    f32 GEMVs on the same bytes, ``x32 @ mu`` and ``(x32*x32) @ sigma^2``,
    sigma^2 formed beforehand (not timed).  What the card's own GEMV
    reaches reading mu and sigma once."""
    x32 = x.float()
    xx, s2 = x32 * x32, sigma * sigma
    return device_ms(lambda: (x32 @ mu, xx @ s2), 10)


def plan_text(M: int, K: int, V: int, mu, sigma) -> str:
    UH = kernel_module("uncertainty_head")
    p = UH.head_plan(M, K, V, UH._alignment(mu, sigma))
    return (f"plan: rows {p.rows} x {p.groups}, {p.tile} columns a block, "
            f"{p.splits} K slices of {p.k_slice}, route {p.route}, "
            f"{p.blocks} blocks, busiest SM {p.balance:.3f}x the mean, "
            f"scratch {p.scratch_bytes / 1e6:.2f} MB")


def check_head(dev, S: int = 10, Ms: tuple = (4, 16)) -> dict:
    """The fused head at qwen2-1.5B's widths with S draws at each row
    count of ``Ms``, in xi and Philox modes, against its plain version;
    determinism, the device step, and the device time beside the bound
    (the serving path's M 4 as the returned row)."""
    from repro_torch.kernels import rng
    UH = kernel_module("uncertainty_head")

    mu, sigma, g = head_case(dev, 1)
    K, V = mu.shape
    worst, rows = 0.0, {}
    for M in Ms:
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        xi = torch.randn((S, M, V), generator=g, device=dev)
        for mode, kw in (("xi", {"xi": xi}), ("philox",
                                              {"seed": 7, "step": 3})):
            got = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, **kw)
            want = UH.uncertainty_head_plain(x, mu, sigma, num_samples=S,
                                             **kw)
            xi_full = xi if mode == "xi" else rng.head_normal(
                7, 3, S, M, torch.arange(V, device=dev))
            e = compare_heads(f"head S={S} M={M} {mode}", got, want, x, mu,
                              sigma, xi_full)
            worst = max(worst, e)
            print(f"  head S={S} M={M} {mode}: ok (max |err| {e:.3g})",
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
        check_head_step(x, mu, sigma, S, M)
        if M == 4:   # the serving path's slot count
            run = lambda: UH.uncertainty_head_cuda(  # noqa: E731
                x, mu, sigma, num_samples=S, seed=7, step=3)
            plain = lambda: UH.uncertainty_head_plain(  # noqa: E731
                x, mu, sigma, num_samples=S, seed=7, step=3)
            nbytes = M * K * 2 + 2 * K * V * 4 + 5 * M * 4
            flops = 4.0 * M * K * V
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
            # no single PyTorch call computes the fused head: no library time
            rows = {"ms": device_ms(run, 10), "cold_ms": cold_ms(run),
                    "plain_ms": time_ms(plain, 1, 0),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            g_ms = gemv_ms(x, mu, sigma)
            print(f"  head S={S} M=4 timed: {rows['ms']:.4f} ms (L2 cold "
                  f"{rows['cold_ms']:.4f}), bound {b_ms:.4f} ({b_by}, "
                  f"{b_ms / rows['ms']:.0%} of it); the GEMV pair on the "
                  f"same bytes {g_ms:.4f} ms ({b_ms / g_ms:.0%}); "
                  f"{plan_text(M, K, V, mu, sigma)}; plain "
                  f"{rows['plain_ms']:.2f} ms", flush=True)
        else:
            run16 = lambda: UH.uncertainty_head_cuda(  # noqa: E731
                x, mu, sigma, num_samples=S, seed=7, step=3)
            ms16 = device_ms(run16, 10)
            b16, _ = bound(M * K * 2 + 2 * K * V * 4 + 5 * M * 4,
                           4.0 * M * K * V, F32_FLOPS)
            print(f"  head S={S} M={M} timed: {ms16:.4f} ms (L2 cold "
                  f"{cold_ms(run16):.4f}), bound {b16:.4f} "
                  f"({b16 / ms16:.0%} of it); "
                  f"{plan_text(M, K, V, mu, sigma)}", flush=True)
    rows["max_abs_err"] = worst
    return rows


def check_head_step(x, mu, sigma, S: int, M: int) -> None:
    """The fused head's Philox step read from device memory: a call with
    a one-element step tensor (eager, then replayed in a CUDA graph with
    new steps written between replays) equals the call with the step as
    an int, bit for bit, at each step."""
    UH = kernel_module("uncertainty_head")
    st = torch.zeros((1,), dtype=torch.int32, device=x.device)

    def call():
        return UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, seed=7,
                                        step=st, step_offset=2)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for step in (0, 1, 41, 2 ** 31 - 3):
        st.fill_(step)
        eager = call()
        graph.replay()
        want = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, seed=7,
                                        step=step + 2)
        for name, got in (("eager", eager), ("replayed", out)):
            if not all(torch.equal(got[k].view(torch.int32),
                                   want[k].view(torch.int32)) for k in want):
                fail(f"head M={M}: the {name} call at device step {step} "
                     "differs from the int step")
    print(f"  head M={M} device step: eager and replayed calls equal the "
          "int step bit for bit (steps 0, 1, 41, 2^31 - 3; offset 2)",
          flush=True)


def _pool(dev, g, NB, BS, Hkv, D):
    return (torch.randn((NB, BS, Hkv, D), generator=g, device=dev)
            .to(torch.bfloat16))


def decode_case(dev, lens_l, MB, seed, D=128, dtype=torch.bfloat16, H=12,
                Hkv=2):
    """Decode attention at qwen2-1.5B's widths (H 12, Hkv 2, BS 16) or
    others: slots of the given depths, each row's blocks shuffled through
    the pool with -1 tails."""
    B, BS = len(lens_l), 16
    NB = B * MB
    g = torch.Generator(device=dev).manual_seed(seed)
    k_pool, v_pool = (_pool(dev, g, NB, BS, Hkv, D).to(dtype) for _ in "kv")
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(dtype)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(seed))
    table = torch.full((B, MB), -1, dtype=torch.int32)
    for b, n in enumerate(lens_l):
        nb = -(-n // BS)
        table[b, :nb] = perm[b * MB:b * MB + nb].to(torch.int32)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, table.to(dev), lens


def decode_bound(q, lens_l, Hkv) -> tuple[float, str]:
    """q in, out, and the cached keys' K and V, each moved once, and the
    depths; the products of the cached keys."""
    B, _, H, D = q.shape
    elt = q.element_size()
    cached = sum(lens_l)
    nbytes = q.numel() * elt * 2 + cached * Hkv * D * elt * 2 + B * 4
    return bound(nbytes, 4.0 * cached * H * D, BF16_FLOPS)


def sdpa_call(q, k_pool, v_pool, table, lens):
    """The library yardstick: SDPA over the slots' K/V gathered and
    expanded to the query heads beforehand (that copy is not timed),
    masked by the readable depth; fully masked slots are left out.
    Returns (the call, the live slots)."""
    from repro_torch.models import layers as L

    H, Hkv = q.shape[2], k_pool.shape[2]
    eff = L.mapped_span(table, k_pool.shape[1], lens)
    live = torch.nonzero(eff > 0).flatten()
    kx, vx = (L.paged_gather(p, table)[live].repeat_interleave(H // Hkv, dim=2)
              .transpose(1, 2).contiguous() for p in (k_pool, v_pool))
    qx = q[live].transpose(1, 2).contiguous()
    mask = (torch.arange(kx.shape[2], device=q.device)[None, :]
            < eff[live, None])[:, None, None, :]
    return (lambda: F.scaled_dot_product_attention(  # noqa: E731
        qx, kx, vx, attn_mask=mask)), live


def cold_ms(fn, calls: int = 20) -> float:
    """Device time of ``fn`` with the L2 cold: a 128 MB buffer (2.5× the
    50 MB L2) written before each call inside the graph, less the same
    writes timed alone."""
    flush = torch.empty((32 * 2 ** 20,), dtype=torch.float32, device="cuda")
    both = device_ms(lambda: (flush.fill_(1.0), fn()), calls)
    alone = device_ms(lambda: flush.fill_(1.0), calls)
    return both - alone


def check_decode(dev) -> dict:
    """The decode kernels at qwen2-1.5B's widths.  The tensor-core kernel
    (the served route: bf16, D 128) at the served case (4 slots, depths
    288 / 150 / 17 / 0 over 19 blocks), at 64 slots and at 4 slots of
    depth 4096 (MB 256), against the plain version and the gather
    reference; the SIMT kernel forced on the same bf16 inputs and with
    f32 operands.  Times of both kernels and SDPA beside the bound, the
    served case with a cold L2 too, a sweep of the tiles a split and the
    HMMA count."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import layers as L

    Hkv, D = 2, 128
    if PA.decode_route(torch.bfloat16, D) != "mma" \
            or PA.decode_route(torch.float32, D) != "simt":
        fail("decode attention: bf16 at D 128 must take the tensor-core "
             "kernel and f32 the SIMT one")
    rng = torch.Generator().manual_seed(9)
    cases = {"served": ([288, 150, 17, 0], 19),
             "64 slots": ([0] + torch.randint(1, 305, (63,), generator=rng)
                          .tolist(), 19),
             "depth 4096": ([4096, 4096, 4096, 4096], 256)}
    # bf16 outputs of f32 sums taken in another order: one bf16 ulp
    # (2^-8 relative) of O(1) values; f32 operands: 2e-5
    tol = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    worst, timed = 0.0, {}
    for name, (lens_l, MB) in cases.items():
        q, k_pool, v_pool, table, lens = decode_case(dev, lens_l, MB, 2)
        eff = L.mapped_span(table, k_pool.shape[1], lens)
        gather = L.decode_attention(q, L.paged_gather(k_pool, table),
                                    L.paged_gather(v_pool, table), eff)
        empty = torch.tensor([n == 0 for n in lens_l], device=dev)
        outs = {}
        for route in ("mma", "simt"):
            got = outs[route] = PA.paged_decode_attention_cuda(
                q, k_pool, v_pool, table, lens, route=route)
            want = PA.paged_decode_attention_plain(q, k_pool, v_pool, table,
                                                   lens, walk=route)
            torch.cuda.synchronize()
            e = max(max_err(got, want), max_err(got, gather))
            nan_rows = torch.isnan(got).flatten(1)
            if not e <= tol[q.dtype] or not same_nan(got, want) \
                    or not same_nan(got, gather) \
                    or not torch.equal(nan_rows.all(1), empty) \
                    or not torch.equal(nan_rows.any(1), empty):
                fail(f"decode attention ({route}) {name}: max |err| "
                     f"{e:.3g} > {tol[q.dtype]} or NaN not exactly on the "
                     f"empty slots")
            if route == "mma":
                worst = max(worst, e)
            print(f"  decode attention ({route}) {name}: ok (max |err| "
                  f"{e:.3g})", flush=True)
        lib, live = sdpa_call(q, k_pool, v_pool, table, lens)
        e_lib = max_err(outs["mma"][live], lib().transpose(1, 2))
        if not e_lib <= tol[q.dtype]:
            fail(f"decode attention {name}: the SDPA yardstick differs by "
                 f"{e_lib:.3g}")
        mma = lambda: PA.paged_decode_attention_cuda(  # noqa: E731
            q, k_pool, v_pool, table, lens)
        b_ms, b_by = decode_bound(q, lens_l, Hkv)
        timed[name] = {
            "ms": device_ms(mma, 100), "cold_ms": cold_ms(mma),
            "simt_ms": device_ms(lambda: PA.paged_decode_attention_cuda(
                q, k_pool, v_pool, table, lens, route="simt"), 100),
            "library_ms": device_ms(lib, 100),
            "bound_ms": b_ms, "bound_by": b_by,
            "tiles": PA.decode_tiles(len(lens_l), Hkv, MB, 16)}
        if name == "served":
            timed[name]["plain_ms"] = time_ms(
                lambda: PA.paged_decode_attention_plain(
                    q, k_pool, v_pool, table, lens), 5)
        # the split sweep: the tensor-core kernel at each split size
        table_tiles = -(-MB * 16 // PA.DECODE_KEY_TILE)
        sweep = [t for t in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32, 64)
                 if t <= table_tiles]
        print(f"  decode split sweep, {name} (tiles a split: ms; default "
              f"{timed[name]['tiles']}): " + ", ".join(
                  f"{t}: {device_ms(lambda: PA.paged_decode_attention_cuda(q, k_pool, v_pool, table, lens, tiles=t), 100):.4f}"  # noqa: E501
                  for t in sweep), flush=True)
    # the SIMT kernel with f32 operands at the served case
    if PA.decode_route(torch.float32, D) != "simt":
        fail("decode attention: f32 must take the SIMT kernel")
    q, k_pool, v_pool, table, lens = decode_case(dev, cases["served"][0], 19,
                                                 2, dtype=torch.float32)
    got = PA.paged_decode_attention_cuda(q, k_pool, v_pool, table, lens)
    want = PA.paged_decode_attention_plain(q, k_pool, v_pool, table, lens)
    torch.cuda.synchronize()
    e = max_err(got, want)
    if not e <= tol[torch.float32] or not same_nan(got, want) \
            or not torch.isnan(got[3]).all() or torch.isnan(got[:3]).any():
        fail(f"decode attention (SIMT) f32: max |err| {e:.3g} > 2e-5 or "
             "NaN not exactly on the empty slot")
    print(f"  decode attention (simt) served f32: ok (max |err| {e:.3g})",
          flush=True)
    for name, t in timed.items():
        print(f"  decode attention timed, {name}: mma {t['ms']:.4f} ms "
              f"(L2 cold {t['cold_ms']:.4f}; {t['tiles']} tiles a split), "
              f"SIMT {t['simt_ms']:.4f}, SDPA {t['library_ms']:.4f}, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})", flush=True)
    print(f"  {sass_counts('paged_attention', 'paged_decode_mma')}",
          flush=True)
    return dict(timed["served"], max_abs_err=worst)


def check_prefill(dev) -> dict:
    """The prefill kernel (bf16, D 128: the tensor-core kernel) at the four
    chunk offsets of the serve trace's 256-token prompts, at a 37-token
    last chunk, and at the mid-block offsets where a prefix hit's suffix
    walk starts (200 of span 256, the served 200-token shared prefix; 264
    of a 320-token prompt), against its plain version and the gather +
    flash reference; offsets 0, 192, 200 and 264 timed beside their
    bounds and SDPA.  A row of a chunk at offset 200 must equal the same
    row of the chunk at offset 192 bit for bit (the hit's suffix against
    the cold walk).  The SIMT kernel (f32, and bf16 at D 72) is held
    against the plain version at the served chunk shape."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import layers as L

    H, Hkv, D, BS = 12, 2, 128, 16
    NB = 4 * 19
    g = torch.Generator(device=dev).manual_seed(4)
    k_pool = _pool(dev, g, NB, BS, Hkv, D)
    v_pool = _pool(dev, g, NB, BS, Hkv, D)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(5))
    long_row = perm[:320 // BS].to(torch.int32).reshape(1, -1).to(dev)
    full_row = long_row[:, :256 // BS].contiguous()
    if PA.prefill_route(torch.bfloat16, D) != "mma":
        fail("prefill attention: bf16 at D 128 must take the tensor-core "
             "kernel")
    tol = 2e-2                       # one bf16 ulp of O(1) outputs
    worst, timed = 0.0, {}
    # (S, offset, span): a 256-token prompt's four 64-token chunks, the
    # 37-token last chunk of a 229-token prompt (rows cross replicas), and
    # the first suffix chunks after mid-block prefix hits
    for S, offset, span in [(64, 0, 256), (64, 64, 256), (64, 128, 256),
                            (64, 192, 256), (37, 192, 229), (64, 200, 256),
                            (64, 264, 320)]:
        row = long_row[:, :-(-span // BS)].contiguous()
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
            e = max(max_err(got, want), max_err(got, ref))
            worst = max(worst, e)
            if not e <= tol or not same_nan(got, want) \
                    or torch.isnan(got).any():
                fail(f"prefill attention S={S} offset={offset} span={span} "
                     f"kv_chunk={kc}: max |err| {e:.3g} > {tol} or NaN")
            print(f"  prefill attention S={S} offset={offset} span={span} "
                  f"kv_chunk={kc}: ok (max |err| {e:.3g})", flush=True)
        if S != 64 or offset not in (0, 192, 200, 264):
            continue
        # the work this chunk needs: Q in, out, and K and V of the keys
        # up to the last query position, each moved once
        keys = min(offset + S, span)
        pairs = sum(min(offset + i + 1, span) for i in range(S))
        nbytes = 2 * q.numel() * 2 + keys * Hkv * D * 2 * 2
        b_ms, b_by = bound(nbytes, 4.0 * pairs * H * D, BF16_FLOPS)
        # library yardstick: SDPA over the span gathered and expanded to
        # the query heads beforehand (not timed)
        kx, vx = (L.paged_gather(p, row)[:, :span]
                  .repeat_interleave(H // Hkv, dim=2)
                  .transpose(1, 2).contiguous() for p in (k_pool, v_pool))
        qx = q.transpose(1, 2).contiguous()
        mask = (torch.arange(span, device=dev)[None, :]
                <= offset + torch.arange(S, device=dev)[:, None])
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qx, kx, vx, attn_mask=mask)
        e_lib = max_err(got, lib().transpose(1, 2))
        if not e_lib <= tol:
            fail(f"prefill attention: the SDPA yardstick differs by "
                 f"{e_lib:.3g} at offset {offset}")
        timed[offset] = {
            "ms": device_ms(lambda: PA.paged_prefill_attention_cuda(
                q, k_pool, v_pool, row, offset, span, 1024), 50),
            "plain_ms": time_ms(lambda: PA.paged_prefill_attention_plain(
                q, k_pool, v_pool, row, offset, span, 1024), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lib, 50), "span": span}
    # a prefix hit's suffix chunk against the cold walk's chunk: the rows
    # at positions 200-255 bit for bit (the offset-200 rows' blocks walk
    # the same four 64-key tiles, the last one further masked)
    qa = torch.randn((1, 64, H, D), generator=g,
                     device=dev).to(torch.bfloat16)
    qb = torch.cat([qa[:, 8:], torch.randn((1, 8, H, D), generator=g,
                                           device=dev).to(torch.bfloat16)],
                   dim=1)
    oa = PA.paged_prefill_attention_cuda(qa, k_pool, v_pool, full_row, 192,
                                         256, 1024)
    ob = PA.paged_prefill_attention_cuda(qb, k_pool, v_pool, full_row, 200,
                                         256, 1024)
    if not torch.equal(oa[:, 8:].view(torch.int16),
                       ob[:, :56].view(torch.int16)):
        fail("prefill attention: rows at positions 200-255 differ between "
             "the chunk at offset 192 and the chunk at offset 200")
    print("  prefill attention offset 200 vs 192: rows 200-255 bit for bit",
          flush=True)
    # the SIMT kernel, which f32 operands and bf16 head dims that are not a
    # multiple of 16 take: f32 at the served chunk shape, bf16 at D 72
    for dtype, Dx, tol_x in ((torch.float32, D, 2e-5),
                             (torch.bfloat16, 72, 2e-2)):
        if PA.prefill_route(dtype, Dx) != "simt":
            fail(f"prefill attention: {dtype} at D {Dx} must take the SIMT "
                 "kernel")
        kx, vx = (_pool(dev, g, NB, BS, Hkv, Dx).to(dtype) for _ in "kv")
        qx = torch.randn((1, 64, H, Dx), generator=g, device=dev).to(dtype)
        for kc in (1024, 64):
            got = PA.paged_prefill_attention_cuda(qx, kx, vx, full_row, 192,
                                                  256, kc)
            want = PA.paged_prefill_attention_plain(qx, kx, vx, full_row,
                                                    192, 256, kc)
            torch.cuda.synchronize()
            e = max_err(got, want)
            if not e <= tol_x or torch.isnan(got).any():
                fail(f"prefill attention (SIMT) {dtype} D={Dx} "
                     f"kv_chunk={kc}: max |err| {e:.3g} > {tol_x} or NaN")
            print(f"  prefill attention (SIMT) {dtype} D={Dx} S=64 "
                  f"offset=192 span=256 kv_chunk={kc}: ok (max |err| "
                  f"{e:.3g})", flush=True)
    for offset, t in timed.items():
        print(f"  prefill attention timed, S 64 offset {offset} span "
              f"{t.pop('span')}: "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), SDPA {t['library_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms", flush=True)
    print(f"  {sass_counts('paged_attention', 'paged_prefill_mma')}",
          flush=True)
    return dict(timed[192], max_abs_err=worst)


# deepseek-moe-16b's shapes on the served path: MHA (H = Hkv = 16, D 128,
# GQA ratio 1) and the head at K 2048, V 102400; zamba2-7b's: MHA at
# H = Hkv = 32, D 112, 256-token prompt chunks and the head at K 3584,
# V 32000
MOE_H, MOE_HKV, MOE_K, MOE_V = 16, 16, 2048, 102400
ZB_H, ZB_HKV, ZB_D, ZB_K, ZB_V = 32, 32, 112, 3584, 32000
# seamless-m4t-medium's: MHA at H = Hkv = 16, D 64, and the head at K 1024,
# V 256206 = 2001 x 128 + 78 (2,002 tiles, the last ragged)
SM_H, SM_HKV, SM_D, SM_K, SM_V = 16, 16, 64, 1024, 256206
# phi-3-vision-4.2b's: MHA at H = Hkv = 32, D 96, and the head at K 3072,
# V 32064 = 250 x 128 + 64 (251 tiles, the last ragged)
PV_H, PV_HKV, PV_D, PV_K, PV_V = 32, 32, 96, 3072, 32064
# its served prompts: the 576 prefix embeds and 64 text tokens
VLM_PROMPT = 640


def check_shapes(dev, model: str, H: int, Hkv: int, D: int, K: int, V: int,
                 decodes, prefills, head_seed: int, plant=()) -> dict:
    """The serving kernels at a model's shapes, each against its plain
    version, the tensor-core route asserted, timed beside its bound and,
    where one exists, its library yardstick: decode attention at 4 slots
    of the given depths (``decodes``: (label, depths, table width)),
    prefill attention (``prefills``: (S, offset, span); none where the
    model has no chunked prefill) and the fused head (M 4, S 10, Philox
    and explicit xi; ``plant``: (row, column) pairs whose column of mu is
    set to give the row a logit of about sqrt(K), an argmax both heads
    must find there).  Returns the times by kernel and case."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import layers as L
    UH = kernel_module("uncertainty_head")

    out = {}
    BS = 16
    tol = 2e-2                        # one bf16 ulp of O(1) outputs
    for label, lens_l, MB in decodes:
        q, k_pool, v_pool, table, lens = decode_case(dev, lens_l, MB, 3, D=D,
                                                     H=H, Hkv=Hkv)
        eff = L.mapped_span(table, k_pool.shape[1], lens)
        gather = L.decode_attention(q, L.paged_gather(k_pool, table),
                                    L.paged_gather(v_pool, table), eff)
        got = PA.paged_decode_attention_cuda(q, k_pool, v_pool, table, lens)
        want = PA.paged_decode_attention_plain(q, k_pool, v_pool, table,
                                               lens)
        torch.cuda.synchronize()
        e = max(max_err(got, want), max_err(got, gather))
        empty = [b for b, n in enumerate(lens_l) if n == 0]
        if PA.decode_route(q.dtype, D) != "mma" or not e <= tol \
                or not same_nan(got, want) \
                or not all(torch.isnan(got[b]).all() for b in empty) \
                or torch.isnan(got[[b for b in range(len(lens_l))
                                    if b not in empty]]).any():
            fail(f"decode attention at {model}'s heads ({label}): max |err| "
                 f"{e:.3g} > {tol}, not the mma route, or NaN not exactly "
                 "on the empty slot")
        lib, live = sdpa_call(q, k_pool, v_pool, table, lens)
        if not max_err(got[live], lib().transpose(1, 2)) <= tol:
            fail(f"decode attention at {model}'s heads ({label}): SDPA "
                 "differs")
        run = lambda: PA.paged_decode_attention_cuda(  # noqa: E731
            q, k_pool, v_pool, table, lens)
        b_ms, b_by = decode_bound(q, lens_l, Hkv)
        out[f"paged_decode_attention {label}"] = {
            "max_abs_err": e, "ms": device_ms(run, 100),
            "cold_ms": cold_ms(run),
            "plain_ms": time_ms(lambda: PA.paged_decode_attention_plain(
                q, k_pool, v_pool, table, lens), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lib, 100)}

    g = torch.Generator(device=dev).manual_seed(6)
    NB = 4 * -(-max((span for _, _, span in prefills), default=0) // BS)
    k_pool, v_pool = (_pool(dev, g, NB, BS, Hkv, D) for _ in "kv")
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(7))
    for S, offset, span in prefills:
        row = perm[:-(-span // BS)].to(torch.int32).reshape(1, -1).to(dev)
        q = torch.randn((1, S, H, D), generator=g,
                        device=dev).to(torch.bfloat16)
        got = PA.paged_prefill_attention_cuda(q, k_pool, v_pool, row, offset,
                                              span, 1024)
        want = PA.paged_prefill_attention_plain(q, k_pool, v_pool, row,
                                                offset, span, 1024)
        ref = L.flash_attention(q, L.paged_gather(k_pool, row)[:, :span],
                                L.paged_gather(v_pool, row)[:, :span],
                                causal=True, q_offset=offset)
        torch.cuda.synchronize()
        e = max(max_err(got, want), max_err(got, ref))
        if PA.prefill_route(q.dtype, D) != "mma" or not e <= tol \
                or torch.isnan(got).any():
            fail(f"prefill attention at {model}'s heads, S {S} offset "
                 f"{offset}: max |err| {e:.3g} > {tol}, not the mma route, "
                 "or NaN")
        # the kv heads expanded to the query heads beforehand, as in
        # ``sdpa_call`` (that copy is not timed)
        kx, vx = (L.paged_gather(p, row)[:, :span]
                  .repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  .contiguous() for p in (k_pool, v_pool))
        qx = q.transpose(1, 2).contiguous()
        mask = (torch.arange(span, device=dev)[None, :]
                <= offset + torch.arange(S, device=dev)[:, None])
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qx, kx, vx, attn_mask=mask)
        if not max_err(got, lib().transpose(1, 2)) <= tol:
            fail(f"prefill attention at {model}'s heads: SDPA differs at S "
                 f"{S} offset {offset}")
        keys = min(offset + S, span)
        pairs = sum(min(offset + i + 1, span) for i in range(S))
        b_ms, b_by = bound(2 * q.numel() * 2 + keys * Hkv * D * 2 * 2,
                           4.0 * pairs * H * D, BF16_FLOPS)
        out[f"paged_prefill_attention S {S} offset {offset}"] = {
            "max_abs_err": e,
            "ms": device_ms(lambda: PA.paged_prefill_attention_cuda(
                q, k_pool, v_pool, row, offset, span, 1024), 50),
            "plain_ms": time_ms(lambda: PA.paged_prefill_attention_plain(
                q, k_pool, v_pool, row, offset, span, 1024), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lib, 50)}

    S, M = 10, 4
    mu, sigma, g = head_case(dev, head_seed, K, V)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    xi = torch.randn((S, M, V), generator=g, device=dev)
    for row, col in plant:
        mu[:, col] = x[row].float() / x[row].float().norm()
    from repro_torch.kernels import rng
    worst, plain_ms = 0.0, None
    for mode, kw in (("xi", {"xi": xi}), ("philox", {"seed": 7, "step": 3})):
        got = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, **kw)
        t0 = time.perf_counter()
        want = UH.uncertainty_head_plain(x, mu, sigma, num_samples=S, **kw)
        torch.cuda.synchronize()
        if mode == "philox":
            plain_ms = (time.perf_counter() - t0) * 1e3
        for row, col in plant:
            if not int(got["pred"][row]) == int(want["pred"][row]) == col:
                fail(f"head at {model}'s widths {mode}: row {row}'s argmax "
                     f"is {int(got['pred'][row])} (plain "
                     f"{int(want['pred'][row])}), planted at {col}")
        xi_full = xi if mode == "xi" else rng.head_normal(
            7, 3, S, M, torch.arange(V, device=dev))
        worst = max(worst, compare_heads(f"head at {model}'s widths {mode}",
                                         got, want, x, mu, sigma, xi_full))
    run = lambda: UH.uncertainty_head_cuda(  # noqa: E731
        x, mu, sigma, num_samples=S, seed=7, step=3)
    b_ms, b_by = bound(M * K * 2 + 2 * K * V * 4 + 5 * M * 4,
                       4.0 * M * K * V, F32_FLOPS)
    out["uncertainty_head"] = {
        "max_abs_err": worst, "ms": device_ms(run, 10), "cold_ms": cold_ms(run),
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    g_ms = gemv_ms(x, mu, sigma)
    print(f"  uncertainty_head at {model}'s widths: the GEMV pair on the "
          f"same bytes {g_ms:.4f} ms ({b_ms / g_ms:.0%} of the bound); "
          f"{plan_text(M, K, V, mu, sigma)}", flush=True)
    for name, t in out.items():
        print(f"  {name} at {model}'s shapes: ok (max |err| "
              f"{t['max_abs_err']:.3g}), {t['ms']:.4f} ms"
              + (f" (L2 cold {t['cold_ms']:.4f})" if "cold_ms" in t else "")
              + f", bound {t['bound_ms']:.6f} ms ({t['bound_by']}, "
              f"{t['bound_ms'] / t['ms']:.0%} of it), plain "
              f"{t['plain_ms']:.3f} ms, library "
              + (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
                 else "none"), flush=True)
    return out


def check_moe_shapes(dev) -> dict:
    """The serving kernels at deepseek-moe-16b's shapes: decode at the
    served depths (ratio 1, where most of the tensor-core kernel's 16 mma
    rows are padding), prefill S 64 at offsets 0 and 192 of span 256, the
    head at K 2048, V 102400."""
    return check_shapes(dev, "deepseek-moe-16b", MOE_H, MOE_HKV, 128, MOE_K,
                        MOE_V, [("served", [288, 150, 17, 0], 19)],
                        [(64, 0, 256), (64, 192, 256)], head_seed=8)


def check_hybrid_shapes(dev) -> dict:
    """The serving kernels at zamba2-7b's shapes (MHA at 32 heads of D
    112): decode at the served depths and at depth 8192 (MB 512), prefill
    of the rounded 256-token chunk at offsets 0 and 256 of a 512-token
    prompt and a ragged 37-token tail at offset 256, the head at K 3584,
    V 32000 (250 whole tiles)."""
    return check_shapes(
        dev, "zamba2-7b", ZB_H, ZB_HKV, ZB_D, ZB_K, ZB_V,
        [("served", [288, 150, 17, 0], 19),
         ("depth 8192", [8192, 8192, 8192, 8192], 512)],
        [(256, 0, 512), (256, 256, 512), (37, 256, 293)], head_seed=10)


def check_encdec_shapes(dev) -> dict:
    """The serving kernels at seamless-m4t-medium's shapes (MHA at 16
    heads of D 64, ratio 1: 15 of the decode kernel's 16 mma rows are
    padding): decode at the served depths, prefill S 64 at offsets 0 and
    192 of span 256, the head at K 1024, V 256206 (a ragged last tile of
    78 columns; V is not a multiple of 4)."""
    return check_shapes(dev, "seamless-m4t-medium", SM_H, SM_HKV, SM_D, SM_K,
                        SM_V, [("served", [288, 150, 17, 0], 19)],
                        [(64, 0, 256), (64, 192, 256)], head_seed=12)


def check_vlm_shapes(dev) -> dict:
    """The serving kernels at phi-3-vision-4.2b's shapes (MHA at 32 heads
    of D 96: six 16-wide k-steps, a 192-byte row; ratio 1, so 15 of the
    decode kernel's 16 mma rows are padding): decode at the served depths
    (prompt 640 + up to 32 generated, a 43-block table, 2 splits), no
    prefill (the family serves batch prefill only, on the plain
    attention), the head at K 3072, V 32064 = 250 x 128 + 64 with rows 0
    and 2's argmax planted in the ragged last tile."""
    return check_shapes(dev, "phi-3-vision-4.2b", PV_H, PV_HKV, PV_D, PV_K,
                        PV_V, [("served", [672, 656, 641, 0], 43)], [],
                        head_seed=14, plant=((0, PV_V - 1), (2, PV_V - 64)))


def sass_opcodes(binary: Path) -> dict[str, dict[str, int]]:
    """{kernel name: {mnemonic: count}} of every function in the SASS of
    a built library or cubin (the mnemonic with its modifiers, e.g.
    IMAD.WIDE.U32; predicates dropped), where the toolkit has cuobjdump;
    {} where it has none."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(binary)], capture_output=True,
                          text=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            counts[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if name is not None and m:
            op = m.group(1)
            counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def sass_counts(source: str, kernel: str, opcodes=("HMMA",)) -> str:
    """The count of each of ``opcodes`` in each kernel of the built
    library ``source`` whose name holds ``kernel``."""
    from repro_torch.kernels import build

    found = {k: v for k, v in sass_opcodes(
        build.library_path(source)).items() if kernel in k}
    if not found:
        return f"SASS of {kernel}: no cuobjdump in this toolkit"
    return "/".join(opcodes) + " instructions in the SASS: " + ", ".join(
        f"{k} " + "/".join(str(opcode_count(v, o)) for o in opcodes)
        for k, v in found.items())


def opcode_count(mnemonics: dict[str, int], opcode: str) -> int:
    """Instructions of ``opcode`` whatever their modifiers (HMMA counts
    HMMA.16816.F32.BF16)."""
    return sum(n for m, n in mnemonics.items() if m.split(".")[0] == opcode)


def kernel_name(mangled: str) -> str:
    """``_ZN<n><anonymous namespace><m>paged_prefill_mmaILi128EE...`` ->
    ``paged_prefill_mma<128>`` (``...IfLi4EE...`` -> ``<float, 4>``): the
    kernels' names in the build logs and
    the SASS (nvcc names each anonymous namespace uniquely)."""
    import re

    ns = re.match(r"_ZN(\d+)", mangled)
    if not ns:
        return mangled[:60]
    pos = ns.end() + int(ns.group(1))
    m = re.match(r"(\d+)", mangled[pos:])
    if not m:
        return mangled[:60]
    start = pos + m.end()
    name = mangled[start:start + int(m.group(1))]
    tail = mangled[start + int(m.group(1)):]
    t = re.match(r"IL[ij](\d+)E", tail)
    if t:
        return f"{name}<{t.group(1)}>"
    for code, arg in (("I13__nv_bfloat16", "bf16"), ("If", "float")):
        if tail.startswith(code):
            t = re.match(r"L[ij](\d+)E", tail[len(code):])
            return f"{name}<{arg}, {t.group(1)}>" if t else f"{name}<{arg}>"
    return name


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
    PC = kernel_module("photonic_conv")
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
        # the stream's calls: exactly C normals an output, four a call
        b2 = bound((B * T + B * To) * 4, 4.0 * n_out * C, F32_FLOPS,
                   philox_calls=n_out * C / 4)
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
    print(f"  {sass_counts('photonic_conv', 'conv_', ('I2F', 'MUFU'))}",
          flush=True)
    print(f"  {philox_sass()}", flush=True)
    return rows["photonic_conv"], rows["photonic_conv_sampled"]


# one and two chained Philox4x32-10 calls keyed as the seeded streams are
# (key (seed, 0)), and one and two chained four-normal draws: each pair's
# difference in the SASS is one call's instructions
PHILOX_PROBE = r"""
#include "philox.cuh"
extern "C" __global__ void rounds1(uint4* v, uint32_t seed) {
  v[threadIdx.x] = repro::philox4x32_10(v[threadIdx.x], seed, 0u);
}
extern "C" __global__ void rounds2(uint4* v, uint32_t seed) {
  v[threadIdx.x] = repro::philox4x32_10(
      repro::philox4x32_10(v[threadIdx.x], seed, 0u), seed, 0u);
}
extern "C" __global__ void normals1(float4* v, uint32_t seed) {
  const uint4 c = reinterpret_cast<uint4*>(v)[threadIdx.x];
  v[threadIdx.x] = repro::philox_normal4(c.x, c.y, c.z, c.w, seed);
}
extern "C" __global__ void normals2(float4* v, uint32_t seed) {
  const uint4 c = reinterpret_cast<uint4*>(v)[threadIdx.x];
  const float4 z = repro::philox_normal4(c.x, c.y, c.z, c.w, seed);
  v[threadIdx.x] = repro::philox_normal4(
      __float_as_uint(z.x), __float_as_uint(z.y), __float_as_uint(z.z),
      __float_as_uint(z.w), seed);
}
"""
# the per-thread integer datapath's opcodes (the uniform datapath's U*
# instructions, such as the key adds, issue beside it)
INT_OPCODES = ("IMAD", "IADD3", "LOP3", "SHF", "LEA", "PRMT", "ISETP",
               "IMNMX", "SEL", "IABS", "IMUL")


def philox_sass() -> str:
    """One Philox4x32-10 call's instructions in the SASS (sm_90a, the
    kernels' flags), from ``PHILOX_PROBE``: the integer-pipe instructions
    of a call and of a round beside ``PHILOX_INT_OPS``, and the
    conversions and special-function instructions of its four normals
    (static counts: the draws' sincosf carries a slow path for large
    arguments that 2 pi u never takes)."""
    from repro_torch.kernels import build

    out = ROOT / "build" / "philox_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PHILOX_PROBE)
    cubin = out / "probe.cubin"
    r = subprocess.run([build.nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-cubin", "-I", str(build.CSRC), "-o", str(cubin),
                        str(out / "probe.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        fail(f"Philox SASS probe: nvcc failed\n{r.stdout}{r.stderr}")
    ops = sass_opcodes(cubin)
    if not ops:
        return "Philox SASS: no cuobjdump in this toolkit"

    def one(name: str) -> dict[str, int]:
        a, b = ops[f"{name}1"], ops[f"{name}2"]
        d = {m: b.get(m, 0) - a.get(m, 0) for m in {*a, *b}}
        return {m: n for m, n in sorted(d.items()) if n}

    call, draw = one("rounds"), one("normals")
    n_int = sum(opcode_count(call, o) for o in INT_OPCODES)
    n_f32 = sum(opcode_count(draw, o) for o in ("FFMA", "FMUL", "FADD"))
    return (f"Philox4x32-10 in the SASS, one call (two chained less one): "
            f"{call}; {n_int} integer-pipe instructions, {n_int / 10:.1f} a "
            f"round (the bounds count PHILOX_INT_OPS = {PHILOX_INT_OPS} a "
            f"call); with its four normals (static counts): word->float "
            f"I2FP.F32.U32 {draw.get('I2FP.F32.U32', 0)}, I2F "
            f"{opcode_count(draw, 'I2F')}, MUFU {opcode_count(draw, 'MUFU')}"
            f" (the bounds count PHILOX_SFU_OPS = {PHILOX_SFU_OPS}), f32 "
            f"FFMA/FMUL/FADD {n_f32}")


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


# the weight-space GEMMs' cases: bench_kernels' dense layer (one row block
# of either kernel), a case with rows in two blocks of the tensor-core
# kernel's tile, and the im2col conv of the paper phase (K 171: x rows off
# 16-byte boundaries); (M, K, N, S, rows given the same x, or None)
BAYES_CASES = ((128, 1024, 4096, 10, None),
               (300, 1024, 512, 10, (3, 200)),
               (800 * 14 * 14, 19 * 9, 32, 10, (5, 100_005)))
# the route sweep: rows at S 10, and samples at M 128 (K 1024, N 4096)
BAYES_SWEEP_ROWS = (8, 16, 32, 64, 128)
BAYES_SWEEP_SAMPLES = (1, 4, 10, 16)


def check_gemms(dev, M, K, N, S, rows, seed) -> dict:
    """Both weight-space entry points against their plain versions at one
    shape, through each kernel (the route's, asserted "mma", and the SIMT
    kernel forced): the single draw, the S-sample GEMM with an explicit
    (S, K, N) eps and with the seeded stream.  ``rows`` (r0, r1) hold the
    same x and lie in different row blocks of each kernel's tile, so they
    must see the same W_s.  Returns the worst errors by entry point."""
    BM = kernel_module("bayes_matmul")
    from repro_torch.kernels import ref

    x, mu, sg, g = gemm_case(dev, M, K, N, seed)
    if rows:
        x[rows[1]] = x[rows[0]]
    eps = torch.randn((K, N), generator=g, device=dev)
    eps_s = torch.randn((S, K, N), generator=g, device=dev)
    for e, s in ((eps, 1), (eps_s, S), (None, S)):
        route = BM.bayes_route(M, K, N, s, x, mu, sg, e)
        if route != "mma":
            fail(f"bayes GEMMs M={M} K={K} N={N}: bayes_route gave {route!r}")
    want1 = ref.bayes_matmul(x, mu, sg, eps)
    want2 = BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=S,
                                          eps=eps_s)
    want3 = BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=S, seed=11)
    worst = {"bayes_matmul": 0.0, "bayes_matmul_sampled": 0.0}
    for route in BM.BAYES_ROUTES[::-1]:
        tag = f"M={M} K={K} N={N} ({route})"
        e1 = rel_check(f"bayes_matmul {tag}", BM.bayes_matmul_cuda(
            x, mu, sg, eps, route=route), want1)
        e2 = rel_check(f"bayes_matmul_sampled eps {tag}",
                       BM.bayes_matmul_sampled_cuda(
                           x, mu, sg, num_samples=S, eps=eps_s, route=route),
                       want2)
        got = BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=S, seed=11,
                                           route=route)
        e3 = rel_check(f"bayes_matmul_sampled seeded {tag}", got, want3)
        note = "one row block"
        if rows:
            r0, r1 = rows
            tile = BM.BAYES_TILE_ROWS[route]
            if r0 // tile == r1 // tile:
                fail(f"bayes {tag}: rows {r0} and {r1} share a {tile}-row "
                     "block")
            if not torch.equal(got[:, r0], got[:, r1]):
                fail(f"bayes_matmul_sampled {tag}: identical rows {r0} and "
                     f"{r1} saw different W_s")
            note = (f"rows {r0} and {r1}, in {tile}-row blocks "
                    f"{r0 // tile} and {r1 // tile}, share W_s")
        ymax = float(want3.abs().max())
        print(f"  bayes GEMMs {tag} S={S}: ok (max |err| {e1:.3g}, {e2:.3g}, "
              f"{e3:.3g}; the seeded GEMM's {e3 / ymax:.3g} of max |y|; "
              f"{note})", flush=True)
        worst["bayes_matmul"] = max(worst["bayes_matmul"], e1)
        worst["bayes_matmul_sampled"] = max(worst["bayes_matmul_sampled"],
                                            e2, e3)
    return worst


def bayes_times(dev, M, K, N, S, seed) -> dict:
    """Device times at one shape: each entry point through the tensor-core
    kernel (route asserted), the SIMT kernel forced on the same inputs, and
    ``torch.matmul`` on W formed beforehand; the bounds of both entry
    points (the sampled GEMM's seeded draws counted once per variate)."""
    BM = kernel_module("bayes_matmul")
    x, mu, sg, g = gemm_case(dev, M, K, N, seed)
    eps = torch.randn((K, N), generator=g, device=dev)
    eps_s = torch.randn((S, K, N), generator=g, device=dev)
    w, w_s = mu + sg * eps, mu + sg * eps_s
    calls = 10 if M <= 4096 else 3
    t = {"matmul": device_ms(lambda: torch.matmul(x, w), calls),
         "matmul_s": device_ms(lambda: torch.matmul(x, w_s), calls)}
    for r in BM.BAYES_ROUTES:
        t[f"single {r}"] = device_ms(lambda: BM.bayes_matmul_cuda(
            x, mu, sg, eps, route=r), calls)
        t[f"seeded {r}"] = device_ms(lambda: BM.bayes_matmul_sampled_cuda(
            x, mu, sg, num_samples=S, seed=3, route=r), calls)
        t[f"eps {r}"] = device_ms(lambda: BM.bayes_matmul_sampled_cuda(
            x, mu, sg, num_samples=S, eps=eps_s, route=r), calls)
    t["b1"] = gemm_bound((M * K + 3 * K * N + M * N) * 4,
                         2.0 * M * K * N + 2.0 * K * N)
    t["b2"] = gemm_bound((M * K + 2 * K * N + S * M * N) * 4,
                         2.0 * S * M * K * N + 2.0 * S * K * N,
                         philox_calls=K * N * -(-S // 4))
    tile = BM.BAYES_TILE_ROWS["mma"]
    draws = -(-M // tile) * K * N * -(-S // 4)
    print(f"  bayes GEMMs timed M={M} K={K} N={N} S={S} (ms): bayes_matmul "
          f"mma {t['single mma']:.4f}, SIMT {t['single simt']:.4f}, "
          f"torch.matmul {t['matmul']:.4f}, bound {t['b1'][0]:.4f} "
          f"({t['b1'][2]}); bayes_matmul_sampled seeded mma "
          f"{t['seeded mma']:.4f}, SIMT {t['seeded simt']:.4f}, explicit eps "
          f"mma {t['eps mma']:.4f}, SIMT {t['eps simt']:.4f}, torch.matmul "
          f"{t['matmul_s']:.4f}, bound {t['b2'][0]:.4f} ({t['b2'][2]}); "
          f"the tensor-core kernel's {draws:.4g} Philox calls (each of "
          f"{-(-M // tile)} row blocks draws its variates) take "
          f"{draws * PHILOX_INT_OPS / INT32_OPS * 1e3:.4f} ms at the int32 "
          "peak", flush=True)
    return t


def bayes_route_sweep(dev) -> None:
    """Both weight-space kernels, forced, at the rows and sample counts
    around ``BAYES_MMA_MIN_ROWS`` (K 1024, N 4096): the measurement the
    threshold is set from (device ms of the seeded S-sample GEMM and of
    the single draw).  The tensor-core kernel's seeded GEMM is held to the
    plain version at each point."""
    BM = kernel_module("bayes_matmul")
    K, N = 1024, 4096
    points = [(M, 10) for M in BAYES_SWEEP_ROWS] + [
        (128, S) for S in BAYES_SWEEP_SAMPLES if S != 10]
    cells = []
    for M, S in points:
        x, mu, sg, g = gemm_case(dev, M, K, N, seed=20)
        eps = torch.randn((K, N), generator=g, device=dev)
        seeded = lambda r: BM.bayes_matmul_sampled_cuda(  # noqa: E731
            x, mu, sg, num_samples=S, seed=4, route=r)
        rel_check(f"bayes_matmul_sampled M={M} S={S} (mma, forced)",
                  seeded("mma"), BM.bayes_matmul_sampled_plain(
                      x, mu, sg, num_samples=S, seed=4))
        t = {r: device_ms(lambda: seeded(r), 3) for r in BM.BAYES_ROUTES}
        cell = (f"M {M} S {S}: seeded simt {t['simt']:.4f} mma "
                f"{t['mma']:.4f}")
        if S == 10:
            t1 = {r: device_ms(lambda: BM.bayes_matmul_cuda(
                x, mu, sg, eps, route=r), 3) for r in BM.BAYES_ROUTES}
            cell += f", one draw simt {t1['simt']:.4f} mma {t1['mma']:.4f}"
        cells.append(cell)
    print(f"  bayes route sweep K={K} N={N} (ms; BAYES_MMA_MIN_ROWS "
          f"{BM.BAYES_MMA_MIN_ROWS}): " + "; ".join(cells), flush=True)


def check_bayes(dev) -> tuple[dict, dict]:
    """Both weight-space entry points: every case of ``BAYES_CASES``
    through both kernels, timed at bench_kernels' shape (the table's rows)
    and at the im2col shape, the route sweep, and the tensor-core kernel's
    HMMA count."""
    from repro_torch.kernels import ref

    worst = {"bayes_matmul": 0.0, "bayes_matmul_sampled": 0.0}
    for i, (M, K, N, S, rows) in enumerate(BAYES_CASES):
        for k, e in check_gemms(dev, M, K, N, S, rows, seed=7 + i).items():
            worst[k] = max(worst[k], e)
    M, K, N, S, _ = BAYES_CASES[0]
    t = bayes_times(dev, M, K, N, S, seed=6)
    Mi, Ki, Ni, Si, _ = BAYES_CASES[-1]
    bayes_times(dev, Mi, Ki, Ni, Si, seed=8)
    BM = kernel_module("bayes_matmul")
    x, mu, sg, g = gemm_case(dev, M, K, N)
    eps = torch.randn((K, N), generator=g, device=dev)
    rows = (
        {"max_abs_err": worst["bayes_matmul"], "ms": t["single mma"],
         "plain_ms": time_ms(lambda: ref.bayes_matmul(x, mu, sg, eps), 3),
         "bound_ms": t["b1"][0], "bound_by": t["b1"][1],
         "library_ms": t["matmul"]},
        {"max_abs_err": worst["bayes_matmul_sampled"], "ms": t["seeded mma"],
         "plain_ms": time_ms(lambda: BM.bayes_matmul_sampled_plain(
             x, mu, sg, num_samples=S, seed=11), 1, 0),
         "bound_ms": t["b2"][0], "bound_by": t["b2"][1],
         "library_ms": t["matmul_s"]})
    bayes_route_sweep(dev)
    print(f"  {sass_counts('bayes_matmul', 'bayes_gemm_mma')}", flush=True)
    return rows


# --------------------------------------------------------------------------
# phase 3 (LM-side kernels): LRT GEMMs, two-pass head, flash attention
# --------------------------------------------------------------------------

# bench_kernels' Bayesian dense layer (f32 x) and qwen2-1.5B's head at the
# serving path's 4 slots (bf16 hidden state)
LRT_SHAPES = ((128, 1024, 4096, torch.float32),
              (4, 1536, 151936, torch.bfloat16))
# ragged M, K and N on the tensor-core route, bf16 x
LRT_RAGGED = (130, 1000, 4100, torch.bfloat16)
# rows at which both LRT kernels are timed, around LRT_MMA_MIN_ROWS
LRT_SWEEP_ROWS = (8, 9, 16, 32, 64)
# qwen2-1.5B's attention widths (H 12, Hkv 2, D 128, bf16):
# (name, B, Sq, Sk, q_offset, causal)
FLASH_CASES = (("prompt 256", 4, 256, 256, 0, True),
               ("causal 2048", 4, 2048, 2048, 0, True),
               ("prefill continuation", 1, 64, 2048, 1984, True),
               ("decode window", 4, 1, 2048, 2047, True),
               ("non-causal", 4, 256, 1024, 0, False))
FLASH_H, FLASH_HKV, FLASH_D = 12, 2, 128


def lrt_case(dev, M, K, N, dtype, seed):
    x, mu, sg, g = gemm_case(dev, M, K, N, seed)
    return x.to(dtype), mu, sg, g


def lrt_moments(x, mu, sg):
    """The LRT output's mean and std from plain f32 GEMMs (TF32 off)."""
    x32 = x.float()
    return x32 @ mu, torch.sqrt((x32 * x32) @ (sg * sg))


def check_lrt(dev) -> tuple[dict, dict]:
    """Both LRT entry points' kernels against their plain version, within
    1e-5 of max |y|: at both shapes of ``LRT_SHAPES`` (the route asserted:
    the tensor-core kernel at M 128, the streaming kernel at the head's
    M 4) and at a ragged bf16 case on the tensor-core route; explicit xi,
    and the seeded stream, which must be a function of its seed whose mean
    over S lies within std/sqrt(S) of the mean output.  At M 128 the
    streaming kernel runs forced on the same inputs, checked and timed
    beside the tensor-core kernel, whose profile must name
    ``lrt_gemm_mma``.  The table's rows are the M 128 shape."""
    BM = kernel_module("bayes_matmul")
    S = 10
    worst1 = worst2 = 0.0
    rows = None
    for M, K, N, dt in (*LRT_SHAPES, LRT_RAGGED):
        x, mu, sg, g = lrt_case(dev, M, K, N, dt, seed=14)
        xi = torch.randn((M, N), generator=g, device=dev)
        xi_s = torch.randn((S, M, N), generator=g, device=dev)
        tag = f"M={M} K={K} N={N}"
        route = BM.lrt_route(M, K, N, x, mu, sg, xi_s)
        if route != ("stream" if M == 4 else "mma"):
            fail(f"lrt {tag}: lrt_route gave {route!r}")
        want1 = BM.lrt_matmul_plain(x, mu, sg, xi)
        e1 = rel_check(f"lrt_matmul {tag}", BM.lrt_matmul_cuda(x, mu, sg, xi),
                       want1, tol=1e-5)
        e2 = rel_check(f"lrt_matmul_sampled xi {tag}",
                       BM.lrt_matmul_sampled_cuda(x, mu, sg, num_samples=S,
                                                  xi=xi_s),
                       BM.lrt_matmul_sampled_plain(x, mu, sg, num_samples=S,
                                                   xi=xi_s), tol=1e-5)
        seeded = lambda seed, route=None: BM.lrt_matmul_sampled_cuda(  # noqa
            x, mu, sg, num_samples=S, seed=seed, route=route)
        got = seeded(21)
        want_seeded = BM.lrt_matmul_sampled_plain(x, mu, sg, num_samples=S,
                                                  seed=21)
        e3 = rel_check(f"lrt_matmul_sampled seeded {tag}", got, want_seeded,
                       tol=1e-5)
        if not torch.equal(got, seeded(21)) or torch.equal(got, seeded(22)):
            fail(f"lrt_matmul_sampled {tag}: not a function of the seed")
        note = moments_check(f"lrt_matmul_sampled {tag}", got,
                             *lrt_moments(x, mu, sg), S)
        worst1, worst2 = max(worst1, e1), max(worst2, e2, e3)
        print(f"  LRT GEMMs {tag} x {dt}, {route} route: ok (max |err| "
              f"{e1:.3g}, {e2:.3g}, {e3:.3g}; lrt_matmul's "
              f"{e1 / float(want1.abs().max()):.3g} of max |y|; seeded "
              f"{note})", flush=True)
        if (M, K, N, dt) == LRT_RAGGED:
            continue
        esize = x.element_size()
        calls = 10 if M == 128 else 3
        b1 = gemm_bound(M * K * esize + (2 * K * N + 2 * M * N) * 4,
                        4.0 * M * K * N)
        b2 = gemm_bound(M * K * esize + (2 * K * N + S * M * N) * 4,
                        4.0 * M * K * N, philox_calls=M * N * -(-S // 4))
        # library yardstick: the two cuBLAS f32 GEMMs on x^2 and sigma^2
        # formed beforehand
        x32 = x.float()
        x2, s2 = x32 * x32, sg * sg
        lib_ms = device_ms(lambda: (torch.matmul(x32, mu),
                                    torch.matmul(x2, s2)), calls)
        r = ({"max_abs_err": e1,
              "ms": device_ms(lambda: BM.lrt_matmul_cuda(x, mu, sg, xi),
                              calls),
              "plain_ms": time_ms(lambda: BM.lrt_matmul_plain(x, mu, sg, xi),
                                  3),
              "bound_ms": b1[0], "bound_by": b1[1], "library_ms": lib_ms},
             {"max_abs_err": max(e2, e3),
              "ms": device_ms(lambda: seeded(21), calls),
              "plain_ms": time_ms(lambda: BM.lrt_matmul_sampled_plain(
                  x, mu, sg, num_samples=S, seed=21), 1, 0),
              "bound_ms": b2[0], "bound_by": b2[1], "library_ms": lib_ms})
        print(f"  LRT GEMMs {tag}: lrt_matmul {r[0]['ms']:.4f} ms, bound "
              f"{b1[0]:.4f} ms ({b1[2]}), plain {r[0]['plain_ms']:.3f} ms; "
              f"lrt_matmul_sampled S={S} {r[1]['ms']:.4f} ms, bound "
              f"{b2[0]:.4f} ms ({b2[2]}), plain {r[1]['plain_ms']:.2f} ms; "
              f"two cuBLAS GEMMs {lib_ms:.4f} ms", flush=True)
        if M != 128:
            continue
        # the streaming kernel, forced, on the same inputs
        es1 = rel_check(f"lrt_matmul {tag} (stream)",
                        BM.lrt_matmul_cuda(x, mu, sg, xi, route="stream"),
                        want1, tol=1e-5)
        es3 = rel_check(f"lrt_matmul_sampled seeded {tag} (stream)",
                        seeded(21, "stream"), want_seeded, tol=1e-5)
        t1 = device_ms(lambda: BM.lrt_matmul_cuda(x, mu, sg, xi,
                                                  route="stream"), calls)
        ts = device_ms(lambda: seeded(21, "stream"), calls)
        print(f"  LRT GEMMs {tag}, stream route forced: ok (max |err| "
              f"{es1:.3g}, {es3:.3g}); lrt_matmul {t1:.4f} ms, "
              f"lrt_matmul_sampled S={S} {ts:.4f} ms", flush=True)
        names = lrt_profile(M, K, N)
        if names != ["lrt_gemm_mma<float, 4>"]:
            fail(f"lrt_matmul {tag}: the profile names {names}, not "
                 "lrt_gemm_mma<float, 4> alone")
        print(f"  lrt_matmul {tag} profiled (fresh process): {names}",
              flush=True)
        rows = r
    rows[0]["max_abs_err"], rows[1]["max_abs_err"] = worst1, worst2
    lrt_route_sweep(dev)
    print(f"  {sass_counts('bayes_matmul', 'lrt_gemm_mma')}", flush=True)
    return rows


_PROFILE_LRT = """
import importlib, json, sys, tempfile
import torch
from torch.profiler import ProfilerActivity, profile
BM = importlib.import_module("repro_torch.kernels.bayes_matmul")
M, K, N = map(int, sys.argv[1:4])
x, mu, sg, xi = (torch.rand(s, device="cuda") for s in
                 ((M, K), (K, N), (K, N), (M, N)))
BM.lrt_matmul_cuda(x, mu, sg, xi)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    BM.lrt_matmul_cuda(x, mu, sg, xi)
    torch.cuda.synchronize()
with tempfile.TemporaryDirectory() as tmp:
    prof.export_chrome_trace(tmp + "/trace.json")
    events = json.load(open(tmp + "/trace.json"))["traceEvents"]
print(json.dumps(sorted(e["name"] for e in events
                        if e.get("cat") == "kernel")))
"""


def lrt_profile(M: int, K: int, N: int) -> list[str]:
    """The kernels one ``lrt_matmul_cuda`` call with f32 operands of
    (M, K, N) launches, by torch.profiler in a fresh process (a second
    profiler session late in this one was seen to record the launches but
    not the kernels), as ``name<args>``."""
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", _PROFILE_LRT, str(M), str(K),
                          str(N)], env=env, capture_output=True, text=True)
    if out.returncode:
        fail(f"lrt profile: the child process failed:\n{out.stderr[-2000:]}")
    names = json.loads(out.stdout.strip().splitlines()[-1])
    return [n.split("::")[-1].split("(")[0] for n in names]


def lrt_route_sweep(dev) -> None:
    """Both LRT kernels, forced, at the rows around ``LRT_MMA_MIN_ROWS``
    and at both widths of ``LRT_SHAPES``: the measurement the threshold is
    set from (lrt_matmul's device time).  The tensor-core kernel is held
    to the plain version at each point."""
    BM = kernel_module("bayes_matmul")
    for _, K, N, dt in LRT_SHAPES:
        cells = []
        for M in LRT_SWEEP_ROWS:
            x, mu, sg, g = lrt_case(dev, M, K, N, dt, seed=20)
            xi = torch.randn((M, N), generator=g, device=dev)
            rel_check(f"lrt_matmul M={M} K={K} N={N} (mma, forced)",
                      BM.lrt_matmul_cuda(x, mu, sg, xi, route="mma"),
                      BM.lrt_matmul_plain(x, mu, sg, xi), tol=1e-5)
            t = {r: device_ms(lambda: BM.lrt_matmul_cuda(x, mu, sg, xi,
                                                         route=r), 3)
                 for r in BM.LRT_ROUTES}
            cells.append(f"M {M} stream {t['stream']:.4f} mma {t['mma']:.4f}")
        print(f"  LRT route sweep, lrt_matmul K={K} N={N} {dt} (ms; "
              f"LRT_MMA_MIN_ROWS {BM.LRT_MMA_MIN_ROWS}): " + ", ".join(cells),
              flush=True)


def check_two_pass(dev) -> dict:
    """The two-pass head against its plain version at M 4 and 16 with bf16
    x; the row is M 4."""
    UH = kernel_module("uncertainty_head")
    S = 10
    mu, sigma, g = head_case(dev, 15)
    K, V = mu.shape
    worst, row = 0.0, {}
    for M in (4, 16):
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        xi = torch.randn((S, M, V), generator=g, device=dev)
        got = UH.uncertainty_head_two_pass_cuda(x, mu, sigma, xi)
        want = UH.uncertainty_head_two_pass_plain(x, mu, sigma, xi)
        e = compare_heads(f"two-pass head M={M}", got, want, x, mu, sigma, xi)
        worst = max(worst, e)
        ms = device_ms(lambda: UH.uncertainty_head_two_pass_cuda(
            x, mu, sigma, xi), 5)
        # inputs read once and outputs written once; the (S, M, V) scratch
        # is the kernel's own and not counted
        b_ms, b_by = bound(M * K * 2 + 2 * K * V * 4 + S * M * V * 4
                           + 5 * M * 4, 4.0 * M * K * V, F32_FLOPS)
        scratch = 2 * S * M * V * 4
        print(f"  two-pass head M={M}: ok (max |err| {e:.3g}), {ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}); with the scratch written and "
              f"re-read {b_ms + scratch / HBM_BYTES_PER_S * 1e3:.4f} ms",
              flush=True)
        if M == 4:
            # no single PyTorch call computes the head: no library time
            row = {"ms": ms, "plain_ms": time_ms(
                lambda: UH.uncertainty_head_two_pass_plain(x, mu, sigma, xi),
                1, 0), "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
    row["max_abs_err"] = worst
    return row


def flash_case(dev, B, Sq, Sk, seed, D=FLASH_D, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, n, h, D), generator=g, device=dev).to(dtype)
            for n, h in ((Sq, FLASH_H), (Sk, FLASH_HKV), (Sk, FLASH_HKV))]


def bf16_check(name: str, got, want32) -> float:
    """bf16 outputs against an f32 reference: within one bf16 ulp of |o|
    (2^(e-8) for |o| in [2^(e-1), 2^e)) plus 2^-20 for f32 sums taken in
    another order."""
    w = want32.float()
    d = (got.float() - w).abs()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    bad = ~(d <= ulp + 2.0 ** -20)
    if bad.any() or not torch.isfinite(got).all():
        fail(f"{name}: {int(bad.sum())} outputs beyond one bf16 ulp of the "
             f"reference (max |err| {float(d.max()):.3g})")
    return float(d.max())


def attention_pairs(Sq, Sk, q_offset, causal) -> int:
    """(query, key) pairs the attention reads: the causal mask's count."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, max(0, q_offset + i + 1)) for i in range(Sq))


def check_flash(dev) -> dict:
    """The tensor-core flash kernel (every case routes there) against the
    plain version's f32 result at each case, and SDPA beside it; the row
    is B 4, Sq = Sk = 2048, causal, whose profile must name
    ``flash_fwd_mma<128>``.  The same inputs through the SIMT kernel (an
    odd-stride view of q routes there) are timed beside it, and the SIMT
    kernel is held against the plain version with f32 operands and with
    bf16 at D 72."""
    FA = kernel_module("flash_attention")
    H, Hkv, D = FLASH_H, FLASH_HKV, FLASH_D
    worst, row = 0.0, {}
    for name, B, Sq, Sk, off, causal in FLASH_CASES:
        q, k, v = flash_case(dev, B, Sq, Sk, 16)
        kw = {"causal": causal, "q_offset": off}
        if FA.flash_route(q.dtype, D, q, k, v) != "mma":
            fail(f"flash attention {name}: bf16 at D {D} must take the "
                 "tensor-core kernel")
        chunks = FA.flash_split(B, Hkv, H // Hkv * Sq, Sk)
        got = FA.flash_attention_cuda(q, k, v, **kw)
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        e = bf16_check(f"flash attention {name}", got, want)
        worst = max(worst, e)
        # library yardstick: SDPA over K/V expanded to the query heads
        # beforehand (not timed), causal by its flag or by a mask
        qx = q.transpose(1, 2).contiguous()
        kx, vx = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        sdpa = {}
        if causal and off == 0 and Sq == Sk:
            sdpa["is_causal"] = True
        elif causal:
            kpos = torch.arange(Sk, device=dev)
            qpos = off + torch.arange(Sq, device=dev)
            sdpa["attn_mask"] = kpos[None, :] <= qpos[:, None]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qx, kx, vx, **sdpa)
        e_lib = max_err(lib().transpose(1, 2), want)
        if not e_lib <= 2e-2:       # one bf16 ulp of O(1) outputs
            fail(f"flash attention {name}: the SDPA yardstick differs by "
                 f"{e_lib:.3g}")
        pairs = attention_pairs(Sq, Sk, off, causal)
        b_ms, b_by = bound((2 * B * Sq * H + 2 * B * Sk * Hkv) * D * 2,
                           4.0 * B * H * D * pairs, BF16_FLOPS)
        calls = 5 if Sq * Sk >= 2 ** 21 else 20
        ms = device_ms(lambda: FA.flash_attention_cuda(q, k, v, **kw), calls)
        lib_ms = device_ms(lib, calls)
        # the SIMT kernel on the same inputs: q seen with an odd S stride
        wide = torch.zeros((B, Sq, H * D + 1), dtype=q.dtype, device=dev)
        wide[..., :H * D] = q.reshape(B, Sq, H * D)
        q_odd = wide[..., :H * D].unflatten(-1, (H, D))
        if FA.flash_route(q.dtype, D, q_odd, k, v) != "simt":
            fail(f"flash attention {name}: an odd-stride q must take the "
                 "SIMT kernel")
        simt_ms = device_ms(lambda: FA.flash_attention_cuda(q_odd, k, v,
                                                            **kw), calls)
        print(f"  flash attention {name} (B {B}, Sq {Sq}, Sk {Sk}, q_offset "
              f"{off}, {chunks} kv chunk{'s' if chunks > 1 else ''}): ok "
              f"(max |err| {e:.3g}; SDPA {e_lib:.3g}), {ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), SDPA {lib_ms:.4f} ms, SIMT kernel "
              f"{simt_ms:.4f} ms, "
              f"{4.0 * B * H * D * pairs / ms / 1e9:.2f} TFLOP/s", flush=True)
        if name == "causal 2048":
            t = device_trace(lambda: FA.flash_attention_cuda(q, k, v, **kw),
                             "flash")
            names = [n for n in t["by_name"] if "flash_" in n]
            if not any("flash_fwd_mma<128>" in n for n in names) or \
                    any("simt" in n or "merge" in n for n in names):
                fail(f"flash attention {name}: the profile names {names}, "
                     "not flash_fwd_mma<128> alone")
            print(f"  flash attention {name} profiled: {top(t['by_name'], 3)}",
                  flush=True)
            row = {"ms": ms, "plain_ms": time_ms(
                lambda: FA.flash_attention_plain(q, k, v, **kw), 1, 0),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    # the SIMT kernel, which f32 operands and bf16 head dims the tensor
    # cores do not take run: f32 at the prompt-256 case, bf16 at D 72
    name, B, Sq, Sk, off, causal = FLASH_CASES[0]
    kw = {"causal": causal, "q_offset": off}
    for dtype, Dx in ((torch.float32, D), (torch.bfloat16, 72)):
        q, k, v = flash_case(dev, B, Sq, Sk, 17, Dx, dtype)
        if FA.flash_route(dtype, Dx, q, k, v) != "simt":
            fail(f"flash attention: {dtype} at D {Dx} must take the SIMT "
                 "kernel")
        got = FA.flash_attention_cuda(q, k, v, **kw)
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        **kw)
        tag = f"flash attention (SIMT) {name} {dtype} D={Dx}"
        if dtype == torch.float32:
            e = max_err(got, want)
            if not e <= 2e-5 or not torch.isfinite(got).all():
                fail(f"{tag}: max |err| {e:.3g} > 2e-05 or not finite")
        else:
            e = bf16_check(tag, got, want)
        print(f"  {tag}: ok (max |err| {e:.3g})", flush=True)
    print(f"  {sass_counts('flash_attention', 'flash_fwd_mma')}", flush=True)
    row["max_abs_err"] = worst
    return row


# --------------------------------------------------------------------------
# phases 4-6: serving at full width
# --------------------------------------------------------------------------

KERNEL_PATH = ["--decode-attn", "kernel", "--prefill", "chunked"]
GATHER_PATH = ["--decode-attn", "gather", "--prefill", "batch"]
SERVE_RUNS = 3


def serve_args(extra: list[str], flags: list[str] = SERVE_FLAGS):
    from repro_torch.launch.serve import build_parser

    args = build_parser().parse_args(flags + extra)
    args.reduced = False                  # full width, from Python
    return args


def build_serve(extra: list[str], flags: list[str] = SERVE_FLAGS, cfg=None):
    """``(args, (engine, cfg))``: the engine at full width (``cfg`` where
    not the flags' arch's own), its decode chunk captured as a CUDA graph
    (set-up: nothing here is counted)."""
    from repro_torch.launch.serve import build_engine

    args = serve_args(extra, flags)
    return args, build_engine(args, cfg=cfg)


def serve_full(extra: list[str], built=None,
               flags: list[str] = SERVE_FLAGS) -> dict:
    from repro_torch.launch.serve import serve

    args = serve_args(extra, flags)
    torch.cuda.synchronize()
    return serve(args, built)


def spread(values: list[float], fmt: str = ".2f") -> str:
    v = sorted(values)
    return (f"median {v[len(v) // 2]:{fmt}} (range {v[0]:{fmt}}-"
            f"{v[-1]:{fmt}})")


def serve_phase(launches) -> dict:
    """Phase 4: the kernel path (kernel entropy) served SERVE_RUNS times
    by one engine, the launch counts zeroed just before each run and
    checked just after it; decode ms a step and tok/s as median and
    range; then the per-token loop (``decode_loop_reference``) on the
    same prompts in batches of the slot count.  Returns the first run's
    counts."""
    from repro_torch.core.entropy import KernelEntropy
    from repro_torch.launch.engine.runner import decode_loop_reference
    from repro_torch.launch.serve import make_requests

    t0 = time.perf_counter()
    args, built = build_serve(KERNEL_PATH + ["--entropy", "kernel"])
    engine, cfg = built
    runner = engine.runner
    print(f"serve engine built in {time.perf_counter() - t0:.1f}s; decode "
          f"chunk graph warm-up + capture {runner.capture_s:.3f}s, "
          f"{runner.graph_key}, launches a replay {runner.captured}",
          flush=True)
    counts = serve_runs(args, built, "serve", launches)
    prompts = [q.prompt for q in make_requests(args, cfg)]
    toks = secs = 0.0
    for b in range(0, len(prompts), args.slots):
        ref = decode_loop_reference(
            engine.params, engine.cfg, prompts[b:b + args.slots],
            args.gen_len, entropy=KernelEntropy(seed=args.seed))
        if not torch.isfinite(torch.from_numpy(ref["MI"])).all():
            fail("per-token loop: non-finite MI")
        toks += ref["token"].size
        secs += ref["decode_s"]
    print(f"per-token loop (decode_loop_reference, eager, one host sync a "
          f"token, dense cache, batches of {args.slots}) on the same "
          f"prompts: {toks / secs:.1f} decode tok/s", flush=True)
    return counts


def serve_runs(args, built, label: str, launches, attention: bool = True,
               runs: int = SERVE_RUNS, head: bool = True,
               floor_ms: float | None = None) -> dict:
    """``args``' trace served ``runs`` times by the engine ``built``,
    the launch counts zeroed just before each run and checked just after
    it (``check_serve``; ``head``: whether the fused head serves the
    model); every run must give run 1's tokens and MI (one
    engine, its carry reset in place between runs; the head stream is
    keyed by seed and step).  Prints each run and decode ms a step
    (beside ``floor_ms``, the step's bytes floor, where given) and tok/s
    as median and range; returns the first run's counts."""
    from repro_torch.launch.serve import serve

    engine, cfg = built
    counts, ms, tps, e2e, p99, first = None, [], [], [], [], None
    for i in range(runs):
        launches.reset()
        torch.cuda.synchronize()
        r = serve(args, built)
        got = launches.snapshot()
        check_serve(r, got, attention_layers(cfg), attention, head)
        counts = counts or got
        seen = [(q.tokens, q.MI) for q in r["requests"]]
        if first is not None and seen != first:
            fail(f"{label} run {i + 1} differs from run 1 on the same "
                 "engine")
        first = first or seen
        steps = r["spec_decode"]["full_model_calls"]
        ms.append(r["decode_s"] / steps * 1e3)
        tps.append(r["decode_tok_per_s"])
        e2e.append(r["e2e_tok_per_s"])
        p99.append(r["latency_p99_s"])
        print(f"{label} run {i + 1}: {r['gen_tokens']} tokens, decode "
              f"{r['decode_tok_per_s']:.1f} tok/s, e2e "
              f"{r['e2e_tok_per_s']:.1f} tok/s, {r['prefill_chunks']} "
              f"prefill chunks, {steps} decode steps ({ms[-1]:.2f} ms "
              f"each), latency p50 {r['latency_p50_s']:.2f}s p99 "
              f"{r['latency_p99_s']:.2f}s, {r['prefill_mode']} prefill "
              f"first shape {r['prefill_compile_s'] * 1e3:.1f} ms, steady "
              f"{r['prefill_steady_s'] * 1e3:.1f} ms a call, launches {got}",
              flush=True)
    above = "" if floor_ms is None else \
        f" ({sorted(ms)[len(ms) // 2] / floor_ms:.2f}x its bytes floor)"
    print(f"{label} {cfg.name} full width, {runs} run(s) of one graphed "
          f"engine: decode ms a step {spread(ms)}{above}, decode tok/s "
          f"{spread(tps, '.1f')}, e2e tok/s {spread(e2e, '.1f')}, p99 s "
          f"{spread(p99)}", flush=True)
    return counts


def check_graph_chunks(extra: list[str], label: str) -> str:
    """Every decode chunk of a serve run at full width as the graph
    replays it against the eager chunk (``steps.build_scan_decode``
    called directly) on a copy of the carry the replay started from:
    tokens, H, SE, MI and p_max bit for bit, and the carry after (depths,
    flags and, for the ssm and hybrid families, every layer's state and
    conv tail, and the hybrid's pool planes)."""
    args, built = build_serve(extra)
    return graph_vs_eager(args, built, label)[1]


WIDEN_FLAGS = ["--long-prompt", "512", "--num-requests", "4"]


def check_widened_table() -> str:
    """A request whose prompt + budget needs more blocks than the
    build-time table holds (``--long-prompt 512`` against a table of
    ceil(296 / 16) = 19 blocks): the scheduler widens its tables mid-run,
    the runner moves to a device table of the new width and captures the
    chunk again over it, and every chunk, those replayed at the new width
    included, is held against the eager chunk bit for bit."""
    args, built = build_serve(KERNEL_PATH + ["--entropy", "kernel"]
                              + WIDEN_FLAGS)
    runner = built[0].runner
    graphed, widths = runner.scan, []

    def recording(*a):
        widths.append(runner.table_width())
        return graphed(*a)

    runner.scan = recording
    try:
        r, report = graph_vs_eager(args, built, "widened table")
    finally:
        runner.__dict__.pop("scan", None)
    wide = sum(w > runner.table_width0 for w in widths)
    if r["table_growths"] < 1 or wide == 0 \
            or not set(widths) | {runner.table_width0} <= set(runner._graphs):
        fail(f"widened table: {r['table_growths']} growths, {wide} chunks "
             f"at a widened table, graphs at widths {sorted(runner._graphs)}")
    long = r["requests"][0]
    if len(long.prompt) != 512 or len(long.tokens) != args.gen_len:
        fail("widened table: the long request did not finish")
    return (f"{report}; {r['table_growths']} table growth(s), widths "
            f"{sorted(set(widths))} blocks, {wide} chunks replayed at the "
            f"widened table, its graph captured mid-run in "
            f"{max(runner.width_capture_s.values()):.3f}s")


def graph_vs_eager(args, built, label: str) -> tuple[dict, str]:
    """``check_graph_chunks`` on an engine already built: one serve run of
    ``args``' trace with every chunk checked; returns (the run, the
    report)."""
    from repro_torch.core.entropy import KernelEntropy
    from repro_torch.launch import steps as S
    from repro_torch.launch.serve import make_requests

    engine, cfg = built
    runner = engine.runner
    eager = S.build_scan_decode(
        engine.cfg, entropy=KernelEntropy(seed=args.seed)
        if args.entropy == "kernel" else None, chunk=args.chunk,
        mi_threshold=args.mi_threshold, se_threshold=args.se_threshold)
    graphed = runner.scan
    chunks = [0]

    def bits(t):
        return t.contiguous().view(torch.int32)

    def checked(tok, cache, step0, active, flags):
        copy = [tok.clone(), {k: v.clone() for k, v in cache.items()},
                active.clone(), {k: v.clone() for k, v in flags.items()}]
        out = graphed(tok, cache, step0, active, flags)
        ys = torch.empty_like(runner.ys)
        step = torch.full((1,), step0, dtype=torch.int32, device=tok.device)
        e_tok, e_cache, e_flags, ys = eager(engine.params, copy[0], copy[1],
                                            step, copy[2], copy[3], ys)
        rows = [S.OUTPUTS.index(k) for k in ("token", "H", "SE", "MI",
                                             "p_max")]
        same = {"outputs": torch.equal(bits(out[3][:, rows]),
                                       bits(ys[:, rows])),
                "tokens": torch.equal(out[0], e_tok),
                "len": torch.equal(cache["len"], e_cache["len"]),
                "flags": all(torch.equal(flags[k], e_flags[k])
                             for k in flags)}
        for k in RECURRENT_CARRY + (ENCDEC_CARRY if cfg.family in
                                    ("encdec", "vlm") else ()):
            if k in cache:
                a, b = cache[k], e_cache[k]
                if "block_table" in cache and k in ("attn_k", "attn_v", "k",
                                                    "v"):
                    # the sink block takes every dropped write (evicted
                    # slots') in no fixed order, and is never read
                    a, b = a[:, :-1], b[:, :-1]
                same[k] = torch.equal(bits(a), bits(b))
        if not all(same.values()):
            fail(f"graph vs eager ({label}): chunk {chunks[0]} at step "
                 f"{step0} differs in "
                 f"{', '.join(k for k, v in same.items() if not v)}")
        chunks[0] += 1
        return out

    runner.scan = checked
    try:
        r = engine.run(make_requests(args, cfg))
    finally:
        del runner.scan
    if chunks[0] == 0 or r["chunks_run"] != chunks[0]:
        fail(f"graph vs eager ({label}): {chunks[0]} chunks compared")
    return r, (f"graph vs eager chunk ({label}): {chunks[0]} chunks of "
               f"{args.chunk} steps bit for bit (tokens, H, SE, MI, p_max, "
               f"carry)")


# the carry leaves a graphed chunk is held to beside the depths: the
# recurrent state and conv tail of the ssm and hybrid families, and the
# hybrid's pool planes
RECURRENT_CARRY = ("ssm", "conv", "attn_k", "attn_v")
# and the encdec family's: its cross strips and its self-attention pools
# (the vlm family's pools too: it has no cross strips)
ENCDEC_CARRY = ("ck", "cv", "k", "v")


def attention_layers(cfg) -> int:
    """Attention launches a decode step and a prefill chunk: one a layer,
    or one an application of the hybrid's shared block, or one a decoder
    layer of the encdec family (its encoder and cross-attention run the
    plain attention)."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_apps
        return n_attn_apps(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import n_dec
        return n_dec(cfg)
    return cfg.num_layers


def check_serve(r: dict, counts: dict, layers: int = 28,
                attention: bool = True, head: bool = True) -> None:
    """The run's launch counts (one attention launch a layer, or a
    hybrid application, a decode step and a prefill chunk, one head a
    step, none where the head is soft-capped (``head`` False: the plain
    explicit-logits head, as in the reference); an attention-free family
    launches the head alone, batch prefill no prefill kernel) and its
    requests (finished, 32 tokens, finite H/SE/MI, MI >= 0)."""
    steps, chunks = r["spec_decode"]["full_model_calls"], r["prefill_chunks"]
    want = {"paged_decode_attention": layers * steps * attention,
            "paged_prefill_attention": layers * chunks * attention,
            "uncertainty_head": steps * head}
    none = {"paged_decode_attention": not attention,
            "paged_prefill_attention": not attention
            or r["prefill_mode"] == "batch", "uncertainty_head": not head}
    for name, n in want.items():
        if counts[name] != n or (n == 0 and not none[name]) or steps == 0:
            fail(f"serve: {name} launched {counts[name]} times, expected "
                 f"{n}" + (" (> 0)" if attention else ""))
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
    window (first kernel start to last kernel end, in ms), the kernels
    (and those of CUDA graph replays, with their busy time), the host
    syncs, and device time by kind and by name.  The profiler slows the
    host, so the idle share is an upper bound."""
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
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    # a graph replay's kernels carry its cudaGraphLaunch's correlation id
    replays = {e.get("args", {}).get("correlation") for e in runtime
               if "GraphLaunch" in e.get("name", "")}
    in_graph = sorted((e["ts"], e["dur"]) for e in events
                      if e.get("cat") == "kernel"
                      and e.get("args", {}).get("correlation") in replays)
    graph_busy, end = 0.0, -math.inf
    for ts, dur in in_graph:
        graph_busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
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
    syncs = [e for e in runtime if "Synchronize" in e.get("name", "")]
    # each sync's cause: the innermost host op around it on its thread
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    causes: dict[str, int] = {}
    for e in syncs:
        around = [o for o in ops if o.get("tid") == e.get("tid")
                  and o["ts"] <= e["ts"] <= o["ts"] + o.get("dur", 0)]
        inner = min(around, key=lambda o: o.get("dur", 0), default=None)
        cause = f"{inner['name'] if inner else 'no op'} -> {e['name']}"
        causes[cause] = causes.get(cause, 0) + 1
    graphs = sum(1 for e in runtime if "GraphLaunch" in e.get("name", ""))
    return {"out": out, "busy_ms": busy / 1e3,
            "window_ms": (end - kern[0][0]) / 1e3, "kernels": len(kern),
            "syncs": len(syncs), "sync_causes": causes,
            "graph_launches": graphs, "graph_kernels": len(in_graph),
            "graph_busy_ms": graph_busy / 1e3, "by_kind": by_kind,
            "by_name": by_name}


def top(table: dict, n: int) -> str:
    return ", ".join(f"{k} {v[0] / 1e3:.2f} ms ({v[1]})" for k, v in
                     sorted(table.items(), key=lambda kv: -kv[1][0])[:n])


PROFILE_SERVE = KERNEL_PATH + ["--entropy", "kernel", "--num-requests", "4",
                               "--prompt-len", "64", "--gen-len", "16"]
# a profiled serve whose prompts must hold more than 64 tokens
PROFILE_PROMPT = {"vlm_serve": ["--prompt-len", str(VLM_PROMPT)]}


# fresh processes started ahead of their traces (``start_tracers``)
TRACERS: list = []
TRACERS_AHEAD = 2


def start_tracers() -> None:
    """Keep ``TRACERS_AHEAD`` fresh processes (``python3 chip_smoke.py
    --trace -``) ready: each imports the port, loads the kernels and opens
    its CUDA context, then waits for the kind of its one trace on its
    standard input, so that a trace does not wait for a process to reach
    the card.  ``stop_tracers`` ends them (also at exit)."""
    if not TRACERS:
        import atexit
        atexit.register(stop_tracers)
    while len(TRACERS) < TRACERS_AHEAD:
        TRACERS.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--trace", "-"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))


def stop_tracers() -> None:
    while TRACERS:
        proc = TRACERS.pop()
        proc.kill()
        proc.communicate()


def traced(kind: str) -> dict:
    """``trace_main(kind)`` run in a fresh process (``python3
    chip_smoke.py --trace KIND``, or one that ``start_tracers`` started):
    late in a long process torch.profiler can drop a window's kernels, in
    part or all of them."""
    torch.cuda.empty_cache()
    if TRACERS:
        proc = TRACERS.pop(0)
        stdout, stderr = proc.communicate(kind + "\n")
        start_tracers()
    else:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--trace", kind], capture_output=True,
                              text=True)
        stdout, stderr = proc.stdout, proc.stderr
    if proc.returncode != 0:
        fail(f"trace {kind} in a fresh process failed:\n{stderr[-3000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def trace_main(kind: str) -> dict:
    """A ``device_trace`` summary, without its output: ``serve`` (or
    ``moe_serve``, deepseek-moe-16b; ``ssm_serve``, mamba2-370m;
    ``hybrid_serve``, zamba2-7b; ``encdec_serve``, seamless-m4t-medium;
    ``vlm_serve``, phi-3-vision-4.2b at prompt 640; ``nemotron_serve``,
    ``codeqwen_serve``, ``qwen2_7b_serve``, ``grok_serve``, phase 21's
    archs), the short kernel-path serve (the engine and its graph built before the
    window), or ``bnn_machine`` / ``bnn_mean``, the BNN's MC prediction
    on 800 images after one untraced call."""
    dev = torch.device("cuda")
    if kind in SERVED:
        flags = SERVED[kind][0]
        extra = PROFILE_SERVE + PROFILE_PROMPT.get(kind, [])
        args = serve_args(extra, flags)
        _, built = build_serve(extra, flags, served_config(args)
                               if args.arch in CUTS else None)
        t = device_trace(lambda: serve_full(extra, built, flags), kind)
        r = t.pop("out")
        return t | {"steps": r["spec_decode"]["full_model_calls"],
                    "prefill_chunks": r["prefill_chunks"],
                    "chunks_run": r["chunks_run"]}
    if kind in ("bnn_machine", "bnn_mean"):
        from repro_torch.models import bnn_cnn as B

        cfg, _, params, x_id, _ = bnn_case(dev)
        mode = kind[len("bnn_"):]
        B.mc_predict(params, cfg, x_id,
                     torch.Generator(device=dev).manual_seed(100), mode)
        gen = torch.Generator(device=dev).manual_seed(100)
        t = device_trace(lambda: B.mc_predict(params, cfg, x_id, gen, mode),
                         kind)
        del t["out"]
        return t
    fail(f"unknown trace {kind!r}")


def profile_serve(kind: str = "serve") -> str:
    """A short kernel-path serve under torch.profiler (1 prefill chunk per
    request, 2 decode chunks each; the engine and its graph built before
    the window) of qwen2-1.5b (``serve``, 28 layers) or deepseek-moe-16b
    (``moe_serve``, ``MOE_DEPTH`` layers), mamba2-370m (``ssm_serve``,
    ``SSM_DEPTH`` layers, batch prefill, no attention kernel) or zamba2-7b
    (``hybrid_serve``, ``HYBRID_DEPTH`` blocks, 3 applications of the
    shared attention, D 112) or seamless-m4t-medium (``encdec_serve``,
    ``ENCDEC_DEPTH`` decoder layers, D 64) or phi-3-vision-4.2b
    (``vlm_serve``, ``VLM_DEPTH`` layers, D 96, batch prefill on
    the plain attention: no prefill kernel) or phase 21's nemotron-4-15b,
    codeqwen1.5-7b, qwen2-7b (``nemotron_serve``, ``codeqwen_serve``,
    ``qwen2_7b_serve``, ``DENSE_ARCH_DEPTH`` layers) or grok-1-314b
    (``grok_serve``, ``GROK_DEPTH`` layers, its soft-capped head plain:
    no head kernel): device time by kind of
    kernel, how much of the traced window the device sits idle, and the
    host syncs by cause."""
    t = traced(kind)
    steps = t["steps"]
    _, D, apps = SERVED[kind]
    prefill = {k: v for k, v in t["by_name"].items() if "paged_prefill_" in k}
    decode = {k: v for k, v in t["by_name"].items() if "paged_decode_" in k}
    # the head's five launches a call; its stream (mu/sigma read once) is
    # the one counted
    head = {k: v for k, v in t["by_name"].items() if "head_stream" in k}
    heads = {k: v for k, v in t["by_name"].items()
             if any(f"head_{n}" in k for n in
                    ("stream", "stats", "merge", "pass2", "final"))}
    if kind == "ssm_serve":
        if prefill or decode or sum(v[1] for v in head.values()) != steps:
            fail(f"profile {kind}: attention kernels ran, or the head did "
                 f"not run once a step ({top(head, 4) or 'no head'})")
    elif kind == "vlm_serve":
        if prefill or t["prefill_chunks"]:
            fail(f"profile {kind}: batch prefill ran prefill chunks or a "
                 f"prefill kernel ({top(prefill, 4)})")
    elif not any(f"paged_prefill_mma<{D}>" in k for k in prefill):
        fail(f"profile {kind}: the served prefill did not run "
             f"paged_prefill_mma<{D}> ({top(prefill, 4) or 'no prefill'})")
    if kind in ("hybrid_serve", "encdec_serve", "vlm_serve",
                "nemotron_serve", "codeqwen_serve", "qwen2_7b_serve") \
            and not head:
        fail(f"profile {kind}: the fused head did not run")
    if kind == "grok_serve" and heads:
        fail(f"profile {kind}: a head kernel ran ({top(heads, 5)}) where "
             "the soft-capped head takes the plain path")
    if any("paged_prefill_simt<__nv_bfloat16>" in k for k in prefill):
        fail("profile: the served bf16 prefill ran the SIMT kernel")
    # the served decode: the tensor-core kernel alone, one launch a call
    if kind != "ssm_serve" and (
            list(decode) != [k for k in decode
                             if f"paged_decode_mma<{D}>" in k]
            or not decode
            or sum(v[1] for v in decode.values()) != apps * steps):
        fail(f"profile {kind}: the served decode did not run "
             f"paged_decode_mma<{D}> alone, {apps} launches a step "
             f"({top(decode, 4) or 'none'})")
    causes = ", ".join(f"{k} {n}" for k, n in sorted(
        t["sync_causes"].items(), key=lambda kv: -kv[1]))
    return (f"profile {kind} (a fresh process), kernel path, {steps} "
            f"decode steps "
            f"+ {t['prefill_chunks']} prefill chunks ({t['chunks_run']} decode "
            f"chunks, {t['graph_launches']} graph launches): device busy "
            f"{t['busy_ms']:.2f} ms of a {t['window_ms']:.2f} ms window (idle "
            f"{1 - t['busy_ms'] / t['window_ms']:.1%}), {t['kernels']} "
            f"kernels ({t['kernels'] / steps:.1f} a decode step), "
            f"{t['syncs']} host syncs ({t['syncs'] / steps:.2f} a decode "
            f"step)\n"
            f"  in the decode graph replays: {t['graph_kernels']} kernels "
            f"({t['graph_kernels'] / steps:.1f} a step), device busy "
            f"{t['graph_busy_ms']:.2f} ms ({t['graph_busy_ms'] / steps:.3f} "
            f"a step)\n"
            f"  host syncs by cause: {causes}\n"
            f"  by kind: {top(t['by_kind'], len(t['by_kind']))}\n"
            f"  top kernels: {top(t['by_name'], 8)}\n"
            f"  prefill kernels: {top(prefill, 4) or 'none'}\n"
            f"  decode kernels: {top(decode, 4) or 'none'}\n"
            f"  head kernels: {top(heads, 5)}")


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
# phase 9: the moe family at full width
# --------------------------------------------------------------------------

MOE_FLAGS = ["--arch", "deepseek_moe_16b", *SERVE_FLAGS[2:]]
# the layers phases 9-13 serve and profile, cut for the script's time
# (the widths stay whole): deepseek-moe-16b 4 of 28, mamba2-370m 12 of
# 48, zamba2-7b 13 of 81 Mamba2 blocks (three applications of the shared
# block), seamless-m4t-medium 4 + 4 of 12 + 12, phi-3-vision-4.2b 8 of 32
MOE_DEPTH, SSM_DEPTH, HYBRID_DEPTH, ENCDEC_DEPTH, VLM_DEPTH = 4, 12, 13, 4, 8
# and phase 21's (``tools/arch_phase.py``): nemotron-4-15b 4 of 32,
# codeqwen1.5-7b 4 of 32, qwen2-7b 4 of 28, grok-1-314b 2 of 64
DENSE_ARCH_DEPTH, GROK_DEPTH = 4, 2
CUTS = {"nemotron_4_15b": {"num_layers": DENSE_ARCH_DEPTH},
        "codeqwen1_5_7b": {"num_layers": DENSE_ARCH_DEPTH},
        "qwen2_7b": {"num_layers": DENSE_ARCH_DEPTH},
        "grok_1_314b": {"num_layers": GROK_DEPTH},
        "deepseek_moe_16b": {"num_layers": MOE_DEPTH},
        "mamba2_370m": {"num_layers": SSM_DEPTH},
        "zamba2_7b": {"num_layers": HYBRID_DEPTH},
        "seamless_m4t_medium": {"num_layers": ENCDEC_DEPTH,
                                "encoder_layers": ENCDEC_DEPTH,
                                "decoder_layers": ENCDEC_DEPTH},
        "phi_3_vision_4_2b": {"num_layers": VLM_DEPTH}}


def served_config(args, **cut):
    """``args.arch`` at full width, cut in depth as ``cut`` or else
    ``CUTS`` says (its reduced config where ``args.reduced``)."""
    import dataclasses

    from repro_torch.configs.registry import get_config, reduced
    cfg = get_config(args.arch)
    return reduced(cfg) if args.reduced \
        else dataclasses.replace(cfg, **(cut or CUTS[args.arch]))


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def reckon(cfg) -> tuple[int, int]:
    """(parameter bytes, the draw's peak bytes) of ``registry.init_params``
    at ``cfg``, run on the meta device under ``MemTracker``: nothing is
    allocated, every tensor the draw makes is counted while it lives."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.models import registry as M

    tracker, out = MemTracker(), []
    with tracker:
        out.append(M.init_params(cfg, torch.Generator(), "meta"))
    peak = sum(by_kind["Total"] for by_kind in
               tracker.get_tracker_snapshot("peak").values())
    return tree_bytes(out[0]), peak


@contextlib.contextmanager
def softcap_heads():
    """Count the plain head's soft-capped logits while the block runs
    (``layers.head_logits_sampled`` / ``head_logits_mean``, which
    ``uncertain_head`` looks up in its module at each call): a list of
    (function, whether the config soft-caps) a call."""
    from repro_torch.models import layers as L

    calls, inner = [], (L.head_logits_sampled, L.head_logits_mean)

    def sampled(p, x, cfg, xi, tp=None):
        calls.append(("sampled", bool(cfg.logits_softcap)))
        return inner[0](p, x, cfg, xi, tp)

    def mean(p, x, cfg, tp=None):
        calls.append(("mean", bool(cfg.logits_softcap)))
        return inner[1](p, x, cfg, tp)

    L.head_logits_sampled, L.head_logits_mean = sampled, mean
    try:
        yield calls
    finally:
        L.head_logits_sampled, L.head_logits_mean = inner


def arch_flags(arch: str) -> list[str]:
    return ["--arch", arch, *SERVE_FLAGS[2:]]


def serve_arch(arch: str, launches, runs: int = 1) -> dict:
    """One arch of the dense or moe family at full width, cut in depth as
    ``CUTS`` says (bf16 body, f32 head, random weights from the seed),
    on phase 4's trace: phase 9 serves deepseek-moe-16b with it, phase 21
    the four archs of ``tools/arch_phase.py``.

    1. The parameters drawn here, their bytes equal to ``reckon``'s and
       the draw's peak beside its reckoning; one engine, its decode chunk
       one CUDA graph, serves the trace ``runs`` times on the kernel path
       in kernel entropy (``serve_runs``: the counts zeroed before each
       run and checked after it); a replay's launches asserted (a decode
       launch a layer a step and the fused head a step; a soft-capped
       head none, and its plain head must have run, as the reference
       routes it); init and capture seconds, peak memory, ms a decode
       step against the bytes floor, tok/s.
    2. One more serve with every chunk held bit for bit against the eager
       chunk (``graph_vs_eager``).
    3. Operand entropy through the kernel path and through the gather /
       batch path (every chunk of the latter against the eager chunk
       too), ``compare_plain`` reported and, for the moe family, the
       prefill routing flips; every request finished with finite H / SE
       / MI and MI >= 0.

    Returns the first measured serve's counts."""
    from repro_torch import resolve_device
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import registry as M

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    args = serve_args(KERNEL_PATH + ["--entropy", "kernel"], arch_flags(arch))
    dev = resolve_device(args.device)
    base = served_config(args)
    want_bytes, want_peak = reckon(base)
    t0 = time.perf_counter()
    params = M.init_params(base, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - before
    nbytes = tree_bytes(params)
    if nbytes != want_bytes:
        fail(f"{arch}: {nbytes} parameter bytes, reckoned {want_bytes}")
    fused = not base.logits_softcap
    with softcap_heads() as capped:
        built = build_engine(args, params, cfg=base)
    engine, cfg = built
    runner = engine.runner
    want = {"paged_decode_attention": cfg.num_layers * args.chunk}
    if fused:
        want["uncertainty_head"] = args.chunk
    if runner.captured != want:
        fail(f"{arch}: a replay records {runner.captured}, expected {want}")
    if fused == bool(capped) or not all(c for _, c in capped):
        fail(f"{arch}: the plain head's logits were computed {len(capped)} "
             f"times in the capture ({capped[:2]}), expected "
             f"{'none' if fused else 'soft-capped ones'}")
    # a decode step reads every parameter but the embedding table (which
    # it reads a row a slot; the moe family's capacity dispatch runs every
    # expert, C 8 at 4 slots) and each slot's K/V at the trace's mean depth
    table = tree_bytes(params["embed"])
    kv_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim \
        * runner.cache["k"].element_size()
    attended = args.slots * (args.prompt_len + args.gen_len / 2) * kv_token
    floor_ms = (nbytes - table + attended) / HBM_BYTES_PER_S * 1e3
    moe = cfg.family == "moe"
    print(f"{arch} engine {cfg.name}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} of "
          f"D {cfg.head_dim}, ff {cfg.moe_d_ff or cfg.d_ff} "
          f"({cfg.mlp_activation}"
          + (f", {cfg.num_experts} experts top-{cfg.top_k}"
             + (f" + {cfg.num_shared_experts} shared"
                if cfg.num_shared_experts else "") if moe else "")
          + f"), V {cfg.vocab_size}, head "
          + ("fused" if fused else f"soft-capped at {cfg.logits_softcap}, "
             "plain")
          + f"; parameters {nbytes / 1e9:.3f} GB (reckoned "
          f"{want_bytes / 1e9:.3f}; layers "
          f"{tree_bytes(params['blocks']) / 1e9:.3f}, embedding "
          f"{table / 1e9:.3f}, head {tree_bytes(params['head']) / 1e9:.3f}"
          f"), drawn in {init_s:.2f}s, the draw's peak {init_peak / 1e9:.3f} "
          f"GB (reckoned {want_peak / 1e9:.3f}, {init_peak / want_peak:.3f}"
          f"x); decode chunk graph warm-up + capture {runner.capture_s:.3f}"
          f"s; bytes floor a decode step {floor_ms:.4f} ms; launches a "
          f"replay {runner.captured}", flush=True)
    counts = serve_runs(args, built, f"{arch} serve", launches, runs=runs,
                        head=fused, floor_ms=floor_ms)
    print(f"{arch} peak memory after the serves "
          f"{(torch.cuda.max_memory_allocated() - before) / 1e9:.3f} GB",
          flush=True)
    with softcap_heads() as capped:
        r, report = graph_vs_eager(args, built, f"{arch}, kernel path, "
                                   "kernel entropy")
    check_finished(arch, r)
    eager_steps = r["chunks_run"] * args.chunk
    if not fused and (len(capped) < eager_steps
                      or not all(c for _, c in capped)):
        fail(f"{arch}: {len(capped)} soft-capped plain heads in the eager "
             f"chunks, expected one a step ({eager_steps})")
    print(report + ("" if fused else f"; the soft-capped plain head ran "
                    f"{len(capped)} times in the eager chunks"), flush=True)
    del built, engine, runner
    gc.collect()
    torch.cuda.empty_cache()

    a_args = serve_args(KERNEL_PATH + ["--entropy", "operand"],
                        arch_flags(arch))
    b_args = serve_args(GATHER_PATH + ["--entropy", "operand"],
                        arch_flags(arch))
    with prefill_routing() if moe else contextlib.nullcontext([]) \
            as routed_a:
        a = serve(a_args, build_engine(a_args, params, cfg=base))
    gc.collect()
    with prefill_routing() if moe else contextlib.nullcontext([]) \
            as routed_b:
        b, report = graph_vs_eager(
            b_args, build_engine(b_args, params, cfg=base),
            f"{arch}, gather path, operand entropy")
    print(report, flush=True)
    check_finished(f"{arch} operand", a, b)
    if moe:
        print(routing_flips(routed_a, routed_b, cfg.num_layers,
                            a_args.prompt_len // a_args.prefill_chunk),
              flush=True)
    print(f"{arch} {compare_plain(a, b)}; peak memory "
          f"{(torch.cuda.max_memory_allocated() - before) / 1e9:.3f} GB",
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_finished(label: str, *runs) -> None:
    """Every request of the runs finished, with finite H / SE / MI and
    MI >= 0."""
    for r in runs:
        for req in r["requests"]:
            u = torch.tensor([req.H, req.SE, req.MI])
            if req.state != "finished" or not torch.isfinite(u).all() \
                    or (u[2] < 0).any():
                fail(f"{label}: request {req.rid} unfinished, non-finite "
                     "or MI < 0")


@contextlib.contextmanager
def prefill_routing():
    """Record the sorted top-k experts of every prompt-sized dispatch
    (16 tokens or more; a decode step routes one token a slot) while the
    block runs, in call order: ``moe_ffn`` looks ``route`` up in its
    module at each call."""
    from repro_torch.models import moe

    calls, inner = [], moe.route

    def recording(bp, cfg, xt, capacity, expert_offsets=None):
        r = inner(bp, cfg, xt, capacity, expert_offsets)
        if xt.shape[0] >= 16:
            calls.append(r["topi"].sort(dim=-1).values)
        return r

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = inner


def routing_flips(chunked: list, batch: list, layers: int,
                  chunks: int) -> str:
    """How often the kernel path's chunked prefill routes a prompt token
    to another expert set than the gather path's batch prefill, by
    layer: the chunked calls run a prompt's chunks one after another,
    each through every layer; the batch calls run a prompt through
    every layer at once."""
    if len(chunked) != len(batch) * chunks:
        fail(f"moe routing: {len(chunked)} chunked and {len(batch)} batch "
             "prefill dispatches recorded")
    flips = torch.zeros(layers)
    tokens = 0
    for p in range(len(batch) // layers):
        for layer in range(layers):
            want = batch[p * layers + layer]
            got = torch.cat([chunked[(p * chunks + c) * layers + layer]
                             for c in range(chunks)])
            flips[layer] += float((got != want).any(-1).sum())
        tokens += want.shape[0]
    share = flips / tokens
    first = int(torch.nonzero(flips).flatten()[0]) if flips.any() else None
    return (f"moe prefill routing, kernel path (chunked) vs gather path "
            f"(batch), operand mode: {int(flips.sum())} of "
            f"{tokens * layers} token-layer expert sets differ "
            f"({float(flips.sum()) / (tokens * layers):.2%}); first layer "
            f"with a flip {first}; share by layer "
            + " ".join(f"{x:.3f}" for x in share.tolist()))


# --------------------------------------------------------------------------
# phase 10: the ssm family at full width
# --------------------------------------------------------------------------

SSM_FLAGS = ["--arch", "mamba2_370m", *SERVE_FLAGS[2:]]
SSM_LONG = 8192
SSM_K, SSM_V = 1024, 50280


def ssm_phase(launches) -> dict:
    """mamba2-370m at full width (d 1024, d_inner 2048, 32 heads of P 64,
    N 128, conv width 4, chunk 256, V 50280; bf16 body, f32 head, random
    weights from the seed), cut in depth to ``SSM_DEPTH`` of its 48 SSD
    blocks, on the serve trace of
    phase 4 with the kernel path's flags and kernel entropy, which fall
    back to the dense layout, the gather read and batch prefill (no KV:
    the cache is each layer's SSM state and conv tail).  One engine, its
    decode chunk one CUDA graph replay, serves the trace SERVE_RUNS times
    (the head launched once a step and nothing else), then once more with
    every chunk held bit for bit against the eager chunk, state included;
    then operand entropy the same way on a second engine; then one request
    of SSM_LONG prompt tokens (SSM_LONG / 256 SSD chunks in one prefill),
    served twice by a third engine, whose decode step is timed beside the
    trace's.  Returns the first run's counts."""
    import gc

    from repro_torch import resolve_device
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import registry as M

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = serve_args(KERNEL_PATH + ["--entropy", "kernel"], SSM_FLAGS)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    base = served_config(args)
    params = M.init_params(base, torch.Generator(
        device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    built = build_engine(args, params, cfg=base)
    engine, cfg = built
    runner = engine.runner
    served = (engine.kv_layout, engine.decode_attn, engine.prefill_mode)
    if served != ("dense", "gather", "batch"):
        fail(f"ssm: the engine serves {served}, expected the dense / "
             "gather / batch fallback")
    if runner.captured != {"uncertainty_head": args.chunk}:
        fail(f"ssm: a replay records {runner.captured}, expected the head "
             f"alone, {args.chunk} launches")
    # a decode step reads every parameter but the embedding table once
    # (the head's mu and sigma in f32) and reads and writes every slot's
    # SSM state and conv tail
    table = params["embed"]["table"]
    body = tree_bytes(params["blocks"]) + tree_bytes(params["final_norm"])
    head = tree_bytes(params["head"])
    state = tree_bytes({k: runner.cache[k] for k in ("ssm", "conv")})
    floor_ms = (body + head + 2 * state) / HBM_BYTES_PER_S * 1e3
    print(f"ssm engine {cfg.name}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, d_inner {cfg.ssm_expand * cfg.d_model}, state "
          f"{cfg.ssm_state}, head dim {cfg.ssm_head_dim}, chunk "
          f"{cfg.ssm_chunk}, V {cfg.vocab_size}; parameters "
          f"{tree_bytes(params) / 1e9:.3f} GB (embedding "
          f"{table.numel() * table.element_size() / 1e9:.3f}), drawn in "
          f"{init_s:.2f}s; served {served}; decode chunk graph warm-up + "
          f"capture {runner.capture_s:.3f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; bytes floor a "
          f"decode step {floor_ms:.4f} ms (body {body / 1e9:.3f} + head "
          f"{head / 1e9:.3f} + 2 x state {state / 1e9:.3f} GB); launches a "
          f"replay {runner.captured}", flush=True)
    counts = serve_runs(args, built, "ssm serve", launches, attention=False)
    print(f"ssm peak memory after the runs "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(graph_vs_eager(args, built, "ssm, kernel entropy")[1], flush=True)
    del built, engine, runner
    gc.collect()

    o_args = serve_args(KERNEL_PATH + ["--entropy", "operand"], SSM_FLAGS)
    print(graph_vs_eager(o_args, build_engine(o_args, params, cfg=base),
                         "ssm, operand entropy")[1], flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    l_args = serve_args(KERNEL_PATH + [
        "--entropy", "kernel", "--num-requests", "1", "--prompt-len",
        str(SSM_LONG), "--long-prompt", str(SSM_LONG)], SSM_FLAGS)
    long_built = build_engine(l_args, params, cfg=base)
    for i in range(2):            # run 1 holds the new graph's first replay
        launches.reset()
        torch.cuda.synchronize()
        r = serve(l_args, long_built)
        check_serve(r, launches.snapshot(), cfg.num_layers, attention=False)
        if len(r["requests"][0].prompt) != SSM_LONG:
            fail("ssm long prompt: the request did not carry the long "
                 "prompt")
        steps = r["spec_decode"]["full_model_calls"]
        print(f"ssm long prompt {SSM_LONG} run {i + 1} "
              f"({SSM_LONG // cfg.ssm_chunk} SSD chunks in one prefill): "
              f"prefill {r['prefill_compile_s']:.3f}s, {steps} decode "
              f"steps at {r['decode_s'] / steps * 1e3:.2f} ms each "
              f"({r['decode_tok_per_s']:.1f} decode tok/s, one live slot "
              f"of {l_args.slots}), peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
    return counts


def check_ssm_head(dev) -> dict:
    """The fused head at mamba2-370m's widths (K 1024, V 50280 = 392 x 128
    + 104: the ragged last tile on a served path), M 4, S 10, against its
    plain version with ``check_head``'s tolerance, in both modes (xi
    operand and Philox), timed against its bytes bound."""
    from repro_torch.kernels import rng
    UH = kernel_module("uncertainty_head")

    S, M = 10, 4
    mu, sigma, g = head_case(dev, 9, SSM_K, SSM_V)
    x = torch.randn((M, SSM_K), generator=g, device=dev).to(torch.bfloat16)
    xi = torch.randn((S, M, SSM_V), generator=g, device=dev)
    worst, plain_ms = 0.0, None
    for mode, kw in (("xi", {"xi": xi}), ("philox", {"seed": 7, "step": 3})):
        got = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, **kw)
        t0 = time.perf_counter()
        want = UH.uncertainty_head_plain(x, mu, sigma, num_samples=S, **kw)
        torch.cuda.synchronize()
        if mode == "philox":
            plain_ms = (time.perf_counter() - t0) * 1e3
        xi_full = xi if mode == "xi" else rng.head_normal(
            7, 3, S, M, torch.arange(SSM_V, device=dev))
        worst = max(worst, compare_heads(f"head at mamba2's widths {mode}",
                                         got, want, x, mu, sigma, xi_full))
    run = lambda: UH.uncertainty_head_cuda(  # noqa: E731
        x, mu, sigma, num_samples=S, seed=7, step=3)
    b_ms, b_by = bound(M * SSM_K * 2 + 2 * SSM_K * SSM_V * 4 + 5 * M * 4,
                       4.0 * M * SSM_K * SSM_V, F32_FLOPS)
    row = {"max_abs_err": worst, "ms": device_ms(run, 10),
           "cold_ms": cold_ms(run), "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None}
    g_ms = gemv_ms(x, mu, sigma)
    print(f"  uncertainty_head at mamba2-370m's widths (K {SSM_K}, V "
          f"{SSM_V}, ragged last tile): ok (max |err| {worst:.3g}), "
          f"{row['ms']:.4f} ms (L2 cold {row['cold_ms']:.4f}), bound "
          f"{b_ms:.6f} ms ({b_by}, {b_ms / row['ms']:.0%} of it), plain "
          f"{plain_ms:.3f} ms, library none; the GEMV pair on the same "
          f"bytes {g_ms:.4f} ms ({b_ms / g_ms:.0%}); "
          f"{plan_text(M, SSM_K, SSM_V, mu, sigma)}", flush=True)
    return row


# --------------------------------------------------------------------------
# phase 11: the hybrid family at full width
# --------------------------------------------------------------------------

HYBRID_FLAGS = ["--arch", "zamba2_7b", *SERVE_FLAGS[2:]]
HYBRID_LONG = 8192
# the profiled serves: their flags, the served attention's head dim and
# its launches a decode step
ENCDEC_FLAGS = ["--arch", "seamless_m4t_medium", *SERVE_FLAGS[2:]]
VLM_FLAGS = ["--arch", "phi_3_vision_4_2b", *SERVE_FLAGS[2:], "--prompt-len",
             str(VLM_PROMPT)]
SERVED = {"serve": (SERVE_FLAGS, 128, 28),
          "moe_serve": (MOE_FLAGS, 128, MOE_DEPTH),
          "ssm_serve": (SSM_FLAGS, 0, 0),
          "hybrid_serve": (HYBRID_FLAGS, ZB_D, -(-HYBRID_DEPTH // 6)),
          "encdec_serve": (ENCDEC_FLAGS, SM_D, ENCDEC_DEPTH),
          "vlm_serve": (VLM_FLAGS, PV_D, VLM_DEPTH),
          # phase 21's archs (D 128 each), profiled by ``python3
          # chip_smoke.py --trace KIND`` or ``profile_serve(KIND)``
          "nemotron_serve": (arch_flags("nemotron_4_15b"), 128,
                             DENSE_ARCH_DEPTH),
          "codeqwen_serve": (arch_flags("codeqwen1_5_7b"), 128,
                             DENSE_ARCH_DEPTH),
          "qwen2_7b_serve": (arch_flags("qwen2_7b"), 128, DENSE_ARCH_DEPTH),
          "grok_serve": (arch_flags("grok_1_314b"), 128, GROK_DEPTH)}


def hybrid_phase(launches) -> dict:
    """zamba2-7b at full width, cut in depth to ``HYBRID_DEPTH`` Mamba2
    blocks (d 3584, d_inner 7168, 112 SSM heads of P 64, N 64, chunk 256;
    one shared attention + MLP block, 32 MHA heads of D 112, ff 14336,
    applied once every 6 blocks; V 32000; bf16 body, f32 head, random
    weights from the seed) on
    the serve trace of phase 4 with the kernel path's flags and kernel
    entropy: paged KV (one pool plane an application behind one table),
    the decode kernel, chunked prefill with the chunk rounded up to
    ssm_chunk (asserted), the prompt's state threaded engine-side.  One
    engine, its decode chunk one CUDA graph replay (the head and 14
    decode launches a step), serves the trace SERVE_RUNS times, then once
    more with every chunk held bit for bit against the eager chunk, state
    and pools included; then operand entropy the same way on a second
    engine; then one request of HYBRID_LONG prompt tokens (32 chunks of
    256), served twice by a third engine, whose decode step is timed
    beside the trace's.  Returns the first run's counts."""
    import gc

    from repro_torch import resolve_device
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import registry as M
    from repro_torch.models.hybrid import n_attn_apps

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = serve_args(KERNEL_PATH + ["--entropy", "kernel"], HYBRID_FLAGS)
    dev = resolve_device(args.device)
    cfg = served_config(args)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    built = build_engine(args, params, cfg=cfg)
    engine, cfg = built
    runner = engine.runner
    A = n_attn_apps(cfg)
    served = (engine.kv_layout, engine.decode_attn, engine.prefill_mode)
    chunk = -(-args.prefill_chunk // cfg.ssm_chunk) * cfg.ssm_chunk
    if served != ("paged", "kernel", "chunked") \
            or engine.prefill_chunk != chunk:
        fail(f"hybrid: the engine serves {served} with prefill chunks of "
             f"{engine.prefill_chunk}, expected paged / kernel / chunked "
             f"with {args.prefill_chunk} rounded up to {chunk}")
    want = {"paged_decode_attention": A * args.chunk,
            "uncertainty_head": args.chunk}
    if runner.captured != want:
        fail(f"hybrid: a replay records {runner.captured}, expected {want}")
    # a decode step reads the Mamba blocks once and the shared block once
    # an application (0.41 GB: it cannot stay in the 50 MB L2), the head
    # (f32) and each slot's K/V at its depth in every plane (the trace's
    # mean depth, prompt + gen / 2), and reads and writes every slot's
    # state and conv tail
    blocks = tree_bytes(params["blocks"]) + tree_bytes(params["final_norm"])
    shared = tree_bytes(params["shared"])
    head = tree_bytes(params["head"])
    state = tree_bytes({k: runner.cache[k] for k in ("ssm", "conv")})
    kv_token = 2 * A * cfg.num_kv_heads * cfg.head_dim \
        * runner.cache["attn_k"].element_size()
    attended = args.slots * (args.prompt_len + args.gen_len / 2) * kv_token
    floor_ms = (blocks + A * shared + head + attended + 2 * state) \
        / HBM_BYTES_PER_S * 1e3
    print(f"hybrid engine {cfg.name}: {cfg.num_layers} Mamba2 layers, d "
          f"{cfg.d_model}, d_inner {cfg.ssm_expand * cfg.d_model}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}; shared block x {A} "
          f"({cfg.num_heads} heads of D {cfg.head_dim}, ff {cfg.d_ff}); V "
          f"{cfg.vocab_size}; parameters {tree_bytes(params) / 1e9:.3f} GB "
          f"(blocks {blocks / 1e9:.3f}, shared {shared / 1e9:.3f}, head "
          f"{head / 1e9:.3f}), drawn in {init_s:.2f}s, peak memory after "
          f"the draw {init_peak / 1e9:.2f} GB; served {served}, prefill "
          f"chunk {engine.prefill_chunk}; decode chunk graph warm-up + "
          f"capture {runner.capture_s:.3f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; bytes floor a "
          f"decode step {floor_ms:.4f} ms (blocks {blocks / 1e9:.3f} + {A} "
          f"x shared {shared / 1e9:.3f} + head {head / 1e9:.3f} + KV "
          f"{attended / 1e9:.3f} + 2 x state {state / 1e9:.3f} GB); "
          f"launches a replay {runner.captured}", flush=True)
    counts = serve_runs(args, built, "hybrid serve", launches)
    print(f"hybrid peak memory after the runs "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(graph_vs_eager(args, built, "hybrid, kernel path, kernel "
                         "entropy")[1], flush=True)
    del built, engine, runner
    gc.collect()

    o_args = serve_args(KERNEL_PATH + ["--entropy", "operand"], HYBRID_FLAGS)
    print(graph_vs_eager(o_args, build_engine(o_args, params, cfg=cfg),
                         "hybrid, kernel path, operand entropy")[1],
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    blocks_needed = -(-(HYBRID_LONG + args.gen_len + args.chunk)
                      // args.kv_block)
    l_args = serve_args(KERNEL_PATH + [
        "--entropy", "kernel", "--num-requests", "1", "--prompt-len",
        str(HYBRID_LONG), "--long-prompt", str(HYBRID_LONG), "--kv-blocks",
        str(blocks_needed + 8)], HYBRID_FLAGS)
    long_built = build_engine(l_args, params, cfg=cfg)
    for i in range(2):            # run 1 holds the new graph's first replay
        launches.reset()
        torch.cuda.synchronize()
        r = serve(l_args, long_built)
        check_serve(r, launches.snapshot(), A)
        chunks = r["prefill_chunks"]
        if len(r["requests"][0].prompt) != HYBRID_LONG \
                or chunks != -(-HYBRID_LONG // chunk):
            fail(f"hybrid long prompt: {chunks} prefill chunks for a "
                 f"prompt of {len(r['requests'][0].prompt)} tokens")
        steps = r["spec_decode"]["full_model_calls"]
        print(f"hybrid long prompt {HYBRID_LONG} run {i + 1} ({chunks} "
              f"chunks of {chunk}, offsets up to "
              f"{(chunks - 1) * chunk}): served in "
              f"{r['total_s']:.3f}s, {steps} decode steps at "
              f"{r['decode_s'] / steps * 1e3:.2f} ms each "
              f"({r['decode_tok_per_s']:.1f} decode tok/s, one live slot "
              f"of {l_args.slots}, depth {HYBRID_LONG} to "
              f"{HYBRID_LONG + args.gen_len}), peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
    return counts


# --------------------------------------------------------------------------
# phase 12: the encdec family at full width
# --------------------------------------------------------------------------

def encdec_phase(launches) -> dict:
    """seamless-m4t-medium at full width (d 1024, 16 MHA heads of D 64, ff
    4096, gelu, V 256206; bf16 body, f32 head, random weights from the
    seed), cut in depth to ``ENCDEC_DEPTH`` encoder and decoder layers of
    its 12 and 12, on the serve trace
    of phase 4 with the kernel path's flags and kernel entropy: paged
    self-attention KV, the decode kernel, chunked prefill of 64 tokens
    whose first chunk runs the encoder on the engine's zero frames and
    writes the slot's cross strips ``ck`` / ``cv``.  One engine, its
    decode chunk one CUDA graph replay (a decode launch a decoder layer
    and the head a step), serves the trace SERVE_RUNS times, then once more with every
    chunk held bit for bit against the eager chunk, the cross strips and
    pools included; then operand entropy on the gather / batch path the
    same way on a second engine; then ``encdec_frames_walk``.  Returns
    the first run's counts."""
    import gc

    from repro_torch import resolve_device
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import registry as M
    from repro_torch.models.encdec import n_dec

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = serve_args(KERNEL_PATH + ["--entropy", "kernel"], ENCDEC_FLAGS)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    base = served_config(args)
    params = M.init_params(base, torch.Generator(
        device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    built = build_engine(args, params, cfg=base)
    engine, cfg = built
    runner = engine.runner
    layers = n_dec(cfg)
    served = (engine.kv_layout, engine.decode_attn, engine.prefill_mode)
    if served != ("paged", "kernel", "chunked") \
            or engine.prefill_chunk != args.prefill_chunk:
        fail(f"encdec: the engine serves {served} with prefill chunks of "
             f"{engine.prefill_chunk}, expected paged / kernel / chunked "
             f"with {args.prefill_chunk}")
    want = {"paged_decode_attention": layers * args.chunk,
            "uncertainty_head": args.chunk}
    if runner.captured != want:
        fail(f"encdec: a replay records {runner.captured}, expected {want}")
    # a decode step reads the decoder's weights but the cross K/V
    # projections (used at the first chunk only), the final norm, the head
    # (f32), every slot's cross strips (ENC_LEN deep, whatever the
    # depth) and each slot's self K/V at its depth (the trace's mean
    # depth, prompt + gen / 2)
    dec = params["decoder"]
    cross_w = tree_bytes({k: dec["cross_attn"][k] for k in ("wk", "wv")})
    decoder = tree_bytes(dec) - cross_w + tree_bytes(params["final_norm"])
    head = tree_bytes(params["head"])
    strips = tree_bytes({k: runner.cache[k] for k in ("ck", "cv")})
    kv_token = 2 * layers * cfg.num_kv_heads * cfg.head_dim \
        * runner.cache["k"].element_size()
    attended = args.slots * (args.prompt_len + args.gen_len / 2) * kv_token
    floor_ms = (decoder + head + strips + attended) / HBM_BYTES_PER_S * 1e3
    print(f"encdec engine {cfg.name}: {cfg.encoder_layers} encoder + "
          f"{layers} decoder layers, d {cfg.d_model}, {cfg.num_heads} heads "
          f"of D {cfg.head_dim}, ff {cfg.d_ff}; V {cfg.vocab_size}; "
          f"parameters {tree_bytes(params) / 1e9:.3f} GB (embedding "
          f"{tree_bytes(params['embed']) / 1e9:.3f}, encoder "
          f"{tree_bytes(params['encoder']) / 1e9:.3f}, decoder "
          f"{tree_bytes(dec) / 1e9:.3f}, head {head / 1e9:.3f}), drawn in "
          f"{init_s:.2f}s, peak memory after the draw "
          f"{init_peak / 1e9:.2f} GB; cross strips {strips / 1e9:.3f} GB at "
          f"{args.slots} slots; served {served}, prefill chunk "
          f"{engine.prefill_chunk}; decode chunk graph warm-up + capture "
          f"{runner.capture_s:.3f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; bytes floor a "
          f"decode step {floor_ms:.4f} ms (decoder {decoder / 1e9:.3f} + "
          f"head {head / 1e9:.3f} + cross strips {strips / 1e9:.3f} + KV "
          f"{attended / 1e9:.3f} GB); launches a replay {runner.captured}",
          flush=True)
    counts = serve_runs(args, built, "encdec serve", launches)
    print(f"encdec peak memory after the runs "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(graph_vs_eager(args, built, "encdec, kernel path, kernel "
                         "entropy")[1], flush=True)
    print(encdec_plain_costs(params, cfg, runner.cache), flush=True)
    del built, engine, runner
    gc.collect()

    o_args = serve_args(GATHER_PATH + ["--entropy", "operand"], ENCDEC_FLAGS)
    print(graph_vs_eager(o_args, build_engine(o_args, params, cfg=base),
                         "encdec, gather path, operand entropy")[1],
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(encdec_frames_walk(params, cfg), flush=True)
    return counts


def encdec_plain_costs(params, cfg, cache) -> str:
    """What the plain attention costs where the encdec family keeps it
    (the reference's jnp ``flash_attention``, no Pallas kernel): the
    cross-attention of one decode step (one query a slot over the engine's
    (B, ENC_LEN) strips, every decoder layer; device time, CUDA graph
    replay) against the bytes of reading the strips once, and one
    request's encoder over ENC_LEN frames (wall time: it runs eagerly at
    the first prefill chunk)."""
    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer

    B = cache["ck"].shape[1]
    layers = E.n_dec(cfg)
    g = torch.Generator(device=cache["ck"].device).manual_seed(26)
    x = torch.randn((B, 1, cfg.d_model), generator=g,
                    device=g.device).to(L.dtype_of(cfg))
    ps = [layer(params["decoder"], i)["cross_attn"] for i in range(layers)]

    def cross():
        for i, p in enumerate(ps):
            L.apply_attention(p, cfg, x, cross_kv=(cache["ck"][i],
                                                   cache["cv"][i]))

    with torch.inference_mode():
        ms = device_ms(cross, 5)
        frames = torch.randn((1, E.ENC_LEN, cfg.d_model), generator=g,
                             device=g.device)
        enc_ms = time_ms(lambda: E.encode(params, cfg, frames), 3)
    strips = tree_bytes({k: cache[k] for k in ("ck", "cv")})
    b_ms = strips / HBM_BYTES_PER_S * 1e3
    return (f"encdec plain attention: the cross-attention of a decode step "
            f"({layers} layers, {B} slots x {E.ENC_LEN} keys, with its q and "
            f"out projections) {ms:.4f} ms of device time against "
            f"{b_ms:.4f} ms to read the strips ({strips / 1e9:.3f} GB) once; "
            f"the encoder over {E.ENC_LEN} frames {enc_ms:.2f} ms (wall, "
            f"eager)")


def bf16_close(name: str, got, want, rel: float = 2e-2) -> str:
    """``got`` finite, with ||got - want|| within ``rel`` of ||want|| (the
    serving kernels' 2e-2, one bf16 ulp of O(1) values, taken over the
    whole tensor: two bf16 paths part by an ulp here and there, and the
    parts grow through the decoder's layers); returns the relative error
    and the max |err|."""
    g, w = got.double(), want.double()
    r = float((g - w).norm() / w.norm())
    if not torch.isfinite(g).all() or not r <= rel:
        fail(f"{name} relative error {r:.3g} > {rel}, or not finite")
    return f"{r:.3g} (max |err| {max_err(got, want):.3g})"


def encdec_frames_walk(params, cfg) -> str:
    """One 256-token prompt with random frames from a seed (the served
    trace feeds zeros, whose encoder output is exactly 0: this is the
    check of the encoder on the card), walked in four 64-token chunks
    through the kernel path (the paged prefill kernel; the first chunk
    runs the encoder and writes ``ck`` / ``cv``) against ``registry.
    prefill`` with the same frames on the gather path: the cross strips
    within one bf16 ulp of ``make_cross_kv(encode(frames))`` and of batch
    prefill's; every layer's self K/V and the hidden state of the first
    decode step (the prompt's last token fed again, as the engine does;
    the kernel read against the gather read) within ``bf16_close``."""
    import dataclasses

    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L
    from repro_torch.models import registry as M

    dev = params["head"]["mu"].device
    P, C, BS = 256, 64, 16
    g = torch.Generator(device=dev).manual_seed(25)
    frames = torch.randn((1, E.ENC_LEN, cfg.d_model), generator=g,
                         device=dev)
    toks = torch.randint(1, cfg.vocab_size - 1, (1, P), generator=g,
                         device=dev)
    kcfg = dataclasses.replace(cfg, decode_attn="kernel")
    gcfg = dataclasses.replace(cfg, decode_attn="gather")
    t0 = time.perf_counter()
    with torch.inference_mode():
        cache = M.make_cache(kcfg, 1, P + BS, device=dev, layout="paged",
                             kv_block=BS)
        MB = cache["block_table"].shape[1]
        perm = torch.randperm(MB, generator=torch.Generator().manual_seed(5))
        cache["block_table"][0].copy_(perm.to(torch.int32))
        for off in range(0, P, C):
            M.prefill_chunk(params, kcfg, toks[:, off:off + C], cache, 0, off,
                            off + C, P, **({"frames": frames} if off == 0
                                           else {}))
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        _, ref = M.prefill(params, gcfg, toks, P + 1, frames)
        enc = E.encode(params, cfg, frames)
        for i in range(E.n_dec(cfg)):
            p = {k: v[i] for k, v in params["decoder"]["cross_attn"].items()}
            k, v = L.make_cross_kv(p, cfg, enc)
            for name, got, want in (("ck", cache["ck"][i], k),
                                    ("cv", cache["cv"][i], v)):
                bf16_check(f"encdec frames walk: {name}[{i}] vs "
                           "make_cross_kv", got, want)
                bf16_check(f"encdec frames walk: {name}[{i}] vs batch "
                           "prefill", got, ref[name][i])
        row = cache["block_table"][:, :P // BS]
        errs = {}
        for n in ("k", "v"):
            walked = torch.stack([L.paged_gather(cache[n][i], row)[0]
                                  for i in range(E.n_dec(cfg))])
            errs[n] = bf16_close(f"encdec frames walk: self {n}", walked,
                                 ref[n][:, 0, :P])
        last = toks[:, -1]
        h_walk, _ = E.decode_hidden(params, kcfg, last, cache)
        h_ref, _ = E.decode_hidden(params, gcfg, last, ref)
        errs["hidden"] = bf16_close(
            "encdec frames walk: first decode step's hidden", h_walk, h_ref)
    gap = max_err(ref["ck"], torch.zeros_like(ref["ck"]))
    return (f"encdec frames walk: one {P}-token prompt, random frames, "
            f"{P // C} chunks of {C} on the kernel path in {walk_s:.3f}s: "
            f"ck / cv within one bf16 ulp of make_cross_kv(encode(frames)) "
            f"and of batch prefill (max |ck| {gap:.3g}); error against batch "
            f"prefill on the gather path, relative: "
            + ", ".join(f"{k} {e}" for k, e in errs.items()))


# --------------------------------------------------------------------------
# phase 13: the vlm family at full width
# --------------------------------------------------------------------------

def vlm_phase(launches) -> dict:
    """phi-3-vision-4.2b at full width (d 3072, 32 MHA heads of D 96, ff
    8192 gated silu, V 32064; bf16 body, f32 head, random weights from the
    seed), cut in depth to ``VLM_DEPTH`` of its 32 layers, on the serve
    trace of phase 4 at prompt
    640 with the kernel path's flags and kernel entropy: paged KV, the
    decode kernel, and batch prefill (the family has no chunked prefill:
    the engine falls back, asserted) of each prompt whose first 576
    positions are the engine's zero prefix embeds.  One engine, its decode
    chunk one CUDA graph replay (a decode launch a layer and the head a
    step),
    serves the trace SERVE_RUNS times, then once more with every chunk
    held bit for bit against the eager chunk, pools included; then
    operand entropy on the gather / batch path the same way on a second
    engine; then ``vlm_prefix_check`` on the first engine's runner.
    Returns the first run's counts."""
    import gc

    from repro_torch import resolve_device
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import registry as M

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = serve_args(KERNEL_PATH + ["--entropy", "kernel"], VLM_FLAGS)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    base = served_config(args)
    params = M.init_params(base, torch.Generator(
        device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    built = build_engine(args, params, cfg=base)
    engine, cfg = built
    runner = engine.runner
    served = (engine.kv_layout, engine.decode_attn, engine.prefill_mode)
    if served != ("paged", "kernel", "batch"):
        fail(f"vlm: the engine serves {served}, expected paged / kernel / "
             "batch (chunked prefill asked for, which vlm does not have)")
    want = {"paged_decode_attention": cfg.num_layers * args.chunk,
            "uncertainty_head": args.chunk}
    if runner.captured != want:
        fail(f"vlm: a replay records {runner.captured}, expected {want}")
    # a decode step reads every layer's weights, the final norm and the
    # head (f32), and each slot's K/V at its depth (the trace's mean
    # depth, prompt + gen / 2); the embedding only a row a slot
    body = tree_bytes(params["blocks"]) + tree_bytes(params["final_norm"])
    head = tree_bytes(params["head"])
    total = tree_bytes(params)
    kv_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim \
        * runner.cache["k"].element_size()
    attended = args.slots * (args.prompt_len + args.gen_len / 2) * kv_token
    floor_ms = (body + head + attended) / HBM_BYTES_PER_S * 1e3
    print(f"vlm engine {cfg.name}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads} heads of D {cfg.head_dim}, ff "
          f"{cfg.d_ff}, {cfg.num_prefix_embeds} prefix embeds; V "
          f"{cfg.vocab_size}; parameters {total / 1e9:.3f} GB (layers "
          f"{tree_bytes(params['blocks']) / 1e9:.3f}, embedding "
          f"{tree_bytes(params['embed']) / 1e9:.3f}, head "
          f"{head / 1e9:.3f}), drawn in {init_s:.2f}s, peak memory after "
          f"the draw {init_peak / 1e9:.2f} GB ({init_peak / total:.2f}x the "
          f"parameters); KV pool {M.kv_bytes(runner.cache) / 1e9:.3f} GB "
          f"({kv_token} bytes a token); served {served}; decode chunk graph "
          f"warm-up + capture {runner.capture_s:.3f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; bytes floor a "
          f"decode step {floor_ms:.4f} ms (layers {body / 1e9:.3f} + head "
          f"{head / 1e9:.3f} + KV {attended / 1e9:.3f} GB); launches a "
          f"replay {runner.captured}", flush=True)
    counts = serve_runs(args, built, "vlm serve", launches)
    print(f"vlm peak memory after the runs "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(graph_vs_eager(args, built, "vlm, kernel path, kernel "
                         "entropy")[1], flush=True)
    print(vlm_prefix_check(engine), flush=True)
    del built, engine, runner
    gc.collect()

    o_args = serve_args(GATHER_PATH + ["--entropy", "operand"], VLM_FLAGS)
    print(graph_vs_eager(o_args, build_engine(o_args, params, cfg=base),
                         "vlm, gather path, operand entropy")[1],
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def vlm_prefix_check(engine) -> str:
    """One 640-token prompt with random prefix embeds from a seed (the
    served trace feeds zeros, whose prefix K/V are exactly 0 in every
    layer: this is the splice's check on the card), admitted through
    ``runner.prefill`` into slot 0 of the engine's paged pool through a
    shuffled block row: the slot's pool rows (through its table) not
    zero under the prefix and bit-equal to the K/V of ``registry.
    prefill`` with the same embeds on the dense layout; the last hidden
    state far from the zero-embeds prefill's.  Then four decode steps
    from that cache, layer by layer: each layer's decode attention read
    through the kernel against the gather read of the same query and
    pool, within ``bf16_close`` (the step goes on from the gather read);
    the fused head's outputs finite.  The two whole decode paths are
    also run side by side and their hidden states' distance reported:
    two bf16 paths part by an ulp here and there and the parts grow
    through the layers (``tools/decode_drift.py`` measures it against
    reads each within a bf16 rounding of an f64 read), so that distance
    is no check of the kernel."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import registry as M
    from repro_torch.models import transformer as T
    from repro_torch.models import uncertain_head as U

    runner, cfg, params = engine.runner, engine.cfg, engine.params
    dev = runner.device
    P, S = cfg.num_prefix_embeds, VLM_PROMPT
    g = torch.Generator(device=dev).manual_seed(26)
    embeds = torch.randn((1, P, cfg.d_model), generator=g, device=dev)
    toks = torch.randint(1, cfg.vocab_size - 1, (1, S), generator=g,
                         device=dev)
    kcfg = dataclasses.replace(cfg, decode_attn="kernel")
    gcfg = dataclasses.replace(cfg, decode_attn="gather")
    with torch.inference_mode():
        _, cache, _, _ = runner.start()
        table = torch.full(tuple(cache["block_table"].shape), -1,
                           dtype=torch.int32)
        table[0] = torch.randperm(
            runner.kv_blocks, generator=torch.Generator().manual_seed(5))[
            :table.shape[1]].to(torch.int32)
        runner.write_table(cache, table.numpy())
        t0 = time.perf_counter()
        runner.prefill(cache, 0, toks[0].cpu().numpy(), table[0].numpy(),
                       embeds)
        runner.sync()
        prefill_s = time.perf_counter() - t0
        h_emb, ref = M.prefill(params, gcfg, toks, S, embeds)
        h_zero, _ = M.prefill(params, gcfg, toks, S, torch.zeros_like(embeds))
        row = cache["block_table"][:1]
        for n in ("k", "v"):
            pooled = torch.stack([L.paged_gather(cache[n][i], row)[0, :S]
                                  for i in range(cfg.num_layers)])
            if not pooled[:, :P].ne(0).any(dim=(1, 2, 3)).all():
                fail(f"vlm prefix: a layer's {n} rows 0-{P - 1} are all 0")
            if not torch.equal(pooled, ref[n][:, 0, :S]):
                fail(f"vlm prefix: the slot's {n} pool rows differ from "
                     f"registry.prefill's (max |err| "
                     f"{max_err(pooled, ref[n][:, 0, :S]):.3g})")
        moved = float((h_emb.double() - h_zero.double()).norm()
                      / h_zero.double().norm())
        if not moved > 0.1:
            fail(f"vlm prefix: random embeds moved the last hidden state by "
                 f"{moved:.3g} of its norm (zero embeds), not > 0.1")

        # the two whole paths side by side, from copies of the cache
        kc = {k: v.clone() for k, v in cache.items()}
        gc_ = {k: v.clone() for k, v in cache.items()}
        tok = torch.full((runner.num_slots,), int(toks[0, -1]),
                         dtype=torch.int32, device=dev)
        apart = []
        for t in range(4):
            hk, _ = T.decode_hidden(params, kcfg, tok, kc)
            hg, _ = T.decode_hidden(params, gcfg, tok, gc_)
            if not torch.isfinite(hk[0]).all():
                fail(f"vlm prefix: decode step {t}'s hidden is not finite")
            apart.append(float((hk[0].double() - hg[0].double()).norm()
                               / hg[0].double().norm()))
            tok[0].fill_(int((hg[0].float() @ params["head"]["mu"]).argmax()))

        # each layer's kernel read against the gather read, same input
        tok.fill_(int(toks[0, -1]))
        worst = 0.0
        for t in range(4):
            lens, tab = cache["len"], cache["block_table"]
            x = L.apply_embed(params["embed"], tok[:, None])
            rot = L.rope_tables(lens.reshape(-1, 1), cfg.head_dim,
                                cfg.rope_theta)
            at = L.paged_index(cache["k"].shape[1], cache["k"].shape[2], tab,
                               lens, 1)
            eff = L.mapped_span(tab, cache["k"].shape[2], lens + 1)
            for i in range(cfg.num_layers):
                bp = T.layer(params["blocks"], i)
                q, k, v = L._qkv(bp["attn"], cfg, L.rms_norm(x, bp["ln1"]),
                                 rot)
                for pool, new in ((cache["k"][i], k), (cache["v"][i], v)):
                    L.paged_scatter(pool, tab, lens, new, at)
                o_k = ops.paged_decode_attention(q, cache["k"][i],
                                                 cache["v"][i], tab, lens + 1)
                o_g = L.decode_attention(q, L.paged_gather(cache["k"][i], tab),
                                         L.paged_gather(cache["v"][i], tab),
                                         eff)
                bf16_close(f"vlm prefix: decode step {t} layer {i}'s "
                           "attention, kernel read vs gather read",
                           o_k[:1], o_g[:1])
                worst = max(worst, float((o_k[0].double() - o_g[0].double())
                                         .norm() / o_g[0].double().norm()))
                x = x + L._mm(o_g.reshape(x.shape[0], 1, -1),
                              bp["attn"]["wo"])
                x = x + L.apply_mlp(bp["mlp"], cfg, L.rms_norm(x, bp["ln2"]))
            x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)[:, 0]
            out = U.head_outputs(params, kcfg, x, lens.clone(), (0, t))
            lens.add_(1)
            if not all(torch.isfinite(out[k][0]) for k in ("H", "SE", "MI",
                                                           "p_max")):
                fail(f"vlm prefix: decode step {t}'s head outputs are not "
                     "finite")
            tok[0].fill_(int(out["next_token"][0]))
    return (f"vlm prefix: one {S}-token prompt with random prefix embeds "
            f"through runner.prefill ({prefill_s * 1e3:.1f} ms) into a "
            f"shuffled block row: pool K/V bit-equal to registry.prefill's, "
            f"rows 0-{P - 1} not zero; last hidden {moved:.3g} of its norm "
            f"from the zero-embeds prefill's; 4 decode steps x "
            f"{cfg.num_layers} layers, kernel read against gather read of "
            f"the same query and pool: worst relative error {worst:.3g} "
            f"(<= 2e-2); head outputs finite; the whole kernel and gather "
            f"paths' hidden states apart by "
            + ", ".join(f"{a:.4f}" for a in apart) + " of the norm")


# --------------------------------------------------------------------------
# phase 14: the prefix cache and speculative decoding (qwen2-1.5B)
# --------------------------------------------------------------------------

SHARED = ["--shared-prefix", "200"]
# the layers phase 14 serves (of qwen2-1.5B's 28): cut for the script's
# time (the widths stay whole)
SPEC_LAYERS = 4
PREFIX_ON = ["--prefix-cache", "on"]
SPEC_FORCED = ["--spec-decode", "on", "--spec-k", "4", "--spec-draft-s", "1",
               "--spec-mi-threshold", "inf"]
SPEC_ADAPTIVE = SPEC_FORCED + ["--spec-k-min", "2", "--spec-k-max", "6"]
# operand noise keys the slot, and speculation moves finish times: a hit
# of the second wave (one prefill chunk) can then finish before a slot of
# the first and change where the last request lands.  The spec runs pin
# the admission schedule: the second wave arrives once the first has
# drained (the idle engine skips ahead to it), four admissions at once
PINNED = ["--arrivals", ",".join(["0"] * 4 + ["1000000"] * 4)]
STREAMS = ("slot", "tokens", "H", "SE", "MI", "p_max", "epistemic_flags",
           "aleatoric_flags")


def phase_serve(args, built, launches, counts: dict) -> tuple[dict, int]:
    """One serve of ``args``' trace by the engine ``built``, the launch
    counts zeroed just before it and read just after (added to
    ``counts``): one decode launch a layer a decode step (a chunk's
    steps, or a speculative round's k draft steps), one prefill launch a
    layer a chunk, one head a step in kernel entropy and none in operand
    entropy (its head is plain PyTorch); every request finished with 32
    finite tokens.  Returns the run and its decode steps."""
    from repro_torch.launch.serve import serve

    engine, cfg = built
    runner = engine.runner
    depths = []
    real = runner.spec_round

    def counted(k, lens0):
        depths.append(k)
        return real(k, lens0)

    runner.spec_round = counted
    launches.reset()
    torch.cuda.synchronize()
    try:
        r = serve(args, built)
    finally:
        del runner.spec_round
    got = launches.snapshot()
    steps = r["chunks_run"] * args.chunk + sum(depths)
    layers = cfg.num_layers
    want = {"paged_decode_attention": layers * steps,
            "paged_prefill_attention": layers * r["prefill_chunks"],
            "uncertainty_head": steps if args.entropy == "kernel" else 0}
    for name, n in want.items():
        if got[name] != n or steps == 0:
            fail(f"prefix/spec serve: {name} launched {got[name]} times, "
                 f"expected {n}")
    for name, n in got.items():
        counts[name] += n
    for req in r["requests"]:
        u = torch.tensor([req.H, req.SE, req.MI])
        if req.state != "finished" or len(req.tokens) != args.gen_len \
                or not torch.isfinite(u).all() or (u[2] < 0).any():
            fail(f"prefix/spec serve: request {req.rid} unfinished or "
                 "non-finite")
    return r, steps


def same_streams(label: str, a: dict, b: dict) -> None:
    """Every request's slot, tokens, H, SE, MI, p_max and flag counts bit
    for bit (the floats compared as stored)."""
    for x, y in zip(a["requests"], b["requests"]):
        for name in STREAMS:
            if getattr(x, name) != getattr(y, name):
                fail(f"{label}: request {x.rid} differs in {name} "
                     f"(slots {x.slot}, {y.slot})")


def spec_graph_vs_eager(args, built) -> str:
    """Every speculative round of a serve that replays a captured graph,
    against the same round run eagerly (``runner.spec_fns``) on a copy of
    the carry it started from: proposals, tokens, H, SE, MI, p_max and
    flags bit for bit, and the carry after (token, depths, the pools
    without the sink block)."""
    from repro_torch.launch.serve import make_requests

    engine, cfg = built
    runner = engine.runner
    real = runner.spec_round
    checked = [0]

    def bits(t):
        return t.contiguous().view(torch.int32) if t.element_size() == 4 \
            else t.contiguous().view(torch.int16)

    def compare(k, lens0):
        if k not in runner.spec_graphs:
            return real(k, lens0)
        tok = runner.tok.clone()
        cache = {n: t.clone() for n, t in runner.cache.items()}
        ys = real(k, lens0).clone()
        hid = torch.empty_like(runner.spec_hid)
        eys = torch.empty_like(runner.spec_ys)
        states = {n: torch.empty_like(t)
                  for n, t in runner.spec_states.items()}
        draft, verify = runner.spec_fns(k)
        draft(runner.params, tok, cache, hid, eys, states)
        verify(runner.params, hid,
               torch.as_tensor(lens0, dtype=torch.int32, device=tok.device),
               eys)
        same = {"outputs": torch.equal(bits(ys), bits(eys[:k])),
                "token": torch.equal(tok, runner.tok),
                "len": torch.equal(cache["len"], runner.cache["len"])}
        for n in ("k", "v"):
            same[n] = torch.equal(bits(cache[n][:, :-1]),
                                  bits(runner.cache[n][:, :-1]))
        if not all(same.values()):
            fail(f"spec graph vs eager: round {checked[0]} (k {k}) differs "
                 f"in {', '.join(n for n, v in same.items() if not v)}")
        checked[0] += 1
        return runner.spec_ys[:k]

    runner.spec_round = compare
    try:
        engine.run(make_requests(args, cfg))
    finally:
        del runner.spec_round
    if checked[0] == 0:
        fail("spec graph vs eager: no replayed round compared")
    return (f"spec graph vs eager: {checked[0]} rounds of depth "
            f"{sorted(runner.spec_graphs)} replayed from their graphs, bit "
            "for bit against the eager rounds (outputs, token, depths, "
            "pools)")


def spec_phase(launches, smi: str) -> dict:
    """Phase 14: qwen2-1.5B at full width, cut in depth to
    ``SPEC_LAYERS`` of its 28 layers, on phase 4's trace with a 200-token
    shared prefix, the kernel path, every engine on one copy of the
    parameters.  (1) Kernel entropy, the prefix cache on: 4 hits, 4
    misses, 800 of 2,048 prompt tokens saved, 4 copy-on-write copies, the
    pool balanced, and the prefill kernel launched at the hits' offset
    200; beside the cache off.  (2) Operand entropy: the streams with the
    cache on and off bit for bit.  (3) Speculative decoding over the
    cache (operand entropy), the second wave arriving once the first has
    drained (``PINNED``): k 4 forced and adaptive k 2-6 against spec off,
    bit for bit.  (4) A replayed spec round against the eager round.
    Returns the launches of the served runs."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch.serve import build_engine

    counts = dict.fromkeys(launches.COUNTS, 0)
    kernel = KERNEL_PATH + SHARED + ["--entropy", "kernel"]
    operand = KERNEL_PATH + SHARED + ["--entropy", "operand"]
    t0 = time.perf_counter()
    args_on = serve_args(kernel + PREFIX_ON)
    cfg = served_config(args_on, num_layers=SPEC_LAYERS)
    built_on = build_engine(args_on, cfg=cfg)
    params = built_on[0].params
    engines = {"on": (args_on, built_on)}
    for key, extra in (("off", kernel), ("op_on", operand + PREFIX_ON),
                       ("op_off", operand),
                       ("forced", operand + PREFIX_ON + SPEC_FORCED),
                       ("adaptive", operand + PREFIX_ON + SPEC_ADAPTIVE)):
        a = serve_args(extra)
        engines[key] = (a, build_engine(a, params, cfg=cfg))
    print(f"prefix/spec: 6 engines on one copy of the parameters built in "
          f"{time.perf_counter() - t0:.1f}s ({smi})", flush=True)

    # (1) kernel entropy, the cache on, the prefill offsets recorded
    offsets = []
    real = PA.paged_prefill_attention_cuda

    def recorded(q, k_pool, v_pool, block_row, offset, span, kv_chunk=1024):
        before = launches.COUNTS["paged_prefill_attention"]
        out = real(q, k_pool, v_pool, block_row, offset, span, kv_chunk)
        offsets.append((int(offset),
                        launches.COUNTS["paged_prefill_attention"] - before))
        return out

    PA.paged_prefill_attention_cuda = recorded
    try:
        r_on, _ = phase_serve(*engines["on"], launches, counts)
    finally:
        PA.paged_prefill_attention_cuda = real
    r_off, _ = phase_serve(*engines["off"], launches, counts)
    pc = r_on["prefix_cache"]
    eng_on = engines["on"][1][0]
    alloc, tree = eng_on._last_alloc, eng_on._last_pcache
    got = (pc["hits"], pc["misses"], pc["prompt_tokens_saved"],
           pc["prompt_tokens"], pc["cow_copies"])
    if got != (4, 4, 800, 2048, 4):
        fail(f"prefix cache: (hits, misses, saved, prompt tokens, copies) "
             f"{got}, expected (4, 4, 800, 2048, 4)")
    if alloc._reserved or alloc.in_use != tree.cached_blocks():
        fail(f"prefix cache: pool unbalanced ({alloc.in_use} in use, "
             f"{tree.cached_blocks()} cached, {alloc._reserved} reserved)")
    at = {}
    for off, n in offsets:
        if n != 1:
            fail(f"prefix cache: a prefill call at offset {off} counted {n}")
        at[off] = at.get(off, 0) + 1
    layers = engines["on"][1][1].num_layers
    if at.get(200) != 4 * layers or r_on["prefill_chunks"] != 20 \
            or r_off["prefill_chunks"] != 32:
        fail(f"prefix cache: prefill launches by offset {at}, chunks "
             f"{r_on['prefill_chunks']} (cache on) / "
             f"{r_off['prefill_chunks']} (off)")
    print(f"prefix cache, kernel entropy ({smi}): {pc['hits']} hits, "
          f"{pc['misses']} misses, {pc['prompt_tokens_saved']} of "
          f"{pc['prompt_tokens']} prompt tokens saved, {pc['cow_copies']} "
          f"CoW copies, {pc['blocks_cached_end']} blocks cached at exit, "
          f"pool balanced; paged_prefill_mma launches by offset {at}",
          flush=True)
    for label, r in (("cache on", r_on), ("cache off", r_off)):
        print(f"  {label}: {r['prefill_chunks']} prefill chunks, e2e "
              f"{r['e2e_tok_per_s']:.1f} tok/s, decode "
              f"{r['decode_tok_per_s']:.1f} tok/s, p99 "
              f"{r['latency_p99_s']:.3f} s, p50 {r['latency_p50_s']:.3f} s, "
              f"total {r['total_s']:.3f} s", flush=True)

    # (2) operand entropy: noise keyed by (slot, depth), streams equal
    r_op_on, _ = phase_serve(*engines["op_on"], launches, counts)
    r_op_off, _ = phase_serve(*engines["op_off"], launches, counts)
    same_streams("prefix cache, operand entropy", r_op_on, r_op_off)
    print(f"prefix cache, operand entropy: cache on = cache off bit for bit "
          f"({r_op_on['gen_tokens']} tokens: tokens, H, SE, MI, p_max, "
          f"flags, slots)", flush=True)

    # (3) speculative decoding over the cache against spec off, the
    # schedule pinned
    base_args = serve_args(operand + PREFIX_ON + PINNED)
    base, steps_off = phase_serve(base_args, engines["op_on"][1], launches,
                                  counts)
    base_ms = base["decode_s"] / steps_off * 1e3
    for key in ("forced", "adaptive"):
        _, built = engines[key]
        args = serve_args(operand + PREFIX_ON + PINNED + (
            SPEC_FORCED if key == "forced" else SPEC_ADAPTIVE))
        r, steps = phase_serve(args, built, launches, counts)
        same_streams(f"spec decode ({key})", r, base)
        if r["prefix_cache"]["hits"] != 4:
            fail(f"spec decode ({key}): {r['prefix_cache']['hits']} hits")
        sd = r["spec_decode"]
        runner = built[0].runner
        print(f"spec decode {key} ({smi}): = spec off bit for bit; "
              f"{sd['rounds']} rounds of k {sd['round_k_min']}-"
              f"{sd['round_k_max']} ({sd['k_up']} grows, {sd['k_down']} "
              f"shrinks), acceptance {sd['acceptance_rate']:.3f} "
              f"({sd['accepted']}/{sd['drafted']}), "
              f"{sd['tokens_per_round']:.2f} tokens a round, "
              f"{sd['rollbacks']} rollbacks, {sd['gated_slot_rounds']} "
              f"gated; full-model calls {sd['full_model_calls']} against "
              f"{base['spec_decode']['full_model_calls']} spec off; "
              f"{steps} decode steps against {steps_off}; graphs "
              f"{ {k: round(v, 3) for k, v in runner.spec_capture_s.items()} }"
              f" s to run + capture; decode "
              f"{r['decode_s'] / steps * 1e3:.2f} ms a step against "
              f"{base_ms:.2f}, {r['decode_tok_per_s']:.1f} tok/s against "
              f"{base['decode_tok_per_s']:.1f}, e2e "
              f"{r['e2e_tok_per_s']:.1f} against "
              f"{base['e2e_tok_per_s']:.1f}", flush=True)

    # (4) a replayed round against the eager round
    print(spec_graph_vs_eager(serve_args(operand + PREFIX_ON + PINNED
                                         + SPEC_FORCED),
                              engines["forced"][1]), flush=True)
    return counts


# --------------------------------------------------------------------------
# phase 15: priority scheduling, preempt-and-restore and the escalation lane
# (qwen2-1.5B)
# --------------------------------------------------------------------------

# the priority burst of benchmarks/bench_serve.py:493-512: 2 slots, chunk
# 8, max_len 80 (= prompt 16 + gen 56 + chunk 8), six class-2 requests
# (16-token prompts, heavy-tailed generations, two bursts) and three
# class-0 requests (8-token prompts, 8 tokens, SLO 0.5 s) arriving mid-burst
BURST_FLAGS = ["--arch", "qwen2_1_5b", "--slots", "2", "--chunk", "8",
               "--prompt-len", "16", "--gen-len", "56", "--kv-layout",
               "paged", "--kv-block", "16", "--prefill-chunk", "64",
               "--seed", "0", "--entropy", "kernel", *KERNEL_PATH]
BURST_LO_GENS = (32, 48, 16, 40, 24, 16)
BURST_LO_ARRIVALS = (0, 0, 0, 0, 16, 16)
BURST_HI_ARRIVALS = (4, 12, 24)
ESCALATE_S = 40
# preempt-and-restore at full width: one slot, a class-2 request (prompt
# 256, gen 32) preempted by a class-0 arrival at step 8 (prompt 64, gen 16)
RESTORE_FLAGS = ["--arch", "qwen2_1_5b", "--slots", "1", "--chunk", "8",
                 "--prompt-len", "256", "--gen-len", "32", "--kv-layout",
                 "paged", "--kv-block", "16", "--prefill-chunk", "64",
                 "--seed", "0", "--entropy", "operand", "--policy",
                 "priority", *KERNEL_PATH]


def burst_requests(vocab: int) -> list:
    from repro_torch.launch.engine import Request

    prompts = np.random.default_rng(7).integers(0, vocab, size=(9, 16)) \
        .astype(np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=gen,
                    priority=2, arrival_step=arr)
            for i, (gen, arr) in enumerate(zip(BURST_LO_GENS,
                                               BURST_LO_ARRIVALS))]
    reqs += [Request(rid=6 + j, prompt=prompts[6 + j, :8], max_new_tokens=8,
                     priority=0, slo_s=0.5, arrival_step=arr)
             for j, arr in enumerate(BURST_HI_ARRIVALS)]
    return reqs


def check_risk_run(label: str, engine, r: dict) -> None:
    """Every request finished at its full length with finite H / SE / MI
    and MI >= 0 (``check_finished``), and the pool back at identity."""
    check_finished(label, r)
    for req in r["requests"]:
        if len(req.tokens) != req.max_new_tokens:
            fail(f"{label}: request {req.rid} gave {len(req.tokens)} of "
                 f"{req.max_new_tokens} tokens")
    alloc = engine._last_alloc
    if alloc.in_use or alloc._reserved \
            or sorted(alloc._free) != list(range(alloc.num_blocks)):
        fail(f"{label}: pool unbalanced ({alloc.in_use} in use, "
             f"{alloc._reserved} reserved)")


def class_line(label: str, r: dict) -> str:
    return f"  {label}: " + "; ".join(
        f"class {cls} latency p50 {c['latency_p50_s']:.3f} p99 "
        f"{c['latency_p99_s']:.3f} s, queue p50 {c['queue_p50_s']:.3f} p99 "
        f"{c['queue_p99_s']:.3f} s, service p50 {c['service_p50_s']:.3f} "
        f"p99 {c['service_p99_s']:.3f} s, {c['preemptions']} preemptions, "
        f"{c['escalations']} escalations"
        for cls, c in sorted(r["per_class"].items()))


def lane_graph_vs_eager(engine, seed: int) -> list:
    """Wrap the escalation lane runner's ``scan``: every chunk the lane
    replays from its graph is held against the eager chunk
    (``steps.build_scan_decode`` at the lane's S) on a copy of the carry
    it started from, bit for bit (outputs, token, depth, flags, the dense
    K/V).  Returns the list the compared chunks are counted in; the
    caller restores the runner with ``del runner.scan``."""
    from repro_torch.core.entropy import KernelEntropy
    from repro_torch.launch import steps as S

    runner = engine.escalation_runner(engine.escalate_s)
    eager = S.build_scan_decode(runner.cfg, entropy=KernelEntropy(seed=seed),
                                chunk=runner.chunk,
                                mi_threshold=runner._mi_threshold,
                                se_threshold=runner._se_threshold)
    graphed = runner.scan
    checked = []

    def bits(t):
        return t.contiguous().view(torch.int32) if t.element_size() == 4 \
            else t.contiguous().view(torch.int16)

    def compare(tok, cache, step0, active, flags):
        copy = [tok.clone(), {k: v.clone() for k, v in cache.items()},
                active.clone(), {k: v.clone() for k, v in flags.items()}]
        out = graphed(tok, cache, step0, active, flags)
        ys = torch.empty_like(runner.ys)
        step = torch.full((1,), step0, dtype=torch.int32, device=tok.device)
        e_tok, e_cache, e_flags, ys = eager(runner.params, *copy[:2], step,
                                            *copy[2:], ys)
        same = {"outputs": torch.equal(bits(out[3]), bits(ys)),
                "token": torch.equal(out[0], e_tok),
                "flags": all(torch.equal(flags[k], e_flags[k])
                             for k in flags)}
        for k in cache:
            same[k] = torch.equal(bits(cache[k]), bits(e_cache[k]))
        if not all(same.values()):
            fail(f"lane graph vs eager: chunk {len(checked)} at step {step0} "
                 f"differs in {', '.join(k for k, v in same.items() if not v)}")
        checked.append(step0)
        return out

    runner.scan = compare
    return checked


def risk_phase(launches, smi: str) -> dict:
    """Phase 15: qwen2-1.5B at full width.  (a) The priority burst on the
    kernel path with kernel entropy, each engine serving it twice and the
    second run measured: fifo, then priority with the escalation lane
    armed at the upper quartile of the fifo run's chunk-end carried MI and
    S 40; the launch counts zeroed just before the measured priority run
    and read just after it.  Gates: every request at its full length,
    preemptions > 0, 1 <= escalations < 9, finite H / SE / MI with MI >=
    0, the pool balanced after each run.  (c) The lane's graphed chunk
    against its eager chunk, in the priority engine's first run.  (b)
    Preempt-and-restore in operand entropy, one slot: the victim's and the
    class-0 stream bit for bit against their solo runs on the same engine,
    the pool at identity.  (d) The fused head at S 40 (M 1 and 4).
    Returns the measured priority run's launches."""
    from repro_torch.launch.engine.mesh_check import lane_threshold
    from repro_torch.launch.serve import build_engine

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    args = serve_args(BURST_FLAGS, [])
    fifo = build_engine(args)
    params = fifo[0].params
    vocab = fifo[1].vocab_size
    print(f"risk: fifo engine built in {time.perf_counter() - t0:.1f}s "
          f"({smi})", flush=True)

    fifo[0].run(burst_requests(vocab))                   # warm-up
    torch.cuda.synchronize()
    r_fifo = fifo[0].run(burst_requests(vocab))
    check_risk_run("fifo burst", fifo[0], r_fifo)
    thr, ends = lane_threshold(r_fifo, args.chunk)
    print(f"risk: escalate-mi {thr:.6g}, the upper quartile of {len(ends)} "
          f"chunk-end carried MIs of the fifo run (range "
          f"{min(ends):.6g}-{max(ends):.6g})", flush=True)

    t0 = time.perf_counter()
    p_args = serve_args(BURST_FLAGS + ["--policy", "priority", "--escalate-mi",
                                       repr(thr), "--escalate-s",
                                       str(ESCALATE_S)], [])
    prio, cfg = build_engine(p_args, params)
    lane_runner = prio.escalation_runner(ESCALATE_S)
    print(f"risk: priority engine built in {time.perf_counter() - t0:.1f}s; "
          f"lane runner (S {lane_runner.cfg.mc_samples}, 1 slot, dense, "
          f"{lane_runner.cfg.decode_attn}) chunk graph warm-up + capture "
          f"{lane_runner.capture_s:.3f}s, launches a replay "
          f"{lane_runner.captured}", flush=True)
    if lane_runner.graph is None:
        fail("risk: the lane runner captured no graph")

    # (c) the warm-up run, every lane chunk against the eager chunk
    checked = lane_graph_vs_eager(prio, args.seed)
    try:
        prio.run(burst_requests(vocab))
    finally:
        del lane_runner.scan
    if not checked:
        fail("lane graph vs eager: no lane chunk ran")
    print(f"lane graph vs eager: {len(checked)} chunks of {args.chunk} steps "
          f"at S {ESCALATE_S} replayed from the lane's graph, bit for bit "
          "against the eager chunks (outputs, token, depth, flags, dense "
          "K/V)", flush=True)

    # (a) the measured priority run, its launches counted
    launches.reset()
    torch.cuda.synchronize()
    r_prio = prio.run(burst_requests(vocab))
    got = launches.snapshot()
    check_risk_run("priority burst", prio, r_prio)
    esc = r_prio["escalation"]
    steps = r_prio["spec_decode"]["full_model_calls"]
    layers = cfg.num_layers
    want = {"paged_decode_attention": layers * steps,
            "paged_prefill_attention": layers * r_prio["prefill_chunks"],
            "uncertainty_head": steps + esc["steps"]}
    for name, n in want.items():
        if got[name] != n or n == 0:
            fail(f"priority burst: {name} launched {got[name]} times, "
                 f"expected {n} (> 0)")
    if r_prio["preemptions"] < 1:
        fail("priority burst: no preemption")
    if not 1 <= esc["escalations"] < 9:
        fail(f"priority burst: {esc['escalations']} escalations, expected "
             "1 to 8")
    hi_f = r_fifo["per_class"][0]["latency_p99_s"]
    hi_p = r_prio["per_class"][0]["latency_p99_s"]
    print(f"priority burst ({smi}): hi_p99_fifo / hi_p99_priority "
          f"{hi_f / hi_p:.3f} ({hi_f:.3f} / {hi_p:.3f} s; the reference's "
          f"bar 2x, a reading here); preemptions {r_prio['preemptions']}; "
          f"escalations {esc['escalations']} by class {esc['by_class']}, "
          f"{esc['tokens']} escalated tokens, lane {esc['steps']} steps in "
          f"{esc['decode_s']:.3f} s ({esc['decode_s'] / esc['steps'] * 1e3:.2f}"
          f" ms a step), lane capture {lane_runner.capture_s:.3f} s; main "
          f"{steps} decode steps, {r_prio['prefill_chunks']} prefill chunks, "
          f"decode {r_prio['decode_s']:.3f} s in all; launches {got}",
          flush=True)
    for label, r in (("fifo", r_fifo), ("priority", r_prio)):
        main_s = r["decode_s"] - r["escalation"]["decode_s"]
        print(class_line(label, r), flush=True)
        print(f"    {label}: e2e {r['e2e_tok_per_s']:.1f} tok/s, decode "
              f"{r['decode_tok_per_s']:.1f} tok/s, {r['chunks_run']} chunks "
              f"({main_s / r['spec_decode']['full_model_calls'] * 1e3:.2f} "
              f"ms a main step), {r['prefill_chunks']} prefill chunks, total "
              f"{r['total_s']:.3f} s", flush=True)

    # (b) preempt-and-restore, operand entropy, bit for bit
    from repro_torch.launch.engine import Request

    r_args = serve_args(RESTORE_FLAGS, [])
    restore, _ = build_engine(r_args, params)
    rng = np.random.default_rng(11)
    lo_p = rng.integers(0, vocab, size=256).astype(np.int32)
    hi_p_ = rng.integers(0, vocab, size=64).astype(np.int32)

    def lo(**kw):
        return Request(rid=0, prompt=lo_p, max_new_tokens=32, **kw)

    def hi(**kw):
        return Request(rid=1, prompt=hi_p_, max_new_tokens=16, **kw)

    solo_lo = restore.run([lo()])["requests"][0]
    solo_hi = restore.run([hi()])["requests"][0]
    both = restore.run([lo(priority=2), hi(priority=0, arrival_step=8)])
    check_risk_run("preempt-and-restore", restore, both)
    v, h = both["requests"]
    if both["preemptions"] != 1 or v.preempt_count != 1 \
            or (v.slot, h.slot) != (0, 0):
        fail(f"preempt-and-restore: {both['preemptions']} preemptions, "
             f"slots {v.slot}, {h.slot}")
    for name, a, b in (("victim", v, solo_lo), ("class 0", h, solo_hi)):
        for key in ("tokens", "H", "SE", "MI", "p_max"):
            if getattr(a, key) != getattr(b, key):
                fail(f"preempt-and-restore: the {name} stream's {key} "
                     "differs from its solo run")
    print(f"preempt-and-restore (operand entropy, 1 slot, kernel decode "
          f"attention): the victim (prompt 256, 32 tokens, preempted at step "
          f"8) and the class-0 stream (prompt 64, 16 tokens) bit for bit "
          f"against their solo runs (tokens, H, SE, MI, p_max); "
          f"{both['prefill_chunks']} prefill chunks (the victim's 4 twice); "
          "pool at identity", flush=True)

    # (d) the fused head at the lane's shape
    check_head(dev, ESCALATE_S, (1, 4))
    return got


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


def bnn_case(dev):
    """The blood-cell BNN from seed 0: (cfg, CPU params, device params,
    800 in-distribution and 800 OOD images on the device)."""
    import numpy as np
    from repro_torch.configs.registry import get_bnn_config
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
    rng = np.random.default_rng(0)
    x_id = torch.from_numpy(blood_cells(rng, 800)[0]).to(dev)
    x_ood = torch.from_numpy(blood_cells_ood(rng, 800)[0]).to(dev)
    return cfg, pc, to(pc, dev), x_id, x_ood


def paper_bnn(dev) -> None:
    from repro_torch.core.uncertainty import auroc, predictive_moments
    from repro_torch.models import bnn_cnn as B

    cfg, pc, params, x_id, x_ood = bnn_case(dev)

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
        tr = traced(f"bnn_{mode}")
        print(f"    traced (a fresh process), 800 images: device busy {tr['busy_ms']:.2f} ms "
              f"of a {tr['window_ms']:.2f} ms window, {tr['kernels']} "
              f"kernels, {tr['syncs']} host syncs; top kernels: "
              f"{top(tr['by_name'], 4)}", flush=True)


# --------------------------------------------------------------------------
# phase 8: the LM-side kernels through the library surface
# --------------------------------------------------------------------------

LM_KERNELS = ("lrt_matmul", "lrt_matmul_sampled", "uncertainty_head_two_pass",
              "flash_attention")


def lm_call(counts: dict, name: str, fn):
    """One call of an entry point of ``repro_torch.kernels``: the launch
    counts are zeroed just before it and read just after; its own kernel
    must have launched, and no other."""
    from repro_torch.kernels import launches

    seen = dict.fromkeys(launches.COUNTS, 0)
    out = on_path(seen, fn)
    others = {k: n for k, n in seen.items() if n and k != name}
    if seen[name] < 1 or others:
        fail(f"lm kernels: {name} launched {seen[name]} times, other kernels "
             f"{others}")
    counts[name] += seen[name]
    return out


def lm_kernels(dev, counts: dict) -> None:
    """The four LM-side entry points at the shapes of phase 3, each call
    counted, checked by the repo's own references and timed (CUDA-graph
    replay): the LRT GEMMs against plain f32 GEMMs and sigma/sqrt(S), the
    two-pass head against the fused head on the same xi, flash attention
    against the models' online-softmax attention in f32."""
    import repro_torch.kernels as K
    from repro_torch.models import layers as L
    UH = kernel_module("uncertainty_head")

    S = 10
    for M, Kd, N, dt in LRT_SHAPES:
        x, mu, sg, g = lrt_case(dev, M, Kd, N, dt, seed=17)
        xi = torch.randn((M, N), generator=g, device=dev)
        mean, std = lrt_moments(x, mu, sg)
        y = lm_call(counts, "lrt_matmul",
                    lambda: K.lrt_matmul(x, mu, sg, xi))
        e = rel_check(f"ops.lrt_matmul M={M}", y, mean + std * xi, tol=1e-5)
        ys = lm_call(counts, "lrt_matmul_sampled",
                     lambda: K.lrt_matmul_sampled(x, mu, sg, 23,
                                                  num_samples=S))
        if ys.shape != (S, M, N):
            fail(f"ops.lrt_matmul_sampled: shape {tuple(ys.shape)}")
        note = moments_check(f"ops.lrt_matmul_sampled M={M}", ys, mean, std,
                             S)
        calls = 10 if M == 128 else 3
        t1 = device_ms(lambda: K.lrt_matmul(x, mu, sg, xi), calls)
        ts = device_ms(lambda: K.lrt_matmul_sampled(x, mu, sg, 23,
                                                    num_samples=S), calls)
        print(f"  ops.lrt_matmul M={M} K={Kd} N={N}: {t1:.4f} ms (max |err| "
              f"vs f32 GEMMs {e:.3g}); ops.lrt_matmul_sampled S={S}: "
              f"{ts:.4f} ms, {note}", flush=True)

    mu, sigma, g = head_case(dev, 18)
    Kd, V = mu.shape
    for M in (4, 16):
        x = torch.randn((M, Kd), generator=g, device=dev).to(torch.bfloat16)
        xi = torch.randn((S, M, V), generator=g, device=dev)
        out = lm_call(counts, "uncertainty_head_two_pass",
                      lambda: K.uncertainty_head(x, mu, sigma, xi))
        fused = UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, xi=xi)
        e = compare_heads(f"ops.uncertainty_head M={M} vs the fused head",
                          out, fused, x, mu, sigma, xi)
        u = torch.stack([out["H"], out["SE"], out["MI"]])
        if not torch.isfinite(u).all() or (out["MI"] < 0).any() or \
                (out["H"] > math.log(V) + 1e-4).any():
            fail(f"ops.uncertainty_head M={M}: H/SE/MI non-finite, MI < 0 "
                 "or H > log V")
        ms = device_ms(lambda: K.uncertainty_head(x, mu, sigma, xi), 5)
        print(f"  ops.uncertainty_head M={M} V={V} S={S}: {ms:.4f} ms, "
              f"agrees with the fused head (max |err| {e:.3g}); mean H "
              f"{float(out['H'].mean()):.4f}, MI "
              f"{float(out['MI'].mean()):.3g}", flush=True)

    for name, B, Sq, Sk, off, causal in FLASH_CASES:
        q, k, v = flash_case(dev, B, Sq, Sk, 19)
        kw = {"causal": causal, "q_offset": off}
        o = lm_call(counts, "flash_attention",
                    lambda: K.flash_attention(q, k, v, **kw))
        if o.shape != q.shape or o.dtype != q.dtype:
            fail(f"ops.flash_attention {name}: {tuple(o.shape)} {o.dtype}")
        want = L.flash_attention(q.float(), k.float(), v.float(), **kw)
        e = bf16_check(f"ops.flash_attention {name} vs the models' attention",
                       o, want)
        calls = 5 if Sq * Sk >= 2 ** 21 else 20
        ms = device_ms(lambda: K.flash_attention(q, k, v, **kw), calls)
        print(f"  ops.flash_attention {name}: {ms:.4f} ms (max |err| vs the "
              f"models' attention {e:.3g})", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on a GPU")
    dev = torch.device("cuda")
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.kernels import build, launches

    if sys.argv[1:2] == ["--trace"]:
        kind = sys.argv[2]
        if kind == "-":
            # started ahead (``start_tracers``): ready the process, then
            # wait for the kind of the trace (none: the script ended)
            import repro_torch.launch.serve  # noqa: F401
            for name in build.SOURCES:
                build.load(name)
            torch.zeros(1, device=dev)
            torch.cuda.synchronize()
            kind = sys.stdin.readline().strip()
            if not kind:
                return
        print(json.dumps(trace_main(kind)), flush=True)
        return

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
        entry, spills = "?", ""
        for line in rep["log"].splitlines():
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                regs = line.split(":", 1)[1].strip()
                print(f"  ptxas {name} {entry}: {regs}; {spills}")

    t0 = time.perf_counter()
    print("kernels vs plain versions:", flush=True)
    seconds = {}

    def timed(check):
        t = time.perf_counter()
        out = check(dev)
        seconds[check.__name__] = round(time.perf_counter() - t, 1)
        return out

    rows = {"uncertainty_head": timed(check_head),
            "paged_decode_attention": timed(check_decode),
            "paged_prefill_attention": timed(check_prefill)}
    rows["photonic_conv"], rows["photonic_conv_sampled"] = \
        timed(check_photonic)
    rows["bayes_matmul"], rows["bayes_matmul_sampled"] = timed(check_bayes)
    rows["lrt_matmul"], rows["lrt_matmul_sampled"] = timed(check_lrt)
    rows["uncertainty_head_two_pass"] = timed(check_two_pass)
    rows["flash_attention"] = timed(check_flash)
    timed(check_moe_shapes)
    print(f"kernels: seconds by check {seconds}", flush=True)
    print(f"phase kernels: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    counts = serve_phase(launches)
    print(f"phase serve: {time.perf_counter() - t0:.1f}s", flush=True)

    # the traces' fresh processes start here, after phases 3 and 4 took
    # their times, and each reaches the card while an earlier phase runs
    start_tracers()

    t0 = time.perf_counter()
    print(check_graph_chunks(KERNEL_PATH + ["--entropy", "kernel"],
                             "kernel path, kernel entropy"), flush=True)
    print(check_graph_chunks(GATHER_PATH + ["--entropy", "operand"],
                             "gather path, operand entropy"), flush=True)
    print(check_widened_table(), flush=True)
    print(f"phase graph vs eager: {time.perf_counter() - t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    print(profile_serve(), flush=True)
    print(f"phase profile: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    a = serve_full(KERNEL_PATH + ["--entropy", "operand"])
    b = serve_full(GATHER_PATH + ["--entropy", "operand"])
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

    t0 = time.perf_counter()
    lm_counts = dict.fromkeys(LM_KERNELS, 0)
    lm_kernels(dev, lm_counts)
    counts.update(lm_counts)
    print(f"lm kernels launches {lm_counts}", flush=True)
    print(f"phase lm kernels: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    moe_counts = serve_arch("deepseek_moe_16b", launches, SERVE_RUNS)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += moe_counts[name]
    print(f"moe launches {moe_counts}", flush=True)
    print(profile_serve("moe_serve"), flush=True)
    print(f"phase moe: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    check_ssm_head(dev)
    ssm_counts = ssm_phase(launches)
    counts["uncertainty_head"] += ssm_counts["uncertainty_head"]
    print(f"ssm launches {ssm_counts}", flush=True)
    print(profile_serve("ssm_serve"), flush=True)
    print(f"phase ssm: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    check_hybrid_shapes(dev)
    hybrid_counts = hybrid_phase(launches)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += hybrid_counts[name]
    print(f"hybrid launches {hybrid_counts}", flush=True)
    print(profile_serve("hybrid_serve"), flush=True)
    print(f"phase hybrid: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    check_encdec_shapes(dev)
    encdec_counts = encdec_phase(launches)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += encdec_counts[name]
    print(f"encdec launches {encdec_counts}", flush=True)
    print(profile_serve("encdec_serve"), flush=True)
    print(f"phase encdec: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    check_vlm_shapes(dev)
    vlm_counts = vlm_phase(launches)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += vlm_counts[name]
    print(f"vlm launches {vlm_counts}", flush=True)
    print(profile_serve("vlm_serve"), flush=True)
    stop_tracers()                      # no trace after phase 13
    print(f"phase vlm: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    spec_counts = spec_phase(launches, smi)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += spec_counts[name]
    print(f"prefix/spec launches {spec_counts}", flush=True)
    print(f"phase prefix/spec: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    risk_counts = risk_phase(launches, smi)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += risk_counts[name]
    print(f"risk launches {risk_counts}", flush=True)
    print(f"phase risk: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tools"))
    import train_phase
    train_counts = train_phase.train_phase(launches, smi)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += train_counts[name]
    print(f"train (serves of the trained states) launches {train_counts}",
          flush=True)
    print(f"phase train: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    import mesh_phase
    torch.cuda.empty_cache()
    mesh_counts = mesh_phase.mesh_phase(smi)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += mesh_counts[name]
    print(f"mesh launches (both ranks) {mesh_counts}", flush=True)
    print(f"phase mesh: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    import train_mesh_phase
    torch.cuda.empty_cache()
    train_mesh_counts, dense_ranks = train_mesh_phase.train_mesh_phase(
        launches, smi)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += train_mesh_counts[name]
    print(f"train mesh launches (the serves of the gathered states, "
          f"phases 18 and 19) {train_mesh_counts}", flush=True)
    print(f"phase train mesh (18 and 19): {time.perf_counter() - t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    import dryrun_phase
    dryrun_phase.dryrun_phase(dense_ranks, smi)
    print(f"phase dry run (20): {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    import arch_phase
    arch_counts = arch_phase.arch_phase(launches)
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "uncertainty_head"):
        counts[name] += arch_counts[name]
    print(f"archs launches {arch_counts}", flush=True)
    print(f"phase archs (21): {time.perf_counter() - t0:.1f}s", flush=True)

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
        "lrt_matmul": ("src/repro_torch/kernels/csrc/bayes_matmul.cu",
                       "src/repro/kernels/bayes_matmul.py:130"),
        "lrt_matmul_sampled": (
            "src/repro_torch/kernels/csrc/bayes_matmul.cu",
            "src/repro/kernels/bayes_matmul.py:283"),
        "uncertainty_head_two_pass": (
            "src/repro_torch/kernels/csrc/uncertainty_head.cu",
            "src/repro/kernels/uncertainty_head.py:120"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:72"),
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
