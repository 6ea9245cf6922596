"""Phase 16 of ``chip_smoke.py``: training on the GPU.

    python3 tools/train_phase.py [--only ARCH ...] [--profile [ARCH]]

runs the phase alone in a fresh process (it builds the kernels first,
for the serves of the trained states); ``--only`` runs the named archs'
full-width runs and card-against-CPU checks alone; ``--profile`` instead
times ARCH's full-width step (qwen2-1.5B's by default) with the
deterministic algorithms on and off, in turns, and prints one step's
device time by kernel.  The phase:

  (a) takes SVI train steps of each family at full width through
      ``launch.steps.build_train_step`` (bf16 parameters, f32 head and
      moments, per-layer remat): qwen2-1.5B (28 layers, V 151936) six at
      batch 8 x seq 256; mamba2-370m whole (48 layers) three at 8 x 512,
      two SSD chunks a row; seamless-m4t-medium whole (12 + 12 layers,
      V 256206) three at 8 x 256 with 1024 random encoder frames a row;
      zamba2-7b cut in depth to 54 of its 81 blocks (9 applications of
      the shared block) three at 4 x 512; deepseek-moe-16b cut in depth
      to 8 of its 28 layers three at 8 x 256 (``train.CARD_DEPTH``: one
      card does not hold either whole training state); every loss and
      grad norm finite; ms a step (forward + backward + AdamW), AdamW's
      share, tokens/s, peak memory and the card's memory left free on
      one line a model;
  (b) serves each of those trained states through
      ``registry.serving_params`` on the serving engine's kernel path,
      built on the trained config (its launches counted and checked);
      then two steps of phi-3-vision-4.2b at full width (32 layers,
      640-token rows whose first 576 are random prefix embeds, batch 8),
      the second timed, for its time and peak memory;
  (c) at the reduced configs of qwen2, deepseek-moe, mamba2, zamba2 and
      seamless, holds the card's train steps against the port's own CPU
      steps on the same draws (f32; for moe the first step's routing
      equal), and crashes the train CLI at step 6 and resumes it on the
      card: bit for bit against the uncrashed run, no ``.tmp`` left;
  (d) trains the blood-cell BNN 300 steps on the card on the reference
      run's stream (``tools/data/bnn_reference_stream.npz``, written by
      ``tests/_bnn_stream.py``) and checks the paper's three bars in
      machine mode: ID accuracy > 0.5, OOD AUROC of MI > 0.7, rejection
      by MI raising ID accuracy.

Training launches none of the kernel table's kernels; (b) launches the
serving kernels.  grok-1-314b does not train on one card at any depth
(``train.TOO_LARGE``): it is held on the CPU only, reduced.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402

STREAM = Path(__file__).resolve().parent / "data" / \
    "bnn_reference_stream.npz"
FULL_STEPS, FULL_BATCH, FULL_SEQ = 6, 8, 256
DEVICE = "cuda"
# the full-width runs (deepseek-moe-16b and zamba2-7b cut in depth to
# ``train.CARD_DEPTH``): arch, batch, seq, steps; each trained state then
# serves, but the vlm run's, which is there for its time and memory
FULL_RUNS = (("qwen2_1_5b", FULL_BATCH, FULL_SEQ, FULL_STEPS),
             ("mamba2_370m", 8, 512, 3),
             ("seamless_m4t_medium", 8, 256, 3),
             ("zamba2_7b", 4, 512, 3),
             ("deepseek_moe_16b", 8, 256, 3))
VLM_RUN = ("phi_3_vision_4_2b", 8, 640, 2)
# the reduced archs held card against CPU
CARD_VS_CPU = ("qwen2_1_5b", "deepseek_moe_16b", "mamba2_370m", "zamba2_7b",
               "seamless_m4t_medium")


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _tokens(cfg, step: int, batch: int, seq: int, seed: int = 0):
    from repro_torch.data.synthetic import TokenStreamState, token_batch
    toks, _ = token_batch(TokenStreamState(seed=seed, host=0, num_hosts=1,
                                           step=step), batch, seq + 1,
                          cfg.vocab_size)
    return toks


def _batch(cfg, step: int, batch: int, seq: int, dev) -> dict:
    """The CLI's train batch (``train.lm_batch``) with its modality input
    random, from a seeded generator on ``dev``, where it has one: zero
    frames would make the encoder's output 0, zero embeds the prefix K/V."""
    from repro_torch.launch.train import lm_batch

    out = lm_batch(cfg, _tokens(cfg, step, batch, seq), dev)
    gen = torch.Generator(device=dev).manual_seed(1000 + step)
    for name in ("frames", "prefix_embeds"):
        if name in out:
            out[name] = torch.randn(out[name].shape, generator=gen,
                                    device=dev)
    return out


def _depth(cfg, arch: str) -> str:
    """``cfg``'s depth beside the whole model's, and the cut's reason."""
    from repro_torch.configs.registry import get_config

    full = get_config(arch).num_layers
    if cfg.family == "encdec":
        return f"{cfg.encoder_layers} + {cfg.decoder_layers} layers"
    if cfg.num_layers == full:
        return f"{cfg.num_layers} layers"
    return (f"{cfg.num_layers} of {full} layers, cut in depth: the whole "
            f"training state does not fit one card")


def _full_state(smi: str, arch: str = "qwen2_1_5b", steps: int = FULL_STEPS,
                batch: int = FULL_BATCH):
    """``arch``'s training state at full width on the card (cut in depth
    where ``train.train_config`` cuts it), and its train step: (cfg,
    state, step_fn)."""
    from repro_torch.core import tree as T
    from repro_torch.core.svi import SVIConfig
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import train_config
    from repro_torch.models import registry as M
    from repro_torch.optim import adamw

    dev = torch.device(DEVICE)
    cfg = train_config(arch, reduced_cfg=False)
    _free()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_train_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=steps,
                                moment_dtype=cfg.moment_dtype)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in T.leaves(params))
    held = (torch.cuda.memory_allocated() - base) / 1e9
    print(f"train: {cfg.name} full width ({_depth(cfg, arch)}, "
          f"d {cfg.d_model}, V {cfg.vocab_size}, {cfg.param_dtype} "
          f"parameters, {cfg.moment_dtype} moments, remat {cfg.remat}): "
          f"{n_params:,} parameters, state {held:.2f} GB ({base / 1e9:.2f} "
          f"GB held before), init {time.perf_counter() - t0:.1f}s ({smi})",
          flush=True)
    svi = SVIConfig(num_train_examples=max(60_000, batch * steps),
                    kl_warmup_steps=max(steps // 4, 1))
    return cfg, state, S.build_train_step(cfg, opt_cfg, svi, seed=0)


def full_width(smi: str, arch: str = "qwen2_1_5b", batch: int = FULL_BATCH,
               seq: int = FULL_SEQ, steps: int = FULL_STEPS):
    """Train steps of ``arch`` at full width: every loss and grad norm
    finite; ms a step (median of the steps after the first), tokens/s,
    AdamW's ms and peak memory on one line.  Returns (cfg, state)."""
    from repro_torch.launch import steps as S

    dev = torch.device(DEVICE)
    cfg, state, step_fn = _full_state(smi, arch, steps, batch)

    # AdamW's own time, on CUDA events around the update
    opt_ms = []
    orig = S.adamw.apply_updates

    def timed(p, g, s, c):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(p, g, s, c)
        b.record()
        opt_ms.append((a, b))
        return out

    S.adamw.apply_updates = timed
    ms, rows = [], []
    names = ["loss", "nll", "kl", "beta", "accuracy", "grad_norm", "lr"]
    if cfg.family == "moe":
        names.append("aux_loss")
    try:
        for i in range(steps):
            b = _batch(cfg, i, batch, seq, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append({k: float(m[k]) for k in names})
    finally:
        S.adamw.apply_updates = orig
    for i, r in enumerate(rows):
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            C.fail(f"train {cfg.name}: step {i} loss {r['loss']} grad_norm "
                   f"{r['grad_norm']}")
        aux = f" aux_loss {r['aux_loss']:.4f}" if "aux_loss" in r else ""
        print(f"train {cfg.name} step {i}: {ms[i]:.1f} ms (AdamW "
              f"{opt_ms[i][0].elapsed_time(opt_ms[i][1]):.1f}), loss "
              f"{r['loss']:.4f} nll {r['nll']:.4f} kl {r['kl']:.4g} beta "
              f"{r['beta']:.2f} acc {r['accuracy']:.4f} grad_norm "
              f"{r['grad_norm']:.4f} lr {r['lr']:.3g}{aux}", flush=True)
    steady = sorted(ms[1:])
    opt = sorted(a.elapsed_time(b) for a, b in opt_ms[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9
    med = steady[len(steady) // 2]
    tokens = batch * seq
    print(f"train {cfg.name} full width, {_depth(cfg, arch)}, batch {batch} "
          f"x seq {seq} ({smi}): steps 2-{steps} ms a step median "
          f"{med:.1f} (range {steady[0]:.1f}-{steady[-1]:.1f}), AdamW "
          f"{opt[len(opt) // 2]:.1f} ms of it; {tokens / med * 1e3:,.0f} "
          f"tokens/s; step 1 {ms[0]:.1f} ms; peak memory {peak:.2f} GB "
          f"(torch.cuda.max_memory_allocated), {total - peak:.2f} of the "
          f"card's {total:.2f} GB left free", flush=True)
    return cfg, state


def serve_trained(arch: str, cfg, state: dict, launches) -> dict:
    """The trained state served through ``registry.serving_params`` on the
    serving engine's kernel path (kernel entropy, 4 requests of phase 4's
    trace; the engine built on the trained config, depth cut included);
    the launches counted around the run and checked as phase 4 checks
    them.  Returns the counts."""
    from repro_torch.core import tree as T
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import registry as M

    served = M.serving_params(state["params"])
    body = [k for k in state["params"] if k != "head"]
    if not all(a is b for k in body for a, b in zip(
            T.leaves(served[k]), T.leaves(state["params"][k]))):
        C.fail(f"serve trained {cfg.name}: the body was copied")
    args = C.serve_args(C.KERNEL_PATH + ["--entropy", "kernel",
                                         "--num-requests", "4"],
                        ["--arch", arch, *C.SERVE_FLAGS[2:]])
    built = build_engine(args, served, cfg=cfg)
    launches.reset()
    torch.cuda.synchronize()
    r = serve(args, built)
    got = launches.snapshot()
    C.check_serve(r, got, C.attention_layers(built[1]),
                  attention=cfg.family != "ssm")
    print(f"serve of the trained {cfg.name} state (serving_params, "
          f"{_depth(cfg, arch)}, kernel path, kernel entropy): "
          f"{r['gen_tokens']} tokens, decode {r['decode_tok_per_s']:.1f} "
          f"tok/s, launches {got}", flush=True)
    return got


def card_vs_cpu(arch: str = "qwen2_1_5b") -> None:
    """(c), first half: three train steps of the reduced ``arch`` on the
    card and on the CPU from one init, on the same eps (drawn on the CPU
    from the step keys) and the same batches (random encdec frames).  The
    first step's gradients, every leaf, within 1e-4 of the leaf's largest
    entry (f32 sums in another order) and the three losses within 1e-5
    relative; for moe the first step's routing (experts and keep mask of
    every layer) equal first, as a route that flips is a discrete change.
    Parameters are not held after AdamW: its first steps move an entry
    with a near-zero gradient by about lr whatever that gradient's last
    bits are, so they are read out, not checked."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core import keys as K
    from repro_torch.core import tree as T
    from repro_torch.core.svi import SVIConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import moe
    from repro_torch.models import registry as M
    from repro_torch.optim import adamw

    cfg = reduced(get_config(arch))
    seq = 32 if cfg.family in ("dense", "vlm") else 40
    init = M.init_train_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batches = [_batch(cfg, i, 4, seq, "cpu") for i in range(3)]

    def noise(key, shape, dev):
        return K.normal(key, shape, "cpu").to(dev)

    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    svi = SVIConfig(num_train_examples=1000, kl_warmup_steps=2)
    out, orig, route = {}, S.adamw.apply_updates, moe.route
    for name in ("cpu", DEVICE):
        dev = torch.device(name)
        params = T.map_tree(lambda t: t.clone().to(dev), init)
        state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
        fn = S.build_train_step(cfg, opt_cfg, svi, seed=0, noise=noise)
        grads, routes = [], []

        def capture(p, g, st, c):
            if not grads:
                grads.extend(x.detach().cpu().clone() for x in T.leaves(g))
            return orig(p, g, st, c)

        def recording(*a, **kw):
            r = route(*a, **kw)
            if not grads:
                routes.append((r["topi"].cpu(), r["keep"].cpu()))
            return r

        S.adamw.apply_updates, moe.route = capture, recording
        try:
            losses = []
            for i in range(3):
                state, m = fn(state, {k: v.to(dev)
                                      for k, v in batches[i].items()})
                losses.append(float(m["loss"]))
        finally:
            S.adamw.apply_updates, moe.route = orig, route
        out[name] = (losses, grads, state["params"], routes)
    (lc, gc_, pc, rc), (lg, gg, pg, rg) = out["cpu"], out[DEVICE]
    flips = sum(int((a[0] != b[0]).sum() + (a[1] != b[1]).sum())
                for a, b in zip(rg, rc))
    if len(rg) != len(rc) or flips:
        C.fail(f"train card vs CPU ({arch}): the first step's routing "
               f"differs ({flips} experts or keep entries of "
               f"{len(rc)} layers)")
    dl = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    dg = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
             for a, b in zip(gg, gc_))
    dp = max(float((a.cpu() - b).abs().max())
             for a, b in zip(T.leaves(pg), T.leaves(pc)))
    if dl > 1e-5 or dg > 1e-4:
        C.fail(f"train card vs CPU ({arch}): loss rel {dl:.3g} (1e-5), "
               f"gradients {dg:.3g} of the leaf's largest (1e-4)")
    routed = f", routing of {len(rc)} layers equal" if rc else ""
    print(f"train card vs CPU (reduced {arch}, f32, 3 steps of 4 x {seq}, "
          f"same eps{routed}): losses {[round(v, 5) for v in lg]}, max "
          f"relative loss difference {dl:.3g} (limit 1e-5), first-step "
          f"gradients within {dg:.3g} of each leaf's largest entry (limit "
          f"1e-4); parameters after 3 AdamW steps differ by up to "
          f"{dp:.3g} (lr 3e-3, read out)", flush=True)


def crash_resume() -> None:
    """(c), second half: the train CLI on the card (reduced), ten steps
    straight against a crash at step 6 resumed from the step-4
    checkpoint: losses and final state bit for bit, no ``.tmp``."""
    from repro_torch.core import tree as T
    from repro_torch.launch import train as TT

    def args(**kw):
        base = dict(arch="qwen2_1_5b", reduced=True, device=DEVICE,
                    steps=10, batch=2, seq=16, lr=1e-3, micro_batches=1,
                    compress_topk=0.0, seed=0, ckpt_dir=None, ckpt_every=4,
                    resume=False, fail_at_step=None)
        base.update(kw)
        return argparse.Namespace(**base)

    log = io.StringIO()           # the CLI's step lines
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(log):
        ref = TT.train(args(ckpt_dir=f"{d}/a"))
        try:
            TT.train(args(ckpt_dir=f"{d}/b", fail_at_step=6))
            C.fail("train CLI: the injected failure did not raise")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        out = TT.train(args(ckpt_dir=f"{d}/b", resume=True))
        left = [p.name for p in Path(d, "b").iterdir()
                if p.name.endswith(".tmp")]
    same = out["history"] == ref["history"][4:] and all(
        torch.equal(a, b) for a, b in zip(T.leaves(ref["state"]),
                                          T.leaves(out["state"])))
    if not same or left:
        fail_at = [i for i, (a, b) in enumerate(zip(ref["history"][4:],
                                                    out["history"]))
                   if a != b]
        C.fail(f"train CLI crash/resume on the card: not bit-exact (steps "
               f"{fail_at} differ) or .tmp left {left}")
    if "resumed from step 4" not in log.getvalue():
        C.fail("train CLI: the resumed run did not start from step 4")
    print(f"train CLI crash at step 6 + resume on the card (reduced, "
          f"deterministic algorithms): steps 4-9 losses and the final state "
          f"(parameters, moments, step) bit for bit against the uncrashed "
          f"run; no .tmp", flush=True)


def bnn_bars(smi: str) -> None:
    """(d): the BNN trained 300 steps on the card; the three bars."""
    from repro_torch.core import uncertainty as U
    from repro_torch.data import synthetic as TD
    from repro_torch.launch.train import train_bnn
    from repro_torch.models import bnn_cnn as TB

    dev = torch.device(DEVICE)
    cfg = TB.BNNConfig(num_classes=7, in_channels=3, width=16,
                       mc_samples=10)
    xtr, ytr = TD.blood_cells(np.random.default_rng(0), 3000)
    with np.load(STREAM) as f:
        stream = (f["indices"], f["eps"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = train_bnn(cfg, xtr, ytr, steps=300, device=dev,
                             stream=stream)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    def moments(x, seed):
        probs = TB.mc_predict(params, cfg, torch.from_numpy(x).to(dev),
                              torch.Generator(device=dev).manual_seed(seed),
                              mode="machine")
        return U.predictive_moments(probs)

    xte, yte = TD.blood_cells(np.random.default_rng(1), 300)
    m = moments(xte, 5)
    acc = float((m["p_mean"].argmax(-1).cpu() == torch.from_numpy(yte)
                 .long()).float().mean())
    rng = np.random.default_rng(2)
    xid, _ = TD.blood_cells(rng, 250)
    xood, _ = TD.blood_cells_ood(rng, 250)
    mi_id, mi_ood = moments(xid, 6)["MI"], moments(xood, 6)["MI"]
    auroc = float(U.auroc(mi_ood, mi_id))
    xr, yr = TD.blood_cells(np.random.default_rng(3), 400)
    mr = moments(xr, 7)
    y = torch.from_numpy(yr).long().to(dev)
    t, _ = U.best_rejection_threshold(mr["MI"], mr["p_mean"], y)
    rej = U.rejection_accuracy(mr["p_mean"], mr["MI"], y, t)
    acc_all = float(rej["accuracy_all"])
    acc_acc = float(rej["accuracy_accepted"])
    print(f"train BNN on the card ({smi}): 300 SVI steps of 64 images on "
          f"the reference run's stream in {train_s:.1f}s "
          f"({train_s / 300 * 1e3:.1f} ms a step), loss {hist[0]:.4f} -> "
          f"{hist[-1]:.4f}; machine mode: ID accuracy {acc:.4f} (> 0.5), "
          f"OOD AUROC of MI {auroc:.4f} (> 0.7; MI mean ID "
          f"{float(mi_id.mean()):.3g}, OOD {float(mi_ood.mean()):.3g}), "
          f"rejection accuracy {acc_all:.4f} -> {acc_acc:.4f} at MI <= "
          f"{t:.3g} (rejecting {float(rej['rejection_rate']):.3f})",
          flush=True)
    if not np.isfinite(hist).all() or acc <= 0.5 or auroc <= 0.7 \
            or acc_acc < acc_all:
        C.fail("train BNN on the card: a paper bar failed")


def profile_full(smi: str, arch: str = "qwen2_1_5b") -> None:
    """``--profile [arch]``: ``arch``'s full-width step at its phase shape
    (qwen2-1.5B's by default) after two warm-up steps, timed in turns with
    the deterministic algorithms on (as trained) and off
    (``steps.deterministic`` a no-op), then one step under torch.profiler:
    its device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as S

    batch, seq = {r[0]: r[1:3] for r in FULL_RUNS + (VLM_RUN,)}[arch]
    dev = torch.device(DEVICE)
    cfg, state, step_fn = _full_state(smi, arch, 9, batch)
    on = S.deterministic

    def step(i, det=True):
        S.deterministic = on if det else (lambda d: contextlib.nullcontext())
        try:
            b = _batch(cfg, i, batch, seq, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        finally:
            S.deterministic = on

    step(0)
    step(1)
    turns = [(det, step(2 + i, det)) for i, det in
             enumerate((True, False, False, True, True, False))]
    for det in (True, False):
        print(f"train profile {cfg.name} batch {batch} x seq {seq} ({smi}): "
              f"deterministic {'on ' if det else 'off'}: ms a step "
              f"{[round(ms, 1) for d, ms in turns if d == det]}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = step(8)
    # the kernels' own rows (the operators' rows repeat their time)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"train profile {cfg.name}: one step {wall:.1f} ms wall, "
          f"{busy:.1f} ms of device time in {sum(e.count for e in rows)} "
          f"kernel launches (idle {max(0.0, 1 - busy / wall) * 100:.1f}%); "
          f"top kernels by device time:", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:18]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x "
              f"{e.key[:110]}", flush=True)


SERVING = ("paged_decode_attention", "paged_prefill_attention",
           "uncertainty_head")


def train_phase(launches, smi: str, only=()) -> dict:
    """Phase 16 (see the module docstring); ``only``: the archs to run
    (their full-width runs and card-against-CPU checks; no crash / resume
    and no BNN), all by default.  Returns the serving kernels' launches
    in the serves of the trained states, summed."""
    counts = dict.fromkeys(SERVING, 0)
    for arch, batch, seq, steps in FULL_RUNS:
        if only and arch not in only:
            continue
        cfg, state = full_width(smi, arch, batch, seq, steps)
        del state["opt"]                  # the serve needs the params only
        _free()
        got = serve_trained(arch, cfg, state, launches)
        for name in SERVING:
            counts[name] += got[name]
        del state
        _free()
    if not only or VLM_RUN[0] in only:
        full_width(smi, *VLM_RUN)
        _free()
    for arch in CARD_VS_CPU:
        if not only or arch in only:
            card_vs_cpu(arch)
    if not only:
        crash_resume()
        bnn_bars(smi)
    return counts


def main():
    if not torch.cuda.is_available():
        C.fail("no CUDA device: this script runs on a GPU")
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.kernels import build, launches

    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", nargs="?", const="qwen2_1_5b", default=None,
                    metavar="ARCH", help="profile ARCH's full-width step")
    ap.add_argument("--only", nargs="+", default=(), metavar="ARCH",
                    help="run only these archs' training checks")
    args = ap.parse_args()
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    if args.profile:
        profile_full(smi, args.profile)
    else:
        print(f"train launches {train_phase(launches, smi, args.only)}",
              flush=True)
    print(f"phase train: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
