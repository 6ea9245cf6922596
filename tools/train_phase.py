"""Phase 16 of ``chip_smoke.py``: training on the GPU.

    python3 tools/train_phase.py [--profile]

runs the phase alone in a fresh process (it builds the kernels first,
for the serve of the trained state); ``--profile`` instead times the
full-width step with the deterministic algorithms on and off, in turns,
and prints one step's device time by kernel.  The phase:

  (a) takes six SVI train steps of qwen2-1.5B at full width (28 layers,
      V 151936, bf16 parameters, f32 moments, per-layer remat) at batch
      8 x seq 256 through ``launch.steps.build_train_step``: every loss
      and grad norm finite; ms a step (forward + backward, AdamW apart),
      tokens/s and peak memory;
  (b) serves the trained state through ``registry.serving_params`` on
      the serving engine's kernel path (its launches counted);
  (c) at the reduced config, holds the card's train steps against the
      port's own CPU steps on the same draws (f32), and crashes the train
      CLI at step 6 and resumes it on the card: bit for bit against the
      uncrashed run, no ``.tmp`` left;
  (d) trains the blood-cell BNN 300 steps on the card on the reference
      run's stream (``tools/data/bnn_reference_stream.npz``, written by
      ``tests/_bnn_stream.py``) and checks the paper's three bars in
      machine mode: ID accuracy > 0.5, OOD AUROC of MI > 0.7, rejection
      by MI raising ID accuracy.

Training launches none of the kernel table's kernels; (b) launches the
serving kernels.
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


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _tokens(cfg, step: int, batch: int, seq: int, seed: int = 0):
    from repro_torch.data.synthetic import TokenStreamState, token_batch
    toks, _ = token_batch(TokenStreamState(seed=seed, host=0, num_hosts=1,
                                           step=step), batch, seq + 1,
                          cfg.vocab_size)
    return toks


def _full_state(smi: str):
    """qwen2-1.5B's training state at full width on the card, and its
    train step: (cfg, state, step_fn)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree as T
    from repro_torch.core.svi import SVIConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import registry as M
    from repro_torch.optim import adamw

    dev = torch.device(DEVICE)
    cfg = get_config("qwen2_1_5b")
    _free()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_train_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1,
                                total_steps=FULL_STEPS,
                                moment_dtype=cfg.moment_dtype)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in T.leaves(params))
    held = (torch.cuda.memory_allocated() - base) / 1e9
    print(f"train: qwen2-1.5B full width ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, V {cfg.vocab_size}, {cfg.param_dtype} parameters, "
          f"{cfg.moment_dtype} moments, remat {cfg.remat}): {n_params:,} "
          f"parameters, state {held:.2f} GB ({base / 1e9:.2f} GB held "
          f"before), init "
          f"{time.perf_counter() - t0:.1f}s ({smi})", flush=True)
    svi = SVIConfig(num_train_examples=max(60_000, FULL_BATCH * FULL_STEPS),
                    kl_warmup_steps=max(FULL_STEPS // 4, 1))
    return cfg, state, S.build_train_step(cfg, opt_cfg, svi, seed=0)


def full_width(smi: str) -> dict:
    """(a): six steps of qwen2-1.5B at full width; returns the state."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import lm_batch

    dev = torch.device(DEVICE)
    cfg, state, step_fn = _full_state(smi)

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
    try:
        for i in range(FULL_STEPS):
            batch = lm_batch(cfg, _tokens(cfg, i, FULL_BATCH, FULL_SEQ), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append({k: float(m[k]) for k in
                         ("loss", "nll", "kl", "beta", "accuracy",
                          "grad_norm", "lr")})
    finally:
        S.adamw.apply_updates = orig
    for i, r in enumerate(rows):
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            C.fail(f"train: step {i} loss {r['loss']} grad_norm "
                   f"{r['grad_norm']}")
        print(f"train step {i}: {ms[i]:.1f} ms (AdamW "
              f"{opt_ms[i][0].elapsed_time(opt_ms[i][1]):.1f}), loss "
              f"{r['loss']:.4f} nll {r['nll']:.4f} kl {r['kl']:.4g} beta "
              f"{r['beta']:.2f} acc {r['accuracy']:.4f} grad_norm "
              f"{r['grad_norm']:.4f} lr {r['lr']:.3g}", flush=True)
    steady = sorted(ms[1:])
    opt = sorted(a.elapsed_time(b) for a, b in opt_ms[1:])
    med = steady[len(steady) // 2]
    tokens = FULL_BATCH * FULL_SEQ
    print(f"train qwen2-1.5B full width ({smi}): steps 2-{FULL_STEPS} ms a "
          f"step median {med:.1f} (range {steady[0]:.1f}-{steady[-1]:.1f}), "
          f"AdamW {opt[len(opt) // 2]:.1f} ms of it; "
          f"{tokens / med * 1e3:,.0f} tokens/s at batch {FULL_BATCH} x seq "
          f"{FULL_SEQ}; step 1 {ms[0]:.1f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    return state


def serve_trained(state: dict, launches) -> dict:
    """(b): the trained state served on the kernel path; its launches."""
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import registry as M

    served = M.serving_params(state["params"])
    if served["blocks"]["attn"]["wq"] is not state["params"]["blocks"][
            "attn"]["wq"]:
        C.fail("serve trained: the body was copied")
    args = C.serve_args(C.KERNEL_PATH + ["--entropy", "kernel",
                                         "--num-requests", "4"])
    built = build_engine(args, served)
    launches.reset()
    torch.cuda.synchronize()
    r = serve(args, built)
    got = launches.snapshot()
    C.check_serve(r, got, C.attention_layers(built[1]))
    print(f"serve of the trained state (serving_params, kernel path, "
          f"kernel entropy): {r['gen_tokens']} tokens, decode "
          f"{r['decode_tok_per_s']:.1f} tok/s, launches {got}", flush=True)
    return got


def card_vs_cpu() -> None:
    """(c), first half: three train steps at the reduced config on the
    card and on the CPU from one init, on the same eps (drawn on the CPU
    from the step keys).  The first step's gradients, every leaf, within
    1e-4 of the leaf's largest entry (f32 sums in another order) and the
    three losses within 1e-5 relative.  Parameters are not held after
    AdamW: its first steps move an entry with a near-zero gradient by
    about lr whatever that gradient's last bits are, so they are read
    out, not checked."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core import keys as K
    from repro_torch.core import tree as T
    from repro_torch.core.svi import SVIConfig
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import registry as M
    from repro_torch.optim import adamw

    cfg = reduced(get_config("qwen2_1_5b"))
    init = M.init_train_params(cfg, torch.Generator().manual_seed(3), "cpu")

    def noise(key, shape, dev):
        return K.normal(key, shape, "cpu").to(dev)

    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    svi = SVIConfig(num_train_examples=1000, kl_warmup_steps=2)
    out, orig = {}, S.adamw.apply_updates
    for name in ("cpu", DEVICE):
        dev = torch.device(name)
        params = T.map_tree(lambda t: t.clone().to(dev), init)
        state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
        fn = S.build_train_step(cfg, opt_cfg, svi, seed=0, noise=noise)
        grads = []

        def capture(p, g, st, c):
            if not grads:
                grads.extend(x.detach().cpu().clone() for x in T.leaves(g))
            return orig(p, g, st, c)

        S.adamw.apply_updates = capture
        try:
            losses = []
            for i in range(3):
                state, m = fn(state, lm_batch(cfg, _tokens(cfg, i, 4, 32),
                                              dev))
                losses.append(float(m["loss"]))
        finally:
            S.adamw.apply_updates = orig
        out[name] = (losses, grads, state["params"])
    (lc, gc_, pc), (lg, gg, pg) = out["cpu"], out[DEVICE]
    dl = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    dg = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
             for a, b in zip(gg, gc_))
    dp = max(float((a.cpu() - b).abs().max())
             for a, b in zip(T.leaves(pg), T.leaves(pc)))
    if dl > 1e-5 or dg > 1e-4:
        C.fail(f"train card vs CPU: loss rel {dl:.3g} (1e-5), gradients "
               f"{dg:.3g} of the leaf's largest (1e-4)")
    print(f"train card vs CPU (reduced qwen2, f32, 3 steps, same eps): "
          f"losses {[round(v, 5) for v in lg]}, max relative loss "
          f"difference {dl:.3g} (limit 1e-5), first-step gradients within "
          f"{dg:.3g} of each leaf's largest entry (limit 1e-4); parameters "
          f"after 3 AdamW steps differ by up to {dp:.3g} (lr 3e-3, read "
          f"out)", flush=True)


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


def profile_full(smi: str) -> None:
    """``--profile``: qwen2-1.5B's full-width step after two warm-up
    steps, timed in turns with the deterministic algorithms on (as
    trained) and off (``steps.deterministic`` a no-op), then one step
    under torch.profiler: its device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as S
    from repro_torch.launch.train import lm_batch

    dev = torch.device(DEVICE)
    cfg, state, step_fn = _full_state(smi)
    on = S.deterministic

    def step(i, det=True):
        S.deterministic = on if det else (lambda d: contextlib.nullcontext())
        try:
            batch = lm_batch(cfg, _tokens(cfg, i, FULL_BATCH, FULL_SEQ), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        finally:
            S.deterministic = on

    step(0)
    step(1)
    turns = [(det, step(2 + i, det)) for i, det in
             enumerate((True, False, False, True, True, False))]
    for det in (True, False):
        print(f"train profile ({smi}): deterministic "
              f"{'on ' if det else 'off'}: ms a step "
              f"{[round(ms, 1) for d, ms in turns if d == det]}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = step(8)
    # the kernels' own rows (the operators' rows repeat their time)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"train profile: one step {wall:.1f} ms wall, {busy:.1f} ms of "
          f"device time in {sum(e.count for e in rows)} kernel launches "
          f"(idle {max(0.0, 1 - busy / wall) * 100:.1f}%); top kernels by "
          f"device time:", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:18]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x "
              f"{e.key[:110]}", flush=True)


def train_phase(launches, smi: str) -> dict:
    """Phase 16 (see the module docstring); returns the launches of the
    trained state's serve."""
    state = full_width(smi)
    got = serve_trained(state, launches)
    del state
    _free()
    card_vs_cpu()
    crash_resume()
    bnn_bars(smi)
    return got


def main():
    if not torch.cuda.is_available():
        C.fail("no CUDA device: this script runs on a GPU")
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.kernels import build, launches

    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    if sys.argv[1:] == ["--profile"]:
        profile_full(smi)
    else:
        print(f"train launches {train_phase(launches, smi)}", flush=True)
    print(f"phase train: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
