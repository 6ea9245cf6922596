"""Fault-tolerant training CLI (the port's ``repro.launch.train``).

  * The SVI ELBO train step (the Bayesian head's KL + NLL) built by
    ``launch.steps.build_train_step``: plain PyTorch with autograd,
    deterministic algorithms on CUDA.
  * Atomic async checkpoints every ``--ckpt-every`` steps holding the
    optimizer state AND the data-stream cursor; ``--resume`` finds the
    latest whole step and continues bit-exactly (the step's noise is keyed
    by (seed, step), not carried in generator state).
  * A step-deadline monitor flags steps slower than ``factor`` x the
    trailing median (``StragglerMonitor``).
  * Failure injection (``--fail-at-step``), which tests use to show that
    a mid-run crash resumes losslessly; the checkpoint writer is joined on
    every exit from the step loop, so a crash never leaves a ``.tmp``.

The dense and vlm families train (``registry.TRAIN_FAMILIES``); the
others raise ``NotImplementedError`` (ROADMAP.md item 12b).  The mesh of
the JAX launcher is ROADMAP item 13: the port trains on one device.
``train_bnn`` is the paper BNN's SVI loop (the reference's quickstart
and tests train it the same way).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 6 \\
      --batch 8 --seq 256            # qwen2-1.5B at full width, on a GPU
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.svi import SVIConfig
from repro_torch.data.pipeline import to_device
from repro_torch.data.synthetic import TokenStreamState, token_batch
from repro_torch.launch import steps as S
from repro_torch.models import registry as M
from repro_torch.optim import adamw


class StragglerMonitor:
    """Flags steps slower than ``factor`` x trailing-median step time."""

    def __init__(self, factor: float = 3.0, window: int = 16):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= 4:
            med = statistics.median(self.times[-self.window:])
            slow = dt > self.factor * med
        self.times.append(dt)
        if slow:
            self.flagged += 1
        return slow


def lm_batch(cfg, toks: np.ndarray, device) -> dict:
    """The train batch of ``toks`` (B, S + 1) as the reference CLI
    builds it: inputs, shifted labels, and zero encoder frames (encdec)
    or zero prefix embeds (vlm)."""
    batch = to_device({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                      device)
    B = toks.shape[0]
    if cfg.family == "encdec":
        from repro_torch.models.encdec import ENC_LEN
        batch["frames"] = torch.zeros((B, ENC_LEN, cfg.d_model),
                                      dtype=torch.float32, device=device)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.zeros(
            (B, cfg.num_prefix_embeds, cfg.d_model), dtype=torch.float32,
            device=device)
    return batch


def train(args) -> dict:
    """Run ``args``' training; returns the loss history, the straggler
    count and the final state."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=args.steps // 10,
        moment_dtype=cfg.moment_dtype, compress_topk=args.compress_topk)
    svi = SVIConfig(num_train_examples=max(60_000, args.batch * args.steps),
                    kl_warmup_steps=max(args.steps // 4, 1))
    step_fn = S.build_train_step(cfg, opt_cfg, svi,
                                 micro_batches=args.micro_batches,
                                 seed=args.seed)

    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    stream = TokenStreamState(seed=args.seed, host=0, num_hosts=1)
    start_step = 0
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_train_params(cfg, gen, device)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    if mgr is not None and args.resume:
        step, tree, extra = mgr.restore_latest(state)
        if step is not None:
            state = tree
            start_step = int(extra["step"])
            stream = TokenStreamState(**extra["stream"])
            print(f"resumed from step {start_step}")

    monitor = StragglerMonitor()
    history = []
    # join any in-flight async save on EVERY exit from the step loop
    # (exceptions included): the snapshot must reach its atomic rename
    # before the process acts on the failure, or an immediate resume
    # races the writer thread
    try:
        for i in range(start_step, args.steps):
            toks, stream = token_batch(stream, args.batch, args.seq + 1,
                                       cfg.vocab_size)
            batch = lm_batch(cfg, toks, device)
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            slow = monitor.observe(dt)
            history.append(loss)
            if args.fail_at_step is not None and i == args.fail_at_step:
                raise RuntimeError(f"injected failure at step {i}")
            if mgr is not None and (i + 1) % args.ckpt_every == 0:
                mgr.save_async(i + 1, state,
                               extra={"step": i + 1, "stream": vars(stream)})
            if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {loss:8.4f} "
                      f"nll {float(metrics['nll']):8.4f} "
                      f"kl {float(metrics['kl']):10.1f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"{'STRAGGLER' if slow else ''}")
    finally:
        if mgr is not None:
            mgr.wait()
    if mgr is not None:
        mgr.save_async(args.steps, state,
                       extra={"step": args.steps, "stream": vars(stream)})
        mgr.wait()
    return {"final_loss": history[-1] if history else float("nan"),
            "history": history, "straggler_flags": monitor.flagged,
            "state": state}


def train_bnn(cfg, images: np.ndarray, labels: np.ndarray, *, steps: int,
              lr: float = 3e-3, batch: int = 64, seed: int = 0,
              device="cuda", stream=None) -> tuple[dict, list[float]]:
    """The paper BNN trained by SVI in surrogate mode, as the reference's
    tests and quickstart train it: AdamW (warm-up 10, weight decay 1e-4,
    cosine to ``steps``), KL warm-up over a third of the steps, batches of
    ``batch`` images drawn uniformly from ``images``.  The batches come
    from a numpy generator seeded with ``seed`` and the probabilistic
    block's eps from the step keys (``keys.normal``), unless ``stream`` =
    (indices (steps, batch), eps (steps, *block shape)) gives both, e.g.
    the reference run's own.  Returns (params, the loss history)."""
    from repro_torch.models import bnn_cnn as B

    device = resolve_device(device)
    params = B.init_params(torch.Generator(device=device).manual_seed(seed),
                           cfg)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=10, total_steps=steps,
                                weight_decay=1e-4)
    svi = SVIConfig(num_train_examples=images.shape[0],
                    kl_warmup_steps=steps // 3)
    noise = None
    if stream is not None:
        indices, eps = (torch.as_tensor(np.asarray(a)) for a in stream)

        def noise(key, shape, dev):
            # the step key is (seed, (fold, step), (split, 1, 0), (fold, i))
            return eps[key[1][1]].reshape(shape).to(dev)

    step_fn = S.build_train_step(cfg, opt_cfg, svi, seed=seed,
                                 nll_fn=B.nll_fn(cfg, noise=noise))
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    x = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    y = torch.from_numpy(np.asarray(labels)).long().to(device)
    rng = np.random.default_rng(seed)
    history = []
    for i in range(steps):
        idx = indices[i] if stream is not None else \
            torch.from_numpy(rng.integers(0, x.shape[0], batch))
        idx = idx.long().to(device)
        state, metrics = step_fn(state, {"images": x[idx], "labels": y[idx]})
        history.append(metrics["loss"])
    return state["params"], [float(v) for v in history]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; raises "
                         "without a GPU — 'cpu' runs on the CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--compress-topk", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    return ap


def main():
    out = train(build_parser().parse_args())
    print(f"final loss {out['final_loss']:.4f} "
          f"(stragglers flagged: {out['straggler_flags']})")


if __name__ == "__main__":
    main()
