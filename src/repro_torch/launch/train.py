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
  * The train mesh (``--mesh DxM``): data parallelism, and FSDP where the
    config asks, over ``data``; tensor and sequence parallelism over
    ``model`` (``launch.mesh.train_mesh``, the JAX launcher's rules,
    ``sharding.partition.train_dims``).  ``main`` spawns the D·M ranks
    (gloo on the CPU, or on one shared card; NCCL with a card a rank) or
    joins ``torchrun``'s; without the flag the mesh is the JAX launcher's
    ``make_mesh_for_args``: 2 x 2 with exactly four ranks or cards, else
    none.  Each rank draws the whole state from the seed, keeps its share
    and reads its rows of every global batch; checkpoints hold whole
    leaves and restore under any mesh.  Every LM family trains sharded
    (the moe family Megatron over each expert's ff with one dispatch
    group a data rank, the ssm and hybrid families' Mamba2 blocks
    head-parallel, the encdec family Megatron in both stacks); a width
    the mesh does not divide where the family's forward splits it raises
    NotImplementedError (``registry.check_trains_sharded``).

Every family trains (``registry.TRAIN_FAMILIES``).  ``--full`` trains
at full width; where one card cannot hold a family's whole training
state (bf16 weights and gradients, f32 moments, the f32 head), it is cut
in depth to ``CARD_DEPTH``, and grok-1-314b,
too large for one card at any depth, is refused (NotImplementedError:
it waits for a machine of more cards than the 80 GB one the port is
measured on).
``train_bnn`` is the paper BNN's SVI loop (the reference's quickstart
and tests train it the same way).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 6 \\
      --batch 8 --seq 256            # qwen2-1.5B at full width, on a GPU
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch zamba2_7b --steps 3 --batch 4 --seq 512   # 54 of 81 layers
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --mesh 2x2 --steps 8 --batch 8 --seq 32     # four gloo ranks
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.svi import SVIConfig
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.data.synthetic import TokenStreamState, token_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as S
from repro_torch.models import registry as M
from repro_torch.optim import adamw
from repro_torch.sharding import partition as P


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


# the depth a full-width training state is cut to on one 80 GB card, where
# the whole model does not fit (~12 bytes a bf16 parameter, 16 a head
# one): the deepest whose measured peak leaves >= 10 GB (deepseek-moe-16b)
# or >= 15 GB (zamba2-7b, a multiple of attn_every = 6) free.  A layer
# adds ≈ 8.2 GB to deepseek's peak (0.59B parameters) and a block ≈ 1.1 GB
# to zamba2's (78M); at 6 layers and 48 blocks the peaks read 53.6 and
# 57.4 GB on an H100 80GB HBM3 (tools/train_phase.py)
CARD_DEPTH = {"deepseek_moe_16b": 8, "zamba2_7b": 54}
# one grok-1-314b layer holds 4.9B parameters, ≈ 39 GB of state beside
# ≈ 26 GB of embedding and head
TOO_LARGE = {"grok_1_314b": "its state does not fit one 80 GB card even at "
                            "one layer"}


def train_config(arch: str, reduced_cfg: bool = True):
    """The config ``arch`` trains at: reduced, or at full width, cut in
    depth to ``CARD_DEPTH`` where it has an entry.  Raises
    NotImplementedError for a full-width arch that no depth fits on one
    card: it waits for a machine with more cards."""
    cfg = get_config(arch)
    if reduced_cfg:
        return reduced(cfg)
    if arch in TOO_LARGE:
        raise NotImplementedError(
            f"{arch} does not train at full width: {TOO_LARGE[arch]}; it "
            "waits for a machine with more cards")
    if arch in CARD_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=CARD_DEPTH[arch])
    return cfg


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


def train(args, mesh=None) -> dict:
    """Run ``args``' training, on this rank's share under a train
    ``mesh`` (``launch.mesh.TrainMesh``; rank 0 prints); returns the loss
    history, the straggler count and the final state (the rank's
    share)."""
    cfg = train_config(args.arch, args.reduced)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=args.steps // 10,
        moment_dtype=cfg.moment_dtype, compress_topk=args.compress_topk)
    svi = SVIConfig(num_train_examples=max(60_000, args.batch * args.steps),
                    kl_warmup_steps=max(args.steps // 4, 1))

    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    stream = TokenStreamState(seed=args.seed, host=0, num_hosts=1)
    start_step = 0
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_train_params(cfg, gen, device)
    dims = None
    if mesh is not None:
        # the rank keeps its blocks (the whole leaves are freed here) and
        # its moments are those blocks' (zeros, like the whole moments')
        dims = P.train_dims(cfg, params, mesh.shape)
        params = P.shard_tree(params, dims, mesh)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    sdims = None if mesh is None else P.state_pspecs(dims, state["opt"])
    step_fn = S.build_train_step(cfg, opt_cfg, svi,
                                 micro_batches=args.micro_batches,
                                 seed=args.seed, mesh=mesh, dims=dims)
    if mgr is not None and args.resume:
        step, tree, extra = mgr.restore_latest(state, mesh, sdims)
        if step is not None:
            state = tree
            start_step = int(extra["step"])
            stream = TokenStreamState(**extra["stream"])
            say(f"resumed from step {start_step}")

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
            if mesh is not None:
                toks = shard_batch({"t": toks}, mesh,
                                   args.micro_batches)["t"]
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
                               extra={"step": i + 1, "stream": vars(stream)},
                               mesh=mesh, dims=sdims)
            if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
                say(f"step {i:5d} loss {loss:8.4f} "
                      f"nll {float(metrics['nll']):8.4f} "
                      f"kl {float(metrics['kl']):10.1f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"{'STRAGGLER' if slow else ''}")
    finally:
        if mgr is not None:
            mgr.wait()
    if mgr is not None:
        mgr.save_async(args.steps, state,
                       extra={"step": args.steps, "stream": vars(stream)},
                       mesh=mesh, dims=sdims)
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
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="full width (cut in depth to CARD_DEPTH where one "
                         "card cannot hold the whole model)")
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
    ap.add_argument("--mesh", default=None,
                    help="train mesh DxM (data x model), e.g. 2x2: D·M "
                         "ranks; default 2x2 with exactly four ranks or "
                         "cards, else none ('none' or 1x1: unsharded)")
    return ap


def mesh_shape(args):
    """The (D, M) ``args`` train at, or None: ``--mesh``, else the JAX
    launcher's default (``launch.mesh.default_train_mesh``)."""
    spec = getattr(args, "mesh", None)
    if spec is not None:
        return meshlib.parse_train_mesh(spec)
    return meshlib.default_train_mesh(args.device)


def train_rank(tp, args) -> dict:
    """One rank of a ``--mesh`` run (``launch.mesh.spawn`` runs it):
    ``train`` on this rank's share; the result without the state."""
    out = train(args, meshlib.train_mesh(tp, *mesh_shape(args)))
    out.pop("state")
    return out


def run(args) -> dict:
    """``train(args)``, on the train mesh the arguments name: spawned
    ranks (rank 0's result, without the state), or this process's share
    when it already is a rank (``torchrun``).  An arch that cannot train
    at the arguments' width raises before a rank starts."""
    shape = mesh_shape(args)
    if shape is None:
        return train(args)
    M.check_trains_sharded(train_config(args.arch, args.reduced))
    n = shape[0] * shape[1]
    if meshlib.in_group():
        tp = meshlib.join(n, args.device)
        return train(args, meshlib.train_mesh(tp, *shape))
    resolve_device(args.device)         # no GPU raises before a rank starts
    return meshlib.spawn(n, args.device, train_rank, args)[0]


def main(argv=None):
    out = run(build_parser().parse_args(argv))
    print(f"final loss {out['final_loss']:.4f} "
          f"(stragglers flagged: {out['straggler_flags']})")


if __name__ == "__main__":
    main()
