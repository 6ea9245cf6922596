"""What the train-mesh tests run inside the spawned ranks.

``launch.mesh.Ranks.run`` pickles a function by its import path, so the
functions a rank runs live here, in a module the ranks can import.  It
imports torch and the port only: a rank loads no JAX.  The helpers that
draw the state and the batches are shared with the test process, which
runs the unsharded reference on the same draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core.svi import SVIConfig
from repro_torch.data.pipeline import make_batch, shard_batch, to_device
from repro_torch.data.synthetic import TokenStreamState
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as S
from repro_torch.models import registry as M
from repro_torch.optim import adamw
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as P

BATCH, SEQ = 4, 16
# encoder frames a row of the encdec batches (random, so that the encoder's
# output is not 0; fewer than the served ENC_LEN to keep the CPU runs short)
FRAMES = 32
OPT = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
SVI = SVIConfig(num_train_examples=1000, kl_warmup_steps=2)


def config(arch: str, fsdp=None, **changes):
    """The reduced ``arch``, with ``fsdp_params`` set where given and any
    other field of ``changes`` (e.g. ``vocab_size``)."""
    cfg = reduced(get_config(arch))
    if fsdp is not None:
        changes["fsdp_params"] = fsdp
    return dataclasses.replace(cfg, **changes) if changes else cfg


def whole_state(cfg, seed: int = 3, device="cpu", opt=OPT) -> dict:
    params = M.init_train_params(cfg, torch.Generator().manual_seed(seed),
                                 "cpu")
    params = T.map_tree(lambda t: t.to(device), params)
    return {"params": params, "opt": adamw.init_state(params, opt)}


def batches(cfg, n: int) -> list[dict]:
    """``n`` global host batches of the token stream (vlm: its random
    prefix embeds, ``make_batch``; encdec: ``FRAMES`` N(0, 1) frames a
    row, seeded by the step)."""
    out = []
    for i in range(n):
        b = make_batch(cfg, TokenStreamState(seed=0, host=0, num_hosts=1,
                                             step=i), BATCH, SEQ)[0]
        if cfg.family == "encdec":
            b["frames"] = np.random.default_rng(i).standard_normal(
                (BATCH, FRAMES, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


class Recorder:
    """Wraps ``steps.adamw.apply_updates`` to keep each step's gradients
    (host copies, as the step hands them to AdamW)."""

    def __enter__(self):
        self.grads = []
        self._orig = S.adamw.apply_updates

        def rec(p, g, st, c, **kw):
            self.grads.append([x.detach().cpu().clone()
                               for x in T.leaves(g)])
            return self._orig(p, g, st, c, **kw)

        S.adamw.apply_updates = rec
        return self

    def __exit__(self, *exc):
        S.adamw.apply_updates = self._orig


METRICS = ("loss", "nll", "kl", "beta", "accuracy", "grad_norm")
# moe's metric beside them
AUX = "aux_loss"


def run_steps(cfg, state, step_fn, global_batches, mesh=None,
              micro_batches: int = 1):
    """The steps over ``global_batches`` (a rank's rows under ``mesh``):
    (metrics a step, gradients a step)."""
    device = T.leaves(state["params"])[0].device
    out = []
    with Recorder() as rec:
        for b in global_batches:
            if mesh is not None:
                b = shard_batch(b, mesh, micro_batches)
            state, m = step_fn(state, to_device(b, device))
            out.append({k: float(m[k]) for k in METRICS + (AUX,)
                        if k in m})
    return out, rec.grads


def gathered(tree_leaves: list, dims: dict, mesh) -> list:
    """Whole leaves, in host memory, from a rank's blocks (``T.items``
    order of ``dims``)."""
    return [P.gather_leaf(x, spec, mesh, host=True)
            for x, (_, spec) in zip(tree_leaves, T.items(dims))]


def sharded_steps(tp, arch: str, shape: tuple, micro_batches: int = 1,
                  fsdp=None, steps: int = 2, changes=None, opt=OPT):
    """``steps`` sharded train steps of the reduced ``arch`` (``changes``
    to its config, ``opt`` its AdamW) at ``shape`` (D, M) from
    ``whole_state``'s draw: rank 0 returns (metrics a step, the first
    step's gradients gathered whole, the final parameters gathered
    whole); the other ranks of the mesh None, ranks past it too."""
    mesh = meshlib.train_mesh(tp, *shape)
    if mesh is None:
        return None
    cfg = config(arch, fsdp, **(changes or {}))
    state = whole_state(cfg, device=tp.device, opt=opt)
    dims = P.train_dims(cfg, state["params"], shape)
    state = P.shard_state(state, dims, mesh)
    fn = S.build_train_step(cfg, opt, SVI, micro_batches=micro_batches,
                            seed=0, mesh=mesh, dims=dims)
    metrics, grads = run_steps(cfg, state, fn, batches(cfg, steps), mesh,
                               micro_batches)
    g0 = gathered(grads[0], dims, mesh)
    final = gathered(T.leaves(state["params"]), dims, mesh)
    return (metrics, g0, final) if mesh.rank == 0 else None


def collective_roundtrip(tp, device: str) -> list:
    """Each autograd collective of ``sharding.collectives`` forward and
    backward on a (2, 4, 6) input drawn per rank, over a 1 x size model
    axis: (name, forward output, input gradient) on this rank, in host
    memory (a fixed upstream gradient)."""
    mesh = meshlib.train_mesh(tp, 1, tp.size)
    ax = mesh.model
    out = []
    g = torch.Generator().manual_seed(10 + tp.rank)
    for name, fn in (("copy", lambda x: C.copy(x, ax)),
                     ("reduce", lambda x: C.reduce(x, ax)),
                     ("gather_sum", lambda x: C.gather(x, ax, 1)),
                     ("gather_split", lambda x: C.gather(x, ax, 1, "split")),
                     ("reduce_scatter", lambda x: C.reduce_scatter(x, ax, 1)),
                     ("split", lambda x: C.split(x, ax, 1))):
        x = torch.randn((2, 4, 6), generator=g).to(device).requires_grad_()
        y = fn(x)
        up = torch.randn(y.shape, generator=g).to(device)
        (gx,) = torch.autograd.grad(y, x, up)
        out.append((name, y.detach().cpu(), gx.cpu()))
    return out


def state_roundtrip(tp, arch: str, shape: tuple) -> list:
    """The leaves of the reduced ``arch``'s whole training state (FSDP as
    its config says) whose rank blocks (``shard_state``) do not gather
    back whole bit for bit, or whose block is not the whole leaf's shape
    over the blocks; [] when all do."""
    mesh = meshlib.train_mesh(tp, *shape)
    if mesh is None:
        return []
    cfg = config(arch)
    whole = whole_state(cfg)
    for t in T.leaves(whole["params"]):
        t.normal_(generator=torch.Generator().manual_seed(t.numel()))
    dims = P.train_dims(cfg, whole["params"], shape)
    sdims = P.state_pspecs(dims, whole["opt"])
    mine = P.shard_state(whole, dims, mesh)
    bad = []
    for (path, full), (_, part), (_, spec) in zip(
            T.items(whole), T.items(mine), T.items(sdims)):
        n = 1
        for e in spec:
            n *= 1 if e is None else (
                mesh.axis(e).size if isinstance(e, str)
                else mesh.axis(e[0]).size * mesh.axis(e[1]).size)
        back = P.gather_leaf(part, spec, mesh)
        if part.numel() * n != full.numel() or not torch.equal(back, full):
            bad.append(path)
    return bad


def stream_shapes(tp, arch: str, shape: tuple) -> dict:
    """One sharded step with the hidden state the head receives recorded:
    its shape on this rank and whether the stream was sequence-parallel."""
    from repro_torch.models import transformer as TR

    mesh = meshlib.train_mesh(tp, *shape)
    if mesh is None:
        return {}
    seen = {}
    orig = TR.head_loss

    def rec(params, cfg, hidden, labels, *a, **kw):
        seen.update(hidden=list(hidden.shape),
                    sp=TR.seq_parallel(cfg, kw["mesh"], labels.shape[1]))
        return orig(params, cfg, hidden, labels, *a, **kw)

    TR.head_loss = rec
    try:
        cfg = config(arch)
        state = whole_state(cfg)
        dims = P.train_dims(cfg, state["params"], shape)
        state = P.shard_state(state, dims, mesh)
        fn = S.build_train_step(cfg, OPT, SVI, seed=0, mesh=mesh, dims=dims)
        run_steps(cfg, state, fn, batches(cfg, 1), mesh)
    finally:
        TR.head_loss = orig
    return seen


def train_rank_state(tp, args) -> dict:
    """``launch.train.train`` on this rank at ``args.mesh``: the loss
    history and the rank's final state (path -> tensor), or {"failed":
    the message} where the run's injected failure stopped it (every rank
    stops at the same step; the ranks stay up for the next call)."""
    from repro_torch.launch import train as TT

    mesh = meshlib.train_mesh(tp, *TT.mesh_shape(args))
    if mesh is None:
        return None
    try:
        out = TT.train(args, mesh)
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
        return {"failed": str(e)}
    return {"history": out["history"],
            "state": {p: t.clone() for p, t in T.items(out["state"])}}


def train_gathered(tp, args) -> dict:
    """``launch.train.train`` on this rank at ``args.mesh`` (a resume
    with nothing left to run restores the latest checkpoint), then the
    state gathered whole: rank 0 returns path -> whole leaf."""
    from repro_torch.launch import train as TT

    mesh = meshlib.train_mesh(tp, *TT.mesh_shape(args))
    if mesh is None:
        return None
    cfg = config(args.arch)
    state = TT.train(args, mesh)["state"]
    whole = M.init_train_params(cfg, torch.Generator(), "meta")
    sdims = P.state_pspecs(P.train_dims(cfg, whole, mesh.shape),
                           state["opt"])
    out = {p: P.gather_leaf(t, spec, mesh, host=True)
           for (p, t), (_, spec) in zip(T.items(state), T.items(sdims))}
    return out if mesh.rank == 0 else None
