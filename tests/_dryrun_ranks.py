"""What the dry-run tests run inside the spawned ranks: one real train
step of a reduced arch on a 2 x 2 gloo mesh, with what the dry run
reckons for the same step measured on the real tensors.

A rank pickles functions by import path and loads no JAX: this module
imports torch and the port only (with the draws of
``_train_mesh_ranks``).
"""

from __future__ import annotations

from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

import _train_mesh_ranks as R
from repro_torch.core import tree as T
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as S
from repro_torch.sharding import partition as P

SHAPE = (2, 2)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree))


def real_step(tp, arch: str, micro_batches: int) -> dict:
    """One train step of the reduced ``arch`` at 2 x 2 from
    ``R.whole_state`` on ``R.batches``' first batch: the rank's
    parameter, gradient (as the step hands them to AdamW) and moment
    bytes, the bytes it put into each axis' collectives, the step's
    FLOPs (``FlopCounterMode``) and its ``MemTracker`` peak."""
    mesh = meshlib.train_mesh(tp, *SHAPE)
    cfg = R.config(arch)
    state = R.whole_state(cfg)
    dims = P.train_dims(cfg, state["params"], SHAPE)
    state = P.shard_state(state, dims, mesh)
    grads = []
    fn = S.build_train_step(cfg, R.OPT, R.SVI, micro_batches, seed=0,
                            mesh=mesh, dims=dims,
                            on_grads=lambda g: grads.append(
                                sum(nbytes({"g": x}) for x in g)))
    batch = to_device(shard_batch(R.batches(cfg, 1)[0], mesh, micro_batches),
                      "cpu")
    for k in mesh.traffic:
        mesh.traffic[k] = 0
    tracker = MemTracker()
    tracker.track_external(*T.leaves(state), *batch.values())
    with tracker, FlopCounterMode(display=False) as flops:
        fn(state, batch)
    peak = sum(s["Total"] for s in
               tracker.get_tracker_snapshot("peak").values())
    return {"param_bytes": nbytes(state["params"]), "grad_bytes": grads[0],
            "moment_bytes": nbytes(state["opt"]["mu"])
            + nbytes(state["opt"]["nu"]),
            "traffic": dict(mesh.traffic),
            "flops": flops.get_total_flops(), "peak": peak}
