"""Phase 20 of ``chip_smoke.py``: the dry run held to phase 18's
measured ranks.

Phase 18 (a) trains qwen2-1.5B at full width, cut to
``train_mesh_phase.DENSE_LAYERS`` of its 28 layers, at ``--mesh 2x2`` on
four gloo ranks of the card, and returns each rank's measured parameter,
gradient and moment bytes, its allocator peak and the bytes it put into
each axis' collectives a step.  This phase reckons the SAME cell with
``repro_torch.launch.dryrun.reckon_train`` in the main process: rank 0
of a fake group of four, fake tensors on ``cuda`` (nothing allocated,
no collective run), one step.  It fails unless

* the parameter, gradient and moment bytes equal every rank's measured
  ones;
* the bytes a rank put into each axis' collectives equal every rank's
  (phase 18's last step);
* the dry run's peak (``MemTracker``) over every rank's allocator peak
  lies in ``PEAK_BAND`` (``PERF.md`` §6, PR 36: predicted before the
  first run);
* no process group is left in this process.

It prints the dry run's FLOPs beside the measured step's wall time, as
a reading (the ranks share one card through host-staged gloo, so that
rate says nothing of a sharded step's speed).

    python3 tools/dryrun_phase.py

dry-runs the cell alone and prints it (no card measurement to hold it
to): the quick check that the fake-tensor trace runs on the card
machine's PyTorch.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as C  # noqa: E402
import train_mesh_phase as TM  # noqa: E402

# the dry run's peak over the allocator's, each rank: MemTracker counts
# the tensors the step holds at its peak, rounded to the allocator's
# 512-byte blocks; the allocator also holds cuBLAS's workspaces and
# blocks it rounds up further (PR 35 measured 6.777 GB where the dry run
# on the meta device reckons 6.710 GB: 0.990)
PEAK_BAND = (0.95, 1.01)


def reckon():
    """Phase 18 (a)'s cell, dry-run as rank 0 with fake tensors on the
    card's device type: (the dry run's output, seconds)."""
    from repro_torch.launch import dryrun as D

    t0 = time.perf_counter()
    out = D.reckon_train(TM._config(TM.ARCH), TM.MESH, TM.BATCH, TM.SEQ, 1,
                         rank=0, device="cuda", opt_cfg=TM._opt(TM.STEPS),
                         svi=TM._svi(TM.BATCH, TM.STEPS), seed=0)
    return out, time.perf_counter() - t0


def dryrun_phase(outs: list, smi: str) -> None:
    """Phase 20: the dry run against phase 18 (a)'s ranks (``outs``)."""
    out, seconds = reckon()
    if dist.is_initialized():
        C.fail("dry run: a process group was left in the main process")
    mem, traffic = out["memory"], out["traffic"]
    for o in outs:
        got = (mem["param_bytes"], mem["grad_bytes"], mem["moment_bytes"])
        want = (o["param_bytes"], o["grad_bytes"], o["moment_bytes"])
        if got != want:
            C.fail(f"dry run: rank {o['rank']}'s parameter / gradient / "
                   f"moment bytes {want} measured, {got} reckoned")
        if traffic != o["rows"][-1]["traffic"]:
            C.fail(f"dry run: rank {o['rank']}'s collective bytes a step "
                   f"{o['rows'][-1]['traffic']} measured, {traffic} "
                   "reckoned")
        ratio = mem["peak_bytes"] / o["peak_bytes"]
        if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
            C.fail(f"dry run: rank {o['rank']}'s peak {o['peak_bytes']} B "
                   f"measured, {mem['peak_bytes']} B reckoned: "
                   f"{ratio:.4f}, outside {PEAK_BAND}")
    flops = out["cost"]["flops"]
    ms = [o["rows"][-1]["ms"] for o in outs]
    print(f"dry run: {TM.ARCH} full width, {TM.DENSE_LAYERS} of 28 layers, "
          f"2x2, {TM.BATCH} x {TM.SEQ}, rank 0 reckoned on a fake group of 4 "
          f"(fake tensors on cuda) in {seconds:.1f}s: params "
          f"{mem['param_bytes']} B, grads {mem['grad_bytes']} B, moments "
          f"{mem['moment_bytes']} B (each equal to every rank's measured "
          f"bytes); collectives a step {traffic} B (equal to every rank's); "
          f"peak {mem['peak_bytes']} B reckoned against measured "
          f"{[o['peak_bytes'] for o in outs]} B (ratios "
          f"{[round(mem['peak_bytes'] / o['peak_bytes'], 4) for o in outs]}"
          f", band {PEAK_BAND}); by kind "
          f"{ {k: v for k, v in mem['peak_by_kind'].items() if v} }; "
          f"{flops:.4e} FLOPs a rank a step beside the measured step's "
          f"{[round(x, 1) for x in ms]} ms (a reading: "
          f"{flops / (min(ms) * 1e-3) / 1e12:.2f} TFLOP/s a rank on "
          f"host-staged gloo); {smi}", flush=True)


def main():
    if not torch.cuda.is_available():
        C.fail("no CUDA device: this script runs on a GPU")
    import repro_torch  # noqa: F401  (pins the precision flags)
    out, seconds = reckon()
    mem = out["memory"]
    print(f"dry run alone: {TM.ARCH} {TM.DENSE_LAYERS} layers 2x2 in "
          f"{seconds:.1f}s: params {mem['param_bytes']} grads "
          f"{mem['grad_bytes']} moments {mem['moment_bytes']} peak "
          f"{mem['peak_bytes']} B; traffic {out['traffic']}; flops "
          f"{out['cost']['flops']:.4e}; group left: "
          f"{dist.is_initialized()}", flush=True)


if __name__ == "__main__":
    main()
