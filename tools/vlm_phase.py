"""Run the vlm phase of ``chip_smoke.py`` alone, in a fresh process, on one
GPU.

    python3 tools/vlm_phase.py

Builds the kernels, prints the card's name, power limit and clocks,
then calls ``chip_smoke.py``'s ``check_vlm_shapes`` (the decode kernel
and the fused head at phi-3-vision-4.2b's shapes against their plain
versions, bounds and SDPA), ``vlm_phase`` (phi-3-vision-4.2b at full
width served three times by one graphed engine with batch prefill, graph
vs eager in both entropy modes, the random-prefix-embeds admission) and
``profile_serve("vlm_serve")``.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main():
    if not torch.cuda.is_available():
        C.fail("no CUDA device: this script runs on a GPU")
    import repro_torch  # noqa: F401  (pins the precision flags)
    from repro_torch.kernels import build, launches

    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    C.check_vlm_shapes(torch.device("cuda"))
    print(f"vlm launches {C.vlm_phase(launches)}", flush=True)
    print(C.profile_serve("vlm_serve"), flush=True)
    print(f"phase vlm: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
