"""Run the priority-scheduling and escalation-lane phase of
``chip_smoke.py`` alone, in a fresh process, on one GPU.

    python3 tools/risk_phase.py

Builds the kernels, prints the card's name, power limit and clocks, then
calls ``chip_smoke.py``'s ``risk_phase``: qwen2-1.5B at full width on the
priority burst (fifo, then priority with the escalation lane at S 40),
the lane's replayed chunks against the eager ones, preempt-and-restore
in operand entropy against the solo runs, and the fused head at S 40
(M 1 and 4) against its plain version.
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
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}, {clocks}", flush=True)
    t0 = time.perf_counter()
    print(f"risk launches {C.risk_phase(launches, smi)}", flush=True)
    print(f"phase risk: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
