"""Run the prefix-cache and speculative-decoding phase of
``chip_smoke.py`` alone, in a fresh process, on one GPU.

    python3 tools/prefix_spec_phase.py

Builds the kernels, prints the card's name, power limit and clocks, then
calls ``chip_smoke.py``'s ``check_prefill`` (the prefill kernel at the
served chunk offsets and at the prefix hits' mid-block offsets 200 and
264, timed beside their bounds, and a hit's rows against the cold walk's
bit for bit) and ``spec_phase`` (qwen2-1.5B at full width with a
200-token shared prefix: the prefix cache in kernel and operand entropy,
speculative decoding forced and adaptive against spec off, replayed spec
rounds against eager ones).
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
    row = C.check_prefill(torch.device("cuda"))
    print(f"prefill row {row}", flush=True)
    print(f"prefix/spec launches {C.spec_phase(launches, smi)}", flush=True)
    print(f"phase prefix/spec: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
