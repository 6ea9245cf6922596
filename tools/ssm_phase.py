"""Run the ssm phase of ``chip_smoke.py`` alone, in a fresh process, on
one GPU.

    python3 tools/ssm_phase.py

Builds the kernels, prints the card's name, power limit and clocks,
then calls ``chip_smoke.py``'s ``check_ssm_head`` (the fused head at
mamba2-370m's K 1024, V 50280 against its plain version and bound),
``ssm_phase`` (mamba2-370m at full width served three times by one
graphed engine, graph vs eager in both entropy modes, the 8192-token
prompt) and ``profile_serve("ssm_serve")``.  Run it twice in one call to
see the step's spread across processes; late in the full
``chip_smoke.py`` the same step reads slower.
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
    C.check_ssm_head(torch.device("cuda"))
    print(f"ssm launches {C.ssm_phase(launches)}", flush=True)
    print(C.profile_serve("ssm_serve"), flush=True)
    print(f"phase ssm: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
