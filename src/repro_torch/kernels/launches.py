"""Launch counts of the port's CUDA kernels.

Each kernel wrapper adds one to its count where it launches its kernel,
and nowhere else, so a run can show that the serving path went through
the kernels (``chip_smoke.py`` zeroes the counts, drives the engine and
reads them back).  Process-wide telemetry: plain integers, no locking.
"""

from __future__ import annotations

COUNTS = {"uncertainty_head": 0, "paged_decode_attention": 0,
          "paged_prefill_attention": 0}


def reset() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def snapshot() -> dict[str, int]:
    return dict(COUNTS)
