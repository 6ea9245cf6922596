"""Launch counts of the port's CUDA kernels.

Each kernel wrapper adds one to its count where it launches its kernel,
and nowhere else (once per call, also where a call is several launches,
as the heads' passes are), so a run can show that a path went through
the kernels (``chip_smoke.py`` zeroes the counts, drives a path and
reads them back).  Process-wide telemetry: plain integers, no locking.
"""

from __future__ import annotations

COUNTS = {"uncertainty_head": 0, "paged_decode_attention": 0,
          "paged_prefill_attention": 0, "photonic_conv": 0,
          "photonic_conv_sampled": 0, "bayes_matmul": 0,
          "bayes_matmul_sampled": 0, "lrt_matmul": 0,
          "lrt_matmul_sampled": 0, "uncertainty_head_two_pass": 0,
          "flash_attention": 0}


def reset() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def snapshot() -> dict[str, int]:
    return dict(COUNTS)
