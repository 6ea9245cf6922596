"""Phase 21 of ``chip_smoke.py``: the four configs no other phase serves
on the card, each at full width on the kernel path.

    python3 tools/arch_phase.py

runs the phase alone, in a fresh process, on one GPU (it builds the
kernels first and prints the card's name, power limit and clocks).
``python3 chip_smoke.py --trace KIND`` (or ``chip_smoke.profile_serve(
KIND)``) traces a short serve of one arch under torch.profiler in a
fresh process, KIND one of ``nemotron_serve``, ``codeqwen_serve``,
``qwen2_7b_serve`` and ``grok_serve``.

The archs, cut in depth by ``chip_smoke.CUTS`` for the script's time
(every width whole, random weights from the seed):

* nemotron-4-15b (4 of 32 layers): the squared-ReLU MLP; 48 query heads
  over 8 kv heads of D 128; the fused head at K 6144 x V 256000 (12.58
  GB of f32 mu and sigma, three K slices at M 4);
* codeqwen1.5-7b (4 of 32): MHA over 32 kv heads, QKV biases, the head
  at K 4096 x V 92416;
* qwen2-7b (4 of 28): 7 query heads a kv head on both paged kernels
  (rows 7-15 of the decode kernel's m16 fragment are padding, prefill
  packs 448 rows a kv head at S 64), the head at K 3584 x V 152064;
* grok-1-314b (2 of 64): 8 experts top-2 at expert ff 32768 (capacity
  dispatch, ``experts_tp``), one layer 4.92 B parameters; its head is
  soft-capped, so every decode step takes the plain explicit-logits head
  and no fused head, as the reference routes it
  (``models/uncertain_head.py``).

For each dense arch, first ``chip_smoke.check_shapes``: decode at the
served depths, prefill S 64 at offsets 0 and 192 of span 256 and the
fused head (M 4, S 10, Philox and explicit xi, row 0's argmax planted
in the last column and row 3's in the last tile's first column), each
against its plain version on the tensor-core route, timed beside its
bound and its yardstick.  grok's attention (48 over 8, D 128) is
nemotron's, which that case covers; grok has no fused head.

Then each arch is served by ``chip_smoke.serve_arch`` (phase 9 serves
deepseek-moe-16b with it too): parameter bytes and the draw's peak
against the meta-device reckoning; one graphed engine on phase 4's
trace in kernel entropy with a replay's launches asserted (grok: no
fused head, its soft-capped plain head run); every chunk of a second
serve against the eager chunk bit for bit; operand entropy through the
kernel path against the gather / batch path.

``arch_phase`` returns the summed launch counts of the measured serves.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402

ARCHS = ("nemotron_4_15b", "codeqwen1_5_7b", "qwen2_7b", "grok_1_314b")
# the head's seed in ``check_shapes`` by dense arch (the other phases
# take 8 to 14)
HEAD_SEEDS = {"nemotron_4_15b": 16, "codeqwen1_5_7b": 18, "qwen2_7b": 20}


def check_arch_shapes(dev, arch: str) -> dict:
    """The three serving kernels at a dense arch's full-width shapes
    (``chip_smoke.check_shapes``; the module docstring)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    V = cfg.vocab_size
    return C.check_shapes(
        dev, cfg.name, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.d_model, V, [("served", [288, 150, 17, 0], 19)],
        [(64, 0, 256), (64, 192, 256)], head_seed=HEAD_SEEDS[arch],
        plant=((0, V - 1), (3, V - (V % 128 or 128))))


def arch_phase(launches) -> dict:
    """The phase: the dense archs' kernel shapes, then every arch served
    (module docstring).  Returns the measured serves' summed counts."""
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"archs: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
          "at the start", flush=True)
    total = dict.fromkeys(launches.COUNTS, 0)
    for arch in ARCHS:
        t0 = time.perf_counter()
        if arch in HEAD_SEEDS:
            check_arch_shapes(dev, arch)
            gc.collect()
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        counts = C.serve_arch(arch, launches)
        for name, n in counts.items():
            total[name] += n
        print(f"{arch}: shapes {t1 - t0:.1f}s, serves "
              f"{time.perf_counter() - t1:.1f}s, launches {counts}",
              flush=True)
    return total


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
    print(f"archs launches {arch_phase(launches)}", flush=True)
    print(f"phase archs (21): {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
