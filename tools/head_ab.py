"""Time the fused uncertainty head at the six served widths, in turns
across source trees, on one GPU.

    python3 tools/head_ab.py SRC [SRC ...]

Each SRC is a ``src`` directory holding a ``repro_torch`` package (this
checkout's, or an unpacked earlier commit's, so that two versions of the
kernel are compared inside one run on one card).  Each runs in its own
process in the order given (give parent, change, change, parent), builds
its own kernels, and prints one line: the head's device time per call at
M 4, S 10 and bf16 x, at each served family's head widths (K, V: qwen2
1536 x 151936, deepseek 2048 x 102400, mamba2 1024 x 50280, zamba2
3584 x 32000, seamless 1024 x 256206, phi-3-vision 3072 x 32064), by
CUDA-graph replay with the L2 warm and cold, with the step as an int
and, where the tree's head takes one, as a one-element device tensor,
and each of the head's kernels' device time a call from a torch.profiler
trace of five eager calls.  The first line is the card's name and power
limit.
"""

from __future__ import annotations

import inspect
import json
import math
import re
import subprocess
import sys


def device_ms(fn, calls: int = 10, rounds: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(rounds):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (rounds * calls)


def cold_ms(fn) -> float:
    """``fn`` after a 128 MB write (2.5x the L2) inside the graph, less
    the write alone."""
    import torch

    flush = torch.empty((32 * 2 ** 20,), dtype=torch.float32, device="cuda")
    return device_ms(lambda: (flush.fill_(1.0), fn())) \
        - device_ms(lambda: flush.fill_(1.0))


WIDTHS = {"qwen2": (1536, 151936), "deepseek": (2048, 102400),
          "mamba2": (1024, 50280), "zamba2": (3584, 32000),
          "seamless": (1024, 256206), "phi3v": (3072, 32064)}


def pieces(fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+)(?:<[^(]*>)?\(", e.key)
            out[name.group(1) if name else e.key[:40]] = round(
                e.device_time_total / calls / 1e3, 4)
    return out


def width(UH, K: int, V: int) -> dict:
    import torch

    dev = torch.device("cuda")
    M, S = 4, 10
    g = torch.Generator(device=dev).manual_seed(1)
    mu = torch.randn((K, V), generator=g, device=dev) / math.sqrt(K)
    sigma = 0.01 + 0.05 * torch.rand((K, V), generator=g, device=dev)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)

    def run_int():
        return UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, seed=7,
                                        step=3)

    out = {"int_ms": device_ms(run_int), "int_cold_ms": cold_ms(run_int),
           "kernels_ms": pieces(run_int)}
    if "step_offset" in inspect.signature(UH.uncertainty_head_cuda).parameters:
        step = torch.full((1,), 1, dtype=torch.int32, device=dev)

        def run_tensor():
            return UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S,
                                            seed=7, step=step, step_offset=2)

        out["tensor_ms"] = device_ms(run_tensor)
        out["tensor_cold_ms"] = cold_ms(run_tensor)
    return out


def one(src: str) -> dict:
    sys.path.insert(0, src)
    import importlib

    UH = importlib.import_module("repro_torch.kernels.uncertainty_head")
    return {"src": src, **{name: width(UH, K, V)
                           for name, (K, V) in WIDTHS.items()}}


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(sys.argv[2])))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for src in sys.argv[1:]:
        res = subprocess.run([sys.executable, __file__, "--one", src],
                             capture_output=True, text=True, check=True)
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
