"""Time the fused uncertainty head at the serving shape, in turns across
source trees, on one GPU.

    python3 tools/head_ab.py SRC [SRC ...]

Each SRC is a ``src`` directory holding a ``repro_torch`` package (this
checkout's, or an unpacked earlier commit's, so that two versions of the
kernel are compared inside one run on one card).  Each runs in its own
process in the order given (give parent, change, change, parent), builds
its own kernels, and prints one line: the head's device time per call at
M 4, K 1536, V 151936, S 10 (qwen2-1.5B's decode head) by CUDA-graph
replay with the L2 warm and cold, with the step as an int and, where the
tree's head takes one, as a one-element device tensor.  The first line
is the card's name and power limit.
"""

from __future__ import annotations

import inspect
import json
import math
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


def one(src: str) -> dict:
    sys.path.insert(0, src)
    import importlib

    import torch

    UH = importlib.import_module("repro_torch.kernels.uncertainty_head")
    dev = torch.device("cuda")
    M, K, V, S = 4, 1536, 151936, 10
    g = torch.Generator(device=dev).manual_seed(1)
    mu = torch.randn((K, V), generator=g, device=dev) / math.sqrt(K)
    sigma = 0.01 + 0.05 * torch.rand((K, V), generator=g, device=dev)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)

    def run_int():
        return UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S, seed=7,
                                        step=3)

    out = {"src": src, "int_ms": device_ms(run_int),
           "int_cold_ms": cold_ms(run_int)}
    if "step_offset" in inspect.signature(UH.uncertainty_head_cuda).parameters:
        step = torch.full((1,), 1, dtype=torch.int32, device=dev)

        def run_tensor():
            return UH.uncertainty_head_cuda(x, mu, sigma, num_samples=S,
                                            seed=7, step=step, step_offset=2)

        out["tensor_ms"] = device_ms(run_tensor)
        out["tensor_cold_ms"] = cold_ms(run_tensor)
    return out


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
