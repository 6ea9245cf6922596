"""Time variants of the tensor-core decode kernel (``paged_decode_mma`` in
``src/repro_torch/kernels/csrc/paged_attention.cu``) against each other on
one GPU, in one process.

Each variant is the kernel's source with text substitutions.  The script
builds every variant with nvcc (one process each, all at once) into
``build/decode_variants/``, calls each through the same C entry point
(``repro_paged_decode``, mma route), prints each one's error against the
plain version (large for the timing-only variants), and times each by
CUDA-graph replay, in turns: every variant once, then again in reverse
order.

    PYTHONPATH=src python3 -m repro_torch.kernels.decode_variants \
        [--timeline [variant ...]]

``--timeline`` instead builds the kept kernel with time stamps: thread 0
of every block writes %globaltimer and clock64() at eight points of its
walk (entry, the table scanned, warp 0's first tile landed, warp 0's walk
done, the warps' weights, the counter passed, the last block's partials
landed, the end: for a block that merges nothing, where it writes its
output or its partial), and the script prints them per block of one call at
the served case, in ns from the first block's entry and in SM cycles
from the block's own entry.  Timeline variants of the last block's
merge, timing only: ``no_rows`` (no row weights), ``no_elems`` (no
element sums).

Variants:
  kept           the source as it is
  empty          every block returns at once: the launch alone
  no_copy        no K/V copies (the products read whatever shared memory
                 holds); timing only
  no_mma         no products; timing only
  no_cross       no partials merged across blocks: each split stops after
                 its warps' merge; timing only
  no_last_merge  the partials and the counter, but the last block does not
                 merge; timing only
  stages3        three tiles a warp in flight
  warps8         8 warps a block (the same tiles a split)

A substitution that no longer matches the source stops the script.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from repro_torch.kernels import build

CSRC = build.CSRC
OUT = build.BUILD_DIR.parent / "decode_variants"

START = """  const int* trow = table + (size_t)b * MB;
"""
COPY = """        cp_async_16(ks + ck * P + c * 8, kp + src + c * 8, live);
        cp_async_16(vs + ck * P + c * 8, vp + src + c * 8, live);
"""
QK = """      mma_bf16(s[0], qf[kk], bb[0], bb[1]);
      mma_bf16(s[1], qf[kk], bb[2], bb[3]);
"""
PV = """        mma_bf16(o[2 * dp + h], a, bb[2 * h], bb[2 * h + 1]);
"""
CROSS = """  if (nlive == 1) return;
"""
LAST = """  if (!last_s) return;
"""
STAGES = "constexpr int DK_STAGES = 2;"
WARPS = "constexpr int DK_WARPS = 4;"
# (name, slot depths, table width)
CASES = (("served", [288, 150, 17, 0], 19),
         ("64 slots", None, 19),
         ("depth 4096", [4096] * 4, 256))


def _case(dev, lens_l, MB, seed, D=128):
    """qwen2-1.5B's decode widths (H 12, Hkv 2, BS 16), bf16: slots of the
    given depths, each row's blocks shuffled through the pool with -1
    tails (``chip_smoke.py``'s ``decode_case``)."""
    B, H, Hkv, BS = len(lens_l), 12, 2, 16
    NB = B * MB
    g = torch.Generator(device=dev).manual_seed(seed)
    k, v = (torch.randn((NB, BS, Hkv, D), generator=g, device=dev)
            .to(torch.bfloat16) for _ in "kv")
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(torch.bfloat16)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(seed))
    table = torch.full((B, MB), -1, dtype=torch.int32)
    for b, n in enumerate(lens_l):
        nb = -(-n // BS)
        table[b, :nb] = perm[b * MB:b * MB + nb].to(torch.int32)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    return q, k, v, table.to(dev), lens


def _device_ms(fn, calls: int, rounds: int = 5) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``rounds`` times between CUDA events."""
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


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the source no longer holds:\n{old}")
    return text.replace(old, new)


def variants() -> dict[str, str]:
    cu = (CSRC / "paged_attention.cu").read_text()
    return {
        "kept": cu,
        "empty": _sub(cu, START, "  if (b >= 0) return;\n" + START),
        "no_copy": _sub(cu, COPY, ""),
        "no_mma": _sub(_sub(cu, QK, ""), PV, ""),
        "no_cross": _sub(cu, CROSS, "  return;\n"),
        "no_last_merge": _sub(cu, LAST, "  return;\n"),
        "stages3": _sub(cu, STAGES, "constexpr int DK_STAGES = 3;"),
        "warps8": _sub(cu, WARPS, "constexpr int DK_WARPS = 8;"),
    }


STAMPS = r"""
__device__ unsigned long long dk_stamps[1 << 16];
#define STAMP(k)                                                            \
  if (threadIdx.x == 0) {                                                   \
    unsigned long long gt;                                                  \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));                  \
    const size_t blk = blockIdx.x +                                         \
        gridDim.x * (blockIdx.y + gridDim.y * (size_t)blockIdx.z);          \
    dk_stamps[blk * 16 + (k)] = gt;                                         \
    dk_stamps[blk * 16 + 8 + (k)] = clock64();                              \
  }
extern "C" int dk_stamps_read(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, dk_stamps, sizeof(long long) * n);
}
extern "C" int dk_stamps_clear() {
  void* p;
  cudaGetSymbolAddress(&p, dk_stamps);
  return (int)cudaMemset(p, 0, sizeof(dk_stamps));
}
"""
# (anchor, the stamp goes before it)
STAMP_AT = (
    ("  const int* trow = table + (size_t)b * MB;\n", 0, "after"),
    ("  const int nlive = (ntiles + tiles - 1) / tiles;"
     "  // splits that read a key\n", 1, "after"),
    ("    cp_async_wait<DK_STAGES - 1>();  // tile t has landed\n"
     "    __syncwarp();\n", 2, "after"),
    ("  cp_async_wait<0>();  // the empty groups\n", 3, "after"),
    ("  // a thread takes the float4 elements", 4, "before"),
    ("  if (nlive == 1) return;\n", 7, "before"),
    ("  if (!last_s) return;\n", 5, "before"),
    ("    if (tid < rep) {\n      const float m0 = rowm_s[tid];", 6,
     "before"),
    ("    store_bf16x4(og + r * D + d, ar[e], 1.f / rowl_s[r]);\n  }\n}", 7,
     "after_body"),
)


# timeline variants of the last block's merge (timing only)
ROWS = "    if (tid < rep) {\n      const float m0 = rowm_s[tid];"
ELEMS = ("      for (int s2 = 0; s2 < n; ++s2) {\n"
         "        const float c = wt_s[s2 * 16 + r];")
TIMELINE_VARIANTS = {
    "kept": (),
    "no_rows": ((ROWS, ROWS.replace("tid < rep", "tid < 0")),),
    "no_elems": ((ELEMS, ELEMS.replace("s2 < n", "s2 < 0")),),
}


def timeline_source(variant: str = "kept") -> str:
    cu = (CSRC / "paged_attention.cu").read_text()
    cu = _sub(cu, '#include "mma_tile.cuh"\n',
              '#include "mma_tile.cuh"\n' + STAMPS)
    for anchor, k, where in STAMP_AT:
        stamp = f"  STAMP({k});\n"
        if where == "after":
            cu = _sub(cu, anchor, anchor + stamp)
        elif where == "before":
            cu = _sub(cu, anchor, stamp + anchor)
        else:  # before the closing brace of the kernel
            cu = _sub(cu, anchor, anchor[:-1] + stamp + "}")
    for old, new in TIMELINE_VARIANTS[variant]:
        cu = _sub(cu, old, new)
    return cu


def timeline(variant: str = "kept") -> None:
    dev = torch.device("cuda")
    from repro_torch.kernels import paged_attention as PA

    d = OUT / f"timeline_{variant}"
    d.mkdir(parents=True, exist_ok=True)
    for f in CSRC.iterdir():
        shutil.copy(f, d / f.name)
    (d / "paged_attention.cu").write_text(timeline_source(variant))
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                          str(d / "lib.so"), str(d / "paged_attention.cu")],
                         capture_output=True, text=True, check=True)
    entry = False  # ptxas's lines of paged_decode_mma<128>
    for line in res.stdout.splitlines() + res.stderr.splitlines():
        if "Compiling entry function" in line:
            entry = "paged_decode_mma" in line and "ILi128E" in line
        elif entry and ("registers" in line or "spill" in line):
            print(f"  ptxas {variant} paged_decode_mma<128>: "
                  f"{line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_paged_decode.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.dk_stamps_read.argtypes = [p, i]
    label, lens_l, MB = CASES[0]
    q, k, v, table, lens = _case(dev, lens_l, MB, 2)
    B, _, H, D = q.shape
    Hkv, BS = k.shape[2], k.shape[1]
    tiles = PA.decode_tiles(B, Hkv, MB, BS)
    splits = -(-(-(-MB * BS // PA.DECODE_KEY_TILE)) // tiles)
    out = torch.empty_like(q)
    part = torch.empty(B * H * splits * (D + 4), device=dev)
    count = torch.zeros(B * Hkv, dtype=torch.int32, device=dev)
    for _ in range(20):
        lib.dk_stamps_clear()
        lib.repro_paged_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
            lens.data_ptr(), out.data_ptr(), part.data_ptr(),
            count.data_ptr(), B, H, Hkv, D, BS, MB, tiles, 1, 1,
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    n = B * Hkv * splits * 16
    host = (ctypes.c_ulonglong * n)()
    lib.dk_stamps_read(ctypes.cast(host, ctypes.c_void_p), n)
    t0 = min(host[j * 16] for j in range(n // 16) if host[j * 16])
    print(f"timeline {variant}, {label} ({tiles} tiles a split), the last "
          "of 20 calls: block (b, g, split): ns from the first entry at "
          "[entry, scanned, landed, walked, weights, counter, partials, "
          "end]; SM cycles from the block's entry", flush=True)
    for j in range(n // 16):
        if not host[j * 16 + 2]:    # blocks that read no key
            continue
        bx, rest = j % B, j // B
        gy, sz = rest % Hkv, rest // Hkv
        ns = [host[j * 16 + k] - t0 if host[j * 16 + k] else None
              for k in range(8)]
        cyc = [host[j * 16 + 8 + k] - host[j * 16 + 8]
               if host[j * 16 + k] else None for k in range(8)]
        print(f"  ({bx}, {gy}, {sz}) ns {ns} cycles {cyc}", flush=True)


def build_all() -> dict[str, ctypes.CDLL]:
    procs = {}
    for name, text in variants().items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in CSRC.iterdir():
            shutil.copy(f, d / f.name)
        (d / "paged_attention.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "paged_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_paged_decode.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.repro_paged_decode.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times GPU kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    if "--timeline" in sys.argv[1:]:
        for variant in sys.argv[sys.argv.index("--timeline") + 1:] or \
                ["kept"]:
            timeline(variant)
        return
    dev = torch.device("cuda")
    from repro_torch.kernels import paged_attention as PA

    libs = build_all()
    rng = torch.Generator().manual_seed(9)
    for label, lens_l, MB in CASES:
        if lens_l is None:
            lens_l = [0] + torch.randint(1, 305, (63,),
                                         generator=rng).tolist()
        q, k, v, table, lens = _case(dev, lens_l, MB, 2)
        B, _, H, D = q.shape
        Hkv, BS = k.shape[2], k.shape[1]
        tiles = PA.decode_tiles(B, Hkv, MB, BS)
        want = PA.paged_decode_attention_plain(q, k, v, table, lens)
        out = torch.empty_like(q)
        splits = -(-(-(-MB * BS // PA.DECODE_KEY_TILE)) // tiles)
        part = torch.empty(B * H * splits * (D + 4), device=dev)
        count = torch.zeros(B * Hkv, dtype=torch.int32, device=dev)

        def run(lib):
            rc = lib.repro_paged_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                lens.data_ptr(), out.data_ptr(), part.data_ptr(),
                count.data_ptr(), B, H, Hkv, D, BS, MB, tiles, 1, 1,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        order = list(libs)
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                count.zero_()
                run(libs[name])
                torch.cuda.synchronize()
                err = _max_err(out, want)
                count.zero_()
                ms = _device_ms(lambda: run(libs[name]), 100)
                print(f"  {label} ({tiles} tiles a split) {name} (turn "
                      f"{rnd + 1}): {ms:.4f} ms, max |err| {err:.3g}",
                      flush=True)


if __name__ == "__main__":
    main()
