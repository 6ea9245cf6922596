"""Sharded-vs-unsharded serving parity checker.

PyTorch counterpart of ``repro.launch.engine.mesh_check``.  Runs the SAME
staggered mixed-length traffic through an unsharded ``ServeEngine`` and
through a ``--mesh 1xM`` tensor-parallel one (M spawned ranks,
``launch.mesh``) and asserts the decoded streams are BIT-IDENTICAL: token
ids exactly, the (H, SE, MI, p_max) uncertainty floats bitwise, the flag
counts equal, per attention family.  This is the executable form of the
serve-TP exactness argument (``sharding.partition``): only
column-parallel shards exist and each is all-gathered before any
consumer contracts over it, so no float reduction is split across ranks.

The engines run the paged layout with chunked prefill and, by default,
the paged decode and prefill kernels (their plain versions on the CPU),
each rank on its own kv heads.  The dense family runs with the prefix
cache and with 2 kv heads (reduced qwen2 has 1, which no mesh shards), so
that at M 2 its pool shards; the reduced moe, hybrid and encdec configs
have 4.  The unsharded reference runs in this process, the sharded run
in the ranks (one thread each on the CPU, as here).  It runs on the card
and raises without one unless ``--device cpu`` asks for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.engine.mesh_check \\
      --device cpu --families dense,moe,hybrid,encdec --mesh 1x2 \\
      [--entropy kernel] [--json]

Exit code 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.entropy import KernelEntropy
from repro_torch.data.synthetic import TokenStreamState, token_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.models import registry as M

# one representative arch per attention family (dense GQA, MoE with
# capacity routing, hybrid ssm + attention, encdec cross-attention); dense
# additionally runs with the prefix cache on
FAMILIES = {
    "dense": "qwen2_1_5b",
    "moe": "deepseek_moe_16b",
    "hybrid": "zamba2_7b",
    "encdec": "seamless_m4t_medium",
}

# staggered mixed-length traffic: admissions, evictions, grants and (on
# dense) prefix hits all land at different chunks, so the sharded engine
# must reproduce the reference under a non-trivial schedule
PROMPTS = (9, 17, 5, 24, 12)
GENS = (6, 9, 5, 8, 7)
SHARED = 8          # dense: requests 1 and 3 reuse request 0's opening
                    # block (one kv_block) to exercise cached-hit decode

ENGINE = dict(num_slots=2, max_len=32, chunk=4, kv_layout="paged",
              kv_block=8, kv_blocks=12, prefill_mode="chunked",
              prefill_chunk=8, trace_every=4)


def family_config(family: str, entropy: str = "operand"):
    """The reduced config of ``family``'s arch in ``entropy`` mode; dense
    with 2 kv heads (see the module docstring)."""
    cfg = dataclasses.replace(reduced(get_config(FAMILIES[family])),
                              head_entropy=entropy)
    if family == "dense":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    return cfg


def make_traffic(cfg, family: str) -> list[Request]:
    reqs = []
    base = None
    for i, (p, g) in enumerate(zip(PROMPTS, GENS)):
        toks, _ = token_batch(
            TokenStreamState(seed=100 + i, host=0, num_hosts=1),
            1, p, cfg.vocab_size)
        prompt = np.asarray(toks, np.int32)[0].copy()
        if i == 0:
            base = prompt
        elif family == "dense" and i in (1, 3):
            prompt[:SHARED] = base[:SHARED]
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=g))
    return reqs


def run_family(tp, family: str, *, entropy: str = "operand",
               decode_attn: str = "kernel", device="cuda", params=None,
               head_noise=None) -> dict:
    """``family``'s traffic through one engine: unsharded with ``tp`` None,
    else as this rank of the mesh.  ``params``: a numpy parameter tree in
    the JAX package's layout (``registry.params_from_numpy``), else random
    weights from seed 0 (the same on every rank).  ``head_noise``: an
    operand-noise provider.  Returns the engine's result, with ``mesh``
    set."""
    cfg = family_config(family, entropy)
    dev = resolve_device(device if tp is None else tp.device)
    if params is None:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
    else:
        params = M.params_from_numpy(params, cfg, dev)
    eng = ServeEngine(
        params, cfg, **ENGINE, decode_attn=decode_attn, device=dev,
        prefix_cache=family == "dense", head_noise=head_noise, mesh=tp,
        entropy=KernelEntropy(seed=0) if entropy == "kernel" else None)
    del params
    out = eng.run(make_traffic(cfg, family))
    out["mesh"] = "none" if eng.mesh is None else eng.mesh.describe()
    return out


def compare(ref: dict, got: dict) -> list[str]:
    """Field-by-field bitwise diff of two runs' request streams."""
    errs = []
    for a, b in zip(ref["requests"], got["requests"]):
        if a.tokens != b.tokens:
            errs.append(f"request {a.rid}: tokens diverge "
                        f"({a.tokens} vs {b.tokens})")
        for name in ("H", "SE", "MI", "p_max"):
            va, vb = getattr(a, name), getattr(b, name)
            if not (len(va) == len(vb)
                    and all(x == y for x, y in zip(va, vb))):
                errs.append(f"request {a.rid}: {name} not bitwise equal")
        if (a.epistemic_flags, a.aleatoric_flags) \
                != (b.epistemic_flags, b.aleatoric_flags):
            errs.append(f"request {a.rid}: flag counts diverge")
    if len(ref["requests"]) != len(got["requests"]):
        errs.append("the runs finished different numbers of requests")
    return errs


def check(ranks: "meshlib.Ranks", families, *, entropy: str = "operand",
          decode_attn: str = "kernel", device="cuda") -> dict:
    """Every family of ``families``, unsharded here against sharded on
    ``ranks``; the JAX checker's result dict (``ok``, per family
    ``bitwise_equal`` and ``errors``)."""
    out = {"mesh": f"1x{ranks.m}", "entropy": entropy,
           "decode_attn": decode_attn, "families": {}}
    for family in families:
        kw = dict(entropy=entropy, decode_attn=decode_attn, device=device)
        ref = run_family(None, family, **kw)
        got = ranks.run(run_family, family, **kw)[0]
        errs = compare(ref, got)
        row = {"arch": FAMILIES[family], "bitwise_equal": not errs,
               "errors": errs, "gen_tokens": ref["gen_tokens"],
               "prefill_mode": ref["prefill_mode"],
               "prefix_cache_hits": ref["prefix_cache"]["hits"],
               "mesh": got["mesh"]}
        out["families"][family] = row
    out["ok"] = all(r["bitwise_equal"] for r in out["families"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default="dense,moe,hybrid,encdec",
                    help="comma list of " + ",".join(FAMILIES))
    ap.add_argument("--mesh", default="1x2",
                    help="1xM: the sharded run's ranks")
    ap.add_argument("--entropy", choices=("operand", "kernel"),
                    default="operand")
    ap.add_argument("--decode-attn", choices=("kernel", "gather"),
                    default="kernel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print a machine-readable result")
    args = ap.parse_args(argv)
    m = meshlib.parse_mesh(args.mesh)
    if m is None or m < 2:
        ap.error("--mesh needs 1xM with M >= 2")
    dev = resolve_device(args.device)   # no GPU raises before a rank starts
    torch.set_num_threads(1)              # as in the ranks (mesh._rank_main)
    with meshlib.Ranks(m, args.device) as ranks:
        out = check(ranks, args.families.split(","), entropy=args.entropy,
                    decode_attn=args.decode_attn, device=args.device)
    out["device"] = torch.cuda.get_device_name(dev) \
        if dev.type == "cuda" else "cpu"
    if args.as_json:
        print(json.dumps(out))
    else:
        for family, r in out["families"].items():
            status = "BITWISE OK" if r["bitwise_equal"] else "MISMATCH"
            print(f"{family:8s} ({r['arch']}): {status}  "
                  f"[{r['gen_tokens']} tokens, prefill={r['prefill_mode']}, "
                  f"mesh {r['mesh']}]")
            for e in r["errors"]:
                print(f"  {e}")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
