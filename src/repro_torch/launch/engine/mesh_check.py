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

Three serving features can be armed, on both runs alike: ``--spec``
(uncertainty-gated speculative decoding, operand entropy, the gate open,
k 3; ``check`` takes any spec keywords, the adaptive depth's too),
``--escalate-mi`` (the escalation lane at
``--escalate-s`` samples; ``auto`` takes phase 15's rule, the upper
quartile of the MI an unsharded fifo run carries at its chunk ends) and
``--policy priority`` (the traffic then takes priority classes, SLO
deadlines and arrivals mid-run, so that a class-0 arrival preempts and
deadlines order a class).  Beside the streams, every rank's schedule is
held to the unsharded run's: the admission order, the preemptions, the
escalated requests and the lane's tokens, the spec rounds, drafts,
acceptances and rollbacks.  With ``--spec`` alone the streams are also held,
bit for bit, to the unsharded engine with speculation off, request by
request where a request kept its slot (``same_slot``; the first wave
always does); with the lane or the priority policy armed too, a hand-off
or an arrival falls at another token than without speculation, so spec
off is not held.

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
      [--entropy kernel] [--spec] \\
      [--escalate-mi auto [--escalate-s 16]] [--policy priority] [--json]

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

# ``--policy priority``'s traffic: a class-0 request arriving at step 4
# preempts a class-2 decoder, a second at step 8; request 3's SLO puts it
# ahead of the requeued victim, and inside class 2 deadlines order the
# queue (``None``: no SLO)
PRIORITIES = (2, 2, 0, 2, 0)
SLOS = (None, 5.0, 0.5, 0.01, 0.5)
ARRIVALS = (0, 0, 4, 4, 8)

# ``--spec``: the gate open, so every decoding slot drafts from its second
# token on
SPEC = dict(spec_decode=True, spec_k=3, spec_mi_threshold=float("inf"))


def family_config(family: str, entropy: str = "operand"):
    """The reduced config of ``family``'s arch in ``entropy`` mode; dense
    with 2 kv heads (see the module docstring)."""
    cfg = dataclasses.replace(reduced(get_config(FAMILIES[family])),
                              head_entropy=entropy)
    if family == "dense":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    return cfg


def make_traffic(cfg, family: str, policy: str = "fifo") -> list[Request]:
    """The staggered traffic (``PROMPTS``, ``GENS``); under ``policy``
    "priority" with ``PRIORITIES``, ``SLOS`` and ``ARRIVALS``."""
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
        kw = {}
        if policy == "priority":
            kw = dict(priority=PRIORITIES[i], slo_s=SLOS[i],
                      arrival_step=ARRIVALS[i])
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=g, **kw))
    return reqs


def run_family(tp, family: str, *, entropy: str = "operand",
               decode_attn: str = "kernel", device="cuda", params=None,
               head_noise=None, features=None) -> dict:
    """``family``'s traffic through one engine: unsharded with ``tp`` None,
    else as this rank of the mesh.  ``params``: a numpy parameter tree in
    the JAX package's layout (``registry.params_from_numpy``), else random
    weights from seed 0 (the same on every rank).  ``head_noise``: an
    operand-noise provider.  ``features``: ``ServeEngine`` keywords that
    arm the serving features (``SPEC``, ``escalate_mi`` / ``escalate_s``,
    ``policy``; the priority policy serves its own traffic).  Returns the
    engine's result, with ``mesh`` set and the lane's parameters'
    storage compared with the main runner's (``lane_shares_params``,
    None without a lane)."""
    features = dict(features or {})
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
        entropy=KernelEntropy(seed=0) if entropy == "kernel" else None,
        **features)
    del params
    out = eng.run(make_traffic(cfg, family, features.get("policy", "fifo")))
    out["mesh"] = "none" if eng.mesh is None else eng.mesh.describe()
    out["lane_shares_params"] = None
    if eng.escalate_mi is not None:
        out["lane_shares_params"] = shares_storage(
            eng.escalation_runner(eng.escalate_s).params, eng.runner.params)
    return out


def shares_storage(a: dict, b: dict) -> bool:
    """Whether two parameter trees hold the same tensors: every leaf at the
    same address (``data_ptr``) with the same shape."""
    if a.keys() != b.keys():
        return False
    return all(shares_storage(a[k], b[k]) if isinstance(a[k], dict)
               else (a[k].data_ptr(), a[k].shape)
               == (b[k].data_ptr(), b[k].shape) for k in a)


def admissions(result: dict) -> list[int]:
    """The order in which the run admitted requests (a preempted request
    again at its replay), by each request's lifecycle stamps."""
    return [rid for _, rid in sorted(
        (t, r.rid) for r in result["requests"]
        for state, t in r.history if state == "prefilling")]


SPEC_KEYS = ("rounds", "drafted", "accepted", "emitted", "rollbacks",
             "gated_slot_rounds", "full_model_calls", "k_up", "k_down")
LANE_KEYS = ("escalations", "by_class", "tokens", "steps",
             "skipped_too_long")


def schedule(result: dict) -> dict:
    """What a run decided, beside its streams: the admission order, the
    preemptions, the escalated requests, the lane's and the speculative
    rounds' counts."""
    return {"admissions": admissions(result),
            "slots": [r.slot for r in result["requests"]],
            "preemptions": result["preemptions"],
            "escalated": [r.rid for r in result["requests"]
                          if r.was_escalated],
            "lane": {k: result["escalation"][k] for k in LANE_KEYS},
            "spec": {k: result["spec_decode"][k] for k in SPEC_KEYS}}


def same_slot(ref: dict, got: dict) -> list[tuple]:
    """The request pairs of two runs that were served in the same slot:
    operand noise keys the slot, so only these can stream alike when the
    schedules differ (speculation moves finish times, and with them the
    slot a later request takes)."""
    return [(a, b) for a, b in zip(ref["requests"], got["requests"])
            if a.slot == b.slot]


def compare(ref: dict, got: dict, *, with_schedule: bool = True
            ) -> list[str]:
    """Field-by-field bitwise diff of two runs' request streams and their
    schedules (``schedule``); without ``with_schedule``, of the streams
    of the requests that kept their slot (``same_slot``)."""
    errs = []
    pairs = list(zip(ref["requests"], got["requests"]))
    if with_schedule:
        want, have = schedule(ref), schedule(got)
        errs += [f"{key} differ ({want[key]} vs {have[key]})"
                 for key in want if want[key] != have[key]]
    else:
        pairs = same_slot(ref, got)
    for a, b in pairs:
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


def lane_threshold(result: dict, chunk: int) -> tuple[float, list]:
    """The escalation rule of ``chip_smoke.py``'s phases 15 and 17: the
    upper quartile of the MI that a fifo run's requests carried at their
    chunk ends (each one's unfinished chunks); and those MIs."""
    ends = [m for r in result["requests"]
            for m in r.MI[chunk - 1:len(r.MI) - 1:chunk]]
    return float(np.quantile(ends, 0.75)), ends


def check(ranks: "meshlib.Ranks", families, *, entropy: str = "operand",
          decode_attn: str = "kernel", device="cuda", features=None) -> dict:
    """Every family of ``families``, unsharded here against sharded on
    ``ranks``, every rank held; the JAX checker's result dict (``ok``,
    per family ``bitwise_equal`` and ``errors``) with each run's
    schedule.  ``features`` as ``run_family``'s; ``escalate_mi`` "auto"
    takes ``lane_threshold`` of an unsharded fifo run, and where
    speculation is the one feature armed the run is also held to the
    unsharded run without it."""
    features = dict(features or {})
    out = {"mesh": f"1x{ranks.m}", "entropy": entropy,
           "decode_attn": decode_attn, "families": {},
           "features": features}
    for family in families:
        kw = dict(entropy=entropy, decode_attn=decode_attn, device=device)
        armed = dict(features)
        if armed.get("escalate_mi") == "auto":
            base = run_family(None, family, **kw)
            armed["escalate_mi"] = lane_threshold(base, ENGINE["chunk"])[0]
        ref = run_family(None, family, **kw, features=armed)
        errs, kept = [], None
        # spec off is comparable only with speculation the one feature:
        # the lane's hand-offs and the arrivals the priority policy ranks
        # fall at chunk or round ends, which speculation moves
        alone = armed.get("escalate_mi") is None \
            and armed.get("policy", "fifo") == "fifo"
        if armed.get("spec_decode") and alone:
            plain = {k: v for k, v in armed.items()
                     if not k.startswith("spec_")}
            off = run_family(None, family, **kw, features=plain)
            errs += [f"unsharded spec on vs off: {e}" for e in
                     compare(off, ref, with_schedule=False)]
            kept = [a.rid for a, _ in same_slot(off, ref)]
        gots = ranks.run(run_family, family, **kw, features=armed)
        for rank, got in enumerate(gots):
            errs += [f"rank {rank}: {e}" for e in compare(ref, got)]
            if got["lane_shares_params"] is False:
                errs.append(f"rank {rank}: the lane's parameters are a "
                            "second copy")
        row = {"arch": FAMILIES[family], "bitwise_equal": not errs,
               "errors": errs, "gen_tokens": ref["gen_tokens"],
               "prefill_mode": ref["prefill_mode"],
               "prefix_cache_hits": ref["prefix_cache"]["hits"],
               "mesh": gots[0]["mesh"], "schedule": schedule(ref),
               "escalate_mi": armed.get("escalate_mi"),
               "spec_off_held": kept,
               "lane_shares_params": gots[0]["lane_shares_params"]}
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
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding on (operand entropy, k 3), "
                         "the gate open; also held to spec off")
    ap.add_argument("--escalate-mi", default=None,
                    help="arm the escalation lane at this MI, or 'auto': "
                         "the upper quartile of an unsharded fifo run's "
                         "chunk-end MI")
    ap.add_argument("--escalate-s", type=int, default=None,
                    help="the lane's head samples (default 4x S)")
    ap.add_argument("--policy", choices=("fifo", "priority"),
                    default="fifo",
                    help="'priority' serves classes, SLO deadlines and "
                         "mid-run arrivals")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print a machine-readable result")
    args = ap.parse_args(argv)
    m = meshlib.parse_mesh(args.mesh)
    if m is None or m < 2:
        ap.error("--mesh needs 1xM with M >= 2")
    features = {"policy": args.policy}
    if args.spec:
        if args.entropy != "operand":
            ap.error("--spec needs --entropy operand")
        features.update(SPEC)
    if args.escalate_mi is not None:
        features.update(escalate_mi=args.escalate_mi if args.escalate_mi
                        == "auto" else float(args.escalate_mi),
                        escalate_s=args.escalate_s)
    dev = resolve_device(args.device)   # no GPU raises before a rank starts
    torch.set_num_threads(1)              # as in the ranks (mesh._rank_main)
    with meshlib.Ranks(m, args.device) as ranks:
        out = check(ranks, args.families.split(","), entropy=args.entropy,
                    decode_attn=args.decode_attn, device=args.device,
                    features=features)
    out["device"] = torch.cuda.get_device_name(dev) \
        if dev.type == "cuda" else "cpu"
    if args.as_json:
        print(json.dumps(out))
    else:
        for family, r in out["families"].items():
            status = "BITWISE OK" if r["bitwise_equal"] else "MISMATCH"
            sc = r["schedule"]
            print(f"{family:8s} ({r['arch']}): {status}  "
                  f"[{r['gen_tokens']} tokens, prefill={r['prefill_mode']}, "
                  f"mesh {r['mesh']}; admissions {sc['admissions']}, "
                  f"{sc['preemptions']} preemptions, escalated "
                  f"{sc['escalated']}, spec rounds {sc['spec']['rounds']} "
                  f"({sc['spec']['accepted']}/{sc['spec']['drafted']} "
                  f"accepted, {sc['spec']['rollbacks']} rollbacks)"
                  + ("" if r["spec_off_held"] is None else
                     f"; requests {r['spec_off_held']} held to spec off")
                  + "]")
            for e in r["errors"]:
                print(f"  {e}")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
