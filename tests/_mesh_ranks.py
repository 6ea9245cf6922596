"""What the mesh tests run inside the spawned ranks.

``launch.mesh.Ranks.run`` pickles a function by its import path, so the
functions a rank runs live here, in a module the ranks can import (the
test process's ``sys.path`` travels to a spawned child).  It imports
torch and the port only: a rank loads no JAX.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.launch.engine import mesh_check as MC
from repro_torch.launch.engine import scheduler
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.sharding.partition import gather_rep, serve_dims, shard_params


class TableNoise:
    """An operand-noise provider from a (slots, depths, S, V) table of
    another implementation's xi: column b of a step's (S, B, V) xi is
    ``table[b, cache_len[b]]``, which is what a (slot, depth)-keyed
    provider gives.  ``samples``: {sample count: table} of the draws
    taken at other sample counts (a speculative draft head's, the
    escalation lane's): another implementation's stream of one S need
    not be the first rows of another's.  Picklable, so that a rank can
    draw it."""

    def __init__(self, table, samples=None):
        self.table = torch.as_tensor(table)
        self.samples = {s: torch.as_tensor(t)
                        for s, t in (samples or {}).items()}

    def __call__(self, seed, cache_len, num_samples, vocab):
        table = self.samples.get(num_samples, self.table)
        slots = torch.arange(cache_len.shape[0])
        xi = table[slots, cache_len.long().cpu()]                # (B, S, V)
        return xi[:, :num_samples, :vocab].transpose(0, 1).contiguous() \
            .to(cache_len.device)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def gathered_params(tp, family: str) -> list[str]:
    """The leaves of ``family``'s parameters that ``shard_params`` then
    ``gather_rep`` along each leaf's axis do NOT give back bit for bit
    (empty: all do), beside the count of sharded leaves."""
    cfg = MC.family_config(family)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), tp.device)
    dims = serve_dims(params, tp.size)
    mine = shard_params(params, tp.rank, tp.size, dims)
    bad, sharded = [], 0
    for (path, full), (_, part), (_, d) in zip(_leaves(params), _leaves(mine),
                                               _leaves(dims)):
        if d is None:
            if part is not full:
                bad.append(f"{path}: a replicated leaf was copied")
            continue
        sharded += 1
        if not torch.equal(gather_rep(part, tp, dim=d), full):
            bad.append(path)
    return bad + [f"sharded {sharded}"]


def served_heads(tp, family: str, entropy: str = "operand") -> dict:
    """``family``'s traffic through this rank's engine with the paged
    kernels' entry points recorded: for each call the kv heads of the
    pool it was given and the head count it takes its split from, and
    how many gather reads (``layers.decode_attention``) ran; plus the
    rank's parameter and KV leaf shapes."""
    seen = {"decode": set(), "prefill": set(), "gather_reads": 0}
    decode, prefill, gather = (ops.paged_decode_attention,
                               ops.paged_prefill_attention,
                               L.decode_attention)

    def dec(q, kp, vp, table, lens, kv_heads=None):
        seen["decode"].add((kp.shape[2], kv_heads))
        return decode(q, kp, vp, table, lens, kv_heads=kv_heads)

    def pre(q, kp, *args, **kw):
        seen["prefill"].add(kp.shape[2])
        return prefill(q, kp, *args, **kw)

    def read(*args):
        seen["gather_reads"] += 1
        return gather(*args)

    ops.paged_decode_attention = dec
    ops.paged_prefill_attention = pre
    L.decode_attention = read
    try:
        out = MC.run_family(tp, family, entropy=entropy)
    finally:
        ops.paged_decode_attention = decode
        ops.paged_prefill_attention = prefill
        L.decode_attention = gather
    return {"decode": sorted(seen["decode"]),
            "prefill": sorted(seen["prefill"]),
            "gather_reads": seen["gather_reads"],
            "gen_tokens": out["gen_tokens"], "mesh": out["mesh"]}


def rank_layout(tp, family: str, entropy: str = "operand") -> dict:
    """Shapes of this rank's runner parameters and cache leaves."""
    cfg = MC.family_config(family, entropy)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), tp.device)
    eng = MC.ServeEngine(params, cfg, **MC.ENGINE, device=tp.device,
                         decode_attn="kernel", mesh=tp)
    return {"params": {p: tuple(t.shape) for p, t in
                       _leaves(eng.runner.params)},
            "cache": {n: tuple(t.shape) for n, t in
                      eng.runner.cache.items()}}


def loaded(tp, prefixes=("jax", "repro")) -> list[str]:
    """The modules named by ``prefixes`` (or under them) that this rank
    has imported."""
    return sorted(m for m in sys.modules
                  if any(m == p or m.startswith(p + ".") for p in prefixes))


def engine_features(tp) -> dict:
    """Under a rank's mesh handle: the engine builds with speculative
    decoding and with the escalation lane; the lane's runner holds the
    main runner's parameter tensors (the same storage, no second share);
    the priority policy serves requests with SLO deadlines; an empty
    prompt still raises ``ValueError`` before anything is served."""
    cfg = MC.family_config("dense")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), tp.device)
    kw = dict(num_slots=2, max_len=16, device=tp.device, mesh=tp)
    spec = ServeEngine(params, cfg, spec_decode=True, **kw)
    lane = ServeEngine(params, cfg, escalate_mi=0.5, **kw)
    shares = MC.shares_storage(lane.escalation_runner(lane.escalate_s).params,
                               lane.runner.params)
    eng = ServeEngine(params, cfg, policy="priority", **kw)
    prompt = np.arange(4, dtype=np.int32)
    r = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=2),
                 Request(rid=1, prompt=prompt, max_new_tokens=2,
                         slo_s=0.1)])
    try:
        eng.run([Request(rid=0, prompt=prompt[:0], max_new_tokens=2)])
        empty = "served"
    except ValueError as e:
        empty = str(e)
    return {"spec": spec.spec_decode and spec.runner.spec_k_max,
            "lane_shares": shares, "slo_tokens": r["gen_tokens"],
            "empty": empty}


def reversed_clock() -> float:
    """A clock that runs backwards: a later submission stamps earlier."""
    return -time.perf_counter()


# one class, every request with the same SLO: the deadlines order the
# queue exactly as the submission stamps do.  Two long requests hold both
# slots while requests 2 and 3 arrive in two waves and queue
CLOCK_GENS = (12, 12, 4, 4)
CLOCK_ARRIVALS = (0, 0, 4, 8)


def clock_run(tp, skewed=()) -> dict:
    """The dense engine under the priority policy on ``CLOCK_*``'s traffic
    (``tp`` None: unsharded); the ranks in ``skewed`` (rank 0 where
    unsharded) stamp by ``reversed_clock``.  Returns the admission order
    (as ``SlotScheduler.admit`` placed the requests: a skewed clock's
    stamps do not sort), each request's slot and its streams."""
    cfg = MC.family_config("dense")
    dev = torch.device("cpu") if tp is None else tp.device
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    reqs = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=g,
                    priority=0, slo_s=1.0, arrival_step=a)
            for r, g, a in zip(MC.make_traffic(cfg, "dense"), CLOCK_GENS,
                               CLOCK_ARRIVALS)]
    eng = ServeEngine(params, cfg, **MC.ENGINE, decode_attn="kernel",
                      device=dev, mesh=tp, policy="priority")
    own, admit, placed = scheduler.clock, scheduler.SlotScheduler.admit, []

    def logged(sched):
        out = admit(sched)
        placed.extend(r.rid for _, r in out)
        return out

    if (0 if tp is None else tp.rank) in skewed:
        scheduler.clock = reversed_clock
    scheduler.SlotScheduler.admit = logged
    try:
        out = eng.run(reqs)
    finally:
        scheduler.clock = own
        scheduler.SlotScheduler.admit = admit
    return {"admissions": placed,
            "slots": [r.slot for r in out["requests"]],
            "streams": [(r.tokens, r.H, r.SE, r.MI, r.p_max)
                        for r in out["requests"]]}


def lane_heads(tp) -> dict:
    """The heads the escalation lane attends under a rank's mesh handle,
    beside the main runner's: whether each runs on the rank's own kv
    heads (``layers.heads_local``) and the kv heads its cache holds."""
    cfg = MC.family_config("dense")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), tp.device)
    eng = ServeEngine(params, cfg, escalate_mi=0.5, num_slots=2, max_len=16,
                      device=tp.device, mesh=tp)
    lane = eng.escalation_runner(eng.escalate_s)
    return {"main_local": L.heads_local(cfg, eng.runner.tp),
            "lane_local": L.heads_local(cfg, lane.tp),
            "main_kv_heads": eng.runner.cache["k"].shape[-2],
            "lane_kv_heads": lane.cache["k"].shape[-2]}
