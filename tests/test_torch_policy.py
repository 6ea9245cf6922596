"""The priority policy, preempt-and-restore and the MI escalation lane in
the port, against the JAX package.

The ranking and the victim choice equal the JAX policy's on seeded
queues; the scheduler surfaces admission-time victims and fifo never
preempts at admission.  The priority engine and the escalation lane are
held against the JAX engine on the same injected operand noise: the same
slots, tokens exact, H / SE / MI / p_max within 2e-5, the same preemption
and escalation counts.  Preempt-and-restore replays the victim bit for bit
against its solo run with the pool back at identity; the layer armed but
never triggering (one class under the priority policy, escalation at
``inf``) is the fifo engine bit for bit in the dense, moe, hybrid and
encdec families (the reference's ``POLICY_FAMILIES``).

Operand noise keys the slot, so every bitwise comparison pins the
admission schedule and asserts the slots matched.
"""

import dataclasses

import numpy as np
import pytest

from _torch_parity import (dense_pair, encdec_pair, hybrid_pair,  # noqa: F401
                           jax_head_noise, meshless_reference, moe_pair)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.engine import policy as JP
from repro.launch.engine.scheduler import LIFECYCLE as J_LIFECYCLE
from repro_torch.launch.engine import (LIFECYCLE, EscalationLane,
                                       FifoPolicy, PriorityPolicy)
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.launch.engine import SlotScheduler, get_policy

# f32 tolerance of the reduced (f32) model against the JAX package
ATOL = 2e-5

PAGED = dict(max_len=32, chunk=4, kv_layout="paged", kv_block=8)


def _family(name):
    """(tcfg, port params) of a reduced family in operand mode; moe at a
    capacity factor of E / K, where no expert can overflow."""
    pair = {"dense": dense_pair, "moe": moe_pair, "hybrid": hybrid_pair,
            "encdec": encdec_pair}[name]
    _, _, tcfg, tparams = pair()
    if name == "moe":
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.num_experts / tcfg.top_k)
    return tcfg, tparams


def _prompts(n=6, size=12, seed=7):
    return np.random.default_rng(seed).integers(1, 511, size=(n, size)) \
        .astype(np.int32)


def _req(rid, prompt, n, priority=0, slo=None, arrival=0, cls=TRequest):
    return cls(rid=rid, prompt=np.asarray(prompt, np.int32),
               max_new_tokens=n, priority=priority, slo_s=slo,
               arrival_step=arrival)


def _serve(cfg, params, reqs, **kw):
    eng = TEngine(params, cfg, device="cpu", **kw)
    return eng, eng.run(reqs)


def _same_streams(ra, rb):
    assert len(ra["requests"]) == len(rb["requests"])
    for a, b in zip(ra["requests"], rb["requests"]):
        assert a.slot == b.slot, \
            f"request {a.rid} moved slot ({a.slot} vs {b.slot})"
        assert a.finish_reason == b.finish_reason
        assert a.tokens == b.tokens, a.rid
        for name in ("H", "SE", "MI", "p_max"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)),
                                          err_msg=f"{name} of {a.rid}")
        assert a.epistemic_flags == b.epistemic_flags
        assert a.aleatoric_flags == b.aleatoric_flags


def _near_jax(tr, jr):
    """The port's run against the JAX engine's: slots and tokens exact,
    the triplet and p_max within ATOL, the same lifecycle."""
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.slot == b.slot and a.tokens == b.tokens, a.rid
        assert a.finish_reason == b.finish_reason
        assert [s for s, _ in a.history] == [s for s, _ in b.history]
        for name in ("H", "SE", "MI", "p_max"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=f"{name} {a.rid}")


def _balanced(eng):
    alloc = eng._last_alloc
    assert alloc.in_use == 0 and alloc._reserved == 0
    assert sorted(alloc._free) == list(range(alloc.num_blocks))


# ---------------------------------------------------------------------------
# the lifecycle and the policies (host only)
# ---------------------------------------------------------------------------

def test_lifecycle_equals_the_jax_lifecycle():
    assert LIFECYCLE == J_LIFECYCLE
    r = _req(0, [1], 2)
    for to in ("queued", "prefilling", "decoding", "escalated", "finished"):
        r.transition(to)
    assert r.was_escalated and not _req(1, [1], 2).was_escalated
    with pytest.raises(ValueError, match="illegal lifecycle"):
        _req(2, [1], 2).transition("escalated")


def test_get_policy_resolves_and_rejects():
    cfg, params = _family("dense")
    assert isinstance(get_policy("fifo"), FifoPolicy)
    assert isinstance(get_policy("priority"), PriorityPolicy)
    assert get_policy("priority") is not get_policy("priority")
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        get_policy("round_robin")
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        TEngine(params, cfg, device="cpu", num_slots=1, max_len=32,
                policy="lifo")


def test_priority_select_class_then_deadline_then_seq():
    p = PriorityPolicy()
    a = _req(0, [1], 2, priority=2)
    b = _req(1, [1], 2, priority=0, slo=10.0)
    c = _req(2, [1], 2, priority=0, slo=1.0)
    d = _req(3, [1], 2, priority=0)           # no SLO: deadline inf
    for seq, r in enumerate((a, b, c, d)):
        r.seq, r.t_submit = seq, 100.0
    assert p.select([a, b, c, d]) == 2        # best class, earliest deadline
    assert p.select([a, b, d]) == 1           # a finite deadline beats none
    assert p.select([a, d]) == 1              # class beats order
    e = _req(4, [1], 2, priority=0)
    e.seq, e.t_submit = 9, 100.0
    assert p.select([d, e]) == 0              # equal keys: submission order
    assert p.select([]) is None


def test_priority_victim_takes_strictly_worse_classes_only():
    p = PriorityPolicy()
    cand = _req(0, [1], 2, priority=1)
    peer = _req(1, [1], 2, priority=1)
    worse = _req(2, [1], 2, priority=3)
    cheap = _req(3, [1], 2, priority=3)
    worse.tokens, cheap.tokens = [1, 2, 3], [1]   # cheap: the shorter replay
    worse.seq, cheap.seq = 0, 1
    assert p.victim(cand, [(0, peer)]) is None    # never a peer
    assert p.victim(cand, [(0, peer), (1, worse), (2, cheap)]) == 2
    assert p.victim(_req(4, [1], 2, priority=0), [(0, cand)]) == 0
    assert FifoPolicy().victim(cand, [(0, worse)]) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranking_and_victims_equal_the_jax_policy(seed):
    """Seeded queues of mixed classes, deadlines, submission times and
    output lengths: ``select`` and ``victim`` pick what the JAX policy
    picks."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 8))
        rows = [(int(rng.integers(0, 4)),
                 None if rng.random() < 0.4 else float(rng.random()),
                 float(rng.random()), int(rng.integers(0, 5)))
                for _ in range(n)]

        def build(cls):
            out = []
            for i, (prio, slo, t, ntok) in enumerate(rows):
                r = _req(i, [1], 8, priority=prio, slo=slo, cls=cls)
                r.seq, r.t_submit, r.tokens = i, t, [0] * ntok
                out.append(r)
            return out

        tq, jq = build(TRequest), build(JRequest)
        assert PriorityPolicy().select(tq) == JP.PriorityPolicy().select(jq)
        c = int(rng.integers(0, n))
        assert PriorityPolicy().victim(tq[c], list(enumerate(tq))) \
            == JP.PriorityPolicy().victim(jq[c], list(enumerate(jq)))


def test_take_preempted_surfaces_the_victims():
    s = SlotScheduler(1, policy=get_policy("priority"))
    lo = _req(0, [1, 2], 4, priority=2)
    s.submit(lo)
    [(slot, req)] = s.admit()
    assert (slot, req.rid) == (0, 0)
    req.transition("decoding")
    s.submit(_req(1, [1], 4, priority=0))
    placed = s.admit()
    assert [(sl, r.rid) for sl, r in placed] == [(0, 1)]
    assert [(sl, r.rid) for sl, r in s.take_preempted()] == [(0, 0)]
    assert s.take_preempted() == []           # drained
    assert s.preemptions == 1
    assert lo.state == "queued" and lo.preempt_count == 1
    # a prefilling slot is never offered: the better class waits
    s.submit(_req(2, [1], 4, priority=-1))
    assert s.admit() == [] and s.take_preempted() == []


def test_fifo_never_preempts_at_admission():
    s = SlotScheduler(1)
    s.submit(_req(0, [1, 2], 4, priority=9))
    [(_, req)] = s.admit()
    req.transition("decoding")
    s.submit(_req(1, [1], 4, priority=0))
    assert s.admit() == []
    assert s.take_preempted() == [] and s.preemptions == 0


def test_priority_preempts_for_pool_pressure():
    """A pool too short for the better class's prompt: the policy frees a
    worse decoding slot's blocks, and the admission retries."""
    from repro_torch.launch.engine import BlockAllocator
    alloc = BlockAllocator(4, 4)
    s = SlotScheduler(2, allocator=alloc, table_width=4, watermark=0,
                      policy=get_policy("priority"))
    s.submit(_req(0, list(range(1, 13)), 4, priority=2))   # 3 blocks
    [(slot, lo)] = s.admit()
    lo.transition("decoding")
    s.submit(_req(1, list(range(1, 9)), 4, priority=0))    # 2 blocks
    placed = s.admit()
    assert [(sl, r.rid) for sl, r in placed] == [(0, 1)]
    assert [(sl, r.rid) for sl, r in s.take_preempted()] == [(0, 0)]
    assert alloc.in_use == 2 and lo.state == "queued"


# ---------------------------------------------------------------------------
# the priority engine
# ---------------------------------------------------------------------------

def _burst(cls=TRequest):
    # four class-2 requests fill two slots; a class-0 arrival at step 4
    # preempts the cheaper decoding one, a second at 12 the next
    p = _prompts()
    reqs = [_req(i, p[i][:(12 if i % 2 == 0 else 8)], 8, priority=2,
                 cls=cls) for i in range(4)]
    reqs += [_req(4, p[4][:8], 4, priority=0, slo=0.5, arrival=4, cls=cls),
             _req(5, p[5][:8], 4, priority=0, arrival=12, cls=cls)]
    return reqs


@pytest.mark.parametrize("prefill", ["batch", "chunked"])
def test_priority_engine_matches_the_jax_engine(prefill):
    """The burst under the priority policy, the port against the JAX
    engine with the JAX xi injected: slots and tokens exact, H / SE / MI /
    p_max within 2e-5, the same lifecycles and preemptions by class."""
    jcfg, jparams, tcfg, tparams = dense_pair()
    kw = dict(PAGED, num_slots=2, policy="priority", prefill_mode=prefill,
              prefill_chunk=8)
    eng, tr = _serve(tcfg, tparams, _burst(), head_noise=jax_head_noise(),
                     **kw)
    jr = JEngine(jparams, jcfg, **kw).run(_burst(JRequest))
    _near_jax(tr, jr)
    assert tr["preemptions"] == jr["preemptions"] >= 1
    assert {c: v["preemptions"] for c, v in tr["per_class"].items()} \
        == {c: v["preemptions"] for c, v in jr["per_class"].items()}
    assert tr["policy"] == "priority"
    assert all(len(r.tokens) == r.max_new_tokens for r in tr["requests"])
    assert tr["sched_trace"] == jr["sched_trace"]
    _balanced(eng)


def test_high_priority_skips_the_queue():
    cfg, params = _family("dense")
    p = _prompts()
    reqs = [_req(i, p[i], 6, priority=2) for i in range(4)]
    hi = _req(4, p[4], 6, priority=0)
    _, res = _serve(cfg, params, reqs + [hi], num_slots=2, max_len=32,
                    chunk=4, policy="priority")
    assert hi.slot == 0                       # the first placement
    assert hi.t_finish < max(r.t_finish for r in reqs)
    assert res["per_class"][0]["num_requests"] == 1


@pytest.mark.parametrize("prefill", ["batch", "chunked"])
def test_preempt_and_restore_is_bitwise_with_pool_identity(prefill):
    """A class-0 arrival preempts the only (class-2, decoding) slot; the
    victim replays from its prompt into the same slot: its stream and the
    class-0 stream equal their solo runs bit for bit, and every block is
    free after the drain."""
    cfg, params = _family("dense")
    p = _prompts()
    kw = dict(PAGED, num_slots=1, prefill_mode=prefill, prefill_chunk=8)
    _, r_lo = _serve(cfg, params, [_req(0, p[0], 8)], **kw)
    _, r_hi = _serve(cfg, params, [_req(1, p[1][:8], 4)], **kw)
    lo = _req(0, p[0], 8, priority=2)
    hi = _req(1, p[1][:8], 4, priority=0, arrival=4)
    eng, res = _serve(cfg, params, [lo, hi], **kw, policy="priority")
    assert res["preemptions"] == 1 and lo.preempt_count == 1
    assert lo.slot == hi.slot == 0
    assert [s for s, _ in lo.history].count("preempted") == 1
    _same_streams(r_lo, {"requests": [lo]})
    _same_streams(r_hi, {"requests": [hi]})
    assert res["per_class"][2]["preemptions"] == 1
    _balanced(eng)


def test_a_victim_left_in_the_carry_fails_the_run(monkeypatch):
    """Take the victims' surfacing away: the preempted slot stays in the
    decode set while the new occupant prefills, and the run raises; the
    pool still balances."""
    from repro_torch.launch.engine import scheduler as TS
    cfg, params = _family("dense")
    p = _prompts()

    def hidden(self):
        self._admit_preempted = []
        return []

    monkeypatch.setattr(TS.SlotScheduler, "take_preempted", hidden)
    eng = TEngine(params, cfg, device="cpu", **PAGED, num_slots=1,
                  prefill_mode="chunked", prefill_chunk=8,
                  policy="priority")
    with pytest.raises(RuntimeError, match="left in the carry"):
        eng.run([_req(0, p[0], 8, priority=2),
                 _req(1, p[1][:8], 4, priority=0, arrival=4)])
    assert eng._last_alloc.in_use == 0 and not eng._last_alloc._reserved


INERT = {"priority": dict(policy="priority"),
         "escalate_inf": dict(escalate_mi=float("inf"))}


@pytest.mark.parametrize("armed", sorted(INERT))
@pytest.mark.parametrize("family", ["dense", "encdec", "hybrid", "moe"])
def test_inert_layer_is_fifo_bit_for_bit(family, armed):
    """Priority over one class, or escalation armed at ``inf``: the fifo
    engine's streams bit for bit through queue churn (paged, two slots,
    staggered prompts), with no preemption and no escalation."""
    cfg, params = _family(family)
    p = _prompts()
    mk = lambda: [_req(i, p[i][:(12 if i % 2 == 0 else 8)], 6)  # noqa: E731
                  for i in range(4)]
    kw = dict(PAGED, num_slots=2, max_len=24)
    _, r_fifo = _serve(cfg, params, mk(), **kw)
    eng, r_armed = _serve(cfg, params, mk(), **kw, **INERT[armed])
    _same_streams(r_fifo, r_armed)
    assert r_armed["preemptions"] == 0
    assert r_armed["escalation"]["escalations"] == 0
    assert r_armed["escalation"]["enabled"] == (armed == "escalate_inf")
    assert r_armed["policy"] == INERT[armed].get("policy", "fifo")


def test_uniform_priority_with_prefix_cache_and_chunks_is_fifo():
    """One class under the priority policy through prefix-cache hits with
    copy-on-write and chunked prefill: the fifo run bit for bit."""
    cfg, params = _family("dense")
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 511, size=20)
    tails = rng.integers(1, 511, size=(5, 8))
    mk = lambda: [_req(i, np.concatenate([shared, tails[i]]), 6)  # noqa
                  for i in range(5)]
    kw = dict(PAGED, num_slots=2, max_len=48, prefix_cache=True,
              prefill_mode="chunked", prefill_chunk=16)
    _, r_fifo = _serve(cfg, params, mk(), **kw)
    _, r_prio = _serve(cfg, params, mk(), **kw, policy="priority")
    _same_streams(r_fifo, r_prio)
    assert r_fifo["prefix_cache"]["cow_copies"] > 0
    assert r_prio["preemptions"] == 0


# ---------------------------------------------------------------------------
# the escalation lane
# ---------------------------------------------------------------------------

def _wave(cls=TRequest):
    p = _prompts()
    return [_req(i, p[i], 8, priority=i % 2, cls=cls) for i in range(3)]


def _threshold(base_runs) -> float:
    """A threshold at request 0's first chunk-end MI in the JAX baseline,
    moved below it by half the gap to the next lower chunk-end MI of
    either baseline, so that port and JAX (within ATOL) flag the same
    requests."""
    ends = sorted(float(r.MI[3]) for run in base_runs for r in run)
    top = float(base_runs[1][0].MI[3])
    lower = [m for m in ends if m < top - 10 * ATOL]
    gap = top - max(lower) if lower else top
    assert gap > 10 * ATOL
    return top - gap / 2


def test_escalation_lane_matches_the_jax_lane():
    """Request 0's carried MI after the first chunk reaches the threshold
    in both engines: it leaves the main pool and the lane finishes it at
    4 S.  Against the JAX engine's lane on the same injected noise:
    tokens exact, the triplet within 2e-5, and the same escalations, by
    class, lane tokens and skipped requests."""
    jcfg, jparams, tcfg, tparams = dense_pair()
    kw = dict(PAGED, num_slots=3)
    t_base = _wave()
    _serve(tcfg, tparams, t_base, head_noise=jax_head_noise(), **kw)
    j_base = _wave(JRequest)
    JEngine(jparams, jcfg, **kw).run(j_base)
    thr = _threshold([t_base, j_base])
    esc = dict(escalate_mi=thr, escalate_s=4 * tcfg.mc_samples)
    eng, tr = _serve(tcfg, tparams, _wave(), head_noise=jax_head_noise(),
                     **kw, **esc)
    jr = JEngine(jparams, jcfg, **kw, **esc).run(_wave(JRequest))
    _near_jax(tr, jr)
    keys = ("escalations", "by_class", "tokens", "skipped_too_long",
            "steps", "verify_samples", "enabled", "mi_threshold")
    assert {k: tr["escalation"][k] for k in keys} \
        == {k: jr["escalation"][k] for k in keys}
    assert tr["escalation"]["escalations"] >= 1
    assert tr["requests"][0].was_escalated
    assert {c: v["escalations"] for c, v in tr["per_class"].items()} \
        == {c: v["escalations"] for c, v in jr["per_class"].items()}
    for r in tr["requests"]:
        assert r.state == "finished" and len(r.tokens) == 8
    assert set(eng._esc_runners) == {4 * tcfg.mc_samples}
    _balanced(eng)


def test_escalation_runner_is_cached_per_s():
    cfg, params = _family("dense")
    eng = TEngine(params, cfg, device="cpu", num_slots=2, max_len=32,
                  chunk=4, kv_layout="paged", decode_attn="kernel")
    r8 = eng.escalation_runner(8)
    assert eng.escalation_runner(8) is r8
    r16 = eng.escalation_runner(16)
    assert r16 is not r8 and set(eng._esc_runners) == {8, 16}
    assert (r8.cfg.mc_samples, r16.cfg.mc_samples) == (8, 16)
    assert r8.kv_layout == "dense" and r8.num_slots == 1
    assert r8.cfg.decode_attn == "gather"
    # the engine's own parameter tensors, not a copy
    assert r8.params is eng.params
    lane = EscalationLane(r8, chunk=4)
    assert lane.max_len == 32 and not lane.has_work()


def test_too_long_request_skips_the_lane_once():
    """Prompt + budget beyond the lane's max_len: the request keeps
    decoding in the main paged engine (whose table spans 3 blocks of 8,
    24 tokens), counted once."""
    cfg, params = _family("dense")
    req = _req(0, _prompts()[0], 8)           # 12 + 8 > max_len 18
    _, res = _serve(cfg, params, [req], num_slots=1, max_len=18, chunk=4,
                    kv_layout="paged", kv_block=8, kv_blocks=3,
                    escalate_mi=0.0)          # every carried MI triggers
    esc = res["escalation"]
    assert esc["escalations"] == 0 and esc["skipped_too_long"] == 1
    assert not req.was_escalated
    assert len(req.tokens) == 8 and req.state == "finished"


def test_escalation_inside_a_speculative_round():
    """Speculation on every iteration (the gate open and each request's
    carried MI below it from the start, so no plain chunk runs) and
    escalation at 0: each request escalates after its first round, the
    evicted slots take their rejected tails' blocks with them, the lane
    finishes every request, and the pool balances."""
    cfg, params = _family("dense")
    p = _prompts()
    reqs = [_req(i, p[i], 8, priority=i % 2) for i in range(4)]
    for r in reqs:
        r.last_mi = 0.0
    eng, res = _serve(cfg, params, reqs, **PAGED, num_slots=2,
                      spec_decode=True, spec_k=3,
                      spec_mi_threshold=float("inf"), escalate_mi=0.0)
    assert res["chunks_run"] == 0 and res["spec_decode"]["rounds"] > 0
    esc = res["escalation"]
    assert esc["escalations"] == 4 and esc["by_class"] == {0: 2, 1: 2}
    assert esc["tokens"] == sum(len(r.tokens) for r in reqs) \
        - res["spec_decode"]["emitted"]
    for r in reqs:
        assert r.was_escalated and r.state == "finished"
        assert len(r.tokens) == 8
    _balanced(eng)
    assert not bool(eng.runner.active.any())


def test_engine_validates_the_escalation_knobs():
    cfg, params = _family("dense")
    kw = dict(device="cpu", num_slots=1, max_len=32, chunk=4)
    with pytest.raises(ValueError, match="escalate_mi"):
        TEngine(params, cfg, escalate_mi=-0.1, **kw)
    with pytest.raises(ValueError, match="escalate_s"):
        TEngine(params, cfg, escalate_s=0, **kw)
    eng = TEngine(params, cfg, **kw)
    assert eng.escalate_s == 4 * cfg.mc_samples and eng.escalate_mi is None
