"""Uncertainty-gated speculative decoding in the port: the lossless
contract, and the port against the JAX engine.

In operand-entropy mode the port's accepted stream (tokens and the full
uncertainty triplet, with the flag counts) must equal the same queue
served with speculation off, bit for bit, for the dense, moe, hybrid and
encdec families (the reference's ``SPEC_FAMILIES``) and for ssm and vlm
(which ``registry.supports_spec_decode`` admits too), with the prefix
cache and its copy-on-write, with a mean-head draft, with drafts that are
all rejected, and with the adaptive depth; threshold 0 never drafts; a
rejected tail's blocks roll back.  The reference's adaptive-depth tests
fail in the JAX package itself, so the port's adaptive depth is held to
its own spec-off stream.  Against the JAX engine (the JAX xi injected):
tokens exact, H / SE / MI within 2e-5, the same round statistics.

Operand noise keys the slot, so parity is defined only for requests that
land in the same slot in both runs; speculation changes finish times, so
the workloads pin the admission schedule (a first wave only, or one
slot), and every comparison asserts the slots matched.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, dense_pair, encdec_pair,  # noqa: F401
                           hybrid_pair, jax_head_noise, meshless_reference,
                           moe_pair, ssm_pair, vlm_pair)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro_torch.core.entropy import KernelEntropy
from repro_torch.launch import steps as S
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.models import registry as TM

# f32 tolerance of the reduced (f32) model against the JAX package
ATOL = 2e-5

ENGINE = dict(num_slots=3, max_len=32, chunk=4, kv_layout="paged",
              kv_block=8)
CHURN = dict(ENGINE, num_slots=1)
# gate wide open: every slot drafts once it has carried one MI
SPEC = dict(spec_decode=True, spec_k=3, spec_mi_threshold=float("inf"))


def _family(name):
    """(tcfg, port params) of a reduced family in operand mode; moe at a
    capacity factor of E / K, where no expert can overflow (the one
    cross-slot coupling of a decode step)."""
    pair = {"dense": dense_pair, "moe": moe_pair, "hybrid": hybrid_pair,
            "encdec": encdec_pair, "ssm": ssm_pair, "vlm": vlm_pair}[name]
    _, _, tcfg, tparams = pair()
    if name == "moe":
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.num_experts / tcfg.top_k)
    return tcfg, tparams


def _prompts(n=5, size=16, seed=7):
    return np.random.default_rng(seed).integers(1, 511, size=(n, size)) \
        .astype(np.int32)


def _first_wave(cls=TRequest):
    # 3 slots, 3 requests of staggered prompt and generation lengths: no
    # queue refill, so admission is the same in every run
    p = _prompts()
    lens, gens = (12, 8, 10), (8, 4, 6)
    return [cls(rid=i, prompt=p[i][:lens[i]], max_new_tokens=gens[i])
            for i in range(3)]


def _churn(cls=TRequest):
    # one slot and a deep queue: admission churn with one schedule
    p = _prompts()
    gens = (8, 4, 8, 6, 5)
    return [cls(rid=i, prompt=p[i][:(12 if i % 2 == 0 else 8)],
                max_new_tokens=gens[i]) for i in range(5)]


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


def _serve(cfg, params, reqs, **kw):
    eng = TEngine(params, cfg, device="cpu", **kw)
    return eng, eng.run(reqs)


def _garbage(engine):
    """Drafts that propose an impossible token at every depth: the verify
    rejects everything and each round emits one verified token a slot."""
    runner = engine.runner
    orig = runner.spec_fns

    def fns(k):
        draft, verify = orig(k)

        def bad(params, token, cache, hiddens, ys, states):
            out = draft(params, token, cache, hiddens, ys, states)
            ys[:, 0].fill_(-1)
            return out

        return bad, verify

    runner.spec_fns = fns


@pytest.mark.parametrize("family", ["dense", "encdec", "hybrid", "moe",
                                    "ssm", "vlm"])
def test_spec_on_equals_spec_off_across_families(family):
    """The staggered first wave, speculation on against off (ssm on its
    dense fallback; vlm on zero prefix embeds over the first 8 rows): every
    request's tokens, H, SE, MI, p_max and flags bit for bit, rounds
    actually run, no more full-model calls than the chunk path, and the
    pool balanced after the rollbacks."""
    cfg, params = _family(family)
    _, off = _serve(cfg, params, _first_wave(), **ENGINE)
    eng, on = _serve(cfg, params, _first_wave(), **ENGINE, **SPEC)
    _same_streams(off, on)
    sd = on["spec_decode"]
    assert sd["enabled"] and sd["rounds"] > 0 and sd["emitted"] > 0
    assert sd["full_model_calls"] <= off["spec_decode"]["full_model_calls"]
    if eng._last_alloc is not None:
        assert eng._last_alloc.in_use == 0 and not eng._last_alloc._reserved


def test_spec_with_prefix_cache_and_cow():
    """Speculative rounds over prefix hits that copied their tail block
    (20 shared tokens over 8-token blocks): the spec-off stream bit for
    bit, with real hits, copies and rounds, and the pool balanced against
    the tree's references."""
    cfg, params = _family("dense")
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 511, size=20)
    tails = rng.integers(1, 511, size=(5, 8))
    mk = lambda: [TRequest(rid=i, prompt=np.concatenate(  # noqa: E731
        [shared, tails[i]]).astype(np.int32), max_new_tokens=6)
        for i in range(5)]
    kw = dict(CHURN, max_len=48, prefix_cache=True)
    for mode in ("batch", "chunked"):
        _, off = _serve(cfg, params, mk(), prefill_mode=mode,
                        prefill_chunk=8, **kw)
        eng, on = _serve(cfg, params, mk(), prefill_mode=mode,
                         prefill_chunk=8, **kw, **SPEC)
        _same_streams(off, on)
        assert on["prefix_cache"]["hits"] == 4
        assert on["prefix_cache"]["cow_copies"] == 4
        assert on["spec_decode"]["rounds"] > 0
        alloc, tree = eng._last_alloc, eng._last_pcache
        assert alloc.in_use == tree.cached_blocks() and not alloc._reserved


def test_queue_churn_saves_full_model_calls():
    """Admission churn through one slot: the spec-off stream, with
    proposals accepted and fewer full-model calls than the chunk path."""
    cfg, params = _family("dense")
    _, off = _serve(cfg, params, _churn(), **CHURN)
    _, on = _serve(cfg, params, _churn(), **CHURN, **SPEC)
    _same_streams(off, on)
    sd = on["spec_decode"]
    assert sd["accepted"] > 0
    assert sd["full_model_calls"] < off["spec_decode"]["full_model_calls"]


def test_mean_head_draft_is_lossless():
    """``spec_draft_s=0`` (mean-head proposals) changes acceptance only."""
    cfg, params = _family("dense")
    _, off = _serve(cfg, params, _first_wave(), **ENGINE)
    _, on = _serve(cfg, params, _first_wave(), **ENGINE, **SPEC,
                   spec_draft_s=0)
    _same_streams(off, on)
    assert on["spec_decode"]["draft_samples"] == 0
    assert on["spec_decode"]["rounds"] > 0


def test_rejected_drafts_keep_the_stream_and_roll_back_blocks():
    """Every proposal rejected: each round emits one verified token a
    slot, rolls the rejected tail's decode blocks back, and the stream
    and the pool are exact."""
    cfg, params = _family("dense")
    _, off = _serve(cfg, params, _first_wave(), **ENGINE)
    eng = TEngine(params, cfg, device="cpu", **ENGINE, **SPEC)
    _garbage(eng)
    on = eng.run(_first_wave())
    _same_streams(off, on)
    sd = on["spec_decode"]
    assert sd["rounds"] > 0 and sd["accepted"] == 0
    assert sd["acceptance_rate"] == 0.0 and sd["rollbacks"] > 0
    assert sd["tokens_per_round"] <= eng.num_slots
    alloc = eng._last_alloc
    assert alloc.in_use == 0 and not alloc._reserved
    assert sorted(alloc._free) == list(range(alloc.num_blocks))


def test_threshold_zero_never_speculates():
    """The gate is strict (<): threshold 0 admits no slot, and the run is
    the chunk path's."""
    cfg, params = _family("dense")
    _, off = _serve(cfg, params, _first_wave(), **ENGINE)
    _, on = _serve(cfg, params, _first_wave(), **ENGINE, spec_decode=True,
                   spec_k=3, spec_mi_threshold=0.0)
    _same_streams(off, on)
    sd = on["spec_decode"]
    assert sd["rounds"] == 0 and sd["drafted"] == 0
    assert sd["full_model_calls"] == off["spec_decode"]["full_model_calls"]
    assert on["chunks_run"] == off["chunks_run"]


def test_dense_layout_speculates():
    """The dense layout speculates too (rollback is the token / depth
    rewind alone, no blocks)."""
    cfg, params = _family("dense")
    kw = dict(num_slots=3, max_len=32, chunk=4)
    _, off = _serve(cfg, params, _first_wave(), **kw)
    _, on = _serve(cfg, params, _first_wave(), **kw, **SPEC)
    _same_streams(off, on)
    assert on["spec_decode"]["rounds"] > 0


@pytest.mark.parametrize("garbage", [False, True])
def test_adaptive_depth_keeps_the_stream(garbage):
    """The per-slot acceptance EMA walking k in [2, 6] (k 4): the churn
    queue's spec-off stream bit for bit, round depths inside the bounds;
    drafts that are all rejected shrink every slot to k_min and never
    grow it."""
    cfg, params = _family("dense")
    _, off = _serve(cfg, params, _churn(), **CHURN)
    eng = TEngine(params, cfg, device="cpu", **CHURN, spec_decode=True,
                  spec_k=4, spec_mi_threshold=float("inf"), spec_k_min=2,
                  spec_k_max=6)
    if garbage:
        _garbage(eng)
    on = eng.run(_churn())
    _same_streams(off, on)
    sd = on["spec_decode"]
    assert (sd["k_min"], sd["k_max"]) == (2, 6)
    assert 2 <= sd["round_k_min"] <= sd["round_k_max"] <= 6
    if garbage:
        assert sd["accepted"] == 0 and sd["k_up"] == 0
        assert sd["k_down"] > 0 and sd["round_k_min"] == 2
    else:
        assert sd["k_up"] + sd["k_down"] > 0


def test_default_bounds_pin_the_depth():
    cfg, params = _family("dense")
    _, on = _serve(cfg, params, _first_wave(), **ENGINE, **SPEC)
    sd = on["spec_decode"]
    assert sd["k_up"] == sd["k_down"] == 0
    assert sd["round_k_min"] == sd["round_k_max"] == 3


def test_spec_on_matches_the_jax_engine():
    """The dense first wave with speculation on, the port against the
    JAX engine with the JAX xi injected: tokens exact, H / SE / MI /
    p_max within 2e-5, the same round statistics and pool trace."""
    jcfg, jparams, tcfg, tparams = dense_pair()
    tr = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                 **ENGINE, **SPEC).run(_first_wave())
    jr = JEngine(jparams, jcfg, **ENGINE, **SPEC).run(_first_wave(JRequest))
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.slot == b.slot and a.tokens == b.tokens, a.rid
        for name in ("H", "SE", "MI", "p_max"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=name)
        assert a.epistemic_flags == b.epistemic_flags
    keys = ("rounds", "drafted", "accepted", "emitted", "rollbacks",
            "gated_slot_rounds", "full_model_calls")
    assert {k: tr["spec_decode"][k] for k in keys} \
        == {k: jr["spec_decode"][k] for k in keys}
    assert tr["spec_decode"]["rounds"] > 0
    assert tr["sched_trace"] == jr["sched_trace"]


@pytest.mark.parametrize("num_samples", [0, 1])
def test_draft_head_override_matches_jax(num_samples):
    """``head_outputs(num_samples=)``: 0 the mean head, 1 a one-draw
    operand head, against the JAX package's override with its xi."""
    import jax.numpy as jnp
    from repro.models import registry as JM
    jcfg, jparams, tcfg, tparams = dense_pair()
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, tcfg.d_model)).astype(np.float32)
    depth = np.array([5, 9, 12], np.int32)
    import jax
    got = TM.head_outputs(tparams, tcfg, torch.from_numpy(h),
                          torch.from_numpy(depth), (17, 0),
                          num_samples=num_samples,
                          head_noise=jax_head_noise())
    want = JM.head_outputs(jparams, jcfg, jnp.asarray(h),
                           jnp.asarray(depth), jax.random.PRNGKey(17),
                           num_samples=num_samples)
    np.testing.assert_array_equal(got["next_token"].numpy(),
                                  np.asarray(want["next_token"]))
    for name in ("H", "SE", "MI", "p_max"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=ATOL, err_msg=name)
    if num_samples == 0:
        assert float(got["MI"].abs().max()) == 0.0


def test_commit_rewinds_recurrent_state_in_place():
    """``build_spec_commit`` pins the masked slots' token and depth and
    picks each one's state after its last kept step, in place; unmasked
    slots keep theirs."""
    k, L, B = 3, 2, 4
    g = torch.Generator().manual_seed(1)
    cache = {"len": torch.tensor([5, 6, 7, 8], dtype=torch.int32),
             "ssm": torch.randn((L, B, 2, 3), generator=g),
             "conv": torch.randn((L, B, 1, 4), generator=g)}
    states = {n: torch.randn((k, *cache[n].shape), generator=g)
              for n in ("ssm", "conv")}
    token = torch.zeros((B,), dtype=torch.int32)
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    before = {n: t.clone() for n, t in cache.items()}
    mask = torch.tensor([True, False, True, True])
    idx = torch.tensor([2, 0, 0, 1], dtype=torch.int32)
    S.build_spec_commit(None)(cache, token, mask,
                              torch.tensor([9, 9, 8, 7], dtype=torch.int32),
                              torch.tensor([7, 0, 8, 10], dtype=torch.int32),
                              states, idx)
    assert token.tolist() == [9, 0, 8, 7]
    assert cache["len"].tolist() == [7, 6, 8, 10]
    assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    for n in ("ssm", "conv"):
        for b in range(B):
            want = states[n][int(idx[b]), :, b] if mask[b] \
                else before[n][:, b]
            assert torch.equal(cache[n][:, b], want), (n, b)


def test_spec_refuses_kernel_entropy_and_bad_depths():
    cfg, params = _family("dense")
    kw = dict(num_slots=2, max_len=32, chunk=4, device="cpu")
    with pytest.raises(ValueError, match="operand"):
        TEngine(params, cfg, entropy=KernelEntropy(seed=0),
                spec_decode=True, **kw)
    with pytest.raises(ValueError, match="operand"):
        TEngine(params, dataclasses.replace(cfg, head_entropy="kernel"),
                spec_decode=True, **kw)
    with pytest.raises(ValueError, match="spec_k"):
        TEngine(params, cfg, spec_decode=True, spec_k=0, **kw)
    with pytest.raises(ValueError, match="spec_draft_s"):
        TEngine(params, cfg, spec_decode=True, spec_draft_s=-1, **kw)
    for lo, hi in ((0, 4), (5, 6), (2, 3)):
        with pytest.raises(ValueError, match="k_min <= k <= k_max"):
            TEngine(params, cfg, spec_decode=True, spec_k=4, spec_k_min=lo,
                    spec_k_max=hi, **kw)
