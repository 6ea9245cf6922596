"""The serving features under a tensor-parallel mesh on the CPU: two
spawned gloo ranks (one group for the module) against the unsharded port
engine and the JAX engine.

Speculative decoding at ``--mesh 1x2`` for ``mesh_check``'s four families
(the adaptive depth and the mean-head draft on dense): every rank's
streams, admissions and round counts bit for bit against the unsharded
spec-on engine, and each request that kept its slot against the
unsharded spec-off engine.  The
escalation lane and the priority policy with SLO deadlines, together and
apart, in operand and kernel entropy, with the lane's runner on the main
runner's parameter storage.  Dense against the JAX engine on the same
weights and the same injected xi: spec on, the lane and the priority
traffic, tokens exact and floats within 2e-5.  One clock: a rank whose
own clock would reorder the queue admits in rank 0's order.  The CLI at
``--mesh 1x2`` with ``--spec-decode on`` and with ``--policy priority
--escalate-mi``.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _mesh_ranks as R
from _torch_parity import meshless_reference, to_numpy_tree  # noqa: F401
from repro.configs.registry import get_config as jget, reduced as jred
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.models import layers as JL
from repro.models import registry as JM
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve as TS
from repro_torch.launch.engine import mesh_check as MC
from repro_torch.launch.engine import scheduler

ROOT = Path(__file__).resolve().parent.parent
# f32 tolerance of the reduced (f32) model against the JAX package
ATOL = 2e-5
DEPTHS = 128                 # past max_len: idle slots keep advancing
LANE = dict(escalate_mi="auto")
BOTH = dict(policy="priority", escalate_mi="auto")


@pytest.fixture(scope="module")
def ranks():
    with meshlib.Ranks(2, "cpu", timeout_s=120) as r:
        yield r


def _ok(out, family):
    row = out["families"][family]
    assert out["ok"] and row["errors"] == [], row["errors"]
    assert row["mesh"] == "2 ranks, gloo, cpu"
    return row


@pytest.mark.parametrize("family", sorted(MC.FAMILIES))
def test_spec_at_mesh_is_bitwise_the_unsharded_spec_on_and_off(ranks,
                                                                family):
    row = _ok(MC.check(ranks, [family], device="cpu", features=MC.SPEC),
              family)
    spec = row["schedule"]["spec"]
    assert spec["rounds"] > 0 and spec["drafted"] > 0
    assert row["gen_tokens"] == sum(MC.GENS)
    # the first wave keeps its slots whatever speculation moves
    assert {0, 1} <= set(row["spec_off_held"])


def test_adaptive_spec_depth_at_mesh(ranks):
    """k 4 walking in [2, 6]: both ranks take the unsharded depths, and
    every request kept its slot, so every stream equals spec off."""
    feats = dict(MC.SPEC, spec_k=4, spec_k_min=2, spec_k_max=6)
    row = _ok(MC.check(ranks, ["dense"], device="cpu", features=feats),
              "dense")
    spec = row["schedule"]["spec"]
    assert spec["k_up"] + spec["k_down"] > 0
    assert row["spec_off_held"] == list(range(len(MC.PROMPTS)))


def test_mean_head_draft_at_mesh(ranks):
    """The draft proposes with the mean head (``spec_draft_s`` 0, the head's
    mean columns gathered): both ranks as the unsharded engine."""
    feats = dict(MC.SPEC, spec_draft_s=0)
    row = _ok(MC.check(ranks, ["dense"], device="cpu", features=feats),
              "dense")
    assert row["schedule"]["spec"]["rounds"] > 0
    assert {0, 1} <= set(row["spec_off_held"])


@pytest.mark.parametrize("family", sorted(MC.FAMILIES))
def test_priority_and_lane_at_mesh_are_bitwise_the_unsharded_engine(
        ranks, family):
    """The priority traffic (a class-0 arrival preempts, SLO deadlines
    order a class) with the lane armed at phase 15's rule, operand
    entropy: both ranks' streams, admission order, preemptions and
    escalations equal the unsharded run's, and each rank's lane holds
    the main runner's parameter tensors."""
    row = _ok(MC.check(ranks, [family], device="cpu", features=BOTH),
              family)
    sched = row["schedule"]
    assert sched["preemptions"] >= 1 and sched["escalated"]
    assert sched["admissions"][:2] == [1, 0]    # request 1's SLO first
    assert row["lane_shares_params"] is True


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_all_three_features_at_mesh(ranks, family):
    """Speculation, the lane and the priority policy with SLOs at once
    (hybrid: the recurrent state rolled back and re-prefilled on the
    lane): both ranks as the unsharded engine, streams and schedule."""
    row = _ok(MC.check(ranks, [family], device="cpu",
                       features=dict(BOTH, **MC.SPEC)), family)
    sched = row["schedule"]
    assert sched["spec"]["rounds"] > 0 and sched["preemptions"] >= 1
    assert sched["escalated"] and row["spec_off_held"] is None


@pytest.mark.parametrize("features", [LANE, dict(policy="priority")],
                         ids=["lane", "priority"])
def test_kernel_entropy_features_at_mesh(ranks, features):
    """Kernel entropy (the head whole on every rank, the lane's too)."""
    row = _ok(MC.check(ranks, ["dense"], entropy="kernel", device="cpu",
                       features=features), "dense")
    if "escalate_mi" in features:
        assert row["schedule"]["escalated"] and row["lane_shares_params"]
    else:
        assert row["schedule"]["preemptions"] >= 1


def test_the_lane_attends_every_head_at_mesh(ranks):
    """The mode the escalation lane runs in under ``--mesh 1x2``: the main
    runner attends the rank's own kv head (its pool holds one of the two),
    the lane every head (``TP.local_heads`` off: q, k and v gathered, its
    one-slot cache whole), on both ranks."""
    for row in ranks.run(R.lane_heads):
        assert row == {"main_local": True, "lane_local": False,
                       "main_kv_heads": 1, "lane_kv_heads": 2}


# ---------------------------------------------------------------------------
# the JAX engine on the same weights and xi
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_dense():
    jcfg = dataclasses.replace(jred(jget("qwen2_1_5b")),
                               head_entropy="operand", num_kv_heads=2)
    return jcfg, JM.init_params(jax.random.key(0), jcfg)


@functools.lru_cache(maxsize=None)
def _table(samples):
    """The JAX engine's xi at ``samples`` draws, (2 slots, DEPTHS, S, V)."""
    jcfg = _jax_dense()[0]
    key = jax.random.PRNGKey(17)
    xi = jax.vmap(lambda d: JL.decode_head_noise(
        key, jnp.full((2,), d, jnp.int32), samples, jcfg.vocab_size))(
        jnp.arange(DEPTHS))                                    # (D, S, 2, V)
    return np.asarray(xi).transpose(2, 0, 1, 3).copy()


def _noise(jcfg, *others):
    return R.TableNoise(_table(jcfg.mc_samples),
                        {s: _table(s) for s in others})


def _jax_run(jcfg, jparams, features, policy="fifo"):
    reqs = [JRequest(rid=r.rid, prompt=r.prompt,
                     max_new_tokens=r.max_new_tokens, priority=r.priority,
                     slo_s=r.slo_s, arrival_step=r.arrival_step)
            for r in MC.make_traffic(jcfg, "dense", policy)]
    return JEngine(jparams, jcfg, **MC.ENGINE, decode_attn="gather",
                   prefix_cache=True, **features).run(reqs)


def _mesh_run(ranks, jparams, noise, features):
    outs = ranks.run(MC.run_family, "dense", decode_attn="gather",
                     params=to_numpy_tree(jparams), head_noise=noise,
                     features=features)
    assert not MC.compare(outs[0], outs[1])          # the ranks agree
    return outs[0]


def _near_jax(tr, jr):
    assert len(tr["requests"]) == len(jr["requests"]) == len(MC.PROMPTS)
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.slot == b.slot and a.tokens == b.tokens, a.rid
        assert [s for s, _ in a.history] == [s for s, _ in b.history]
        for name in ("H", "SE", "MI", "p_max"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=f"{name} {a.rid}")
        assert a.epistemic_flags == b.epistemic_flags


def test_dense_spec_at_mesh_matches_the_jax_engine(ranks):
    jcfg, jparams = _jax_dense()
    jr = _jax_run(jcfg, jparams, MC.SPEC)
    tr = _mesh_run(ranks, jparams, _noise(jcfg, 1), MC.SPEC)
    _near_jax(tr, jr)
    keys = ("rounds", "drafted", "accepted", "emitted", "rollbacks",
            "gated_slot_rounds", "full_model_calls")
    assert {k: tr["spec_decode"][k] for k in keys} \
        == {k: jr["spec_decode"][k] for k in keys}
    assert tr["spec_decode"]["rounds"] > 0


def _gap_threshold(runs, chunk):
    """A lane threshold near the upper quartile of the runs' chunk-end
    MI, in the middle of a gap wider than 4 ATOL between two of them,
    so that the port and JAX (within ATOL) flag the same requests."""
    ends = sorted({float(m) for run in runs for r in run["requests"]
                   for m in r.MI[chunk - 1:len(r.MI) - 1:chunk]})
    q = float(np.quantile(ends, 0.75))
    gaps = [(lo + hi) / 2 for lo, hi in zip(ends, ends[1:])
            if hi - lo > 4 * ATOL]
    return min(gaps, key=lambda t: abs(t - q))


def test_dense_lane_at_mesh_matches_the_jax_lane(ranks):
    """The lane in operand entropy at S 4x: the port at 1x2 against the
    JAX engine's lane, the same requests escalated, tokens exact, floats
    within 2e-5; the lane's parameters the main runner's on each rank."""
    jcfg, jparams = _jax_dense()
    s = 4 * jcfg.mc_samples
    noise = _noise(jcfg, s)
    thr = _gap_threshold([_jax_run(jcfg, jparams, {}),
                          _mesh_run(ranks, jparams, noise, {})],
                         MC.ENGINE["chunk"])
    esc = dict(escalate_mi=thr, escalate_s=s)
    jr = _jax_run(jcfg, jparams, esc)
    tr = _mesh_run(ranks, jparams, noise, esc)
    _near_jax(tr, jr)
    keys = ("escalations", "by_class", "tokens", "skipped_too_long",
            "steps", "verify_samples")
    assert {k: tr["escalation"][k] for k in keys} \
        == {k: jr["escalation"][k] for k in keys}
    assert tr["escalation"]["escalations"] >= 1
    assert tr["lane_shares_params"] is True


def test_dense_priority_with_slos_at_mesh_matches_the_jax_engine(ranks):
    jcfg, jparams = _jax_dense()
    feats = dict(policy="priority")
    jr = _jax_run(jcfg, jparams, feats, "priority")
    tr = _mesh_run(ranks, jparams, _noise(jcfg), feats)
    _near_jax(tr, jr)
    assert tr["preemptions"] == jr["preemptions"] >= 1
    assert MC.admissions(tr) == [rid for _, rid in sorted(
        (t, r.rid) for r in jr["requests"] for st, t in r.history
        if st == "prefilling")]


# ---------------------------------------------------------------------------
# one clock
# ---------------------------------------------------------------------------

def test_a_skewed_rank_admits_in_rank_0s_order(ranks):
    """Rank 1's clock runs backwards, so its own stamps would put every
    later submission first: unsharded, that clock admits 1, 0, 3, 2
    where the true one admits 0, 1, 2, 3.  At 1x2 with rank 1 skewed,
    both ranks admit in rank 0's order and stream as the unsharded run
    on the true clock."""
    own = scheduler.clock
    true = R.clock_run(None)
    skewed = R.clock_run(None, skewed=(0,))
    assert scheduler.clock is own
    assert true["admissions"] == [0, 1, 2, 3]
    assert skewed["admissions"] == [1, 0, 3, 2]
    for rank in ranks.run(R.clock_run, skewed=(1,)):
        assert rank["admissions"] == true["admissions"]
        assert rank["slots"] == true["slots"]
        assert rank["streams"] == true["streams"]


def test_broadcast_floats_is_the_identity_on_one_rank():
    one = meshlib.TP(rank=0, size=1, backend="gloo", device="cpu")
    assert one.broadcast_floats([1.5, 2]) == [1.5, 2.0]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--slots", "2", "--num-requests", "4",
        "--prompt-len", "8", "--gen-len", "8", "--chunk", "4",
        "--kv-layout", "paged", "--decode-attn", "kernel", "--prefill",
        "chunked", "--prefill-chunk", "8", "--entropy", "operand"]


@pytest.mark.parametrize("flags", [
    ["--spec-decode", "on", "--spec-k", "3"],
    ["--policy", "priority", "--priorities", "2,2,2,0", "--slo-ms",
     "0,900,0,500", "--arrivals", "0,0,0,4", "--escalate-mi", "0.0045"]],
    ids=["spec", "priority-lane"])
def test_cli_serves_the_features_at_mesh_1x2(tmp_path, flags):
    """``serve --mesh 1x2`` with the feature's flags spawns its two ranks
    and reports rank 0's result: the unsharded serve's MI rows and
    counters."""
    out = tmp_path / "stats.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *BASE, *flags,
         "--mesh", "1x2", "--stats-json", str(out)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(out.read_text())
    assert got["mesh"] == "2 ranks, gloo, cpu"
    ref = TS.serve(TS.build_parser().parse_args(BASE + flags))
    assert got["gen_tokens"] == ref["gen_tokens"] == 32
    assert got["preemptions"] == ref["preemptions"]
    for key, names in (("spec_decode", MC.SPEC_KEYS),
                       ("escalation", MC.LANE_KEYS)):
        want = json.loads(json.dumps({k: ref[key][k] for k in names}))
        assert {k: got[key][k] for k in names} == want, key
    assert (got["spec_decode"]["rounds"] > 0) == ("--spec-decode" in flags)
    assert (got["escalation"]["escalations"] > 0) == ("--policy" in flags)
    rows = proc.stdout.split("MI per request:\n")[1].split("  #")[1:]
    assert len(rows) == len(ref["requests"]) == 4
    for row, r in zip(rows, ref["requests"]):
        assert row.startswith(f"{r.rid} ({r.finish_reason}): "
                              + np.array2string(np.asarray(r.MI),
                                                precision=4)), row
