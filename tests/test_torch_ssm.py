"""The port's ssm family (mamba2-370m reduced: 4 layers, d 128, d_inner
256, 8 heads of P 32, N 16, chunk 16, f32) against the JAX package: the
SSD scan and step, the causal conv, the block's three modes, prefill,
operand-mode decode with the JAX xi injected, the serving engine; and
inside the port, prefill-then-decode against a longer prefill, the slot
write, the engine's fallbacks and its scan against the per-token loop.
Tolerance: atol 1e-5 in f32 unless stated; bitwise where stated.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_ssm.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close,  # noqa: F401
                           jax_head_noise, meshless_reference, ssm_pair,
                           to_numpy_tree)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.engine.runner import \
    decode_loop_reference as jax_decode_loop_reference
from repro.models import registry as JM
from repro.models import ssm as JS
from repro_torch.core.entropy import KernelEntropy
from repro_torch.launch import steps as S
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.launch.engine.runner import decode_loop_reference
from repro_torch.models import registry as TM
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import layer

ATOL = 1e-5
STEP_KEYS = ("H", "SE", "MI", "p_max")
PATH_FLAGS = dict(kv_layout="paged", decode_attn="kernel",
                  prefill_mode="chunked", prefill_chunk=8, kv_block=4)


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(
        1, vocab - 1, size=(B, S)).astype(np.int32)


def _ssd_inputs(seed, B, S, H=8, P=32, N=16):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (0.05 + 0.2 * r.random((B, S, H))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    D = (0.5 + r.random(H)).astype(np.float32)
    h0 = r.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("S", [7, 16, 37])
def test_ssd_chunked_matches_jax(S, h0):
    """S below, at and past a multiple of Q 16 (the padded tail chunk),
    with and without a carried state: y and the final state within
    ATOL."""
    x, dt, A, Bm, Cm, D, h = _ssd_inputs(S, 2, S)
    h = h if h0 else None
    jy, jh = JS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)),
                            16, h0=None if h is None else jnp.asarray(h))
    ty, th = TS.ssd_chunked(*(torch.from_numpy(a) for a in
                              (x, dt, A, Bm, Cm, D)), 16,
                            h0=None if h is None else torch.from_numpy(h))
    assert ty.shape == (2, S, 8, 32) and th.dtype == torch.float32
    assert torch.isfinite(ty).all()
    assert_close(ty, jy, atol=ATOL, msg="y")
    assert_close(th, jh, atol=ATOL, msg="h")


def test_ssd_chunked_long_decay_stays_finite():
    """Decays whose within-chunk sums reach -hundreds: the entries above
    the diagonal, exp of a large positive number, are masked to -inf
    before exp, so nothing turns to NaN; y matches the reference."""
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(3, 1, 32)
    dt = dt * 40.0                              # cum_i - cum_j up to ~1e3
    jy, _ = JS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)),
                           16)
    ty, th = TS.ssd_chunked(*(torch.from_numpy(a) for a in
                              (x, dt, A, Bm, Cm, D)), 16)
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    assert_close(ty, jy, atol=1e-4, msg="y")


def test_ssd_step_matches_jax():
    x, dt, A, Bm, Cm, D, h = _ssd_inputs(4, 3, 1)
    args = (h, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)
    jh, jy = JS.ssd_step(*(jnp.asarray(a) for a in args))
    th, ty = TS.ssd_step(*(torch.from_numpy(a) for a in args))
    assert ty.dtype == torch.float32
    assert_close(th, jh, atol=ATOL, msg="h")
    assert_close(ty, jy, atol=ATOL, msg="y")


@pytest.mark.parametrize("act", ["identity", "silu"])
def test_causal_conv_matches_jax_in_bf16(monkeypatch, act):
    """bf16 operands.  With the activation taken out (``identity``), the
    W shifted products add in the reference's order in bf16: bit for
    bit.  With silu, torch rounds once from f32 where the reference
    rounds op by op in bf16: within two bf16 ulps (rtol 2^-6)."""
    if act == "identity":
        monkeypatch.setattr(jax.nn, "silu", lambda v: v)
        monkeypatch.setattr(TS.F, "silu", lambda v: v)
    r = np.random.default_rng(6)
    u, w, b = (jnp.asarray(r.standard_normal(s).astype(np.float32) * sc,
                           jnp.bfloat16)
               for s, sc in (((2, 9, 40), 1.0), ((4, 40), 0.5), ((40,), 1.0)))
    want = np.asarray(JS._causal_conv(u, w, b).astype(jnp.float32))

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)

    got = TS._causal_conv(t(u), t(w), t(b))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 40)
    if act == "identity":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2 ** -6, atol=1e-6)


@pytest.mark.parametrize("mode", ["prefill", "decode", "chunked_h0",
                                  "force_chunked"])
def test_apply_block_matches_jax(mode):
    """The block's three modes on one layer: prefill (no state, S 21),
    decode (states, S 1, the recurrence), the chunked form threading h0
    (S 5) and ``force_chunked`` at S 1; output, state and conv tail
    within ATOL."""
    jcfg, jparams, tcfg, tparams = ssm_pair()
    d_in, H, P, N = TS.dims(tcfg)
    S = {"prefill": 21, "decode": 1, "chunked_h0": 5, "force_chunked": 1}[mode]
    r = np.random.default_rng(7)
    x = r.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    h = (0.3 * r.standard_normal((2, H, P, N))).astype(np.float32)
    c = r.standard_normal((2, tcfg.ssm_conv_width - 1,
                           d_in + 2 * N)).astype(np.float32)
    jbp = jax.tree.map(lambda a: a[2], jparams["blocks"])
    tbp = layer(tparams["blocks"], 2)
    kw = dict(force_chunked=mode == "force_chunked")
    if mode == "prefill":
        jargs, targs = {}, {}
    else:
        jargs = dict(ssm_state=jnp.asarray(h), conv_state=jnp.asarray(c))
        targs = dict(ssm_state=torch.from_numpy(h),
                     conv_state=torch.from_numpy(c))
    want = JS.apply_block(jbp, jcfg, jnp.asarray(x), **jargs, **kw)
    got = TS.apply_block(tbp, tcfg, torch.from_numpy(x), **targs, **kw)
    for name, g, w in zip(("x", "h", "conv"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert_close(g, w, atol=ATOL, msg=name)


def test_init_params_tree_matches_jax_layout():
    _, jparams, tcfg, _ = ssm_pair()
    want = to_numpy_tree(jparams)
    got = TM.init_params(tcfg, torch.Generator().manual_seed(0), CPU)

    def leaves(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(leaves(v, f"{pre}{k}."))
            else:
                out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        return out

    assert leaves(got["blocks"]) == leaves(want["blocks"])
    for k in ("embed", "final_norm"):
        assert leaves({k: got[k]}) == leaves({k: want[k]})
    blocks = got["blocks"]
    np.testing.assert_allclose(blocks["A_log"].numpy(),
                               want["blocks"]["A_log"], atol=1e-6)
    assert (blocks["D"] == 1).all() and (blocks["dt_bias"] == -2).all()
    assert (blocks["conv_b"] == 0).all()
    w = blocks["in_proj"]
    assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.02
    assert not torch.equal(w[0], w[1])          # layers drawn apart


def test_bf16_params_keep_their_f32_leaves():
    """At the served bf16 dtype, the bridge and the init keep ``A_log``,
    ``D`` and ``dt_bias`` in f32 beside bf16 weights."""
    import repro.configs.registry as JR
    from repro_torch.configs.registry import get_config, reduced

    jcfg = JR.reduced(JR.get_config("mamba2_370m"))
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    tcfg = dataclasses.replace(reduced(get_config("mamba2_370m")),
                               param_dtype="bfloat16")
    jparams = JM.init_params(jax.random.key(0), jcfg)
    bridged = TM.params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    drawn = TM.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    for params in (bridged, drawn):
        b = params["blocks"]
        for k in ("A_log", "D", "dt_bias"):
            assert b[k].dtype == torch.float32, k
        for k in ("in_proj", "conv_w", "out_proj", "ln", "gate_ln"):
            assert b[k].dtype == torch.bfloat16, k
    cache = TM.make_cache(tcfg, 3, 40, device=CPU)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].shape == (4, 3, 8, 32, 16)
    assert cache["conv"].shape == (4, 3, 3, 256 + 32)


@pytest.mark.parametrize("S", [5, 21])
def test_prefill_hidden_and_cache_match_jax(S):
    """Batch prefill of two prompts, inside one chunk and across two."""
    jcfg, jparams, tcfg, tparams = ssm_pair()
    toks = _tokens(S, 2, S)
    jh, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 40)
    th, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 40)
    assert set(tc) == set(jc) == {"ssm", "conv", "len"}
    assert_close(th, jh, atol=ATOL)
    for n in ("ssm", "conv"):
        assert tc[n].dtype == torch.float32
        assert_close(tc[n], jc[n], atol=ATOL, msg=n)
    np.testing.assert_array_equal(tc["len"].numpy(), [S, S])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_operand_decode_with_jax_noise_matches_jax():
    """Staggered slot depths, four steps: tokens exact, H/SE/MI/p_max
    within ATOL, the state and conv tail close; the step writes the cache
    in place (the same tensors come back)."""
    jcfg, jparams, tcfg, tparams = ssm_pair()
    toks = _tokens(2, 3, 9)
    _, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 16)
    jc["len"] = jnp.asarray([9, 7, 4], jnp.int32)
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    tc["len"] = torch.tensor([9, 7, 4], dtype=torch.int32)
    leaves = {k: v.data_ptr() for k, v in tc.items()}
    key = jax.random.PRNGKey(17)
    noise = jax_head_noise()
    jtok = jnp.asarray(toks[:, -1])
    ttok = torch.from_numpy(toks[:, -1])
    for t in range(4):
        jo, jc = JM.decode_step(jparams, jcfg, jtok, jc, key)
        to, tc = TM.decode_step(tparams, tcfg, ttok, tc, (17, t),
                                head_noise=noise)
        np.testing.assert_array_equal(to["next_token"].numpy(),
                                      np.asarray(jo["next_token"]))
        for k in STEP_KEYS:
            assert_close(to[k], jo[k], atol=ATOL, msg=f"step {t} {k}")
        jtok, ttok = jo["next_token"], to["next_token"]
    assert {k: v.data_ptr() for k, v in tc.items()} == leaves
    for n in ("ssm", "conv"):
        assert_close(tc[n], jc[n], atol=ATOL, msg=n)
    np.testing.assert_array_equal(tc["len"].numpy(), [13, 11, 8])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_prefill_then_decode_equals_a_longer_prefill():
    """Inside the port (the counterpart of the reference's
    test_ssm_prefill_decode_consistency): a 4-token prefill and seven
    teacher-forced decode steps give the state, conv tail and hidden of an
    11-token prefill within 1e-4, and the next step's outputs agree."""
    _, _, tcfg, tparams = ssm_pair()
    toks = torch.from_numpy(_tokens(9, 1, 12))
    _, cache = TM.prefill(tparams, tcfg, toks[:, :4], 16)
    for i in range(4, 11):
        _, cache = TS.decode_hidden(tparams, tcfg, toks[:, i], cache)
    _, ref = TM.prefill(tparams, tcfg, toks[:, :11], 16)
    for n in ("ssm", "conv"):
        assert_close(cache[n], ref[n].numpy(), atol=1e-4, msg=n)
    np.testing.assert_array_equal(cache["len"].numpy(), ref["len"].numpy())
    a, _ = TM.decode_step(tparams, tcfg, toks[:, 11], cache, (17, 0))
    b, _ = TM.decode_step(tparams, tcfg, toks[:, 11], ref, (17, 0))
    assert torch.equal(a["next_token"], b["next_token"])
    for k in STEP_KEYS:
        assert_close(a[k], b[k].numpy(), atol=1e-4, msg=k)


def test_write_slot_writes_only_its_slot():
    """A batch-1 prefill cache lands in slot 1 of a 3-slot cache: the
    slot's ``ssm``, ``conv`` and ``len`` are replaced whole (the previous
    occupant's state is gone), the other slots are untouched."""
    _, _, tcfg, tparams = ssm_pair()
    cache = TM.make_cache(tcfg, 3, 32, device=CPU)
    g = torch.Generator().manual_seed(3)
    for n in ("ssm", "conv"):
        cache[n].copy_(torch.randn(cache[n].shape, generator=g))
    cache["len"].copy_(torch.tensor([5, 6, 7], dtype=torch.int32))
    before = {k: v.clone() for k, v in cache.items()}
    _, sub = TM.prefill(tparams, tcfg, torch.from_numpy(_tokens(3, 1, 10)),
                        32)
    out = TM.write_slot(tcfg, cache, 1, sub)
    assert out is cache
    for n in ("ssm", "conv"):
        assert torch.equal(cache[n][:, 1], sub[n][:, 0])
        for s in (0, 2):
            assert torch.equal(cache[n][:, s], before[n][:, s])
    np.testing.assert_array_equal(cache["len"].numpy(), [5, 10, 7])
    assert TM.RECURRENT_LEAVES == ("ssm", "conv")


def test_registry_gates_for_the_ssm_family():
    _, _, tcfg, _ = ssm_pair()
    assert TM.module_for(tcfg) is TS
    assert not TM.supports_paged(tcfg)
    assert not TM.supports_prompt_padding(tcfg)
    assert not TM.supports_chunked_prefill(tcfg)
    assert not TM.supports_prefix_cache(tcfg)
    assert set(TM.make_cache(tcfg, 2, 16, device=CPU, layout="paged")) == \
        {"ssm", "conv", "len"}
    with pytest.raises(ValueError, match="no chunked prefill"):
        TM.prefill_chunk(None, tcfg, None, None, 0, 0, 1, 1)


def _requests(cls, cfg, lens, gen=8, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size - 1, size=n)
                .astype(np.int32), max_new_tokens=gen)
            for i, n in enumerate(lens)]


def _streams(res):
    return [(r.tokens, *(np.asarray(getattr(r, k), np.float32).tolist()
                         for k in STEP_KEYS), r.finish_reason)
            for r in res["requests"]]


def test_engine_falls_back_to_dense_gather_batch():
    """Paged / kernel / chunked flags fall back to the dense layout, the
    gather read and batch prefill, silently, as in the JAX engine; the
    streams equal those of an engine asked for dense / gather / batch,
    bit for bit, and prompts keep their exact lengths."""
    _, _, tcfg, tparams = ssm_pair()
    lens = [13, 27, 5]
    asked = TEngine(tparams, tcfg, num_slots=2, max_len=27 + 8 + 4, chunk=4,
                    device="cpu", **PATH_FLAGS)
    assert (asked.kv_layout, asked.decode_attn, asked.prefill_mode) == \
        ("dense", "gather", "batch")
    assert asked.cfg.decode_attn == "gather" and not asked.pad_prompts
    assert asked._bucket(13) == 13
    plain = TEngine(tparams, tcfg, num_slots=2, max_len=27 + 8 + 4, chunk=4,
                    device="cpu")
    a = asked.run(_requests(TRequest, tcfg, lens))
    b = plain.run(_requests(TRequest, tcfg, lens))
    assert a["kv"]["layout"] == "dense" and a["prefill_chunks"] == 0
    assert a["kv"]["bytes_in_use_peak"] == 0        # no KV strips
    assert _streams(a) == _streams(b)


def test_engine_matches_jax_engine():
    """The same flags (falling back alike), operand entropy with the JAX
    xi: the port's engine gives the JAX engine's token streams, and
    H/SE/MI/p_max within ATOL."""
    jcfg, jparams, tcfg, tparams = ssm_pair()
    kw = dict(num_slots=2, max_len=27 + 8 + 4, chunk=4, **PATH_FLAGS)
    lens = [13, 27, 5]
    jr = JEngine(jparams, jcfg, **kw).run(_requests(JRequest, jcfg, lens))
    tr = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                 **kw).run(_requests(TRequest, tcfg, lens))
    assert tr["kv"]["layout"] == jr["kv"]["layout"] == "dense"
    assert tr["prefill_mode"] == jr["prefill_mode"] == "batch"
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens, a.rid
        assert a.finish_reason == b.finish_reason
        for name in STEP_KEYS:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=name)


def test_decode_loop_reference_matches_jax_in_operand_mode():
    jcfg, jparams, tcfg, tparams = ssm_pair()
    prompts = _tokens(5, 3, 7)
    want = jax_decode_loop_reference(jparams, jcfg, prompts, 6)
    got = decode_loop_reference(
        tparams, tcfg, prompts, 6,
        decode_fn=S.build_decode_step(tcfg, head_noise=jax_head_noise()))
    np.testing.assert_array_equal(got["token"], np.asarray(want["token"]))
    for k in STEP_KEYS:
        assert_close(got[k], want[k], atol=ATOL, msg=k)


@pytest.mark.parametrize("entropy", ["operand", "kernel"])
def test_engine_scan_equals_the_per_token_loop(entropy):
    """Requests admitted at engine start: the ssm engine's chunks replay
    ``decode_loop_reference`` bit for bit (tokens, H, MI).  The loop
    prefills its equal-length prompts in one batch, the engine each
    prompt alone into its slot (``runner.prefill`` through
    ``write_slot``)."""
    _, _, tcfg, tparams = ssm_pair()
    cfg = dataclasses.replace(tcfg, head_entropy=entropy)
    ent = KernelEntropy(seed=3) if entropy == "kernel" else None
    gen, prompts = 8, _tokens(6, 3, 8)
    ref = decode_loop_reference(tparams, cfg, prompts, gen, entropy=ent)
    eng = TEngine(tparams, cfg, num_slots=3, max_len=8 + gen, chunk=4,
                  entropy=ent, device="cpu", **PATH_FLAGS)
    res = eng.run([TRequest(rid=i, prompt=prompts[i], max_new_tokens=gen)
                   for i in range(3)])
    for j, req in enumerate(res["requests"]):
        np.testing.assert_array_equal(req.tokens, ref["token"][:, j])
        for k in ("MI", "H"):
            np.testing.assert_array_equal(
                np.asarray(getattr(req, k), np.float32), ref[k][:, j])


def test_runner_start_prefill_and_slot_reuse():
    """The runner zeroes every cache leaf at ``start`` (a recurrent state
    must not survive a run), its prefill ignores the dense width and
    writes the slot's exact-length state, and a second prompt admitted
    into a used slot replaces its state whole."""
    _, _, tcfg, tparams = ssm_pair()
    eng = TEngine(tparams, tcfg, num_slots=2, max_len=24, chunk=4,
                  device="cpu")
    runner = eng.runner
    eng.run(_requests(TRequest, tcfg, [9, 6]))
    assert runner.cache["ssm"].abs().sum() > 0
    tok, cache, active, flags = runner.start()
    assert all(not t.any() for t in cache.values())
    for slot, seed in ((1, 4), (1, 5)):
        prompt = _tokens(seed, 1, 7 + seed)[0]
        runner.prefill(cache, slot, prompt, None)
        _, want = TM.prefill(tparams, tcfg, torch.from_numpy(prompt)[None],
                             999)
        for n in ("ssm", "conv"):
            assert torch.equal(cache[n][:, 1], want[n][:, 0])
            assert not cache[n][:, 0].any()
        assert cache["len"].tolist() == [0, 7 + seed]


@pytest.mark.parametrize("flags", [
    [], ["--kv-layout", "paged", "--decode-attn", "kernel", "--prefill",
         "chunked", "--entropy", "operand"]])
def test_cli_serves_the_reduced_mamba2_on_the_cpu(flags):
    from repro_torch.launch.serve import build_parser, serve
    args = build_parser().parse_args(
        ["--arch", "mamba2_370m", "--device", "cpu", "--reduced",
         "--slots", "2", "--num-requests", "3", "--prompt-len", "12",
         "--gen-len", "4", "--chunk", "4", *flags])
    r = serve(args)
    assert r["gen_tokens"] == 12
    assert r["kv"]["layout"] == "dense" and r["prefill_mode"] == "batch"
    assert r["prefill_chunks"] == 0
    for req in r["requests"]:
        assert req.state == "finished" and np.isfinite(req.MI).all()


def test_cli_without_a_gpu_raises():
    from repro_torch.launch.serve import build_parser, serve
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = build_parser().parse_args(["--arch", "mamba2_370m"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(args)
