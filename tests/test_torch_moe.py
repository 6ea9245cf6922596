"""The port's MoE family against the JAX package on reduced configs (E 8,
top-2, f32): the routed layer (routing, capacity drops, threaded expert
offsets), prefill, chunked prefill, operand-mode decode with the JAX xi
injected, the serving engine; and inside the port, chunked prefill
against batch prefill and the engine's scan against its per-token loop.
Tolerance: atol 1e-5 in f32 unless the check is bitwise.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_moe.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close,  # noqa: F401
                           jax_head_noise, meshless_reference, moe_pair,
                           to_numpy_tree)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.engine.runner import \
    decode_loop_reference as jax_decode_loop_reference
from repro.models import moe as JMoE
from repro.models import registry as JM
from repro_torch.core.entropy import KernelEntropy
from repro_torch.launch import steps as S
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.launch.engine.runner import decode_loop_reference
from repro_torch.models import moe as TMoE
from repro_torch.models import registry as TM
from repro_torch.models.transformer import layer

ATOL = 1e-5
STEP_KEYS = ("H", "SE", "MI", "p_max")
ARCHS = ("deepseek_moe_16b", "grok_1_314b")


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(
        1, vocab - 1, size=(B, S)).astype(np.int32)


def _jax_routing(monkeypatch):
    """Record the reference's top-k experts: ``moe_ffn`` calls
    ``jax.lax.top_k`` once a call."""
    seen = []
    top_k = jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        seen.append(np.asarray(out[1])[0])      # group axis G = 1
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    return seen


def _jax_keep(topi, E, C, offsets=None):
    """The reference's keep mask from its experts (``moe.moe_ffn``: the
    one-hot cumsum position, plus the carried offsets, against C)."""
    oh = jax.nn.one_hot(jnp.asarray(topi), E, dtype=jnp.float32)
    flat = oh.reshape(-1, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - 1.0) * flat,
                  axis=-1).reshape(topi.shape)
    if offsets is not None:
        pos = pos + jnp.asarray(offsets)[jnp.asarray(topi)]
    return np.asarray(pos < C)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["batch", "offsets", "overflow"])
def test_moe_ffn_matches_jax(monkeypatch, arch, mode):
    """One routed layer on the same inputs: experts and keep mask equal,
    aux and y within atol.  ``overflow`` forces C down to 3 (24 tokens x
    top-2 over 8 experts), so experts overflow and drops are held;
    ``offsets`` threads carried counts, whose update must be exact."""
    jcfg, jparams, tcfg, tparams = moe_pair(arch)
    x = np.random.default_rng(2).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    jbp = jax.tree.map(lambda a: a[1], jparams["blocks"])
    tbp = layer(tparams["blocks"], 1)
    E = tcfg.num_experts
    cap, off = {"batch": (None, None), "offsets": (5, None),
                "overflow": (3, None)}[mode]
    if mode == "offsets":
        off = np.random.default_rng(3).integers(0, 3, E).astype(np.float32)
    C = cap or max(int(24 * tcfg.top_k / E * tcfg.capacity_factor), 8)
    seen = _jax_routing(monkeypatch)
    kw = {} if off is None else {"expert_offsets": jnp.asarray(off)}
    want = JMoE.moe_ffn(jbp, jcfg, jnp.asarray(x), capacity=cap, **kw)
    tkw = {} if off is None else {"expert_offsets": torch.from_numpy(off)}
    got = TMoE.moe_ffn(tbp, tcfg, torch.from_numpy(x), capacity=cap, **tkw)
    r = TMoE.route(tbp, tcfg, torch.from_numpy(x).reshape(24, -1), C,
                   tkw.get("expert_offsets"))
    assert len(seen) == 1
    np.testing.assert_array_equal(r["topi"].numpy(), seen[0])
    keep = _jax_keep(seen[0], E, C, off)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    if mode != "batch":
        assert not keep.all()                   # the drop path ran
    assert_close(got[0], want[0], atol=ATOL, msg="y")
    assert_close(got[1], want[1], atol=ATOL, msg="aux")
    if off is not None:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_init_params_tree_matches_jax_layout():
    jcfg, jparams, tcfg, _ = moe_pair()
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
    assert got["blocks"]["router"]["w"].dtype == torch.float32
    w1 = got["blocks"]["experts_ep"]["w1"]
    assert abs(float(w1.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.02
    assert abs(float(got["blocks"]["router"]["w"].std()) / 0.02 - 1.0) < 0.05
    # layers are drawn apart, not copies of one draw
    assert not torch.equal(w1[0], w1[1])


def test_prefill_hidden_and_cache_match_jax():
    """Batch prefill of two prompts (one dispatch over 24 tokens)."""
    jcfg, jparams, tcfg, tparams = moe_pair()
    toks = _tokens(1, 2, 12)
    jh, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 20)
    th, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 20)
    assert_close(th, jh, atol=ATOL)
    for n in ("k", "v"):
        assert_close(tc[n], jc[n], atol=ATOL, msg=n)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_prefill_chunk_matches_jax_and_threads_exact_offsets():
    """Four 8-token chunks of a 30-token prompt (span 32, C 10) into a
    shuffled table: the returned (L, E) expert offsets equal the JAX
    walker's after every chunk, some expert overflows C, and the pools
    match."""
    jcfg, jparams, tcfg, tparams = moe_pair()
    jcfg = dataclasses.replace(jcfg, decode_attn="gather")
    tcfg = dataclasses.replace(tcfg, decode_attn="kernel")
    prompt = _tokens(4, 1, 30)[0]
    jc = JM.make_cache(jcfg, 2, 40, layout="paged", kv_block=4)
    tc = TM.make_cache(tcfg, 2, 40, device=CPU, layout="paged", kv_block=4)
    row = np.full((2, 10), -1, np.int32)
    row[1, :8] = (9, 3, 0, 7, 12, 5, 15, 1)
    jc["block_table"] = jnp.asarray(row)
    tc["block_table"] = torch.from_numpy(row.copy())
    L, E = tcfg.num_layers, tcfg.num_experts
    joff = jnp.zeros((L, E), jnp.float32)
    toff = torch.zeros((L, E), dtype=torch.float32)
    for off in (0, 8, 16, 24):
        chunk = np.zeros((1, 8), np.int32)
        real = prompt[off:off + 8]
        chunk[0, :len(real)] = real
        new_len = off + len(real)
        jc, joff = JM.prefill_chunk(jparams, jcfg, jnp.asarray(chunk), jc,
                                    jnp.int32(1), jnp.int32(off),
                                    jnp.int32(new_len), 32,
                                    expert_offsets=joff)
        tc, toff = TM.prefill_chunk(tparams, tcfg, torch.from_numpy(chunk),
                                    tc, 1, off, new_len, 32,
                                    expert_offsets=toff)
        np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    C = max(int(32 * tcfg.top_k / E * tcfg.capacity_factor), 8)
    assert (toff.sum(-1) == 32 * tcfg.top_k).all() and toff.max() > C
    for n in ("k", "v"):
        for blk in row[1, :8]:
            assert_close(tc[n][:, blk], np.asarray(jc[n])[:, blk],
                         atol=ATOL, msg=f"{n}[{blk}]")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_operand_decode_with_jax_noise_matches_jax(arch):
    """Staggered slot depths, four steps: tokens exact, H/SE/MI/p_max
    within atol, the caches close (grok: its soft-capped head and
    ``experts_tp``)."""
    jcfg, jparams, tcfg, tparams = moe_pair(arch)
    toks = _tokens(2, 3, 9)
    _, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 16)
    jc["len"] = jnp.asarray([9, 7, 4], jnp.int32)
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    tc["len"] = torch.tensor([9, 7, 4], dtype=torch.int32)
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
    for n in ("k", "v"):
        assert_close(tc[n], jc[n], atol=ATOL, msg=n)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def _requests(cls, cfg, lens, gen=8, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size - 1, size=n)
                .astype(np.int32), max_new_tokens=gen)
            for i, n in enumerate(lens)]


def _streams(res):
    return [(r.tokens, *(np.asarray(getattr(r, k), np.float32).tolist()
                         for k in STEP_KEYS), r.finish_reason)
            for r in res["requests"]]


@pytest.mark.parametrize("decode_attn", ["gather", "kernel"])
def test_chunked_prefill_equals_batch_prefill_inside_port(decode_attn):
    """Staggered mixed-length prompts (partial chunks, bucket pads,
    admissions mid-stream; the 27-token prompt overflows C 8), operand
    entropy: chunked prefill threading the expert offsets gives the batch
    prefill's streams bit for bit (tests/test_chunked_prefill.py holds the
    reference so)."""
    _, _, tcfg, tparams = moe_pair()
    lens = [13, 27, 5, 18]

    def run(mode):
        eng = TEngine(tparams, tcfg, num_slots=2, max_len=27 + 8 + 4,
                      chunk=4, kv_layout="paged", kv_block=4,
                      prefill_mode=mode, prefill_chunk=8,
                      decode_attn=decode_attn, device="cpu")
        return eng.run(_requests(TRequest, tcfg, lens))

    batch, chunked = run("batch"), run("chunked")
    assert chunked["prefill_mode"] == "chunked"
    assert chunked["prefill_chunks"] == 2 + 4 + 1 + 3
    assert _streams(chunked) == _streams(batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    """Paged KV, chunked prefill, operand entropy with the JAX xi: the
    port's engine gives the JAX engine's token streams, and H/SE/MI/p_max
    within atol (grok: its soft-capped head and ``experts_tp``)."""
    jcfg, jparams, tcfg, tparams = moe_pair(arch)
    kw = dict(num_slots=2, max_len=27 + 8 + 4, chunk=4, kv_layout="paged",
              kv_block=4, prefill_mode="chunked", prefill_chunk=8,
              decode_attn="gather")
    lens = [13, 27, 5]
    jr = JEngine(jparams, jcfg, **kw).run(_requests(JRequest, jcfg, lens))
    tr = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                 **kw).run(_requests(TRequest, tcfg, lens))
    assert tr["prefill_chunks"] == jr["prefill_chunks"]
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens, a.rid
        assert a.finish_reason == b.finish_reason
        for name in STEP_KEYS:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=name)


def test_decode_loop_reference_matches_jax_in_operand_mode():
    jcfg, jparams, tcfg, tparams = moe_pair()
    prompts = _tokens(5, 3, 7)
    want = jax_decode_loop_reference(jparams, jcfg, prompts, 6)
    got = decode_loop_reference(
        tparams, tcfg, prompts, 6,
        decode_fn=S.build_decode_step(tcfg, head_noise=jax_head_noise()))
    np.testing.assert_array_equal(got["token"], np.asarray(want["token"]))
    for k in STEP_KEYS:
        assert_close(got[k], want[k], atol=ATOL, msg=k)


@pytest.mark.parametrize("kv_layout,entropy,decode_attn", [
    ("dense", "operand", "gather"), ("paged", "kernel", "gather")])
def test_engine_scan_equals_the_per_token_loop(kv_layout, entropy,
                                               decode_attn):
    """Requests admitted at engine start: the moe engine's chunks replay
    ``decode_loop_reference`` bit for bit (tokens, H, MI).  The loop
    prefills its prompts in one dispatch, which couples them through the
    capacity (as in the reference), and the engine prefills each prompt
    alone; so both run at a capacity factor of E / K, where C is the
    token count and no expert can overflow."""
    _, _, tcfg, tparams = moe_pair()
    cfg = dataclasses.replace(tcfg, head_entropy=entropy,
                              capacity_factor=tcfg.num_experts / tcfg.top_k)
    ent = KernelEntropy(seed=3) if entropy == "kernel" else None
    gen, prompts = 8, _tokens(6, 3, 8)
    ref = decode_loop_reference(tparams, cfg, prompts, gen, entropy=ent)
    eng = TEngine(tparams, cfg, num_slots=3, max_len=8 + gen, chunk=4,
                  entropy=ent, kv_layout=kv_layout, kv_block=4,
                  decode_attn=decode_attn, device="cpu")
    res = eng.run([TRequest(rid=i, prompt=prompts[i], max_new_tokens=gen)
                   for i in range(3)])
    for j, req in enumerate(res["requests"]):
        np.testing.assert_array_equal(req.tokens, ref["token"][:, j])
        for k in ("MI", "H"):
            np.testing.assert_array_equal(
                np.asarray(getattr(req, k), np.float32), ref[k][:, j])


def test_registry_gates_for_the_moe_family():
    _, _, tcfg, _ = moe_pair()
    assert TM.supports_chunked_prefill(tcfg)
    assert not TM.supports_prefix_cache(tcfg)
    assert TM.supports_prefix_cache(dataclasses.replace(tcfg,
                                                        family="dense"))
    with pytest.raises(ValueError, match="unknown model family"):
        TM.module_for(dataclasses.replace(tcfg, family="retnet"))
    from repro_torch.models import encdec, transformer
    assert TM.module_for(dataclasses.replace(tcfg, family="vlm")) \
        is transformer
    assert TM.module_for(dataclasses.replace(tcfg, family="audio")) is encdec


@pytest.mark.parametrize("flags", [
    [], ["--kv-layout", "paged", "--decode-attn", "kernel", "--prefill",
         "chunked", "--entropy", "operand"]])
def test_cli_serves_the_reduced_moe_on_the_cpu(flags):
    from repro_torch.launch.serve import build_parser, serve
    args = build_parser().parse_args(
        ["--arch", "deepseek_moe_16b", "--device", "cpu", "--reduced",
         "--slots", "2", "--num-requests", "3", "--prompt-len", "12",
         "--gen-len", "4", "--chunk", "4", "--prefill-chunk", "8", *flags])
    r = serve(args)
    assert r["gen_tokens"] == 12
    for req in r["requests"]:
        assert req.state == "finished" and np.isfinite(req.MI).all()
    if flags:
        assert r["prefill_mode"] == "chunked" and r["prefill_chunks"] == 6
