"""The port's vlm family (phi-3-vision reduced: 2 layers, d 128, 4 MHA
heads of D 32, ff 256, gated silu, 8 prefix embeds, V 512, f32) against
the JAX package: the init tree, forward and prefill with the prefix
embeds spliced in, operand-mode decode with the JAX xi injected (dense
and paged), the serving engine (batch prefill, whatever is asked) and
the per-token loop; and inside the port, the registry's gates, the
kernel path against the gather path, the engine's chunks against the
per-token loop and the CLI.

Every model-level test feeds random prefix embeds, made with numpy from
a seed: zero embeds make the prefix rows' K and V exactly 0 in every
layer (``rms_norm`` of zeros), so a splice at the wrong rows, in the
wrong order or with the wrong cast would pass a zero-embeds test.  The
engine tests feed zeros, as both engines do (their frontend is a stub);
the guard test shows that the suite sees changed and misplaced embeds.

Tolerance: atol 1e-5 in f32 on hidden states and H/SE/MI/p_max; on
cache leaves atol 1e-5 plus rtol 1e-5; token streams equal; bitwise
where stated.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_vlm.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, jax_head_noise,  # noqa: F401
                           meshless_reference, to_numpy_tree, vlm_pair)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.engine.runner import \
    decode_loop_reference as jax_decode_loop_reference
from repro.models import registry as JM
from repro.models import transformer as JT
from repro_torch.core.entropy import KernelEntropy
from repro_torch.launch import steps as S
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.launch.engine.runner import decode_loop_reference
from repro_torch.models import registry as TM
from repro_torch.models import transformer as TT

ATOL = 1e-5
RTOL_CACHE = 1e-5
P = 8
STEP_KEYS = ("H", "SE", "MI", "p_max")
ENGINE = dict(num_slots=2, max_len=24 + 8 + 4, chunk=4, kv_layout="paged",
              kv_block=4, prefill_mode="chunked", prefill_chunk=8)


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(
        1, vocab - 1, size=(B, S)).astype(np.int32)


def _embeds(seed, B, d=128):
    return np.random.default_rng(seed).standard_normal(
        (B, P, d)).astype(np.float32)


def _close_cache(got, want, msg):
    assert_close(got, want, atol=ATOL, rtol=RTOL_CACHE, msg=msg)


def test_init_params_tree_matches_jax_layout():
    """The port's random init has the JAX tree's names, shapes and dtypes
    (the dense tree: the vlm family adds no parameter), and
    ``params_from_numpy`` carries the JAX tree across as it comes."""
    jcfg, jparams, tcfg, tparams = vlm_pair()
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

    assert set(got) == set(want) == set(tparams) \
        == {"embed", "blocks", "final_norm", "head"}
    for k in ("embed", "blocks", "final_norm"):
        assert leaves({k: got[k]}) == leaves({k: want[k]}) \
            == leaves({k: tparams[k]}), k
    assert set(got["blocks"]["mlp"]) == {"w1", "w2", "w3"}       # gated
    assert "bq" not in got["blocks"]["attn"]                    # no bias
    assert got["head"]["mu"].shape == (128, 512)
    assert torch.equal(tparams["blocks"]["attn"]["wq"],
                       torch.from_numpy(want["blocks"]["attn"]["wq"].copy()))


def test_forward_matches_jax_with_random_embeds():
    """The whole hidden sequence of two 12-token prompts whose first 8
    positions are random embeds, and the per-layer K/V."""
    jcfg, jparams, tcfg, tparams = vlm_pair()
    toks, emb = _tokens(0, 2, 12), _embeds(0, 2)
    jh, (jk, jv) = JT.forward(jparams, jcfg, jnp.asarray(toks),
                              prefix_embeds=jnp.asarray(emb), return_kv=True)
    th, (tk, tv) = TT.forward(tparams, tcfg, torch.from_numpy(toks),
                              torch.from_numpy(emb), return_kv=True)
    assert th.shape == (2, 12, 128) and tk.shape == (2, 2, 12, 4, 32)
    assert_close(th, jh, atol=ATOL)
    _close_cache(tk, jk, "k")
    _close_cache(tv, jv, "v")


@pytest.mark.parametrize("S", [8, 9, 16])
def test_prefill_hidden_and_cache_match_jax(S):
    """Batch prefill of two prompts with random embeds (a prompt of P
    tokens is the prefix alone): the last hidden and every cache leaf."""
    jcfg, jparams, tcfg, tparams = vlm_pair()
    toks, emb = _tokens(S, 2, S), _embeds(S, 2)
    jh, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 20,
                        jnp.asarray(emb))
    th, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 20,
                        torch.from_numpy(emb))
    assert set(tc) == set(jc) == {"k", "v", "len"}
    assert_close(th, jh, atol=ATOL)
    for n in ("k", "v"):
        assert tc[n].shape == jc[n].shape == (2, 2, 20, 4, 32), n
        _close_cache(tc[n], jc[n], n)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_prompt_shorter_than_the_prefix_raises():
    """The reference fails there with a broadcasting error; the port
    names the prefix's length."""
    _, _, tcfg, tparams = vlm_pair()
    with pytest.raises(ValueError, match="8 prefix embeds"):
        TM.prefill(tparams, tcfg, torch.from_numpy(_tokens(1, 1, 7)), 16,
                   torch.from_numpy(_embeds(1, 1)))


def _paged(mod, cfg, subs, rows, device=None):
    """A 3-slot paged cache (kv_block 4, 24 blocks) with each batch-1
    prefill cache written into its slot through ``rows``."""
    kw = {} if device is None else {"device": device}
    cache = mod.make_cache(cfg, 3, 16, layout="paged", kv_block=4,
                           num_blocks=24, **kw)
    for slot, (sub, row) in enumerate(zip(subs, rows)):
        if device is None:
            cache = mod.write_slot(cfg, cache, jnp.int32(slot), sub,
                                   jnp.asarray(row))
        else:
            cache = mod.write_slot(cfg, cache, slot, sub,
                                   torch.from_numpy(row))
    return cache


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_operand_decode_with_jax_noise_matches_jax(layout):
    """Random embeds, staggered slot depths, four steps with the JAX xi:
    tokens exact, H/SE/MI/p_max within atol, the K/V close after; the
    step writes the cache in place (the same tensors come back).  Paged:
    each slot written from its own batch prefill through a shuffled
    block row (``write_slot``), JAX's gather read against the port's
    kernel read (its plain version here)."""
    jcfg, jparams, tcfg, tparams = vlm_pair()
    toks, emb = _tokens(2, 3, 10), _embeds(2, 3)
    lens = [10, 9, 8]
    if layout == "dense":
        _, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 16,
                           jnp.asarray(emb))
        _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 16,
                           torch.from_numpy(emb))
    else:
        tcfg = dataclasses.replace(tcfg, decode_attn="kernel")
        rows = np.random.default_rng(1).permutation(24)[:12] \
            .reshape(3, 4).astype(np.int32)
        jsubs = [JM.prefill(jparams, jcfg, jnp.asarray(toks[b:b + 1]), 10,
                            jnp.asarray(emb[b:b + 1]))[1] for b in range(3)]
        tsubs = [TM.prefill(tparams, tcfg, torch.from_numpy(toks[b:b + 1]),
                            10, torch.from_numpy(emb[b:b + 1]))[1]
                 for b in range(3)]
        jc = _paged(JM, jcfg, jsubs, rows)
        tc = _paged(TM, tcfg, tsubs, rows, device=CPU)
        assert tc["k"].shape == (2, 25, 4, 4, 32)
    jc["len"] = jnp.asarray(lens, jnp.int32)
    tc["len"] = torch.tensor(lens, dtype=torch.int32)
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
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
    assert {k: v.data_ptr() for k, v in tc.items()} == ptrs
    for n in ("k", "v"):
        got = tc[n] if layout == "dense" else tc[n][:, :24]    # the sink
        _close_cache(got, np.asarray(jc[n]), n)
    np.testing.assert_array_equal(tc["len"].numpy(), [14, 13, 12])


def test_registry_gates_for_the_vlm_family():
    """The dense transformer serves vlm: paged KV, prompt padding, batch
    prefill only (no chunked prefill, no prefix cache); the config-less
    audio family maps to encdec, as in the reference."""
    from repro_torch.configs.registry import (ARCH_IDS, PORTED_FAMILIES,
                                              get_config)
    from repro_torch.models import encdec as TE
    _, _, tcfg, tparams = vlm_pair()
    assert TM.module_for(tcfg) is TT
    assert TM.module_for(dataclasses.replace(tcfg, family="audio")) is TE
    assert TM.supports_paged(tcfg)
    assert TM.supports_prompt_padding(tcfg)
    assert not TM.supports_chunked_prefill(tcfg)
    assert not TM.supports_prefix_cache(tcfg)
    assert {get_config(a).family for a in ARCH_IDS} == set(PORTED_FAMILIES)
    paged = TM.make_cache(tcfg, 2, 16, device=CPU, layout="paged",
                          kv_block=4, num_blocks=10)
    assert set(paged) == {"k", "v", "len", "block_table"}
    with pytest.raises(ValueError, match="no chunked prefill"):
        TM.prefill_chunk(tparams, tcfg, torch.ones((1, 4), dtype=torch.int32),
                         paged, 0, 0, 4, 4)


def _requests(cls, cfg, lens, gen=8, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size - 1, size=n)
                .astype(np.int32), max_new_tokens=gen)
            for i, n in enumerate(lens)]


def test_engine_matches_jax_engine():
    """Paged KV with chunked prefill asked for: both engines take batch
    prefill (zero embeds, prompts padded to a kv_block multiple), gather
    read, operand entropy with the JAX xi: the port's engine gives the
    JAX engine's token streams, and H/SE/MI/p_max within atol."""
    jcfg, jparams, tcfg, tparams = vlm_pair()
    kw = dict(ENGINE, decode_attn="gather")
    lens = [13, 21, 9]
    jr = JEngine(jparams, jcfg, **kw).run(_requests(JRequest, jcfg, lens))
    tr = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                 **kw).run(_requests(TRequest, tcfg, lens))
    assert tr["prefill_mode"] == jr["prefill_mode"] == "batch"
    assert tr["prefill_chunks"] == jr["prefill_chunks"] == 0
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens, a.rid
        assert a.finish_reason == b.finish_reason
        for name in STEP_KEYS:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=name)


def test_kernel_path_equals_gather_path():
    """Operand entropy: the kernel read (the paged decode kernel's plain
    version here) gives the gather read's streams."""
    _, _, tcfg, tparams = vlm_pair()
    lens = [13, 21, 9]

    def run(decode_attn):
        eng = TEngine(tparams, tcfg, device="cpu",
                      **dict(ENGINE, decode_attn=decode_attn))
        return eng.run(_requests(TRequest, tcfg, lens))

    kernel, gather = run("kernel"), run("gather")
    assert kernel["decode_attn"]["mode"] == "kernel"
    assert [r.tokens for r in kernel["requests"]] == \
        [r.tokens for r in gather["requests"]]
    for a, b in zip(kernel["requests"], gather["requests"]):
        for name in STEP_KEYS:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=name)


def test_decode_loop_reference_matches_jax_in_operand_mode():
    """The per-token loop with random embeds as its modality, against the
    JAX loop given the same embeds; a family that takes no modality
    refuses one."""
    jcfg, jparams, tcfg, tparams = vlm_pair()
    prompts, emb = _tokens(5, 3, 11), _embeds(5, 3)
    want = jax_decode_loop_reference(jparams, jcfg, prompts, 6,
                                     modality=jnp.asarray(emb))
    got = decode_loop_reference(
        tparams, tcfg, prompts, 6, modality=emb,
        decode_fn=S.build_decode_step(tcfg, head_noise=jax_head_noise()))
    np.testing.assert_array_equal(got["token"], np.asarray(want["token"]))
    for k in STEP_KEYS:
        assert_close(got[k], want[k], atol=ATOL, msg=k)
    dense = dataclasses.replace(tcfg, family="dense")
    with pytest.raises(ValueError, match="no modality"):
        decode_loop_reference(tparams, dense, prompts, 2, modality=emb)


@pytest.mark.parametrize("kv_layout,entropy,prefill_mode", [
    ("dense", "operand", "batch"), ("paged", "kernel", "batch"),
    ("paged", "operand", "chunked")])
def test_engine_scan_equals_the_per_token_loop(kv_layout, entropy,
                                               prefill_mode):
    """Requests admitted at engine start, zero embeds in both: the
    engine's chunks replay ``decode_loop_reference`` (dense cache, batch
    prefill of the three prompts at once) bit for bit (tokens, H, MI);
    chunked prefill asked for falls back to batch."""
    _, _, tcfg, tparams = vlm_pair()
    cfg = dataclasses.replace(tcfg, head_entropy=entropy)
    ent = KernelEntropy(seed=3) if entropy == "kernel" else None
    gen, prompts = 8, _tokens(6, 3, 20)
    ref = decode_loop_reference(tparams, cfg, prompts, gen, entropy=ent,
                                modality=np.zeros((3, P, 128), np.float32))
    eng = TEngine(tparams, cfg, num_slots=3, max_len=20 + gen, chunk=4,
                  entropy=ent, kv_layout=kv_layout, kv_block=4,
                  prefill_mode=prefill_mode, prefill_chunk=8, device="cpu")
    res = eng.run([TRequest(rid=i, prompt=prompts[i], max_new_tokens=gen)
                   for i in range(3)])
    assert res["prefill_mode"] == "batch" and res["prefill_chunks"] == 0
    for j, req in enumerate(res["requests"]):
        np.testing.assert_array_equal(req.tokens, ref["token"][:, j])
        for k in ("MI", "H"):
            np.testing.assert_array_equal(
                np.asarray(getattr(req, k), np.float32), ref[k][:, j])


def _misplaced(monkeypatch):
    """Make the port splice the embeds over the LAST P rows of the prompt
    (a mutation the suite must see)."""
    def wrong(x, prefix_embeds):
        n = prefix_embeds.shape[1]
        return torch.cat([x[:, :-n], prefix_embeds.to(x.dtype)], dim=1)

    monkeypatch.setattr(TT, "splice_prefix", wrong)


@pytest.mark.parametrize("change", ["embeds", "wrong_rows", "token_ids"])
def test_the_suite_sees_the_splice(change, monkeypatch):
    """Guard: two different random embeds give different prefill hidden
    states and prefix K/V, and zero embeds give prefix K/V exactly 0 (why
    the model tests feed random embeds); embeds spliced over the last P
    rows move the hidden state and the prefix K/V far beyond the
    tolerance of the JAX comparison; the token ids under the prefix
    change nothing."""
    jcfg, jparams, tcfg, tparams = vlm_pair()
    toks = _tokens(8, 1, 12)
    ea, eb = (torch.from_numpy(_embeds(s, 1)) for s in (8, 9))
    ha, ca = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 12, ea)
    if change == "embeds":
        hb, cb = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 12, eb)
        assert (ha - hb).abs().max() > 1e-2
        for n in ("k", "v"):
            assert (ca[n][:, :, :P] - cb[n][:, :, :P]).abs().max() > 1e-2
        _, c0 = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 12,
                           torch.zeros_like(ea))
        assert not c0["k"][:, :, :P].any() and not c0["v"][:, :, :P].any()
        assert c0["k"][:, :, P:].any()
        return
    if change == "token_ids":
        other = toks.copy()
        other[:, :P] = _tokens(10, 1, P)
        assert (other != toks).any()
        ho, co = TM.prefill(tparams, tcfg, torch.from_numpy(other), 12, ea)
        assert torch.equal(ho, ha)
        assert all(torch.equal(co[n], ca[n]) for n in ("k", "v"))
        return
    jh, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 12,
                        jnp.asarray(ea.numpy()))
    assert_close(ha, jh, atol=ATOL)
    _misplaced(monkeypatch)
    hw, cw = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 12, ea)
    assert np.abs(hw.numpy() - np.asarray(jh)).max() > 100 * ATOL
    assert np.abs(cw["k"][:, :, :P].numpy()
                  - np.asarray(jc["k"])[:, :, :P]).max() > 100 * ATOL


@pytest.mark.parametrize("flags", [
    [], ["--kv-layout", "paged", "--decode-attn", "kernel", "--prefill",
         "chunked"]])
def test_cli_serves_the_reduced_vlm_on_the_cpu(flags):
    from repro_torch.launch.serve import build_parser, serve
    args = build_parser().parse_args(
        ["--arch", "phi_3_vision_4_2b", "--device", "cpu", "--reduced",
         "--slots", "2", "--num-requests", "3", "--prompt-len", "12",
         "--gen-len", "4", "--chunk", "4", *flags])
    r = serve(args)
    assert r["gen_tokens"] == 12
    assert r["prefill_mode"] == "batch" and r["prefill_chunks"] == 0
    assert r["kv"]["layout"] == ("paged" if flags else "dense")
    for req in r["requests"]:
        assert req.state == "finished" and np.isfinite(req.MI).all()


def test_cli_without_a_gpu_raises():
    from repro_torch.launch.serve import build_parser, serve
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = build_parser().parse_args(
        ["--arch", "phi_3_vision_4_2b", "--kv-layout", "paged",
         "--decode-attn", "kernel", "--prefill", "chunked"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(args)
