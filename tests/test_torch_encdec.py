"""The port's encdec family (seamless-m4t-medium reduced: 2 encoder and 2
decoder layers, d 128, 4 MHA heads of D 32, ff 256, gelu, V 512, f32)
against the JAX package: the init tree, the encoder, the cross K/V,
prefill, operand-mode decode with the JAX xi injected (dense and paged),
the chunked-prefill walker (first chunk with the frames), the serving
engine and the per-token loop; and inside the port, chunked against batch
prefill, the slot write, the registry's gates, the kernel path against
the gather path and the engine's chunks against the per-token loop.

Every model-level test feeds random frames, made with numpy from a seed:
zero frames make the encoder output exactly 0 (``rms_norm`` of zeros),
hence ``ck`` / ``cv`` 0 and a cross-attention that adds nothing, so a
broken encoder or cross path would pass a zero-frame test.  The engine
tests feed zeros, as both engines do (their frontend is a stub); the
guard test shows that the suite sees the frames and the cross path.

Tolerance: atol 1e-5 in f32 on hidden states and H/SE/MI/p_max; on
cache leaves atol 1e-5 plus rtol 1e-5; token streams equal; bitwise
where stated.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_encdec.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, encdec_pair,  # noqa: F401
                           jax_head_noise, meshless_reference, to_numpy_tree)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.engine.runner import \
    decode_loop_reference as jax_decode_loop_reference
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import registry as JM
from repro_torch.core.entropy import KernelEntropy
from repro_torch.launch import steps as S
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.launch.engine.runner import decode_loop_reference
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import registry as TM

ATOL = 1e-5
RTOL_CACHE = 1e-5
STEP_KEYS = ("H", "SE", "MI", "p_max")
LEAVES = ("k", "v", "ck", "cv")
ENGINE = dict(num_slots=2, max_len=40 + 8 + 4, chunk=4, kv_layout="paged",
              kv_block=4, prefill_mode="chunked", prefill_chunk=16)


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(
        1, vocab - 1, size=(B, S)).astype(np.int32)


def _frames(seed, B, d=128):
    return np.random.default_rng(seed).standard_normal(
        (B, TE.ENC_LEN, d)).astype(np.float32)


def _close_cache(got, want, msg):
    assert_close(got, want, atol=ATOL, rtol=RTOL_CACHE, msg=msg)


def test_init_params_tree_matches_jax_layout():
    """The port's random init has the JAX tree's names, shapes and dtypes
    (encoder and decoder stacked on their layer axes), with its
    distributions; ``params_from_numpy`` walks the JAX tree as it comes."""
    _, jparams, tcfg, tparams = encdec_pair()
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

    assert set(got) == set(want) == set(tparams)
    for k in ("encoder", "decoder", "embed"):
        assert leaves(got[k]) == leaves(want[k]) == leaves(tparams[k]), k
    for k in ("enc_norm", "final_norm"):
        assert leaves({k: got[k]}) == leaves({k: want[k]})
    dec = got["decoder"]
    assert set(dec) == {"ln1", "self_attn", "ln_x", "cross_attn", "ln2",
                        "mlp"}
    assert set(got["encoder"]) == {"ln1", "attn", "ln2", "mlp"}
    assert dec["cross_attn"]["wq"].shape == (2, 128, 128)
    assert (dec["ln_x"] == 1).all() and (got["enc_norm"] == 1).all()
    assert abs(float(dec["cross_attn"]["wk"].std()) * np.sqrt(tcfg.d_model)
               - 1.0) < 0.02
    assert abs(float(got["encoder"]["mlp"]["w2"].std())
               * np.sqrt(tcfg.d_ff) - 1.0) < 0.03
    assert not torch.equal(got["encoder"]["attn"]["wq"][0],
                           got["encoder"]["attn"]["wq"][1])
    assert got["head"]["mu"].shape == (tcfg.d_model, tcfg.vocab_size)


def test_encode_matches_jax():
    """The bidirectional encoder (RoPE, non-causal, ``enc_norm``) over
    ENC_LEN random frames of two requests."""
    jcfg, jparams, tcfg, tparams = encdec_pair()
    assert TE.ENC_LEN == JE.ENC_LEN == 1024
    fr = _frames(0, 2)
    want = JE.encode(jparams, jcfg, jnp.asarray(fr))
    got = TE.encode(tparams, tcfg, torch.from_numpy(fr))
    assert got.shape == (2, 1024, 128) and got.dtype == torch.float32
    assert_close(got, want, atol=ATOL)


def test_make_cross_kv_matches_jax():
    """Cross K/V of every decoder layer from one encoder output: the
    projections alone, (B, ENC_LEN, Hkv, D)."""
    jcfg, jparams, tcfg, tparams = encdec_pair()
    enc = np.random.default_rng(1).standard_normal(
        (2, 1024, 128)).astype(np.float32)
    for i in range(2):
        jp = jax.tree.map(lambda a: a[i], jparams["decoder"]["cross_attn"])
        tp = {k: v[i] for k, v in tparams["decoder"]["cross_attn"].items()}
        jk, jv = JL.make_cross_kv(jp, jcfg, jnp.asarray(enc))
        tk, tv = TL.make_cross_kv(tp, tcfg, torch.from_numpy(enc))
        assert tk.shape == tv.shape == (2, 1024, 4, 32)
        assert_close(tk, jk, atol=ATOL, msg=f"k {i}")
        assert_close(tv, jv, atol=ATOL, msg=f"v {i}")


@pytest.mark.parametrize("S", [7, 16])
def test_prefill_hidden_and_cache_match_jax(S):
    """Batch prefill of two prompts with random frames: the last hidden
    and every cache leaf, ``ck`` / ``cv`` included."""
    jcfg, jparams, tcfg, tparams = encdec_pair()
    toks, fr = _tokens(S, 2, S), _frames(S, 2)
    jh, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 20,
                        jnp.asarray(fr))
    th, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 20,
                        torch.from_numpy(fr))
    assert set(tc) == set(jc) == {*LEAVES, "len"}
    assert_close(th, jh, atol=ATOL)
    for n in LEAVES:
        assert tc[n].shape == jc[n].shape, n
        _close_cache(tc[n], jc[n], n)
    assert tc["ck"].shape == (2, 2, 1024, 4, 32)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


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
    """Random frames, staggered slot depths, four steps with the JAX xi:
    tokens exact, H/SE/MI/p_max within atol, every leaf close after; the
    step writes the cache in place (the same tensors come back) and
    leaves ``ck`` / ``cv`` untouched.  Paged: JAX's gather read against
    the port's kernel read (its plain version here)."""
    jcfg, jparams, tcfg, tparams = encdec_pair()
    toks, fr = _tokens(2, 3, 9), _frames(2, 3)
    lens = [9, 7, 4]
    if layout == "dense":
        _, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 16,
                           jnp.asarray(fr))
        _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 16,
                           torch.from_numpy(fr))
    else:
        tcfg = dataclasses.replace(tcfg, decode_attn="kernel")
        rows = np.random.default_rng(1).permutation(24)[:12] \
            .reshape(3, 4).astype(np.int32)
        jsubs = [JM.prefill(jparams, jcfg, jnp.asarray(toks[b:b + 1]), 9,
                            jnp.asarray(fr[b:b + 1]))[1] for b in range(3)]
        tsubs = [TM.prefill(tparams, tcfg, torch.from_numpy(toks[b:b + 1]),
                            9, torch.from_numpy(fr[b:b + 1]))[1]
                 for b in range(3)]
        jc = _paged(JM, jcfg, jsubs, rows)
        tc = _paged(TM, tcfg, tsubs, rows, device=CPU)
        assert tc["k"].shape == (2, 25, 4, 4, 32)
    jc["len"] = jnp.asarray(lens, jnp.int32)
    tc["len"] = torch.tensor(lens, dtype=torch.int32)
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    cross = {n: tc[n].clone() for n in ("ck", "cv")}
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
    for n in ("ck", "cv"):
        assert torch.equal(tc[n], cross[n]), n
    for n in LEAVES:
        want = np.asarray(jc[n])
        got = tc[n] if layout == "dense" or n in ("ck", "cv") \
            else tc[n][:, :24]                                # the sink
        _close_cache(got, want, n)
    np.testing.assert_array_equal(tc["len"].numpy(), [13, 11, 8])


@pytest.mark.parametrize("decode_attn", ["gather", "kernel"])
def test_prefill_chunk_walks_to_the_jax_cache(decode_attn):
    """A 37-token prompt (span 40) in chunks of 16, zero-padded, into slot
    1 of a shuffled table, the first chunk with random frames: after
    every chunk the slot's pool blocks and ``ck`` / ``cv`` match the JAX
    walker's (gather read), ``len`` is pinned, and slot 0's cross strips
    (a previous occupant's) stay untouched; the first chunk's strips are
    ``make_cross_kv(encode(frames))``."""
    jcfg, jparams, tcfg, tparams = encdec_pair()
    tcfg = dataclasses.replace(tcfg, decode_attn=decode_attn)
    prompt = np.zeros((48,), np.int32)
    prompt[:37] = _tokens(4, 1, 37)[0]
    fr = _frames(4, 1)
    jc = JM.make_cache(jcfg, 2, 48, layout="paged", kv_block=4)
    tc = TM.make_cache(tcfg, 2, 48, device=CPU, layout="paged", kv_block=4)
    row = np.full((2, 12), -1, np.int32)
    row[1, :10] = (9, 3, 0, 7, 12, 5, 15, 1, 20, 11)
    jc["block_table"] = jnp.asarray(row)
    tc["block_table"] = torch.from_numpy(row.copy())
    tc["ck"][:, 0].fill_(0.5)
    tc["cv"][:, 0].fill_(-0.5)
    for off in (0, 16, 32):
        chunk = prompt[None, off:off + 16]
        new_len = min(off + 16, 37)
        frames = fr if off == 0 else None
        jc = JM.prefill_chunk(
            jparams, jcfg, jnp.asarray(chunk), jc, jnp.int32(1),
            jnp.int32(off), jnp.int32(new_len), 40,
            **({} if frames is None else {"frames": jnp.asarray(frames)}))
        tc = TM.prefill_chunk(
            tparams, tcfg, torch.from_numpy(chunk), tc, 1, off, new_len, 40,
            **({} if frames is None else {"frames": torch.from_numpy(frames)}))
        assert tc["len"].tolist() == [0, new_len]
        for n in ("ck", "cv"):
            _close_cache(tc[n][:, 1], np.asarray(jc[n])[:, 1],
                         f"{n} at {off}")
        assert (tc["ck"][:, 0] == 0.5).all() and (tc["cv"][:, 0] == -0.5).all()
        for n in ("k", "v"):
            for blk in row[1, :10]:
                _close_cache(tc[n][:, blk], np.asarray(jc[n])[:, blk],
                             f"{n}[{blk}] at {off}")
    enc = TE.encode(tparams, tcfg, torch.from_numpy(fr))
    for i in range(2):
        p = {k: v[i] for k, v in tparams["decoder"]["cross_attn"].items()}
        k, v = TL.make_cross_kv(p, tcfg, enc)
        assert torch.equal(tc["ck"][i, 1], k[0])
        assert torch.equal(tc["cv"][i, 1], v[0])


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
    """Staggered mixed-length prompts (padded 16-token chunks, admissions
    mid-stream), operand entropy: chunked prefill, its first chunk
    running the encoder, gives the batch prefill's streams bit for bit."""
    _, _, tcfg, tparams = encdec_pair()
    lens = [13, 37, 5, 18]

    def run(mode):
        eng = TEngine(tparams, tcfg, device="cpu",
                      **dict(ENGINE, prefill_mode=mode,
                             decode_attn=decode_attn))
        return eng.run(_requests(TRequest, tcfg, lens))

    batch, chunked = run("batch"), run("chunked")
    assert chunked["prefill_mode"] == "chunked"
    assert chunked["prefill_chunks"] == 1 + 3 + 1 + 2
    assert _streams(chunked) == _streams(batch)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_write_slot_writes_only_its_slots_cross_strips(layout):
    """A batch-1 prefill cache lands in slot 1 of a 3-slot cache: the
    slot's ``ck`` / ``cv`` are replaced whole, in place (the tensors keep
    their addresses), its self-attention K/V go into its strip or through
    its block row, ``len`` is set, and no other slot changes."""
    _, _, tcfg, tparams = encdec_pair()
    paged = layout == "paged"
    cache = TM.make_cache(tcfg, 3, 16, device=CPU, layout=layout,
                          kv_block=4, num_blocks=12)
    g = torch.Generator().manual_seed(3)
    for n in LEAVES:
        cache[n].copy_(torch.randn(cache[n].shape, generator=g))
    cache["len"].copy_(torch.tensor([5, 6, 7], dtype=torch.int32))
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, sub = TM.prefill(tparams, tcfg, torch.from_numpy(_tokens(3, 1, 10)),
                        10 if paged else 16,
                        torch.from_numpy(_frames(3, 1)))
    row = torch.tensor([6, 2, 9, -1], dtype=torch.int32)
    out = TM.write_slot(tcfg, cache, 1, sub, row if paged else None)
    assert out is cache
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    for n in ("ck", "cv") + (() if paged else ("k", "v")):
        assert torch.equal(cache[n][:, 1], sub[n][:, 0]), n
        for s in (0, 2):
            assert torch.equal(cache[n][:, s], before[n][:, s]), n
    if paged:
        for n in ("k", "v"):
            got = cache[n][:, row[:3].long()].reshape(2, 12, 4, 32)[:, :10]
            assert torch.equal(got, sub[n][:, 0]), n
            untouched = [b for b in range(13) if b not in (6, 2, 9, 12)]
            assert torch.equal(cache[n][:, untouched],
                               before[n][:, untouched])
        assert cache["block_table"][1].tolist() == row.tolist()
    np.testing.assert_array_equal(cache["len"].numpy(), [5, 10, 7])


def test_registry_gates_for_the_encdec_family():
    _, _, tcfg, _ = encdec_pair()
    assert TM.module_for(tcfg) is TE
    assert TM.supports_paged(tcfg)
    assert TM.supports_chunked_prefill(tcfg)
    assert TM.supports_prompt_padding(tcfg)
    assert not TM.supports_prefix_cache(tcfg)
    assert not {"ck", "cv"} & set(TM.PAGED_KV_LEAVES)
    paged = TM.make_cache(tcfg, 2, 16, device=CPU, layout="paged",
                          kv_block=4, num_blocks=10)
    assert set(paged) == {*LEAVES, "len", "block_table"}
    assert paged["k"].shape == (2, 11, 4, 4, 32)          # + the sink block
    assert paged["ck"].shape == (2, 2, 1024, 4, 32)
    assert TM.kv_bytes(paged) == 2 * 2 * 10 * 4 * 4 * 32 * 4
    dense = TM.make_cache(tcfg, 2, 16, device=CPU)
    assert dense["k"].shape == (2, 2, 16, 4, 32)
    assert set(dense) == {*LEAVES, "len"}
    with pytest.raises(ValueError, match="frames"):
        TM.prefill(encdec_pair()[3], tcfg, torch.ones((1, 4), dtype=torch.int32),
                   4)


def test_engine_matches_jax_engine():
    """Paged KV, chunked prefill (16-token chunks, the first running the
    encoder on zero frames in both engines), gather read, operand entropy
    with the JAX xi: the port's engine gives the JAX engine's token
    streams and prefill chunk count, and H/SE/MI/p_max within atol."""
    jcfg, jparams, tcfg, tparams = encdec_pair()
    kw = dict(ENGINE, decode_attn="gather")
    lens = [13, 37, 5]
    jr = JEngine(jparams, jcfg, **kw).run(_requests(JRequest, jcfg, lens))
    tr = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                 **kw).run(_requests(TRequest, tcfg, lens))
    assert tr["prefill_chunks"] == jr["prefill_chunks"] == 1 + 3 + 1
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens, a.rid
        assert a.finish_reason == b.finish_reason
        for name in STEP_KEYS:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=name)


def test_kernel_path_equals_gather_path():
    """Operand entropy: the kernel read (the plain versions of the paged
    decode and prefill kernels here) gives the gather read's streams."""
    _, _, tcfg, tparams = encdec_pair()
    lens = [13, 37, 5]

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
    """The per-token loop with random frames as its modality, against the
    JAX loop given the same frames; a family that takes no modality
    refuses one."""
    jcfg, jparams, tcfg, tparams = encdec_pair()
    prompts, fr = _tokens(5, 3, 7), _frames(5, 3)
    want = jax_decode_loop_reference(jparams, jcfg, prompts, 6,
                                     modality=jnp.asarray(fr))
    got = decode_loop_reference(
        tparams, tcfg, prompts, 6, modality=fr,
        decode_fn=S.build_decode_step(tcfg, head_noise=jax_head_noise()))
    np.testing.assert_array_equal(got["token"], np.asarray(want["token"]))
    for k in STEP_KEYS:
        assert_close(got[k], want[k], atol=ATOL, msg=k)
    dense = dataclasses.replace(tcfg, family="dense")
    with pytest.raises(ValueError, match="no modality"):
        decode_loop_reference(tparams, dense, prompts, 2, modality=fr)


@pytest.mark.parametrize("kv_layout,entropy,prefill_mode", [
    ("dense", "operand", "batch"), ("paged", "kernel", "batch"),
    ("paged", "operand", "chunked")])
def test_engine_scan_equals_the_per_token_loop(kv_layout, entropy,
                                               prefill_mode):
    """Requests admitted at engine start, zero frames in both: the
    engine's chunks replay ``decode_loop_reference`` (dense cache, batch
    prefill of the three prompts at once) bit for bit (tokens, H, MI), on
    the gather read; the paged engine also with chunked prefill (16-token
    chunks, the first running the encoder), in operand mode, whose noise
    is keyed by (slot, depth)."""
    _, _, tcfg, tparams = encdec_pair()
    cfg = dataclasses.replace(tcfg, head_entropy=entropy)
    ent = KernelEntropy(seed=3) if entropy == "kernel" else None
    gen, prompts = 8, _tokens(6, 3, 20)
    ref = decode_loop_reference(tparams, cfg, prompts, gen, entropy=ent,
                                modality=np.zeros((3, TE.ENC_LEN, 128),
                                                  np.float32))
    eng = TEngine(tparams, cfg, num_slots=3, max_len=20 + gen, chunk=4,
                  entropy=ent, kv_layout=kv_layout, kv_block=4,
                  prefill_mode=prefill_mode, prefill_chunk=16, device="cpu")
    res = eng.run([TRequest(rid=i, prompt=prompts[i], max_new_tokens=gen)
                   for i in range(3)])
    assert res["prefill_mode"] == prefill_mode
    assert res["prefill_chunks"] == (6 if prefill_mode == "chunked" else 0)
    for j, req in enumerate(res["requests"]):
        np.testing.assert_array_equal(req.tokens, ref["token"][:, j])
        for k in ("MI", "H"):
            np.testing.assert_array_equal(
                np.asarray(getattr(req, k), np.float32), ref[k][:, j])


def _roped_cross(monkeypatch):
    """Make the port's cross-attention query take RoPE at positions [0, S)
    (a mutation the suite must see)."""
    plain = TL.apply_attention

    def roped(p, cfg, x, *, cross_kv=None, **kw):
        if cross_kv is None:
            return plain(p, cfg, x, **kw)
        B, Sq, _ = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        rot = TL.rope_tables(torch.arange(Sq)[None, :], hd, cfg.rope_theta)
        q = TL.rope((x @ p["wq"]).reshape(B, Sq, H, hd), rot)
        out = TL.flash_attention(q, *cross_kv, causal=False,
                                 q_chunk=cfg.attn_q_chunk,
                                 kv_chunk=cfg.attn_kv_chunk)
        return out.reshape(B, Sq, H * hd) @ p["wo"], None

    monkeypatch.setattr(TL, "apply_attention", roped)


@pytest.mark.parametrize("change", ["frames", "roped_cross_query"])
def test_the_suite_sees_the_encoder_and_the_cross_path(change, monkeypatch):
    """Guard: two different random frame tensors give different prefill
    hidden states and ``ck``, zero frames give ``ck`` exactly 0 (why the
    model tests feed random frames), and a cross query with RoPE applied
    moves the prefill hidden state far beyond the tolerance of the JAX
    comparison."""
    jcfg, jparams, tcfg, tparams = encdec_pair()
    toks = torch.from_numpy(_tokens(8, 1, 9))
    fa, fb = (torch.from_numpy(_frames(s, 1)) for s in (8, 9))
    ha, ca = TM.prefill(tparams, tcfg, toks, 9, fa)
    if change == "frames":
        hb, cb = TM.prefill(tparams, tcfg, toks, 9, fb)
        assert (ha - hb).abs().max() > 1e-2
        assert (ca["ck"] - cb["ck"]).abs().max() > 1e-2
        _, c0 = TM.prefill(tparams, tcfg, toks, 9, torch.zeros_like(fa))
        assert not c0["ck"].any() and not c0["cv"].any()
        return
    jh, _ = JM.prefill(jparams, jcfg, jnp.asarray(toks.numpy()), 9,
                       jnp.asarray(fa.numpy()))
    assert_close(ha, jh, atol=ATOL)
    _roped_cross(monkeypatch)
    hr, cr = TM.prefill(tparams, tcfg, toks, 9, fa)
    assert torch.equal(cr["ck"], ca["ck"])             # K/V take no RoPE
    assert np.abs(hr.numpy() - np.asarray(jh)).max() > 100 * ATOL


@pytest.mark.parametrize("flags", [
    [], ["--kv-layout", "paged", "--decode-attn", "kernel", "--prefill",
         "chunked"]])
def test_cli_serves_the_reduced_seamless_on_the_cpu(flags):
    from repro_torch.launch.serve import build_parser, serve
    args = build_parser().parse_args(
        ["--arch", "seamless_m4t_medium", "--device", "cpu", "--reduced",
         "--slots", "2", "--num-requests", "3", "--prompt-len", "20",
         "--gen-len", "4", "--chunk", "4", "--prefill-chunk", "8", *flags])
    r = serve(args)
    assert r["gen_tokens"] == 12
    if flags:
        assert r["kv"]["layout"] == "paged"
        assert r["prefill_mode"] == "chunked"
        assert r["prefill_chunks"] == 3 * 3
    else:
        assert r["kv"]["layout"] == "dense" and r["prefill_chunks"] == 0
    for req in r["requests"]:
        assert req.state == "finished" and np.isfinite(req.MI).all()


def test_cli_without_a_gpu_raises():
    from repro_torch.launch.serve import build_parser, serve
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = build_parser().parse_args(
        ["--arch", "seamless_m4t_medium", "--kv-layout", "paged",
         "--decode-attn", "kernel", "--prefill", "chunked"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(args)
