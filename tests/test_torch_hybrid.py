"""The port's hybrid family (zamba2-7b reduced: 4 layers, the shared
attention + MLP block every 2, d 128, 4 MHA heads of D 32, d_inner 256,
8 SSM heads of P 32, N 16, chunk 16, V 512, f32; and a 5-layer variant
whose last group holds one layer) against the JAX package: the init
tree, prefill, operand-mode decode with the JAX xi injected (dense and
paged), the chunked-prefill walker, the serving engine and the per-token
loop; and inside the port, chunked against batch prefill, the paged slot
write, the registry's gates, the kernel path against the gather path and
the engine's chunks against the per-token loop.

Tolerance: atol 1e-5 in f32 on hidden states and H/SE/MI/p_max; on
cache leaves atol 1e-5 plus rtol 1e-5 (states and K/V reach |5| after
the shared attention, where 1e-5 is about 10 f32 ulp); bitwise where
stated.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_hybrid.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, hybrid_pair,  # noqa: F401
                           jax_head_noise, meshless_reference, to_numpy_tree)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.engine.runner import \
    decode_loop_reference as jax_decode_loop_reference
from repro.models import registry as JM
from repro_torch.core.entropy import KernelEntropy
from repro_torch.launch import steps as S
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.launch.engine.runner import decode_loop_reference
from repro_torch.models import hybrid as TH
from repro_torch.models import registry as TM

ATOL = 1e-5
RTOL_CACHE = 1e-5
STEP_KEYS = ("H", "SE", "MI", "p_max")
LEAVES = ("ssm", "conv", "attn_k", "attn_v")
PATH_FLAGS = dict(kv_layout="paged", decode_attn="kernel",
                  prefill_mode="chunked", prefill_chunk=8, kv_block=4)


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(
        1, vocab - 1, size=(B, S)).astype(np.int32)


def _close_cache(got, want, msg):
    assert_close(got, want, atol=ATOL, rtol=RTOL_CACHE, msg=msg)


def test_init_params_tree_matches_jax_layout():
    """The port's random init has the JAX tree's names, shapes and dtypes
    (Mamba blocks stacked on L, one ``shared`` block), with its
    distributions."""
    _, jparams, tcfg, _ = hybrid_pair()
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

    assert set(got) == set(want)
    for k in ("blocks", "shared", "embed"):
        assert leaves(got[k]) == leaves(want[k]), k
    assert leaves({"f": got["final_norm"]}) == \
        leaves({"f": want["final_norm"]})
    sp = got["shared"]
    assert set(sp) == {"ln1", "attn", "ln2", "mlp"}
    assert (sp["ln1"] == 1).all() and (sp["ln2"] == 1).all()
    assert set(sp["attn"]) == {"wq", "wk", "wv", "wo"}
    assert abs(float(sp["attn"]["wq"].std()) * np.sqrt(tcfg.d_model)
               - 1.0) < 0.02
    assert abs(float(sp["mlp"]["w2"].std()) * np.sqrt(tcfg.d_ff)
               - 1.0) < 0.03
    assert (got["blocks"]["dt_bias"] == -2).all()
    assert got["head"]["mu"].shape == (tcfg.d_model, tcfg.vocab_size)


@pytest.mark.parametrize("layers,S", [(4, 7), (4, 16), (4, 37), (5, 37)])
def test_prefill_hidden_and_cache_match_jax(layers, S):
    """Batch prefill of two prompts (inside one SSD chunk, exactly one,
    across three; the 5-layer depth ends on a group of one layer): the
    last hidden and every cache leaf."""
    jcfg, jparams, tcfg, tparams = hybrid_pair(num_layers=layers)
    assert TH.n_attn_apps(tcfg) == (2 if layers == 4 else 3)
    toks = _tokens(S + layers, 2, S)
    jh, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 40)
    th, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 40)
    assert set(tc) == set(jc) == {*LEAVES, "len"}
    assert_close(th, jh, atol=ATOL)
    for n in LEAVES:
        assert tc[n].shape == jc[n].shape, n
        _close_cache(tc[n], jc[n], n)
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
    """Staggered slot depths, four steps with the JAX xi: tokens exact,
    H/SE/MI/p_max within atol, every leaf close after; the step writes
    the cache in place (the same tensors come back).  Paged: JAX's gather
    read against the port's kernel read (its plain version here)."""
    jcfg, jparams, tcfg, tparams = hybrid_pair()
    toks = _tokens(2, 3, 9)
    lens = [9, 7, 4]
    if layout == "dense":
        _, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 16)
        _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    else:
        tcfg = dataclasses.replace(tcfg, decode_attn="kernel")
        rows = np.full((3, 4), -1, np.int32)
        rows[:, :4] = np.random.default_rng(1).permutation(24)[:12] \
            .reshape(3, 4)
        jsubs = [JM.prefill(jparams, jcfg, jnp.asarray(toks[b:b + 1]),
                            9)[1] for b in range(3)]
        tsubs = [TM.prefill(tparams, tcfg, torch.from_numpy(toks[b:b + 1]),
                            9)[1] for b in range(3)]
        jc = _paged(JM, jcfg, jsubs, rows)
        tc = _paged(TM, tcfg, tsubs, rows, device=CPU)
        assert tc["attn_k"].shape == (2, 25, 4, 4, 32)
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
    for n in LEAVES:
        want = np.asarray(jc[n])
        got = tc[n] if layout == "dense" else tc[n][:, :24]   # the sink
        _close_cache(got, want, n)
    np.testing.assert_array_equal(tc["len"].numpy(), [13, 11, 8])


@pytest.mark.parametrize("decode_attn", ["gather", "kernel"])
def test_prefill_chunk_walks_to_the_jax_cache_and_state(decode_attn):
    """A 37-token prompt in chunks of 16, 16 and 5 into slot 1 of a
    shuffled table: after every chunk the threaded state and the pools
    match the JAX walker's (gather read), ``len`` is pinned, and the
    slot's ssm / conv stay untouched until the finalize chunk, which
    writes them."""
    jcfg, jparams, tcfg, tparams = hybrid_pair()
    tcfg = dataclasses.replace(tcfg, decode_attn=decode_attn)
    prompt = _tokens(4, 1, 37)[0]
    jc = JM.make_cache(jcfg, 2, 48, layout="paged", kv_block=4)
    tc = TM.make_cache(tcfg, 2, 48, device=CPU, layout="paged", kv_block=4)
    row = np.full((2, 12), -1, np.int32)
    row[1, :10] = (9, 3, 0, 7, 12, 5, 15, 1, 20, 11)
    jc["block_table"] = jnp.asarray(row)
    tc["block_table"] = torch.from_numpy(row.copy())
    tc["ssm"].fill_(0.5)                 # a previous occupant's state
    jstate = {"ssm": jnp.zeros((4, 1, 8, 32, 16), jnp.float32),
              "conv": jnp.zeros((4, 1, 3, 256 + 32), jnp.float32)}
    tstate = {n: torch.zeros(tuple(v.shape)) for n, v in jstate.items()}
    for off in (0, 16, 32):
        chunk = prompt[None, off:off + 16]
        new_len = off + chunk.shape[1]
        done = new_len == 37
        jc, jstate = JM.prefill_chunk(
            jparams, jcfg, jnp.asarray(chunk), jc, jnp.int32(1),
            jnp.int32(off), jnp.int32(new_len), 37, state=jstate,
            finalize=done)
        tc, tstate = TM.prefill_chunk(
            tparams, tcfg, torch.from_numpy(chunk), tc, 1, off, new_len, 37,
            state=tstate, finalize=done)
        for n in ("ssm", "conv"):
            _close_cache(tstate[n], jstate[n], f"state {n} at {off}")
        assert tc["len"].tolist() == [0, new_len]
        if not done:
            assert (tc["ssm"] == 0.5).all() and not tc["conv"].any()
    for n in ("ssm", "conv"):
        assert torch.equal(tc[n][:, 1], tstate[n][:, 0])
        _close_cache(tc[n][:, 1], np.asarray(jc[n])[:, 1], n)
    assert (tc["ssm"][:, 0] == 0.5).all()
    for n in ("attn_k", "attn_v"):
        for blk in row[1, :10]:
            _close_cache(tc[n][:, blk], np.asarray(jc[n])[:, blk],
                         f"{n}[{blk}]")


@pytest.mark.parametrize("decode_attn", ["gather", "kernel"])
def test_chunked_prefill_equals_batch_prefill_inside_port(decode_attn):
    """Staggered mixed-length prompts (exact ssm_chunk-multiple chunks,
    ragged tails, admissions mid-stream), operand entropy: chunked
    prefill threading the state gives the batch prefill's streams bit for
    bit."""
    _, _, tcfg, tparams = hybrid_pair()
    lens = [13, 37, 5, 18]

    def run(mode):
        eng = TEngine(tparams, tcfg, num_slots=2, max_len=37 + 8 + 4,
                      chunk=4, kv_layout="paged", kv_block=4,
                      prefill_mode=mode, prefill_chunk=8,
                      decode_attn=decode_attn, device="cpu")
        return eng, eng.run(_requests(TRequest, tcfg, lens))

    _, batch = run("batch")
    eng, chunked = run("chunked")
    assert eng.prefill_chunk == 16 and chunked["prefill_chunk"] == 16
    assert chunked["prefill_chunks"] == 1 + 3 + 1 + 2
    assert _streams(chunked) == _streams(batch)


def test_paged_write_slot_writes_only_its_slot():
    """A batch-1 prefill cache lands in slot 1 of a 3-slot paged cache:
    the slot's ``ssm`` and ``conv`` are replaced whole (the previous
    occupant's state is gone), its strips go through its block row into
    every plane, ``len`` is set, and nothing else changes."""
    _, _, tcfg, tparams = hybrid_pair()
    cache = TM.make_cache(tcfg, 3, 16, device=CPU, layout="paged",
                          kv_block=4, num_blocks=12)
    g = torch.Generator().manual_seed(3)
    for n in LEAVES:
        cache[n].copy_(torch.randn(cache[n].shape, generator=g))
    cache["len"].copy_(torch.tensor([5, 6, 7], dtype=torch.int32))
    before = {k: v.clone() for k, v in cache.items()}
    _, sub = TM.prefill(tparams, tcfg, torch.from_numpy(_tokens(3, 1, 10)),
                        10)
    row = torch.tensor([6, 2, 9, -1], dtype=torch.int32)
    out = TM.write_slot(tcfg, cache, 1, sub, row)
    assert out is cache
    for n in ("ssm", "conv"):
        assert torch.equal(cache[n][:, 1], sub[n][:, 0]), n
        for s in (0, 2):
            assert torch.equal(cache[n][:, s], before[n][:, s]), n
    for n in ("attn_k", "attn_v"):
        got = cache[n][:, row[:3].long()].reshape(2, 12, 4, 32)[:, :10]
        assert torch.equal(got, sub[n][:, 0]), n
        untouched = [b for b in range(13) if b not in (6, 2, 9, 12)]
        assert torch.equal(cache[n][:, untouched], before[n][:, untouched])
    assert cache["block_table"][1].tolist() == row.tolist()
    np.testing.assert_array_equal(cache["len"].numpy(), [5, 10, 7])


def test_registry_gates_for_the_hybrid_family():
    _, _, tcfg, _ = hybrid_pair()
    assert TM.module_for(tcfg) is TH
    assert TM.supports_paged(tcfg)
    assert TM.supports_chunked_prefill(tcfg)
    assert not TM.supports_prompt_padding(tcfg)
    assert not TM.supports_prefix_cache(tcfg)
    assert {"attn_k", "attn_v"} <= set(TM.PAGED_KV_LEAVES)
    assert TM.RECURRENT_LEAVES == ("ssm", "conv")
    paged = TM.make_cache(tcfg, 2, 16, device=CPU, layout="paged",
                          kv_block=4, num_blocks=10)
    assert set(paged) == {*LEAVES, "len", "block_table"}
    assert paged["attn_k"].shape == (2, 11, 4, 4, 32)   # + the sink block
    plane = 2 * 10 * 4 * 4 * 32 * 4                     # A, NB, BS, H, D, f32
    assert TM.kv_bytes(paged) == 2 * plane
    dense = TM.make_cache(tcfg, 2, 16, device=CPU)
    assert dense["attn_k"].shape == (2, 2, 16, 4, 32)
    assert TM.kv_bytes(dense) == 2 * 2 * 2 * 16 * 4 * 32 * 4


def _requests(cls, cfg, lens, gen=8, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size - 1, size=n)
                .astype(np.int32), max_new_tokens=gen)
            for i, n in enumerate(lens)]


def _streams(res):
    return [(r.tokens, *(np.asarray(getattr(r, k), np.float32).tolist()
                         for k in STEP_KEYS), r.finish_reason)
            for r in res["requests"]]


def test_engine_matches_jax_engine():
    """Paged KV, chunked prefill (8 rounded up to ssm_chunk 16 by both),
    gather read, operand entropy with the JAX xi: the port's engine gives
    the JAX engine's token streams and prefill chunk count, and
    H/SE/MI/p_max within atol."""
    jcfg, jparams, tcfg, tparams = hybrid_pair()
    kw = dict(num_slots=2, max_len=37 + 8 + 4, chunk=4, kv_layout="paged",
              kv_block=4, prefill_mode="chunked", prefill_chunk=8,
              decode_attn="gather")
    lens = [13, 37, 5]
    jr = JEngine(jparams, jcfg, **kw).run(_requests(JRequest, jcfg, lens))
    tr = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                 **kw).run(_requests(TRequest, tcfg, lens))
    assert tr["prefill_chunk"] == jr["prefill_chunk"] == 16
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
    _, _, tcfg, tparams = hybrid_pair()
    lens = [13, 37, 5]

    def run(decode_attn):
        eng = TEngine(tparams, tcfg, num_slots=2, max_len=37 + 8 + 4,
                      chunk=4, device="cpu",
                      **dict(PATH_FLAGS, decode_attn=decode_attn))
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
    jcfg, jparams, tcfg, tparams = hybrid_pair()
    prompts = _tokens(5, 3, 7)
    want = jax_decode_loop_reference(jparams, jcfg, prompts, 6)
    got = decode_loop_reference(
        tparams, tcfg, prompts, 6,
        decode_fn=S.build_decode_step(tcfg, head_noise=jax_head_noise()))
    np.testing.assert_array_equal(got["token"], np.asarray(want["token"]))
    for k in STEP_KEYS:
        assert_close(got[k], want[k], atol=ATOL, msg=k)


@pytest.mark.parametrize("kv_layout,entropy,prefill_mode", [
    ("dense", "operand", "batch"), ("paged", "kernel", "batch"),
    ("paged", "operand", "chunked")])
def test_engine_scan_equals_the_per_token_loop(kv_layout, entropy,
                                               prefill_mode):
    """Requests admitted at engine start: the engine's chunks replay
    ``decode_loop_reference`` (dense cache, batch prefill of the three
    prompts at once) bit for bit (tokens, H, MI), on the gather read; the
    paged engine also with chunked prefill (chunks of 16 and 4), in
    operand mode, whose noise is keyed by (slot, depth): interleaved
    prompt chunks start the slots at other global steps than the loop's,
    and the kernel-mode stream is keyed by the global step."""
    _, _, tcfg, tparams = hybrid_pair()
    cfg = dataclasses.replace(tcfg, head_entropy=entropy)
    ent = KernelEntropy(seed=3) if entropy == "kernel" else None
    gen, prompts = 8, _tokens(6, 3, 20)
    ref = decode_loop_reference(tparams, cfg, prompts, gen, entropy=ent)
    eng = TEngine(tparams, cfg, num_slots=3, max_len=20 + gen, chunk=4,
                  entropy=ent, kv_layout=kv_layout, kv_block=4,
                  prefill_mode=prefill_mode, prefill_chunk=8, device="cpu")
    res = eng.run([TRequest(rid=i, prompt=prompts[i], max_new_tokens=gen)
                   for i in range(3)])
    assert res["prefill_mode"] == prefill_mode
    assert res["prefill_chunks"] == (6 if prefill_mode == "chunked" else 0)
    for j, req in enumerate(res["requests"]):
        np.testing.assert_array_equal(req.tokens, ref["token"][:, j])
        for k in ("MI", "H"):
            np.testing.assert_array_equal(
                np.asarray(getattr(req, k), np.float32), ref[k][:, j])


@pytest.mark.parametrize("flags", [
    [], ["--kv-layout", "paged", "--decode-attn", "kernel", "--prefill",
         "chunked"]])
def test_cli_serves_the_reduced_zamba2_on_the_cpu(flags):
    from repro_torch.launch.serve import build_parser, serve
    args = build_parser().parse_args(
        ["--arch", "zamba2_7b", "--device", "cpu", "--reduced",
         "--slots", "2", "--num-requests", "3", "--prompt-len", "20",
         "--gen-len", "4", "--chunk", "4", "--prefill-chunk", "8", *flags])
    r = serve(args)
    assert r["gen_tokens"] == 12
    if flags:
        assert r["kv"]["layout"] == "paged"
        assert r["prefill_mode"] == "chunked" and r["prefill_chunk"] == 16
        assert r["prefill_chunks"] == 3 * 2
    else:
        assert r["kv"]["layout"] == "dense" and r["prefill_chunks"] == 0
    for req in r["requests"]:
        assert req.state == "finished" and np.isfinite(req.MI).all()


def test_cli_without_a_gpu_raises():
    from repro_torch.launch.serve import build_parser, serve
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = build_parser().parse_args(["--arch", "zamba2_7b", "--kv-layout",
                                      "paged", "--decode-attn", "kernel",
                                      "--prefill", "chunked"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(args)
