"""The dense transformer of the port against the JAX package: prefill,
chunked prefill, operand-mode decode with the JAX xi injected, and the
paged layouts against the dense one inside the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, dense_pair,  # noqa: F401
                           jax_head_noise, meshless_reference,
                           to_numpy_tree)
from repro.models import registry as JM
from repro.models import transformer as JT
from repro_torch.models import registry as TM
from repro_torch.models import transformer as TT

STEP_KEYS = ("H", "SE", "MI", "p_max")


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, S)).astype(np.int32)


def test_init_params_tree_matches_jax_layout():
    jcfg, jparams, tcfg, _ = dense_pair()
    want = to_numpy_tree(jparams)
    got = TT.init_params(tcfg, torch.Generator().manual_seed(0), CPU)

    def shapes(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update({f"{k}.{kk}": s for kk, s in shapes(v).items()})
            else:
                out[k] = tuple(v.shape)
        return out

    assert shapes({k: v for k, v in want.items() if k != "head"}) \
        == shapes({k: v for k, v in got.items() if k != "head"})
    assert got["head"]["mu"].shape == want["head"]["q"]["mu"].shape
    assert_close(got["head"]["sigma"][:2, :2], np.full(
        (2, 2), tcfg.head_init_sigma), atol=1e-6)
    assert abs(float(got["head"]["mu"].std()) * np.sqrt(tcfg.d_model)
               - 1.0) < 0.02


def test_prefill_hidden_and_cache_match_jax():
    jcfg, jparams, tcfg, tparams = dense_pair()
    toks = _tokens(1, 2, 12)
    jh, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks), 20)
    th, tc = TT.prefill(tparams, tcfg, torch.from_numpy(toks), 20)
    assert_close(th, jh, atol=2e-5)
    for n in ("k", "v"):
        assert_close(tc[n], jc[n], atol=2e-5, msg=n)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def _jax_decode(jcfg, jparams, cache, toks, steps):
    key = jax.random.PRNGKey(17)
    outs = []
    tok = jnp.asarray(toks[:, -1])
    for _ in range(steps):
        out, cache = JM.decode_step(jparams, jcfg, tok, cache, key)
        tok = out["next_token"]
        outs.append(jax.tree.map(np.asarray, out))
    return outs, cache


def _port_decode(tcfg, tparams, cache, toks, steps, noise):
    outs = []
    tok = torch.from_numpy(toks[:, -1])
    for t in range(steps):
        out, cache = TM.decode_step(tparams, tcfg, tok, cache, (17, t),
                                    head_noise=noise)
        tok = out["next_token"]
        outs.append(out)
    return outs, cache


def test_operand_decode_with_jax_noise_matches_jax():
    jcfg, jparams, tcfg, tparams = dense_pair()
    toks = _tokens(2, 3, 9)
    _, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks), 16)
    # stagger the slot depths: continuous batching decodes slots of
    # different ages side by side
    jc["len"] = jnp.asarray([9, 7, 4], jnp.int32)
    _, tc = TT.prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    tc["len"] = torch.tensor([9, 7, 4], dtype=torch.int32)
    jo, jc = _jax_decode(jcfg, jparams, jc, toks, 4)
    to, tc = _port_decode(tcfg, tparams, tc, toks, 4, jax_head_noise())
    for j, t in zip(jo, to):
        np.testing.assert_array_equal(t["next_token"].numpy(),
                                      j["next_token"])
        for k in STEP_KEYS:
            assert_close(t[k], j[k], atol=2e-5, msg=k)
    for n in ("k", "v"):
        assert_close(tc[n], jc[n], atol=2e-5, msg=n)


def _paged_from_dense(tcfg, dense, max_len, kv_block, perm_seed):
    """The same slots in a paged cache with shuffled physical blocks."""
    B = dense["len"].shape[0]
    cache = TM.make_cache(tcfg, B, max_len, device=CPU, layout="paged",
                          kv_block=kv_block)
    mb = cache["block_table"].shape[1]
    perm = np.random.default_rng(perm_seed).permutation(B * mb)
    for b in range(B):
        sub = {"k": dense["k"][:, b:b + 1], "v": dense["v"][:, b:b + 1],
               "len": dense["len"][b:b + 1]}
        row = torch.from_numpy(perm[b * mb:(b + 1) * mb].astype(np.int32))
        TM.write_slot(tcfg, cache, b, sub, row)
    return cache


@pytest.mark.parametrize("decode_attn", ["gather", "kernel"])
def test_paged_decode_equals_dense_inside_port(decode_attn):
    import dataclasses
    _, _, tcfg, tparams = dense_pair()
    toks = _tokens(3, 2, 10)
    _, dense = TT.prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    dense["len"] = torch.tensor([10, 6], dtype=torch.int32)
    paged = _paged_from_dense(tcfg, {n: v.clone() for n, v in dense.items()},
                              16, 4, 5)
    pcfg = dataclasses.replace(tcfg, decode_attn=decode_attn)
    do, _ = _port_decode(tcfg, tparams, dense, toks, 3, None)
    po, _ = _port_decode(pcfg, tparams, paged, toks, 3, None)
    for d, p in zip(do, po):
        assert torch.equal(d["next_token"], p["next_token"])
        for k in STEP_KEYS:
            assert_close(p[k], d[k].numpy(), atol=2e-6, msg=k)


@pytest.mark.parametrize("decode_attn", ["gather", "kernel"])
def test_chunked_prefill_matches_jax(decode_attn):
    """Two 8-token chunks of a 13-token prompt (bucket span 16) into a
    shuffled table: the pools match the JAX package's chunk walker."""
    import dataclasses
    jcfg, jparams, tcfg, tparams = dense_pair()
    jcfg = dataclasses.replace(jcfg, decode_attn="gather")
    tcfg = dataclasses.replace(tcfg, decode_attn=decode_attn)
    prompt = _tokens(4, 1, 13)[0]
    jc = JM.make_cache(jcfg, 2, 24, layout="paged", kv_block=4)
    tc = TM.make_cache(tcfg, 2, 24, device=CPU, layout="paged", kv_block=4)
    row = np.array([[-1] * 6, [9, 3, 0, 7, -1, -1]], np.int32)
    jc["block_table"] = jnp.asarray(row)
    tc["block_table"] = torch.from_numpy(row.copy())
    for off in (0, 8):
        chunk = np.zeros((1, 8), np.int32)
        real = prompt[off:off + 8]
        chunk[0, :len(real)] = real
        new_len = off + len(real)
        jc = JM.prefill_chunk(jparams, jcfg, jnp.asarray(chunk), jc,
                              jnp.int32(1), jnp.int32(off),
                              jnp.int32(new_len), 16)
        tc = TM.prefill_chunk(tparams, tcfg, torch.from_numpy(chunk), tc, 1,
                              off, new_len, 16)
    for n in ("k", "v"):
        for blk in (9, 3, 0, 7):
            assert_close(tc[n][:, blk], np.asarray(jc[n])[:, blk],
                         atol=2e-5, msg=f"{n}[{blk}]")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_kv_bytes_leaves_out_the_sink():
    _, _, tcfg, _ = dense_pair()
    paged = TM.make_cache(tcfg, 2, 16, device=CPU, layout="paged",
                          kv_block=4, num_blocks=6)
    per_block = 4 * tcfg.num_kv_heads * tcfg.head_dim * 4 * tcfg.num_layers
    assert TM.kv_bytes(paged) == 2 * 6 * per_block
    dense = TM.make_cache(tcfg, 2, 16, device=CPU)
    assert TM.kv_bytes(dense) == 2 * 2 * 16 * per_block // 4


def test_head_logits_match_jax():
    """The mean and one LRT draw of the Bayesian head, from the same
    parameters and variates."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jcfg, jparams, tcfg, tparams = dense_pair()
    r = np.random.default_rng(4)
    x = r.standard_normal((3, tcfg.d_model)).astype(np.float32)
    xi = r.standard_normal((3, tcfg.vocab_size)).astype(np.float32)
    assert_close(TL.head_logits_mean(tparams["head"], torch.from_numpy(x),
                                     tcfg),
                 JL.head_logits_mean(jparams["head"], jnp.asarray(x), jcfg),
                 atol=2e-5)
    assert_close(TL.head_logits_sampled(tparams["head"], torch.from_numpy(x),
                                        tcfg, torch.from_numpy(xi)),
                 JL.head_logits_sampled(jparams["head"], jnp.asarray(x), jcfg,
                                        jnp.asarray(xi)),
                 atol=2e-5)


def test_config_copies_match_jax():
    """The port's copies of the arch configs (and of ``reduced``) hold the
    JAX package's values field for field."""
    import dataclasses
    from repro.configs import registry as JR
    from repro_torch.configs import registry as TR
    assert TR.ARCH_IDS == JR.ARCH_IDS
    for arch in TR.ARCH_IDS:
        full = dataclasses.asdict(TR.get_config(arch))
        assert full == dataclasses.asdict(JR.get_config(arch)), arch
        assert dataclasses.asdict(TR.reduced(TR.get_config(arch))) \
            == dataclasses.asdict(JR.reduced(JR.get_config(arch))), arch


def test_decode_step_builds_rope_tables_and_write_index_once(monkeypatch):
    """Every layer of a decode step shares one set of RoPE tables and one
    paged write index: built per layer, they cost ≈ 1,300 more eager
    launches per step at full width."""
    from repro_torch.models import layers as TL
    _, _, tcfg, tparams = dense_pair()
    calls = {"rope_tables": 0, "paged_index": 0}
    for name in calls:
        def counting(*args, _fn=getattr(TL, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(TL, name, counting)
    cache = TM.make_cache(tcfg, 2, 16, device=CPU, layout="paged",
                          kv_block=4)
    cache["block_table"][:, :2] = torch.tensor([[0, 1], [2, 3]])
    assert tcfg.num_layers > 1
    TT.decode_step(tparams, tcfg, torch.tensor([1, 2], dtype=torch.int32),
                   cache, (0, 0))
    assert calls == {"rope_tables": 1, "paged_index": 1}
