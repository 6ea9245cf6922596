"""The dense family's other archs against the JAX package, reduced:
nemotron-4-15b (a non-gated squared-ReLU MLP, GQA to one KV head),
codeqwen1.5-7b (MHA with QKV biases) and qwen2-7b (GQA to one KV head,
QKV biases), each at 2 layers, d 128, 4 query heads of D 32, V 512, f32.
The other dense tests run reduced qwen2-1.5b; these hold the init tree,
prefill, operand-mode decode with the JAX xi injected, and the serving
engine (paged KV, chunked prefill, gather read) of each arch.

Tolerance: atol 2e-5 in f32 on hidden states, K/V and H/SE/MI/p_max, as
the qwen2-1.5b tests; token streams equal.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_dense_archs.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, dense_pair,  # noqa: F401
                           jax_head_noise, meshless_reference,
                           to_numpy_tree)
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.models import registry as JM
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.models import registry as TM

ATOL = 2e-5
STEP_KEYS = ("H", "SE", "MI", "p_max")
ARCHS = ["nemotron_4_15b", "codeqwen1_5_7b", "qwen2_7b"]
# what sets each arch apart from reduced qwen2-1.5b
TRAITS = {"nemotron_4_15b": dict(kv=1, bias=False, mlp={"w1", "w2"}),
          "codeqwen1_5_7b": dict(kv=4, bias=True, mlp={"w1", "w2", "w3"}),
          "qwen2_7b": dict(kv=1, bias=True, mlp={"w1", "w2", "w3"})}


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(
        1, vocab - 1, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax_layout(arch):
    """The port's random init has the JAX tree's names, shapes and dtypes,
    with the arch's MLP (squared ReLU: no gate), KV heads and biases;
    ``params_from_numpy`` carries the JAX tree across as it comes."""
    jcfg, jparams, tcfg, tparams = dense_pair(arch)
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
    for k in ("embed", "blocks", "final_norm"):
        assert leaves({k: got[k]}) == leaves({k: want[k]}) \
            == leaves({k: tparams[k]}), k
    t = TRAITS[arch]
    attn = got["blocks"]["attn"]
    assert tcfg.num_kv_heads == t["kv"]
    assert attn["wk"].shape == (2, 128, 32 * t["kv"])
    assert ("bq" in attn) == t["bias"]
    if t["bias"]:
        assert not attn["bq"].any() and not attn["bk"].any()
    assert set(got["blocks"]["mlp"]) == t["mlp"]
    assert got["head"]["mu"].shape == want["head"]["q"]["mu"].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_hidden_and_cache_match_jax(arch):
    jcfg, jparams, tcfg, tparams = dense_pair(arch)
    toks = _tokens(1, 2, 12)
    jh, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 20)
    th, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 20)
    assert_close(th, jh, atol=ATOL)
    for n in ("k", "v"):
        assert tc[n].shape == jc[n].shape == (2, 2, 20, tcfg.num_kv_heads,
                                              32), n
        assert_close(tc[n], jc[n], atol=ATOL, msg=n)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_operand_decode_with_jax_noise_matches_jax(arch):
    """Staggered slot depths, three steps with the JAX xi: tokens exact,
    H/SE/MI/p_max within atol, the K/V close after."""
    jcfg, jparams, tcfg, tparams = dense_pair(arch)
    toks = _tokens(2, 3, 9)
    _, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 16)
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    jc["len"] = jnp.asarray([9, 7, 4], jnp.int32)
    tc["len"] = torch.tensor([9, 7, 4], dtype=torch.int32)
    key = jax.random.PRNGKey(17)
    noise = jax_head_noise()
    jtok = jnp.asarray(toks[:, -1])
    ttok = torch.from_numpy(toks[:, -1])
    for t in range(3):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    """Paged KV, chunked prefill (8-token chunks), gather read, operand
    entropy with the JAX xi: the port's engine gives the JAX engine's
    token streams and prefill chunk count, and H/SE/MI/p_max within
    atol."""
    jcfg, jparams, tcfg, tparams = dense_pair(arch)
    kw = dict(num_slots=2, max_len=24, chunk=4, kv_layout="paged",
              kv_block=4, prefill_mode="chunked", prefill_chunk=8,
              decode_attn="gather")
    lens = (13, 6, 9)

    def requests(cls):
        rng = np.random.default_rng(11)
        return [cls(rid=i, prompt=rng.integers(1, 511, size=n)
                    .astype(np.int32), max_new_tokens=4)
                for i, n in enumerate(lens)]

    jr = JEngine(jparams, jcfg, **kw).run(requests(JRequest))
    tr = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                 **kw).run(requests(TRequest))
    assert tr["prefill_mode"] == jr["prefill_mode"] == "chunked"
    assert tr["prefill_chunks"] == jr["prefill_chunks"] == 2 + 1 + 2
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens, a.rid
        assert a.finish_reason == b.finish_reason
        for name in STEP_KEYS:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=ATOL, err_msg=name)
