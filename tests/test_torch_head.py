"""The fused Bayesian head: the port's plain versions against the JAX
oracles, Philox against its known answers and the seeded stream's
moments.  The CUDA kernel is held against its plain version in
test_torch_kernels_cuda.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, meshless_reference  # noqa: F401
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.kernels import ops, ref, rng

# the package exports the ops functions of the same names, which shadow
# these submodules as attributes of repro_torch.kernels
UH = importlib.import_module("repro_torch.kernels.uncertainty_head")

KEYS = ("H", "SE", "MI", "p_max")


def _head(seed, M, K, V, S, sigma=0.3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32)
    mu = (r.standard_normal((K, V)) / np.sqrt(K)).astype(np.float32)
    sg = (sigma * (0.5 + r.random((K, V)))).astype(np.float32)
    xi = r.standard_normal((S, M, V)).astype(np.float32)
    return x, mu, sg, xi


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("M,K,V,S", [(3, 40, 300, 4), (4, 32, 128, 10),
                                     (2, 16, 129, 3), (5, 64, 1000, 6)])
def test_plain_head_with_xi_matches_jax_oracle(M, K, V, S):
    x, mu, sg, xi = _head(M * V, M, K, V, S)
    want = JR.uncertainty_head(*map(jnp.asarray, (x, mu, sg, xi)))
    got = UH.uncertainty_head_plain(*_t(x, mu, sg), num_samples=S,
                                    xi=torch.from_numpy(xi))
    for k in KEYS:
        assert_close(got[k], want[k], atol=1e-5, msg=k)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(
        want["pred"]))


@pytest.mark.parametrize("V,tile", [(300, 128), (1000, 128), (257, 64),
                                    (77, 32)])
def test_tile_loop_matches_straightforward_oracle(V, tile):
    """Ragged vocab tails (masked to -1e30), per-tile merges and the
    first-tile-wins argmax against the untiled port oracle, in both the
    explicit-xi and the seeded mode."""
    x, mu, sg, xi = _head(V, 3, 24, V, 5)
    tx, tmu, tsg, txi = _t(x, mu, sg, xi)
    for got, want in (
            (UH.uncertainty_head_plain(tx, tmu, tsg, num_samples=5, xi=txi,
                                       tile=tile),
             ref.uncertainty_head(tx, tmu, tsg, txi)),
            (UH.uncertainty_head_plain(tx, tmu, tsg, num_samples=5, seed=9,
                                       step=4, tile=tile),
             ref.uncertainty_head_sampled(tx, tmu, tsg, 9, 4, 5))):
        for k in KEYS:
            assert_close(got[k], want[k], atol=2e-6, msg=k)
        assert torch.equal(got["pred"], want["pred"])


def test_argmax_ties_keep_the_lowest_index():
    """Identical columns across tiles: the lowest vocab index wins, as
    jnp.argmax within a tile and the strict '>' across tiles give."""
    K, V, S = 8, 300, 2
    x = torch.ones((2, K))
    mu = torch.zeros((K, V))
    mu[:, [40, 170, 290]] = 1.0
    out = UH.uncertainty_head_plain(x, mu, torch.zeros((K, V)),
                                    num_samples=S, seed=1, tile=128)
    assert out["pred"].tolist() == [40, 40]


def test_nan_row_does_not_leak_into_other_rows():
    """An idle decode slot feeds a NaN hidden row: every other row's
    outputs are exactly what they are without it."""
    x, mu, sg, _ = _head(5, 4, 16, 300, 3)
    tx, tmu, tsg = _t(x, mu, sg)
    clean = UH.uncertainty_head_plain(tx, tmu, tsg, num_samples=3, seed=2)
    tx[1] = float("nan")
    dirty = UH.uncertainty_head_plain(tx, tmu, tsg, num_samples=3, seed=2)
    keep = [0, 2, 3]
    for k in (*KEYS, "pred"):
        assert torch.equal(dirty[k][keep], clean[k][keep]), k
    assert torch.isnan(dirty["H"][1])


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), "d16cfe09 94fdcceb 5001e420 24126ea1")])
def test_philox_known_answers(ctr, key, want):
    out = rng.philox4x32(*ctr, *key)
    assert " ".join(f"{int(w):08x}" for w in out) == want


def test_seeded_head_is_deterministic_and_seed_dependent():
    x, mu, sg, _ = _head(6, 4, 16, 300, 4)
    tx, tmu, tsg = _t(x, mu, sg)
    a = ops.uncertainty_head_sampled(tx, tmu, tsg, 5, 2, num_samples=4)
    b = ops.uncertainty_head_sampled(tx, tmu, tsg, 5, 2, num_samples=4)
    c = ops.uncertainty_head_sampled(tx, tmu, tsg, 6, 2, num_samples=4)
    d = ops.uncertainty_head_sampled(tx, tmu, tsg, 5, 3, num_samples=4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["H"], c["H"])
    assert not torch.equal(a["H"], d["H"])


def test_philox_normals_have_standard_moments():
    """n draws: mean and skew within 5/sqrt(n), variance within
    5*sqrt(2/n) of a standard normal — the contract the JAX package
    holds its own in-kernel stream to."""
    z = rng.head_normal(3, 1, 8, 16, torch.arange(4096)).double().ravel()
    n = z.numel()
    assert abs(float(z.mean())) < 5 / np.sqrt(n)
    assert abs(float(z.var()) - 1.0) < 5 * np.sqrt(2 / n)
    assert abs(float(((z - z.mean()) ** 3).mean() / z.std() ** 3)) \
        < 5 * np.sqrt(6 / n)


def test_seeded_head_moments_match_jax_seeded_oracle():
    """The two generators differ, so the seeded heads agree in
    distribution: over M rows, the mean per-row difference of H, SE and
    MI lies within 5 standard errors (sigma / sqrt(M)) of zero."""
    M, K, V, S = 64, 32, 512, 16
    x, mu, sg, _ = _head(7, M, K, V, S, sigma=0.2)
    got = UH.uncertainty_head_plain(*_t(x, mu, sg), num_samples=S, seed=3,
                                    step=0)
    want = JR.uncertainty_head_sampled(*map(jnp.asarray, (x, mu, sg)), 3, S)
    for k in ("H", "SE", "MI"):
        d = got[k].double().numpy() - np.asarray(want[k], np.float64)
        se = d.std(ddof=1) / np.sqrt(M)
        assert abs(d.mean()) <= 5 * se + 1e-7, (k, d.mean(), se)


def test_ops_dispatch_cpu_to_plain_and_entropy_bytes():
    x, mu, sg, xi = _head(8, 3, 16, 200, 4)
    tx, tmu, tsg, txi = _t(x, mu, sg, xi)
    got = ops.uncertainty_head(tx, tmu, tsg, txi)
    want = UH.uncertainty_head_plain(tx, tmu, tsg, num_samples=4, xi=txi)
    assert all(torch.equal(got[k], want[k]) for k in got)
    for kind in ("weight_space", "lrt", "head", "conv"):
        for in_kernel in (False, True):
            kw = dict(num_samples=10, m=4, k=8, n=16, b=2, t_out=5,
                      in_kernel=in_kernel)
            assert ops.entropy_bytes(kind, **kw) == JO.entropy_bytes(kind,
                                                                     **kw)



@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "encdec"])
def test_kernel_mode_head_moments_match_the_reference_tail(family):
    """By design the port's kernel mode takes the fused head for every
    family, where the reference gives these families its plain operand
    tail (xi keyed by (key, slot, depth)).  From one decode hidden state
    of the same prefill in both packages (random frames for encdec), N
    draws of the port's head (its plain version, Philox keyed by (seed,
    step)) and of the reference's tail (N keys): the mean H, SE and MI of
    each slot agree within 4 sigma / sqrt(N), sigma the two draws' pooled
    standard deviation.  Doubling the head's sigma in one package fails
    this by far."""
    import dataclasses

    import jax

    from _torch_parity import encdec_pair, hybrid_pair, moe_pair, ssm_pair
    from repro.models import registry as JM
    from repro.models import uncertain_head as JU
    from repro_torch.models import registry as TM
    from repro_torch.models import uncertain_head as TU

    pair = {"moe": moe_pair, "ssm": ssm_pair, "hybrid": hybrid_pair,
            "encdec": encdec_pair}[family]
    jcfg, jparams, tcfg, tparams = pair()
    jcfg = dataclasses.replace(jcfg, head_entropy="kernel")
    tcfg = dataclasses.replace(tcfg, head_entropy="kernel")
    r = np.random.default_rng(21)
    toks = r.integers(1, 511, size=(2, 16)).astype(np.int32)
    frames = r.standard_normal((2, 1024, 128)).astype(np.float32) \
        if family == "encdec" else None
    _, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), 20,
                       None if frames is None else jnp.asarray(frames))
    _, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), 20,
                       None if frames is None else torch.from_numpy(frames))
    jh, _ = JM.module_for(jcfg).decode_hidden(jparams, jcfg,
                                              jnp.asarray(toks[:, -1]), jc)
    th, _ = TM.module_for(tcfg).decode_hidden(tparams, tcfg,
                                              torch.from_numpy(toks[:, -1]),
                                              tc)
    assert_close(th, jh, atol=1e-5)
    N, depth = 64, jnp.asarray([16, 16], jnp.int32)
    port = [TU.head_outputs(tparams, tcfg, th, torch.tensor([16, 16]),
                            (5, step)) for step in range(N)]
    ref = jax.jit(jax.vmap(
        lambda k: JU.head_outputs(jparams, jcfg, jh, depth, k)))(
        jax.random.split(jax.random.PRNGKey(5), N))
    far = {}                       # gap / standard error, where > 4
    for k in ("H", "SE", "MI"):
        a = torch.stack([o[k] for o in port]).double().numpy()     # (N, B)
        b = np.asarray(ref[k], np.float64)
        assert a.shape == b.shape == (N, 2)
        se = np.sqrt((a.var(0, ddof=1) + b.var(0, ddof=1)) / N)
        gap = np.abs(a.mean(0) - b.mean(0))
        if not (gap <= 4 * se).all():
            far[k] = np.round(gap / se, 1).tolist()
    assert not far, far
