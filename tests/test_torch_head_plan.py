"""The fused head's split-K stream plan (``head_plan``) at the served
widths, and the plain versions' K-slice loop against the JAX package's
jnp oracle and the port's straightforward oracle: ragged last slices,
V % 4 == 2 and V smaller than one tile."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels import ref as JR
from repro_torch.kernels import ref

UH = importlib.import_module("repro_torch.kernels.uncertainty_head")

KEYS = ("H", "SE", "MI", "p_max")
# (K, V) of each served family's head
WIDTHS = {"qwen2-1.5b": (1536, 151936), "deepseek-moe-16b": (2048, 102400),
          "mamba2-370m": (1024, 50280), "zamba2-7b": (3584, 32000),
          "seamless-m4t-medium": (1024, 256206),
          "phi-3-vision-4.2b": (3072, 32064),
          "nemotron-4-15b": (6144, 256000), "codeqwen1.5-7b": (4096, 92416),
          "qwen2-7b": (3584, 152064)}
SMEM_PER_SM = 228 * 1024       # an H100 SM's shared memory


def _partition(ranges, n: int) -> bool:
    """The half-open ranges, sorted, cover [0, n) end to end, no overlap."""
    ends = 0
    for a, b in sorted(ranges):
        if a != ends or b <= a:
            return False
        ends = b
    return ends == n


def _covers_once(plan) -> bool:
    """Every (row, column, K row) lies in exactly one work item: the items
    are the product of a row partition, a K partition and a column
    partition, each pair met once."""
    items = list(plan.items())
    rows = {r for r, _, _ in items}
    ks = {k for _, k, _ in items}
    cols = {c for _, _, c in items}
    return (len(items) == len(set(items)) == len(rows) * len(ks) * len(cols)
            and _partition(rows, plan.M) and _partition(ks, plan.K)
            and _partition(cols, plan.V))


@pytest.mark.parametrize("M", [1, 4, 5, 16, 20])
@pytest.mark.parametrize("model", list(WIDTHS))
def test_head_plan_at_served_widths(model, M):
    K, V = WIDTHS[model]
    plan = UH.head_plan(M, K, V)
    assert _covers_once(plan)
    assert plan.balance <= UH.PLAN_BALANCE, plan
    # whole waves of two blocks an SM, or near them, or short slices
    assert (plan.waves >= UH.PLAN_WAVES
            or plan.k_slice <= UH.PLAN_SHORT_SLICE), plan
    assert plan.scratch_bytes < UH.PLAN_SCRATCH * 2 * K * V * 4, plan
    assert plan.route == ("bulk" if V % 4 == 0 else "async8")
    # the smallest row template that holds M, several groups above 16
    assert plan.rows == next((r for r in (4, 8, 16) if M <= r), 16)
    assert plan.groups * plan.rows >= M > (plan.groups - 1) * plan.rows
    # whole stages a slice, x within its budget, two blocks an SM
    assert plan.k_slice % UH.STREAM_STAGE_ROWS == 0
    assert plan.rows * plan.k_slice * 4 <= UH.STREAM_X_BYTES
    assert 2 * (plan.smem_bytes + 1024) <= SMEM_PER_SM
    assert plan.tile == plan.cols * 128 == UH.STREAM_TILE


@pytest.mark.parametrize("V,align,want", [
    (1000, 16, "bulk"), (1000, 8, "async8"), (1000, 4, "async4"),
    (1002, 16, "async8"), (1002, 4, "async4"), (1001, 16, "async4"),
    (256206, 16, "async8")])
def test_head_route_follows_alignment(V, align, want):
    """16-byte rows take the TMA bulk copies; V % 4 == 2 (every odd row
    8-byte aligned only) takes 8-byte cp.async, an odd V 4-byte."""
    assert UH.head_route(V, align) == want
    assert UH.head_plan(4, 64, V, align).route == want


@pytest.mark.parametrize("M,K,V,k_slice", [(3, 40, 300, 8), (4, 16, 90, 16),
                                           (20, 30, 129, 8),
                                           (2, 1000, 77, 96)])
def test_plan_items_cover_small_and_ragged_shapes(M, K, V, k_slice):
    plan = dataclasses.replace(UH.head_plan(M, K, V), k_slice=k_slice)
    assert _covers_once(plan)
    assert plan.splits == -(-K // k_slice)
    assert sum(plan.sm_bytes()) == plan.groups * K * V * 8


def _head(seed, M, K, V, S, sigma=0.3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32)
    mu = (r.standard_normal((K, V)) / np.sqrt(K)).astype(np.float32)
    sg = (sigma * (0.5 + r.random((K, V)))).astype(np.float32)
    xi = r.standard_normal((S, M, V)).astype(np.float32)
    return x, mu, sg, xi


# (M, K, V, k_slice): a ragged last K slice, V % 4 == 2, V below a tile
SLICED = [(4, 40, 302, 16), (3, 24, 90, 8), (5, 50, 1002, 16),
          (16, 33, 130, 8), (2, 64, 61, 24)]


@pytest.mark.parametrize("M,K,V,k_slice", SLICED)
def test_sliced_plain_head_matches_jax_oracle(M, K, V, k_slice):
    S = 5
    x, mu, sg, xi = _head(M + K + V, M, K, V, S)
    plan = dataclasses.replace(UH.head_plan(M, K, V), k_slice=k_slice)
    want = JR.uncertainty_head(*map(jnp.asarray, (x, mu, sg, xi)))
    t = [torch.from_numpy(a) for a in (x, mu, sg, xi)]
    for got in (UH.uncertainty_head_plain(*t[:3], num_samples=S, xi=t[3],
                                          plan=plan),
                UH.uncertainty_head_two_pass_plain(*t, plan=plan)):
        for k in KEYS:
            assert_close(got[k], want[k], atol=1e-5, msg=k)
        np.testing.assert_array_equal(got["pred"].numpy(),
                                      np.asarray(want["pred"]))


@pytest.mark.parametrize("M,K,V,k_slice", SLICED)
def test_sliced_plain_head_matches_straightforward_oracle(M, K, V, k_slice):
    """Explicit xi and the seeded stream, against the port's untiled,
    unsliced oracle; the two-pass plain version gives the fused one's
    bits under the same plan."""
    S = 4
    x, mu, sg, xi = (torch.from_numpy(a) for a in _head(V, M, K, V, S))
    plan = dataclasses.replace(UH.head_plan(M, K, V), k_slice=k_slice)
    fused = UH.uncertainty_head_plain(x, mu, sg, num_samples=S, xi=xi,
                                      plan=plan)
    for got, want in (
            (fused, ref.uncertainty_head(x, mu, sg, xi)),
            (UH.uncertainty_head_plain(x, mu, sg, num_samples=S, seed=9,
                                       step=4, plan=plan),
             ref.uncertainty_head_sampled(x, mu, sg, 9, 4, S))):
        for k in KEYS:
            assert_close(got[k], want[k], atol=2e-6, msg=k)
        assert torch.equal(got["pred"], want["pred"])
    two = UH.uncertainty_head_two_pass_plain(x, mu, sg, xi, plan=plan)
    assert all(torch.equal(two[k], fused[k]) for k in fused)


def test_plain_mean_and_variance_sum_the_slices_in_slice_order():
    """mean and var are the K slices' partials added in slice order; one
    slice as long as K is the single product."""
    x, mu, sg, _ = (torch.from_numpy(a) for a in _head(3, 4, 40, 50, 1))
    mean, std = UH._mean_std(x, mu, sg, 16)
    x2, s2 = x * x, sg * sg
    parts = [(x[:, a:a + 16] @ mu[a:a + 16], x2[:, a:a + 16] @ s2[a:a + 16])
             for a in (0, 16, 32)]
    assert torch.equal(mean, parts[0][0] + parts[1][0] + parts[2][0])
    assert torch.equal(std, torch.sqrt(torch.clamp(
        parts[0][1] + parts[1][1] + parts[2][1], min=0.0)))
    whole, _ = UH._mean_std(x, mu, sg, 40)
    assert torch.equal(whole, x @ mu)


def test_plain_head_defaults_to_the_shapes_plan():
    x, mu, sg, xi = (torch.from_numpy(a) for a in _head(4, 3, 24, 200, 3))
    plan = UH.head_plan(3, 24, 200)
    a = UH.uncertainty_head_plain(x, mu, sg, num_samples=3, xi=xi)
    b = UH.uncertainty_head_plain(x, mu, sg, num_samples=3, xi=xi, plan=plan)
    assert all(torch.equal(a[k], b[k]) for k in a)
