"""The port's CUDA kernels against their plain PyTorch versions.

Every test here needs a GPU and skips without one.  The module imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX, so run it as a script,
which leaves the conftest out):

    PYTHONPATH=src python tests/test_torch_kernels_cuda.py
"""

import dataclasses
import importlib
import sys

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, cuda_device  # noqa: F401
from repro_torch.core.photonic import quantize_ste
from repro_torch.kernels import launches, ref, rng
from repro_torch.kernels import paged_attention as PA

# the package exports the ops functions of the same names, which shadow
# these submodules as attributes of repro_torch.kernels
BM = importlib.import_module("repro_torch.kernels.bayes_matmul")
FA = importlib.import_module("repro_torch.kernels.flash_attention")
PC = importlib.import_module("repro_torch.kernels.photonic_conv")
UH = importlib.import_module("repro_torch.kernels.uncertainty_head")

pytestmark = pytest.mark.needs_cuda

KEYS = ("H", "SE", "MI", "p_max")


def _head(seed, M, K, V, S, sigma=0.3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32)
    mu = (r.standard_normal((K, V)) / np.sqrt(K)).astype(np.float32)
    sg = (sigma * (0.5 + r.random((K, V)))).astype(np.float32)
    xi = r.standard_normal((S, M, V)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, mu, sg, xi)]


def _decode_case(seed, H, Hkv, D, BS, MB, lens):
    r = np.random.default_rng(seed)
    B = len(lens)
    NB = B * MB
    k = r.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    v = r.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    q = r.standard_normal((B, 1, H, D)).astype(np.float32)
    perm = r.permutation(NB)
    table = np.full((B, MB), -1, np.int32)
    for b, n in enumerate(lens):
        nb = -(-n // BS)
        table[b, :nb] = perm[b * MB:b * MB + nb]       # shuffled, -1 tail
    return [torch.from_numpy(a) for a in
            (q, k, v, table, np.asarray(lens, np.int32))]


@pytest.mark.parametrize("M,V", [(4, 1000), (16, 513), (20, 300)])
def test_cuda_head_matches_plain(cuda_device, M, V):
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(M, M, 64, V, 10))
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, **kw)
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, **kw)
        for k in KEYS:
            assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
        assert torch.equal(got["pred"].cpu(), want["pred"].cpu())


@pytest.mark.parametrize("M", [1, 4])
def test_cuda_head_matches_plain_at_the_lanes_forty_draws(cuda_device, M):
    """The escalation lane's head: S 40 draws (4x the serving S) at one row
    and at four, in xi and Philox modes, against the plain version."""
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(40 + M, M, 64, 1000,
                                                        40))
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=40, **kw)
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=40, **kw)
        for k in KEYS:
            assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
        assert torch.equal(got["pred"].cpu(), want["pred"].cpu())


def test_cuda_head_bf16_input_and_nan_row(cuda_device):
    """x arrives as bf16 at full width; an idle slot's NaN row stays in
    its row."""
    x, mu, sg, _ = (t.to(cuda_device) for t in _head(3, 4, 64, 700, 10))
    x = x.to(torch.bfloat16)
    x[2] = float("nan")
    got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=1, step=2)
    want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, seed=1,
                                     step=2)
    for k in KEYS:
        assert torch.isnan(got[k][2]), k
        assert_close(got[k][[0, 1, 3]], want[k][[0, 1, 3]].cpu(), atol=2e-5,
                     msg=k)
    assert torch.equal(got["pred"][[0, 1, 3]].cpu(),
                       want["pred"][[0, 1, 3]].cpu())


def test_cuda_head_is_deterministic_per_seed_and_counts_launches(
        cuda_device):
    x, mu, sg, _ = (t.to(cuda_device) for t in _head(5, 4, 64, 900, 10))
    launches.reset()
    a = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=7, step=3)
    b = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=7, step=3)
    c = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=8, step=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["H"], c["H"])
    assert launches.snapshot()["uncertainty_head"] == 3


def test_cuda_head_matches_plain_at_a_ragged_served_vocab(cuda_device):
    """mamba2-370m's head, K 1024 and V 50280 = 392 x 128 + 104: the last
    128-column tile is ragged on a served path.  H/SE/MI/p_max within
    2e-4 (f32 sums over 50,280 columns in another order), pred equal
    wherever p-bar's top-2 gap is resolvable, with the xi operand and
    with the Philox stream."""
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(8, 4, 1024, 50280,
                                                       10, sigma=0.05))
    x = x.to(torch.bfloat16)
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, **kw)
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, **kw)
        for k in KEYS:
            assert torch.isfinite(got[k]).all(), k
            assert_close(got[k], want[k].cpu(), atol=2e-4, msg=k)
        full = kw.get("xi")
        if full is None:
            full = rng.head_normal(4, 9, 10, 4,
                                   torch.arange(50280, device=cuda_device))
        pbar = torch.softmax(ref.lrt_matmul(x, mu, sg, full), -1).mean(0)
        top = pbar.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 1e-6
        assert not ((got["pred"] != want["pred"]) & clear).any()


def test_cuda_head_matches_plain_at_zamba2s_widths(cuda_device):
    """zamba2-7b's head, K 3584 and V 32000 (250 whole 128-column tiles),
    M 4, S 10: H/SE/MI/p_max within 2e-4 of the plain version, pred equal
    wherever p-bar's top-2 gap is resolvable, with the xi operand and
    with the Philox stream; one launch a call."""
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(12, 4, 3584, 32000,
                                                       10, sigma=0.05))
    x = x.to(torch.bfloat16)
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        launches.reset()
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, **kw)
        assert launches.snapshot()["uncertainty_head"] == 1
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, **kw)
        for k in KEYS:
            assert torch.isfinite(got[k]).all(), k
            assert_close(got[k], want[k].cpu(), atol=2e-4, msg=k)
        full = kw.get("xi")
        if full is None:
            full = rng.head_normal(4, 9, 10, 4,
                                   torch.arange(32000, device=cuda_device))
        pbar = torch.softmax(ref.lrt_matmul(x, mu, sg, full), -1).mean(0)
        top = pbar.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 1e-6
        assert not ((got["pred"] != want["pred"]) & clear).any()


def test_cuda_head_matches_plain_at_seamless_vocab(cuda_device):
    """seamless-m4t-medium's head, K 1024 and V 256206 = 2001 x 128 + 78
    (V not a multiple of 4): the last tile is ragged.  Row 0's argmax is
    planted in the last column, row 1's in the last tile's first column:
    both kernels find them there, with p_max near 1; H/SE/MI/p_max within
    2e-4 of the plain version, pred equal wherever p-bar's top-2 gap is
    resolvable, with the xi operand and with the Philox stream; one
    launch a call."""
    V = 256206
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(25, 4, 1024, V, 10,
                                                       sigma=0.05))
    x = x.to(torch.bfloat16)
    x32 = x.float()
    for row, col in ((0, V - 1), (1, V - 78)):
        mu[:, col] = x32[row] / x32[row].norm()      # a logit of ~32
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        launches.reset()
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, **kw)
        assert launches.snapshot()["uncertainty_head"] == 1
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, **kw)
        for k in KEYS:
            assert torch.isfinite(got[k]).all(), k
            assert_close(got[k], want[k].cpu(), atol=2e-4, msg=k)
        assert got["pred"][:2].tolist() == [V - 1, V - 78]
        assert want["pred"][:2].tolist() == [V - 1, V - 78]
        assert (got["p_max"][:2] > 0.9).all()
        full = kw.get("xi")
        if full is None:
            full = rng.head_normal(4, 9, 10, 4,
                                   torch.arange(V, device=cuda_device))
        pbar = torch.softmax(ref.lrt_matmul(x, mu, sg, full), -1).mean(0)
        top = pbar.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 1e-6
        assert not ((got["pred"] != want["pred"]) & clear).any()


def test_cuda_head_matches_plain_at_phi3_vision_widths(cuda_device):
    """phi-3-vision's head, K 3072 and V 32064 = 250 x 128 + 64: the last
    tile is ragged.  Row 0's argmax is planted in the last column, row
    2's in the last tile's first column: both kernels find them there,
    with p_max near 1; H/SE/MI/p_max within 2e-4 of the plain version,
    pred equal wherever p-bar's top-2 gap is resolvable, with the xi
    operand and with the Philox stream; one launch a call."""
    V = 32064
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(26, 4, 3072, V, 10,
                                                       sigma=0.05))
    x = x.to(torch.bfloat16)
    x32 = x.float()
    for row, col in ((0, V - 1), (2, V - 64)):
        mu[:, col] = x32[row] / x32[row].norm()      # a logit of ~55
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        launches.reset()
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, **kw)
        assert launches.snapshot()["uncertainty_head"] == 1
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, **kw)
        for k in KEYS:
            assert torch.isfinite(got[k]).all(), k
            assert_close(got[k], want[k].cpu(), atol=2e-4, msg=k)
        assert got["pred"][[0, 2]].tolist() == [V - 1, V - 64]
        assert want["pred"][[0, 2]].tolist() == [V - 1, V - 64]
        assert (got["p_max"][[0, 2]] > 0.9).all()
        full = kw.get("xi")
        if full is None:
            full = rng.head_normal(4, 9, 10, 4,
                                   torch.arange(V, device=cuda_device))
        pbar = torch.softmax(ref.lrt_matmul(x, mu, sg, full), -1).mean(0)
        top = pbar.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 1e-6
        assert not ((got["pred"] != want["pred"]) & clear).any()


def _sliced(M, K, V, k_slice=None):
    """head_plan of the shape, its K slices forced to ``k_slice`` rows."""
    plan = UH.head_plan(M, K, V)
    return plan if k_slice is None else dataclasses.replace(plan,
                                                            k_slice=k_slice)


@pytest.mark.parametrize("M", [1, 4, 5, 16, 20])
def test_cuda_head_row_templates_match_plain(cuda_device, M):
    """Each row template (4, 8 and 16 rows; M 20 takes two groups of 16)
    with K 300 cut into 64-row slices (the last of 44 rows), fused head in
    both modes and two-pass head, against the plain versions under the
    same plan."""
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(40 + M, M, 300, 1000,
                                                       10))
    plan = _sliced(M, 300, 1000, 64)
    assert plan.rows == {1: 4, 4: 4, 5: 8, 16: 16, 20: 16}[M]
    assert plan.splits == 5
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, plan=plan,
                                       **kw)
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10,
                                         plan=plan, **kw)
        for k in KEYS:
            assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
        assert torch.equal(got["pred"].cpu(), want["pred"].cpu())
    got = UH.uncertainty_head_two_pass_cuda(x, mu, sg, xi, plan=plan)
    want = UH.uncertainty_head_two_pass_plain(x, mu, sg, xi, plan=plan)
    for k in KEYS:
        assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
    assert torch.equal(got["pred"].cpu(), want["pred"].cpu())


@pytest.mark.parametrize("V,route", [(1000, "bulk"), (1002, "async8"),
                                     (1001, "async4"), (77, "async4"),
                                     (130, "async8")])
def test_cuda_head_copy_routes_match_plain(cuda_device, V, route):
    """Each copy route by V's alignment (TMA bulk rows, 8- and 4-byte
    cp.async), a ragged last tile and a V below one tile, K 200 in
    three 72-row slices (the last of 56), in both modes."""
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(V, 4, 200, V, 10))
    plan = _sliced(4, 200, V, 72)
    assert plan.route == route
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, plan=plan,
                                       **kw)
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10,
                                         plan=plan, **kw)
        for k in KEYS:
            assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
        assert torch.equal(got["pred"].cpu(), want["pred"].cpu())


def test_cuda_head_route_follows_the_operands_alignment(cuda_device):
    """mu/sigma that start 8 bytes past a 16-byte boundary (V % 4 == 0)
    take the 8-byte route and match the plain version; a bulk plan
    forced on them is refused, never replaced."""
    K, V = 64, 1000
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(9, 4, K, V, 10))
    mu_v, sg_v = (torch.empty(K * V + 2, device=cuda_device)[2:].view(K, V)
                  .copy_(t) for t in (mu, sg))
    assert mu_v.data_ptr() % 16 == 8
    got = UH.uncertainty_head_cuda(x, mu_v, sg_v, num_samples=10, xi=xi)
    want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10, xi=xi)
    for k in KEYS:
        assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
    assert UH.head_plan(4, K, V, UH._alignment(mu_v, sg_v)).route == "async8"
    with pytest.raises(RuntimeError):
        UH.uncertainty_head_cuda(x, mu_v, sg_v, num_samples=10, xi=xi,
                                 plan=UH.head_plan(4, K, V))


def test_cuda_head_matches_plain_at_seamless_vocab_split_k(cuda_device):
    """V 256206 (the 8-byte cp.async route: every odd row of mu/sigma is
    8-byte aligned only) with K 1000 in four slices of 256 (the last of
    232): H/SE/MI/p_max within 2e-4, pred equal wherever p-bar's top-2
    gap is resolvable, the planted argmax found in the ragged last
    tile."""
    V = 256206
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(27, 4, 1000, V, 10,
                                                       sigma=0.05))
    x = x.to(torch.bfloat16)
    x32 = x.float()
    mu[:, V - 3] = x32[1] / x32[1].norm()
    plan = _sliced(4, 1000, V, 256)
    assert plan.route == "async8" and plan.splits == 4
    for kw in ({"xi": xi}, {"seed": 4, "step": 9}):
        got = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, plan=plan,
                                       **kw)
        want = UH.uncertainty_head_plain(x, mu, sg, num_samples=10,
                                         plan=plan, **kw)
        for k in KEYS:
            assert torch.isfinite(got[k]).all(), k
            assert_close(got[k], want[k].cpu(), atol=2e-4, msg=k)
        assert int(got["pred"][1]) == int(want["pred"][1]) == V - 3
        full = kw.get("xi")
        if full is None:
            full = rng.head_normal(4, 9, 10, 4,
                                   torch.arange(V, device=cuda_device))
        pbar = torch.softmax(ref.lrt_matmul(x, mu, sg, full), -1).mean(0)
        top = pbar.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 1e-6
        assert not ((got["pred"] != want["pred"]) & clear).any()


@pytest.mark.parametrize("M", [4, 16])
def test_cuda_two_pass_head_matches_plain_split_k(cuda_device, M):
    """The two-pass head at M 4 and 16 with K 520 cut into 128-row slices
    (the last of 8) and V 20000: within 2e-5 of its plain version, the
    same bits twice."""
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(60 + M, M, 520, 20000,
                                                       10, sigma=0.1))
    plan = _sliced(M, 520, 20000, 128)
    got = UH.uncertainty_head_two_pass_cuda(x, mu, sg, xi, plan=plan)
    want = UH.uncertainty_head_two_pass_plain(x, mu, sg, xi, plan=plan)
    for k in KEYS:
        assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
    assert torch.equal(got["pred"].cpu(), want["pred"].cpu())
    again = UH.uncertainty_head_two_pass_cuda(x, mu, sg, xi, plan=plan)
    assert all(torch.equal(got[k], again[k]) for k in got)


def _bitwise(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               for k in a)


def test_cuda_head_device_step_replays_in_a_cuda_graph(cuda_device):
    """The step read from device memory: one call captured in a CUDA graph
    with a one-element step tensor, new steps written between replays,
    equals the eager kernel called with the int step at each one, and an
    eager call with the tensor equals it too (same stream, same bits)."""
    x, mu, sg, _ = (t.to(cuda_device) for t in _head(6, 4, 64, 900, 10))
    step = torch.zeros((1,), dtype=torch.int32, device=cuda_device)

    def call():
        return UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=7,
                                        step=step, step_offset=3)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    seen = []
    for s in (0, 5, 1, 2 ** 31 - 4, 5):
        step.fill_(s)
        graph.replay()
        want = UH.uncertainty_head_cuda(x, mu, sg, num_samples=10, seed=7,
                                        step=s + 3)
        assert _bitwise(out, want) and _bitwise(call(), want), s
        seen.append(out["H"].clone())
    assert not torch.equal(seen[0], seen[1]) and torch.equal(seen[1],
                                                             seen[4])


def _decode_route(route, dtype, D):
    """The kernel a decode call takes: ``route`` forced, or for "auto"
    ``decode_route``'s (bf16 with D % 16 == 0 on the tensor cores)."""
    want = "mma" if dtype == torch.bfloat16 and D % 16 == 0 else "simt"
    if route == "auto":
        assert PA.decode_route(dtype, D) == want
        return want
    return route


@pytest.mark.parametrize("route", ["auto", "simt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(12, 2, 64), (12, 2, 128), (4, 4, 32),
                                     (16, 16, 128)])   # deepseek-moe, MHA
def test_cuda_decode_matches_plain(cuda_device, route, dtype, H, Hkv, D):
    q, k, v, table, lens = (t.to(cuda_device) for t in _decode_case(
        5, H, Hkv, D, BS=16, MB=4, lens=(60, 17, 1, 0)))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    took = _decode_route(route, dtype, D)
    got = PA.paged_decode_attention_cuda(
        q, k, v, table, lens, route=None if route == "auto" else route)
    want = PA.paged_decode_attention_plain(q, k, v, table, lens, walk=took)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert_close(got.float(), want.float().cpu(), atol=tol, equal_nan=True)
    assert torch.isnan(got[3]).all() and not torch.isnan(got[:3]).any()


@pytest.mark.parametrize("route", ["auto", "simt"])
def test_cuda_decode_multi_block_runs_match_plain(cuda_device, route):
    """64 slots: each split takes a run of several blocks (decode_split >
    1) or several tiles a warp (decode_tiles > 4), with holes, staggered
    depths and an empty slot among them."""
    lens = [int(n) for n in np.random.default_rng(9).integers(0, 300, 64)]
    lens[5] = 0
    q, k, v, table, ln = (t.to(cuda_device) for t in _decode_case(
        9, 12, 2, 128, BS=16, MB=19, lens=lens))
    table[7, 3] = -1                              # a hole below the depth
    assert PA.decode_split(64, 2, 19) > 1
    assert PA.decode_tiles(64, 2, 19, 16) > PA.DECODE_WARPS
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    took = _decode_route(route, torch.bfloat16, 128)
    got = PA.paged_decode_attention_cuda(
        q, k, v, table, ln, route=None if route == "auto" else route)
    want = PA.paged_decode_attention_plain(q, k, v, table, ln, walk=took)
    assert_close(got.float(), want.float().cpu(), atol=2e-2, equal_nan=True)
    assert torch.isnan(got[5]).all()


@pytest.mark.parametrize("tiles", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("BS", [4, 16, 32])
def test_cuda_decode_mma_split_sizes_match_plain(cuda_device, tiles, BS):
    """The tensor-core kernel at 1 to 8 tiles a split (one to two tiles a
    warp, splits merged by the last block), with tiles that cross blocks
    (BS 4) and blocks that hold two tiles (BS 32), rep 16 and rep 1."""
    for H, Hkv, D in ((16, 1, 64), (4, 4, 128)):
        q, k, v, table, lens = (t.to(cuda_device) for t in _decode_case(
            BS + tiles, H, Hkv, D, BS=BS, MB=640 // BS,
            lens=(637, 300, 129, 16, 0)))
        table[1, 2] = -1                          # a hole below the depth
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        got = PA.paged_decode_attention_cuda(q, k, v, table, lens,
                                             tiles=tiles)
        want = PA.paged_decode_attention_plain(q, k, v, table, lens,
                                               walk="mma", tiles=tiles)
        assert_close(got.float(), want.float().cpu(), atol=2e-2,
                     equal_nan=True)
        assert torch.isnan(got[4]).all() and not torch.isnan(got[:4]).any()


def test_cuda_decode_mma_replays_in_a_cuda_graph(cuda_device):
    """One call captured in a CUDA graph, new depths written into lens in
    place between replays: each replay matches the plain version at its
    depths, so the last block's counters are back at 0 after every run."""
    depths = [(288, 150, 17, 0), (300, 0, 90, 33), (5, 299, 160, 1)]
    q, k, v, table, lens = (t.to(cuda_device) for t in _decode_case(
        11, 12, 2, 128, BS=16, MB=19, lens=depths[0]))
    full = torch.from_numpy(np.random.default_rng(11).permutation(
        table.numel()).astype(np.int32)).reshape(table.shape)
    table = full.to(cuda_device)                  # every entry mapped
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    assert PA.decode_tiles(4, 2, 19, 16) < 19     # several splits merge
    PA.paged_decode_attention_cuda(q, k, v, table, lens)   # warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PA.paged_decode_attention_cuda(q, k, v, table, lens)
    for d in depths[1:] + depths[:1]:
        for _ in range(2):
            lens.copy_(torch.tensor(d, dtype=torch.int32))
            graph.replay()
            want = PA.paged_decode_attention_plain(q, k, v, table, lens)
            torch.cuda.synchronize()
            assert_close(out.float(), want.float().cpu(), atol=2e-2,
                         equal_nan=True)
            empty = [b for b, n in enumerate(d) if n == 0]
            assert all(torch.isnan(out[b]).all() for b in empty)


_PROFILE_DECODE = """
import json, sys, tempfile
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import paged_attention as PA
names = {}
for case in sys.argv[1:]:
    dtype, D, route, *heads = json.loads(case)
    H, Hkv = heads or (12, 2)
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((4, 1, H, D), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((76, 16, Hkv, D), generator=g, device="cuda").to(dt)
            for _ in "kv")
    table = torch.randperm(76, device="cuda").to(torch.int32).reshape(4, 19)
    lens = torch.tensor([288, 150, 17, 0], dtype=torch.int32, device="cuda")
    call = lambda: PA.paged_decode_attention_cuda(q, k, v, table, lens,
                                                  route=route)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(tmp + "/trace.json")
        events = json.load(open(tmp + "/trace.json"))["traceEvents"]
    names[case] = sorted(e["name"] for e in events
                         if e.get("cat") == "kernel")
print(json.dumps(names))
"""


def _decode_kernels(*cases):
    """Per case (dtype, D, route[, H, Hkv]) the names of the kernels one
    decode call launches (4 slots over 76 blocks), from torch.profiler in
    a fresh process."""
    import json
    import os
    import subprocess
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [src, os.environ.get("PYTHONPATH")])))
    args = [json.dumps(c) for c in cases]
    out = subprocess.run([sys.executable, "-c", _PROFILE_DECODE, *args],
                         env=env, capture_output=True, text=True, check=True)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    return [names[a] for a in args]


def test_cuda_decode_mma_is_one_launch(cuda_device):
    """By kernel name in a torch.profiler trace (a fresh process, as for
    flash attention): the served bf16 call launches paged_decode_mma<128>
    and nothing else; the SIMT route launches its kernel and the merge."""
    mma, simt, f32 = _decode_kernels(("bfloat16", 128, None),
                                     ("bfloat16", 128, "simt"),
                                     ("float32", 64, None))
    assert len(mma) == 1 and "paged_decode_mma<128>" in mma[0], mma
    for n in (simt, f32):
        assert len(n) == 2 and any("paged_decode_simt<" in x for x in n) \
            and any("paged_decode_simt_merge" in x for x in n), n


def test_cuda_decode_mma_matches_plain_at_zamba2s_mha(cuda_device):
    """zamba2-7b's shared attention (H = Hkv = 32, D 112, bf16): the
    decode route is the tensor-core kernel, paged_decode_mma<112> alone
    in one launch by name, and it agrees with the plain version (atol
    2e-2, one bf16 ulp of O(1) outputs) at the served depths and at
    depth 8192, with NaN exactly on the empty slot."""
    assert PA.decode_route(torch.bfloat16, 112) == "mma"
    (names,) = _decode_kernels(("bfloat16", 112, None, 32, 32))
    assert len(names) == 1 and "paged_decode_mma<112>" in names[0], names
    for MB, lens in ((19, [288, 150, 17, 0]), (512, [8192, 8191, 4000, 0])):
        q, k, v, table, d = (t.to(cuda_device) for t in _decode_case(
            MB, 32, 32, 112, 16, MB, lens))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        launches.reset()
        out = PA.paged_decode_attention_cuda(q, k, v, table, d)
        assert launches.snapshot()["paged_decode_attention"] == 1
        want = PA.paged_decode_attention_plain(q, k, v, table, d)
        torch.cuda.synchronize()
        assert_close(out.float(), want.float().cpu(), atol=2e-2,
                     equal_nan=True)
        assert torch.isnan(out[3]).all() and not torch.isnan(out[:3]).any()


@pytest.mark.parametrize("S,offset,span", [(256, 0, 512), (256, 256, 512),
                                           (37, 256, 293)])
def test_cuda_prefill_mma_matches_plain_at_zamba2s_mha(cuda_device, S,
                                                       offset, span):
    """zamba2-7b's prompt chunks (256 tokens, the rounded ssm_chunk, and a
    ragged 37-token tail; H = Hkv = 32, D 112, bf16): the tensor-core
    kernel, paged_prefill_mma<112> by name in one launch, within 2e-2 of
    the plain version, no NaN."""
    assert PA.prefill_route(torch.bfloat16, 112) == "mma"
    (run,) = _prefill_kernels((S + offset, S, 32, 32, 112, offset, span))
    assert run["launches"] == 1
    assert any("paged_prefill_mma<112>" in n for n in run["names"]), run
    assert not any("paged_prefill_simt" in n for n in run["names"]), run
    q, k, v, row = _prefill_bf16(cuda_device, S + offset, S, 32, 32, 112, 16,
                                 span)
    for kc in (1024, 64):
        got = PA.paged_prefill_attention_cuda(q, k, v, row, offset, span,
                                              kc)
        want = PA.paged_prefill_attention_plain(q, k, v, row, offset, span,
                                                kc)
        assert not torch.isnan(got).any()
        assert_close(got.float(), want.float().cpu(), atol=2e-2)


def test_cuda_decode_mma_matches_plain_at_seamless_mha(cuda_device):
    """seamless-m4t-medium's decoder self-attention (H = Hkv = 16, D 64,
    bf16, ratio 1: 15 of the 16 mma rows are padding): the decode route
    is the tensor-core kernel, paged_decode_mma<64> alone in one launch by
    name, and it agrees with the plain version (atol 2e-2) at the served
    depths, with NaN exactly on the empty slot."""
    assert PA.decode_route(torch.bfloat16, 64) == "mma"
    (names,) = _decode_kernels(("bfloat16", 64, None, 16, 16))
    assert len(names) == 1 and "paged_decode_mma<64>" in names[0], names
    for MB, lens in ((19, [288, 150, 17, 0]), (33, [520, 1, 16, 0])):
        q, k, v, table, d = (t.to(cuda_device) for t in _decode_case(
            MB, 16, 16, 64, 16, MB, lens))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        launches.reset()
        out = PA.paged_decode_attention_cuda(q, k, v, table, d)
        assert launches.snapshot()["paged_decode_attention"] == 1
        want = PA.paged_decode_attention_plain(q, k, v, table, d)
        torch.cuda.synchronize()
        assert_close(out.float(), want.float().cpu(), atol=2e-2,
                     equal_nan=True)
        assert torch.isnan(out[3]).all() and not torch.isnan(out[:3]).any()


def test_cuda_decode_mma_matches_plain_at_phi3_vision_mha(cuda_device):
    """phi-3-vision's attention (H = Hkv = 32, D 96: six 16-wide k-steps,
    a 192-byte row; ratio 1, so 15 of the 16 mma rows are padding): the
    decode route is the tensor-core kernel, paged_decode_mma<96> alone in
    one launch by name, and it agrees with the plain version (atol 2e-2)
    at the served depths over a 43-block table (2 splits), with 4 tiles a
    split (11 splits) and at 2 slots (3 splits), with NaN exactly on the
    empty slot."""
    assert PA.decode_route(torch.bfloat16, 96) == "mma"
    (names,) = _decode_kernels(("bfloat16", 96, None, 32, 32))
    assert len(names) == 1 and "paged_decode_mma<96>" in names[0], names
    assert PA.decode_tiles(4, 32, 43, 16) == 22
    assert PA.decode_tiles(2, 32, 43, 16) == 15
    for lens, tiles in (([672, 656, 641, 0], None), ([672, 656, 641, 0], 4),
                        ([672, 300], None)):
        q, k, v, table, d = (t.to(cuda_device) for t in _decode_case(
            len(lens), 32, 32, 96, 16, 43, lens))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        launches.reset()
        out = PA.paged_decode_attention_cuda(q, k, v, table, d, tiles=tiles)
        assert launches.snapshot()["paged_decode_attention"] == 1
        want = PA.paged_decode_attention_plain(q, k, v, table, d,
                                               tiles=tiles)
        torch.cuda.synchronize()
        assert_close(out.float(), want.float().cpu(), atol=2e-2,
                     equal_nan=True)
        live = [b for b, n in enumerate(lens) if n]
        assert not torch.isnan(out[live]).any()
        assert all(torch.isnan(out[b]).all() for b, n in enumerate(lens)
                   if not n)


@pytest.mark.parametrize("S,offset,span", [(64, 0, 256), (64, 192, 256),
                                           (37, 192, 229)])
def test_cuda_prefill_mma_matches_plain_at_seamless_mha(cuda_device, S,
                                                        offset, span):
    """seamless-m4t-medium's prompt chunks (64 tokens at offsets 0 and 192
    of a 256-token prompt, and a ragged 37-token tail; H = Hkv = 16, D 64,
    bf16): the tensor-core kernel, paged_prefill_mma<64> by name in one
    launch, within 2e-2 of the plain version, no NaN."""
    assert PA.prefill_route(torch.bfloat16, 64) == "mma"
    (run,) = _prefill_kernels((S + offset, S, 16, 16, 64, offset, span))
    assert run["launches"] == 1
    assert any("paged_prefill_mma<64>" in n for n in run["names"]), run
    assert not any("paged_prefill_simt" in n for n in run["names"]), run
    q, k, v, row = _prefill_bf16(cuda_device, S + offset, S, 16, 16, 64, 16,
                                 span)
    for kc in (1024, 64):
        got = PA.paged_prefill_attention_cuda(q, k, v, row, offset, span,
                                              kc)
        want = PA.paged_prefill_attention_plain(q, k, v, row, offset, span,
                                                kc)
        assert not torch.isnan(got).any()
        assert_close(got.float(), want.float().cpu(), atol=2e-2)


@pytest.mark.parametrize("kc", [1024, 16])
def test_cuda_prefill_matches_plain(cuda_device, kc):
    r = np.random.default_rng(kc)
    S, H, Hkv, D, BS, span, offset = 32, 12, 2, 128, 16, 64, 32
    k = torch.from_numpy(r.standard_normal((8, BS, Hkv, D)).astype(
        np.float32)).to(cuda_device)
    v = torch.randn_like(k)
    q = torch.randn((1, S, H, D), device=cuda_device)
    row = torch.tensor([[5, 1, 7, -1]], dtype=torch.int32,
                       device=cuda_device)
    got = PA.paged_prefill_attention_cuda(q, k, v, row, offset, span, kc)
    want = PA.paged_prefill_attention_plain(q, k, v, row, offset, span, kc)
    assert_close(got, want.cpu(), atol=2e-5)


def _prefill_bf16(dev, seed, S, H, Hkv, D, BS, span, hole=None):
    r = np.random.default_rng(seed)
    nblk = -(-span // BS)
    NB = nblk + 4
    k, v = (torch.from_numpy(r.standard_normal((NB, BS, Hkv, D)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(r.standard_normal((1, S, H, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    row = r.permutation(NB)[:nblk].astype(np.int32)[None]
    if hole is not None:
        row[0, hole] = -1       # an unmapped entry reads block 0, unmasked
    return q, k, v, torch.from_numpy(row).to(dev)


_PROFILE_PREFILL = """
import json, sys, tempfile
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from test_torch_kernels_cuda import _prefill_bf16
from repro_torch.kernels import launches
from repro_torch.kernels import paged_attention as PA
out = {}
for case in sys.argv[2:]:
    seed, S, H, Hkv, D, offset, span = json.loads(case)
    q, k, v, row = _prefill_bf16("cuda", seed, S, H, Hkv, D, 16, span)
    call = lambda: PA.paged_prefill_attention_cuda(q, k, v, row, offset, span)
    call()
    torch.cuda.synchronize()
    launches.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(tmp + "/trace.json")
        events = json.load(open(tmp + "/trace.json"))["traceEvents"]
    out[case] = {"names": sorted(e["name"] for e in events
                                 if e.get("cat") == "kernel"
                                 and "paged_prefill_" in e["name"]),
                 "launches": launches.snapshot()["paged_prefill_attention"]}
print(json.dumps(out))
"""


def _prefill_kernels(*cases):
    """Per case (seed, S, H, Hkv, D, offset, span) of ``_prefill_bf16``:
    the names of the prefill kernels one call launches, from torch.profiler
    in a fresh process (in the test process it records no kernels when
    the test runs alone), and the call's launch count."""
    import json
    import os
    import subprocess
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(here.parent / "src"),
                      os.environ.get("PYTHONPATH")])))
    args = [json.dumps(c) for c in cases]
    out = subprocess.run([sys.executable, "-c", _PROFILE_PREFILL, str(here),
                          *args], env=env, capture_output=True, text=True,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return [got[a] for a in args]


@pytest.mark.parametrize("kc", [1024, 64])
@pytest.mark.parametrize("offset", [0, 64, 128, 192])
def test_cuda_prefill_mma_matches_plain_at_the_served_shape(cuda_device,
                                                            offset, kc):
    """qwen2-1.5B's chunk (S 64, H 12, Hkv 2, D 128) at the four chunk
    offsets of a 256-token prompt: bf16 outputs within one bf16 ulp of
    O(1) values (atol 2e-2) of the plain version, no NaN."""
    S, H, Hkv, D, BS, span = 64, 12, 2, 128, 16, 256
    q, k, v, row = _prefill_bf16(cuda_device, offset + kc, S, H, Hkv, D, BS,
                                 span)
    got = PA.paged_prefill_attention_cuda(q, k, v, row, offset, span, kc)
    want = PA.paged_prefill_attention_plain(q, k, v, row, offset, span, kc)
    assert got.dtype == torch.bfloat16 and not torch.isnan(got).any()
    assert_close(got.float(), want.float().cpu(), atol=2e-2)


@pytest.mark.parametrize("S,H,Hkv,D,BS,offset,span,hole", [
    (37, 12, 2, 128, 16, 192, 229, None),   # rows cross replicas; ragged
    (64, 12, 2, 128, 16, 128, 256, 5),      # a -1 entry inside the span
    (50, 32, 32, 96, 16, 30, 80, None),     # phi-3-vision's D 96, MHA
    (33, 16, 1, 64, 16, 0, 40, None),       # rep 16
    (64, 16, 16, 128, 16, 0, 256, None),    # deepseek-moe's MHA chunks
    (64, 16, 16, 128, 16, 192, 256, None),
])
def test_cuda_prefill_mma_matches_plain(cuda_device, S, H, Hkv, D, BS,
                                        offset, span, hole):
    assert PA.prefill_route(torch.bfloat16, D) == "mma"
    q, k, v, row = _prefill_bf16(cuda_device, S + D, S, H, Hkv, D, BS, span,
                                 hole)
    for kc in (1024, 64):
        got = PA.paged_prefill_attention_cuda(q, k, v, row, offset, span,
                                              kc)
        want = PA.paged_prefill_attention_plain(q, k, v, row, offset, span,
                                                kc)
        assert not torch.isnan(got).any()
        assert_close(got.float(), want.float().cpu(), atol=2e-2)


def test_cuda_prefill_routes_by_dtype_and_head_dim(cuda_device):
    """bf16 at D 128 launches the tensor-core kernel; bf16 at D 72 (not a
    multiple of 16) launches the SIMT kernel and agrees all the same."""
    mma, simt = _prefill_kernels((1, 64, 12, 2, 128, 192, 256),
                                 (2, 20, 4, 2, 72, 16, 48))
    assert mma["launches"] == 1 and simt["launches"] == 1
    names = mma["names"]
    assert any("paged_prefill_mma<128>" in n for n in names), names
    assert not any("paged_prefill_simt" in n for n in names), names
    assert PA.prefill_route(torch.bfloat16, 72) == "simt"
    q, k, v, row = _prefill_bf16(cuda_device, 2, 20, 4, 2, 72, 16, 48)
    names = simt["names"]
    assert any("paged_prefill_simt" in n for n in names), names
    assert not any("paged_prefill_mma" in n for n in names), names
    got = PA.paged_prefill_attention_cuda(q, k, v, row, 16, 48)
    want = PA.paged_prefill_attention_plain(q, k, v, row, 16, 48)
    assert_close(got.float(), want.float().cpu(), atol=2e-2)


def test_cuda_prefill_refuses_what_it_cannot_take(cuda_device):
    q, k, v, row = _prefill_bf16(cuda_device, 3, 8, 2, 1, 144, 16, 32)
    with pytest.raises(ValueError):                      # D > 128
        PA.paged_prefill_attention_cuda(q, k, v, row, 0, 32)
    q, k, v, row = _prefill_bf16(cuda_device, 3, 8, 17, 1, 64, 16, 32)
    with pytest.raises(ValueError):                      # rep > 16
        PA.paged_prefill_attention_cuda(q, k, v, row, 0, 32)


def test_cuda_wrappers_refuse_bad_operands(cuda_device):
    q, k, v, table, lens = (t.to(cuda_device) for t in _decode_case(
        1, 4, 1, 32, BS=16, MB=2, lens=(20, 3)))
    with pytest.raises(TypeError):
        PA.paged_decode_attention_cuda(q, k, v, table.long(), lens)
    with pytest.raises(ValueError):
        PA.paged_decode_attention_cuda(q.cpu(), k, v, table, lens)
    with pytest.raises(ValueError, match="mma decode route"):   # f32
        PA.paged_decode_attention_cuda(q, k, v, table, lens, route="mma")
    # the C entry point refuses a forced mma it cannot take: f32, D % 16
    dec, _ = PA._fns()
    part = torch.empty(4096, device=cuda_device)
    count = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    for dtype, D, bf16 in ((torch.float32, 32, 0), (torch.bfloat16, 24, 1)):
        qx = q[..., :D].contiguous().to(dtype)
        kx, vx = (t[..., :D].contiguous().to(dtype) for t in (k, v))
        out = torch.empty_like(qx)
        rc = dec(qx.data_ptr(), kx.data_ptr(), vx.data_ptr(),
                 table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 part.data_ptr(), count.data_ptr(), 2, 4, 1, D, 16, 2, 1,
                 bf16, 1, torch.cuda.current_stream().cuda_stream)
        assert rc == 1, (dtype, D, rc)            # cudaErrorInvalidValue
    x, mu, sg, _ = (t.to(cuda_device) for t in _head(1, 2, 16, 50, 2))
    with pytest.raises(ValueError):
        UH.uncertainty_head_cuda(x, mu, sg[:, :10], num_samples=2)


def _assert_adc_close(got, want):
    """Bit-equal, or at most 0.1% of outputs one ADC step (4/127) apart:
    Box-Muller's libm calls may round an ulp apart between the kernel and
    PyTorch's CUDA ops, which can move a sum across an ADC level."""
    d = (got - want).abs().cpu().double()
    flips = d > 0
    assert flips.sum() <= 0.001 * d.numel(), int(flips.sum())
    assert torch.allclose(d[flips], torch.full_like(d[flips], 4 / 127),
                          rtol=1e-4)


def _conv(dev, B, T, C):
    r = np.random.default_rng(B * T + C)
    x = torch.from_numpy(r.uniform(-1.5, 1.5, (B, T)).astype(
        np.float32)).to(dev)
    mu = torch.linspace(-0.9, 0.9, C, device=dev)
    sg = 0.3 * mu.abs()
    eps = torch.from_numpy(r.standard_normal((B, T - C + 1, C)).astype(
        np.float32)).to(dev)
    return x, mu, sg, eps


# (B, T, C) at C 1, 4, 9 and 16: rows of one block and of several, and
# rows whose To * C is not a multiple of 4 (T 9, 301 at C 9; 263 at C 1),
# so that the row's last Philox call runs past its end
@pytest.mark.parametrize("B,T,C", [
    (3, 300, 9), (16, 256, 9), (1, 9, 9), (5, 600, 9), (4, 301, 9),
    (2, 1000, 1), (3, 263, 1), (3, 262, 4), (2, 1100, 4), (2, 515, 16),
    (3, 271, 16), (1, 16, 16)])
def test_cuda_photonic_conv_matches_plain(cuda_device, B, T, C):
    x, mu, sg, eps = _conv(cuda_device, B, T, C)
    got = PC.photonic_conv_cuda(x, mu, sg, eps)
    assert torch.equal(got, PC.photonic_conv_plain(x, mu, sg, eps))
    got = PC.photonic_conv_sampled_cuda(x, mu, sg, 17)
    _assert_adc_close(got, PC.photonic_conv_plain(x, mu, sg, seed=17))
    assert torch.equal(got, PC.photonic_conv_sampled_cuda(x, mu, sg, 17))
    # another seed draws another stream, and the kernel follows it
    got18 = PC.photonic_conv_sampled_cuda(x, mu, sg, 18)
    _assert_adc_close(got18, PC.photonic_conv_plain(x, mu, sg, seed=18))
    if got.numel() > 1:     # a single output lands on one ADC level for
        assert not torch.equal(got, got18)      # two seeds a few % of times


@pytest.mark.parametrize("B,T,C", [(8, 256, 9), (3, 1000, 9), (2, 515, 16),
                                   (4, 262, 4)])
def test_cuda_sampled_conv_equals_explicit_on_the_conv_stream(
        cuda_device, B, T, C):
    """The seeded kernel draws the (B, To, C) operand that conv_normal
    gives, so it equals the explicit kernel fed with that operand: bit for
    bit, or one ADC step where the kernel's libm and PyTorch's CUDA ops
    round a normal an ulp apart."""
    x, mu, sg, _ = _conv(cuda_device, B, T, C)
    To = T - C + 1
    eps = rng.conv_normal(23, torch.arange(B, device=cuda_device),
                              torch.arange(To, device=cuda_device), C)
    _assert_adc_close(PC.photonic_conv_sampled_cuda(x, mu, sg, 23),
                      PC.photonic_conv_cuda(x, mu, sg, eps))


_PROFILE_CONV = """
import importlib, json, tempfile
import torch
from torch.profiler import ProfilerActivity, profile
PC = importlib.import_module("repro_torch.kernels.photonic_conv")
x = torch.rand((64, 4096), device="cuda") * 2 - 1
mu = torch.linspace(-0.5, 0.5, 9, device="cuda")
sg = 0.2 * mu.abs()
eps = torch.randn((64, 4088, 9), device="cuda")
calls = {"explicit": lambda: PC.photonic_conv_cuda(x, mu, sg, eps),
         "sampled": lambda: PC.photonic_conv_sampled_cuda(x, mu, sg, 3)}
names = {}
for case, call in calls.items():
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(tmp + "/trace.json")
        events = json.load(open(tmp + "/trace.json"))["traceEvents"]
    names[case] = sorted(e["name"] for e in events
                         if e.get("cat") == "kernel")
print(json.dumps(names))
"""


def test_cuda_photonic_conv_is_one_launch(cuda_device):
    """By kernel name in a torch.profiler trace (a fresh process, as for
    the attention kernels): one call of either entry point launches its
    own kernel once and nothing else."""
    import json
    import os
    import subprocess
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [src, os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", _PROFILE_CONV], env=env,
                         capture_output=True, text=True, check=True)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names["explicit"]) == 1 \
        and "conv_explicit" in names["explicit"][0], names
    assert len(names["sampled"]) == 1 \
        and "conv_sampled" in names["sampled"][0], names


def _gemm(seed, M, K, N, S=None, dev="cuda"):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32)
    mu = (0.3 * r.standard_normal((K, N))).astype(np.float32)
    sg = np.abs(0.1 * r.standard_normal((K, N))).astype(np.float32)
    eps = r.standard_normal((K, N) if S is None else (S, K, N)).astype(
        np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, mu, sg, eps)]


def _rel_close(got, want, tol=1e-4):
    """f32 sums in another order: within 1e-4 of max |y|."""
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


def _bayes_route(route, M, K, N, S, x, mu, sg, eps=None):
    """The kernel a case runs: the forced one, or ``bayes_route``'s, which
    is asserted to be the tensor-core kernel wherever N % 4 == 0 (every
    operand here lies on a 16-byte boundary)."""
    if route != "auto":
        return route
    got = BM.bayes_route(M, K, N, S, x, mu, sg, eps)
    want = "mma" if N % 4 == 0 and M >= BM.BAYES_MMA_MIN_ROWS else "simt"
    assert got == want, (got, want)
    return None


# route "auto" takes bayes_route's kernel: the tensor-core kernel at
# (128, 1024, 300), (200, 171, 32), (130, 1024, 260) and the im2col-like
# (1000, 171, 32) (K % 4 != 0: x copied 4 bytes at a time); "simt" forces
# the SIMT kernels at every shape
@pytest.mark.parametrize("route", ["auto", "simt"])
@pytest.mark.parametrize("M,K,N", [(33, 70, 17), (128, 1024, 300),
                                   (1, 9, 7), (200, 171, 32),
                                   (130, 1024, 260), (1000, 171, 32)])
def test_cuda_bayes_matmul_matches_plain(cuda_device, route, M, K, N):
    x, mu, sg, eps = _gemm(M + K, M, K, N)
    r = _bayes_route(route, M, K, N, 1, x, mu, sg, eps)
    _rel_close(BM.bayes_matmul_cuda(x, mu, sg, eps, route=r),
               ref.bayes_matmul(x, mu, sg, eps))
    xb, mb, sb = (t.to(torch.bfloat16) for t in (x, mu, sg))
    _rel_close(BM.bayes_matmul_cuda(xb, mb, sb, eps, route=r),
               ref.bayes_matmul(xb, mb, sb, eps))


@pytest.mark.parametrize("route", ["auto", "simt"])
@pytest.mark.parametrize("S", [1, 4, 10, 16])
@pytest.mark.parametrize("M,K,N", [(33, 70, 17), (130, 171, 32),
                                   (130, 1024, 260), (1000, 171, 32)])
def test_cuda_bayes_matmul_sampled_matches_plain(cuda_device, route, S, M, K,
                                                 N):
    x, mu, sg, eps = _gemm(S + M, M, K, N, S)
    for kw in ({"eps": eps}, {"seed": 9}):
        r = _bayes_route(route, M, K, N, S, x, mu, sg, kw.get("eps"))
        got = BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=S, route=r,
                                           **kw)
        want = BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=S, **kw)
        assert got.shape == (S, M, N)
        _rel_close(got, want)


def test_cuda_bayes_routes_agree_on_the_seeded_w(cuda_device):
    """With x = I the seeded GEMM returns W_s itself: both kernels draw
    the TAG_BAYES stream of a seed at the same weight elements, so they
    give the same W_s within the rule, and the tensor-core kernel matches
    the plain version of its own 3xTF32 arithmetic."""
    K, N, S = 160, 260, 10
    _, mu, sg, _ = _gemm(6, K, K, N)
    eye = torch.eye(K, device=cuda_device)
    assert BM.bayes_route(K, K, N, S, eye, mu, sg) == "mma"
    mma = BM.bayes_matmul_sampled_cuda(eye, mu, sg, num_samples=S, seed=3)
    simt = BM.bayes_matmul_sampled_cuda(eye, mu, sg, num_samples=S, seed=3,
                                        route="simt")
    _rel_close(mma, simt)
    _rel_close(mma, BM.bayes_matmul_sampled_plain(
        eye, mu, sg, num_samples=S, seed=3, split="tf32x3"))
    assert not torch.equal(simt[0], simt[1])


@pytest.mark.parametrize("route", ["mma", "simt"])
def test_cuda_sampled_gemm_shares_w_across_row_blocks(cuda_device, route):
    """Rows 3 and 200 lie in different row blocks of either kernel's tile
    (128 rows on the tensor cores, 64 on the SIMT kernel): with the same x
    row they must see the same W_s for every s."""
    x, mu, sg, _ = _gemm(4, 300, 171, 40)
    x[200] = x[3]
    tile = BM.BAYES_TILE_ROWS[route]
    assert 3 // tile != 200 // tile
    assert BM.bayes_route(300, 171, 40, 10, x, mu, sg) == "mma"
    launches.reset()
    y = BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=10, seed=3,
                                     route=route)
    y2 = BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=10, seed=3,
                                      route=route)
    assert launches.snapshot()["bayes_matmul_sampled"] == 2
    assert torch.equal(y, y2)
    assert torch.equal(y[:, 3], y[:, 200])
    assert not torch.equal(y[0, 3], y[1, 3])


def test_cuda_quantizers_do_not_synchronize(cuda_device):
    """The DAC/ADC quantizers run three times per machine-mode forward
    pass of the BNN: a host copy of their scale would stall the stream
    each time."""
    x = torch.linspace(-2, 2, 1001, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q = ref.quantize(x, 8, 4.0)
        qs = quantize_ste(x, 8, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(q.cpu(), ref.quantize(x.cpu(), 8, 4.0))
    assert torch.equal(qs.cpu(), quantize_ste(x.cpu(), 8, 1.0))


def test_cuda_paper_wrappers_refuse_bad_operands(cuda_device):
    x, mu, sg, eps = _gemm(1, 8, 16, 12)
    with pytest.raises(ValueError):
        BM.bayes_matmul_cuda(x, mu, sg[:, :5], eps)
    with pytest.raises(ValueError):
        BM.bayes_matmul_sampled_cuda(x, mu, sg, num_samples=17)
    with pytest.raises(ValueError):
        BM.bayes_matmul_cuda(x, mu, sg, eps, route="wgmma")
    # mu one float off a 16-byte boundary: the route sends the call to the
    # SIMT kernel, and the tensor-core kernel, forced, refuses it (the
    # wrapper raises) rather than fault; so does N % 4 != 0
    M, K, N, S = 130, 64, 36, 4
    x, mu, sg, eps = _gemm(2, M, K, N, S)
    flat = torch.zeros(K * N + 1, device=cuda_device)
    mum = flat[1:].view(K, N)
    mum.copy_(mu)
    assert BM.bayes_route(M, K, N, S, x, mu, sg, eps) == "mma"
    assert BM.bayes_route(M, K, N, S, x, mum, sg, eps) == "simt"
    _rel_close(BM.bayes_matmul_sampled_cuda(x, mum, sg, num_samples=S,
                                            eps=eps),
               BM.bayes_matmul_sampled_plain(x, mu, sg, num_samples=S,
                                             eps=eps))
    with pytest.raises(RuntimeError):
        BM.bayes_matmul_sampled_cuda(x, mum, sg, num_samples=S, eps=eps,
                                     route="mma")
    with pytest.raises(RuntimeError):
        BM.bayes_matmul_cuda(x, mum, sg, eps[0], route="mma")
    with pytest.raises(RuntimeError):                    # N % 4 != 0
        BM.bayes_matmul_sampled_cuda(x, mu[:, :34], sg[:, :34],
                                     num_samples=S, seed=1, route="mma")
    xc = torch.zeros((2, 20), device=cuda_device)
    mu9 = torch.zeros(9, device=cuda_device)
    with pytest.raises(ValueError):
        PC.photonic_conv_cuda(xc, mu9, mu9, torch.zeros((2, 11, 9),
                                                        device=cuda_device))
    with pytest.raises(TypeError):
        PC.photonic_conv_sampled_cuda(xc.double(), mu9, mu9, 1)


# ---------------------------------------------------------------------------
# the LM-side kernels: LRT GEMMs, two-pass head, flash attention
# ---------------------------------------------------------------------------

def _lrt(seed, M, K, N, S):
    x, mu, sg, _ = _gemm(seed, M, K, N)
    xi = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (S, M, N)).astype(np.float32)).to(x.device)
    return x, mu, sg, xi


# route "auto" takes lrt_route's kernel: the tensor-core kernel at
# (128, 1024, 300), (130, 1000, 4100) and (64, 72, 36), ragged edges
# included; "stream" forces the streaming kernel at every shape
@pytest.mark.parametrize("route", ["auto", "stream"])
@pytest.mark.parametrize("M,K,N", [(33, 70, 17), (4, 1536, 1000),
                                   (128, 1024, 300), (1, 9, 7), (9, 65, 129),
                                   (130, 1000, 4100), (64, 72, 36)])
def test_cuda_lrt_matmul_matches_plain(cuda_device, route, M, K, N):
    x, mu, sg, xi = _lrt(M + K, M, K, N, 1)
    r = None if route == "auto" else route
    for xx in (x, x.to(torch.bfloat16)):
        _rel_close(BM.lrt_matmul_cuda(xx, mu, sg, xi[0], route=r),
                   BM.lrt_matmul_plain(xx, mu, sg, xi[0]))


@pytest.mark.parametrize("route", ["auto", "stream"])
@pytest.mark.parametrize("S", [1, 4, 10, 37])
@pytest.mark.parametrize("M,K,N", [(33, 70, 17), (16, 171, 300),
                                   (130, 1000, 4100), (64, 72, 36)])
def test_cuda_lrt_matmul_sampled_matches_plain(cuda_device, route, S, M, K,
                                               N):
    x, mu, sg, xi = _lrt(S + M, M, K, N, S)
    r = None if route == "auto" else route
    for kw in ({"xi": xi}, {"seed": 9}):
        got = BM.lrt_matmul_sampled_cuda(x, mu, sg, num_samples=S, route=r,
                                         **kw)
        want = BM.lrt_matmul_sampled_plain(x, mu, sg, num_samples=S, **kw)
        assert got.shape == (S, M, N)
        _rel_close(got, want)


def test_cuda_lrt_routes_agree_on_the_seeded_stream(cuda_device):
    """Both kernels draw the TAG_LRT stream of a seed at the same
    elements: the same seed gives the same samples within the rule, and
    the tensor-core kernel matches the plain version of its own 3xTF32
    arithmetic."""
    x, mu, sg, _ = _lrt(5, 130, 1000, 4100, 1)
    for xx in (x, x.to(torch.bfloat16)):
        assert BM.lrt_route(130, 1000, 4100, xx, mu, sg) == "mma"
        mma = BM.lrt_matmul_sampled_cuda(xx, mu, sg, num_samples=10, seed=3)
        stream = BM.lrt_matmul_sampled_cuda(xx, mu, sg, num_samples=10,
                                            seed=3, route="stream")
        _rel_close(mma, stream, tol=1e-5)
        _rel_close(mma, BM.lrt_matmul_sampled_plain(
            xx, mu, sg, num_samples=10, seed=3, split="tf32x3"), tol=1e-5)


def test_cuda_seeded_lrt_is_deterministic_and_counts_launches(cuda_device):
    x, mu, sg, xi = _lrt(3, 20, 64, 90, 1)
    launches.reset()
    a = BM.lrt_matmul_sampled_cuda(x, mu, sg, num_samples=10, seed=7)
    b = BM.lrt_matmul_sampled_cuda(x, mu, sg, num_samples=10, seed=7)
    c = BM.lrt_matmul_sampled_cuda(x, mu, sg, num_samples=10, seed=8)
    BM.lrt_matmul_cuda(x, mu, sg, xi[0])
    assert torch.equal(a, b) and not torch.equal(a, c)
    counts = launches.snapshot()
    assert counts["lrt_matmul_sampled"] == 3 and counts["lrt_matmul"] == 1


@pytest.mark.parametrize("M,V", [(4, 1000), (16, 513), (20, 300)])
def test_cuda_two_pass_head_matches_plain(cuda_device, M, V):
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(M, M, 64, V, 10))
    launches.reset()
    for xx in (x, x.to(torch.bfloat16)):
        got = UH.uncertainty_head_two_pass_cuda(xx, mu, sg, xi)
        want = UH.uncertainty_head_two_pass_plain(xx, mu, sg, xi)
        for k in KEYS:
            assert_close(got[k], want[k].cpu(), atol=2e-5, msg=k)
        assert torch.equal(got["pred"].cpu(), want["pred"].cpu())
    assert launches.snapshot()["uncertainty_head_two_pass"] == 2
    assert launches.snapshot()["uncertainty_head"] == 0


def test_cuda_two_pass_head_nan_row_stays_in_its_row(cuda_device):
    x, mu, sg, xi = (t.to(cuda_device) for t in _head(4, 4, 64, 700, 10))
    x[1] = float("nan")
    got = UH.uncertainty_head_two_pass_cuda(x, mu, sg, xi)
    want = UH.uncertainty_head_two_pass_plain(x, mu, sg, xi)
    for k in KEYS:
        assert torch.isnan(got[k][1]), k
        assert_close(got[k][[0, 2, 3]], want[k][[0, 2, 3]].cpu(), atol=2e-5,
                     msg=k)


def _attn(seed, B, Sq, Sk, H, Hkv, D, dtype, dev="cuda"):
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(r.standard_normal((B, S, h, D)).astype(
        np.float32)).to(dev, dtype) for S, h in ((Sq, H), (Sk, Hkv),
                                                   (Sk, Hkv)))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,q_offset", [
    (1, 32, 32, 4, 4, 16, True, 0),
    (2, 70, 70, 6, 2, 16, True, 0),          # GQA, ragged S
    (2, 64, 64, 8, 1, 32, False, 0),         # MQA, non-causal
    (2, 200, 200, 12, 2, 128, True, 0),
    (1, 64, 300, 12, 2, 128, True, 236),     # prefill continuation
    (3, 1, 257, 12, 2, 128, True, 256),      # the decode window
    (1, 100, 333, 4, 2, 128, False, 0),
    (1, 40, 90, 2, 1, 200, True, 50),        # D 200 (the 256 tiles)
    (1, 20, 20, 2, 2, 72, True, 0),          # D not a multiple of 64
    # bf16 at these takes the tensor-core kernel, with the kv split where
    # the row blocks do not fill the card (f32 takes the SIMT kernel)
    (1, 1, 2048, 12, 2, 128, True, 2047),    # Sq 1 against Sk 2048
    (1, 64, 2048, 12, 2, 128, True, 1984),   # the continuation
    (2, 37, 37, 12, 2, 128, True, 0),        # rows cross a replica
    (1, 50, 300, 16, 1, 64, True, 250),      # Hkv 1, H 16 (rep 16)
    (1, 40, 90, 4, 2, 64, True, 50),         # D 64
    (2, 33, 140, 8, 2, 96, False, 0),        # D 96, non-causal
    (1, 70, 200, 6, 3, 112, True, 130),      # D 112
    (2, 40, 100, 6, 2, 128, True, -20),      # rows 0-19 see no key
])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, B, Sq, Sk,
                                            H, Hkv, D, causal, q_offset):
    q, k, v = _attn(Sq + Sk + D, B, Sq, Sk, H, Hkv, D, dtype)
    got = FA.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    q_offset=q_offset)
    assert got.dtype == dtype and got.shape == (B, Sq, H, D)
    # f32: sums in another order; bf16: one bf16 ulp of O(1) outputs
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert_close(got.float(), want.float().cpu(), atol=tol)


def test_cuda_flash_attention_reads_strides_and_counts(cuda_device):
    """q/k/v as (B, H, S, D) tensors seen through a transpose: the kernel
    reads them by stride, as the contiguous copies give."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
               _attn(1, 2, 48, 48, 6, 2, 64, torch.float32))
    assert not q.is_contiguous()
    launches.reset()
    got = FA.flash_attention_cuda(q, k, v, causal=True)
    want = FA.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
    assert torch.equal(got, want)
    assert launches.snapshot()["flash_attention"] == 2


_PROFILE_FLASH = """
import importlib, json, sys, tempfile
import torch
from torch.profiler import ProfilerActivity, profile
FA = importlib.import_module("repro_torch.kernels.flash_attention")
names = {}
for case in sys.argv[1:]:
    dtype, D, Sq, Sk, off, odd = json.loads(case)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((4, n, h, D), device="cuda").to(dt)
               for n, h in ((Sq, 12), (Sk, 2), (Sk, 2)))
    if odd:   # q seen with an odd S stride
        q = torch.cat([q.flatten(2), q[..., :1, :1].flatten(2)], -1)
        q = q[..., :12 * D].unflatten(-1, (12, D))
    FA.flash_attention_cuda(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        FA.flash_attention_cuda(q, k, v, q_offset=off)
        torch.cuda.synchronize()
    # the trace's kernel events carry the full names (key_averages may
    # shorten a long one to "flash_fwd_...")
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(tmp + "/trace.json")
        events = json.load(open(tmp + "/trace.json"))["traceEvents"]
    names[case] = sorted(e["name"] for e in events
                         if e.get("cat") == "kernel" and "flash_" in e["name"])
print(json.dumps(names))
"""


def _flash_kernels(*cases):
    """Names of the flash kernels one causal call launches for each case
    (dtype name, D, Sq, Sk, q_offset, odd S stride), B 4, H 12, Hkv 2,
    from torch.profiler in a fresh process: late in a long test process
    the profiler was seen to record the launches but not the kernels."""
    import json
    import os
    import subprocess
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [src, os.environ.get("PYTHONPATH")])))
    args = [json.dumps(c) for c in cases]
    out = subprocess.run([sys.executable, "-c", _PROFILE_FLASH, *args],
                         env=env, capture_output=True, text=True, check=True)
    names = json.loads(out.stdout.strip().splitlines()[-1])
    return [names[a] for a in args]


def test_cuda_flash_attention_routes_by_dtype_head_dim_and_stride(
        cuda_device):
    """By kernel name: bf16 at D 128 launches the tensor-core kernel alone
    (no merge without a split); the decode window adds the merge; f32,
    bf16 at D 72 and bf16 with an odd S stride launch the SIMT kernel."""
    assert FA.flash_split(4, 2, 6 * 200, 200) == 1
    assert FA.flash_split(4, 2, 6, 2048) > 1
    mma, split, f32, d72, odd = _flash_kernels(
        ("bfloat16", 128, 200, 200, 0, False),
        ("bfloat16", 128, 1, 2048, 2047, False),
        ("float32", 128, 200, 200, 0, False),
        ("bfloat16", 72, 200, 200, 0, False),
        ("bfloat16", 64, 40, 40, 0, True))
    assert len(mma) == 1 and "flash_fwd_mma<128>" in mma[0], mma
    assert len(split) == 2 and any("flash_fwd_mma<128>" in n
                                   for n in split) \
        and any("flash_merge" in n for n in split), split
    for names in (f32, d72, odd):
        assert len(names) == 1 and "flash_fwd_simt" in names[0], names


def test_cuda_flash_attention_odd_stride_bf16_takes_simt(cuda_device):
    """A bf16 view whose S stride is odd cannot take 16-byte copies: it
    routes to the SIMT kernel and still matches the plain version."""
    B, S, H, Hkv, D = 2, 40, 4, 2, 64
    q, k, v = _attn(7, B, S, S, H, Hkv, D, torch.bfloat16)
    wide = torch.zeros((B, S, H * D + 1), dtype=torch.bfloat16,
                       device=cuda_device)
    wide[..., :H * D] = q.reshape(B, S, H * D)
    qv = wide[..., :H * D].unflatten(-1, (H, D))
    assert qv.stride(1) % 2 == 1
    assert FA.flash_route(torch.bfloat16, D, q, k, v) == "mma"
    assert FA.flash_route(torch.bfloat16, D, qv, k, v) == "simt"
    got = FA.flash_attention_cuda(qv, k, v, causal=True)
    want = FA.flash_attention_plain(qv, k, v, causal=True)
    assert_close(got.float(), want.float().cpu(), atol=2e-2)


def test_cuda_flash_attention_split_call_counts_one_launch(cuda_device):
    """The decode window splits over kv chunks and merges them: two
    launches, one count, and no other kernel's count moves."""
    q, k, v = _attn(8, 4, 1, 2048, 12, 2, 128, torch.bfloat16)
    assert FA.flash_split(4, 2, 6, 2048) > 1
    launches.reset()
    got = FA.flash_attention_cuda(q, k, v, causal=True, q_offset=2047)
    assert launches.snapshot()["flash_attention"] == 1
    assert sum(launches.snapshot().values()) == 1
    want = FA.flash_attention_plain(q, k, v, causal=True, q_offset=2047)
    assert_close(got.float(), want.float().cpu(), atol=2e-2)


def test_cuda_flash_attention_bf16_reads_strides(cuda_device):
    """The tensor-core kernel reads a transposed (B, H, S, D) view by
    stride, as the contiguous copies give."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
               _attn(9, 2, 100, 100, 6, 2, 64, torch.bfloat16))
    assert not q.is_contiguous()
    assert FA.flash_route(torch.bfloat16, 64, q, k, v) == "mma"
    got = FA.flash_attention_cuda(q, k, v, causal=True)
    want = FA.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
    assert torch.equal(got, want)


def test_cuda_lm_wrappers_refuse_bad_operands(cuda_device):
    x, mu, sg, xi = _lrt(1, 8, 16, 12, 3)
    with pytest.raises(ValueError):
        BM.lrt_matmul_cuda(x, mu, sg[:, :5], xi[0])
    with pytest.raises(ValueError):
        BM.lrt_matmul_sampled_cuda(x, mu, sg, num_samples=0)
    with pytest.raises(ValueError):
        BM.lrt_matmul_sampled_cuda(x, mu, sg, num_samples=3, xi=xi[:2])
    with pytest.raises(ValueError):
        BM.lrt_matmul_cuda(x, mu, sg, xi[0], route="wgmma")
    # an operand one float off a 16-byte boundary: the route sends the
    # call to the streaming kernel, and the tensor-core kernel, forced,
    # refuses it (the wrapper raises) rather than fault
    M, K, N = 64, 72, 36
    x, mu, sg, xi = _lrt(2, M, K, N, 1)
    flat = torch.zeros(M * K + 1, device=cuda_device)
    xm = flat[1:].view(M, K)
    xm.copy_(x)
    assert BM.lrt_route(M, K, N, x, mu, sg, xi) == "mma"
    assert BM.lrt_route(M, K, N, xm, mu, sg, xi) == "stream"
    _rel_close(BM.lrt_matmul_cuda(xm, mu, sg, xi[0]),
               BM.lrt_matmul_plain(x, mu, sg, xi[0]))
    with pytest.raises(RuntimeError):
        BM.lrt_matmul_cuda(xm, mu, sg, xi[0], route="mma")
    with pytest.raises(RuntimeError):                    # K % 4 != 0
        BM.lrt_matmul_cuda(x[:, :70], mu[:70], sg[:70], xi[0], route="mma")
    hx, hmu, hsg, hxi = (t.to(cuda_device) for t in _head(1, 4, 16, 50, 3))
    with pytest.raises(ValueError):
        UH.uncertainty_head_two_pass_cuda(hx, hmu, hsg, hxi[:, :2])
    q, k, v = _attn(2, 1, 8, 8, 4, 4, 264, torch.float32)
    with pytest.raises(ValueError):                      # D > 256
        FA.flash_attention_cuda(q, k, v)
    q, k, v = _attn(2, 1, 8, 8, 6, 4, 32, torch.float32)
    with pytest.raises(ValueError):                      # H % Hkv != 0
        FA.flash_attention_cuda(q, k, v)
    q, k, v = _attn(2, 1, 8, 8, 4, 2, 32, torch.float32)
    with pytest.raises(TypeError):
        FA.flash_attention_cuda(q.to(torch.bfloat16), k, v)


def _graph_runner(dev, entropy="kernel", decode_attn="kernel", chunk=4,
                  arch="qwen2_1_5b"):
    """A reduced ``arch`` (qwen2 or deepseek-moe: 2 layers, D 32, V 512;
    mamba2: 4 layers, d 128, N 16, V 512; zamba2: mamba2's blocks and 2
    applications of the shared block, 4 MHA heads of D 32; seamless: 2
    encoder and 2 decoder layers, 4 MHA heads of D 32; phi-3-vision: 2
    layers, 4 MHA heads of D 32, 8 prefix embeds) runner on the card: 3
    slots,
    paged KV (the dense recurrent cache for mamba2, as the engine falls
    back), the chunk captured as a CUDA graph."""
    import dataclasses

    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.entropy import KernelEntropy
    from repro_torch.launch.engine.runner import ModelRunner
    from repro_torch.models import registry as TM

    cfg = dataclasses.replace(reduced(get_config(arch)),
                              head_entropy=entropy, decode_attn=decode_attn)
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    if not TM.supports_paged(cfg):
        cfg = dataclasses.replace(cfg, decode_attn="gather")
    return ModelRunner(params, cfg, num_slots=3, max_len=32, chunk=chunk,
                       entropy=KernelEntropy(seed=5), mi_threshold=0.05,
                       se_threshold=1.0,
                       kv_layout="paged" if TM.supports_paged(cfg)
                       else "dense", kv_block=4, kv_blocks=24, device=dev)


@pytest.mark.parametrize("entropy,decode_attn", [("kernel", "kernel"),
                                                 ("operand", "gather")])
def test_cuda_captured_chunk_equals_the_eager_chunk(cuda_device, entropy,
                                                    decode_attn):
    """Three replays with a slot admitted (prefilled, activated) before
    each: every replay equals the eager chunk run on a copy of the carry
    it started from, bit for bit (outputs, tokens, depths, counters)."""
    _check_replays_against_eager(
        _graph_runner(cuda_device, entropy, decode_attn), cuda_device)


@pytest.mark.parametrize("entropy,decode_attn", [("kernel", "kernel"),
                                                 ("operand", "gather")])
def test_cuda_moe_captured_chunk_equals_the_eager_chunk(cuda_device, entropy,
                                                        decode_attn):
    """The moe family's chunk (routing, capacity dispatch, batched
    experts) as three replays with slots admitted between them, each bit
    for bit the eager chunk on a copy of its carry."""
    _check_replays_against_eager(
        _graph_runner(cuda_device, entropy, decode_attn,
                      arch="deepseek_moe_16b"), cuda_device)


@pytest.mark.parametrize("entropy", ["kernel", "operand"])
def test_cuda_ssm_captured_chunk_equals_the_eager_chunk(cuda_device,
                                                        entropy):
    """The ssm family's chunk (the recurrence writing each layer's state
    and conv tail in place) as three replays with slots admitted between
    them, each bit for bit the eager chunk on a copy of its carry."""
    _check_replays_against_eager(
        _graph_runner(cuda_device, entropy, arch="mamba2_370m"), cuda_device)


@pytest.mark.parametrize("entropy,decode_attn", [("kernel", "kernel"),
                                                 ("operand", "gather")])
def test_cuda_hybrid_captured_chunk_equals_the_eager_chunk(cuda_device,
                                                           entropy,
                                                           decode_attn):
    """The hybrid family's chunk (the shared block's applications, each
    writing its own pool plane; every layer's state and conv tail) as
    three replays with slots admitted between them (batch prefill through
    the paged slot write), each bit for bit the eager chunk on a copy of
    its carry, state and pools included."""
    runner = _graph_runner(cuda_device, entropy, decode_attn,
                           arch="zamba2_7b")
    assert runner.kv_layout == "paged"
    _check_replays_against_eager(runner, cuda_device)


def test_cuda_encdec_captured_chunk_equals_the_eager_chunk(cuda_device):
    """The encdec family's chunk (12 decoder layers reduced to 2: paged
    self-attention, cross-attention over each slot's ``ck`` / ``cv``) as
    three replays with slots admitted between them through chunked
    prefill, whose first chunk runs the encoder on random frames and
    writes the slot's cross strips in place: each replay bit for bit the
    eager chunk on a copy of its carry, the cross strips and pools
    included."""
    runner = _graph_runner(cuda_device, arch="seamless_m4t_medium")
    assert runner.kv_layout == "paged"
    ptrs = {k: v.data_ptr() for k, v in runner.cache.items()}
    _check_replays_against_eager(runner, cuda_device, frames=True)
    assert {k: v.data_ptr() for k, v in runner.cache.items()} == ptrs
    assert runner.cache["ck"].abs().amax(dim=(0, 2, 3, 4)).gt(0).all()


def test_cuda_vlm_captured_chunk_equals_the_eager_chunk(cuda_device):
    """The vlm family's chunk (the dense transformer over a paged pool
    whose first 8 rows a slot hold the prefix embeds' K/V) as three
    replays with slots admitted between them through batch prefill with
    random prefix embeds: each replay bit for bit the eager chunk on a
    copy of its carry, the pools included; the prefix rows are not
    zero."""
    runner = _graph_runner(cuda_device, arch="phi_3_vision_4_2b")
    assert runner.kv_layout == "paged"
    assert runner.captured == {"paged_decode_attention": 2 * 4,
                               "uncertainty_head": 4}
    _check_replays_against_eager(runner, cuda_device, prefix=True)
    table = runner.cache["block_table"][:, :2].long()     # rows 0-7
    assert runner.cache["k"][:, table].abs().amax(dim=(0, 3, 4, 5)) \
        .gt(0).all()


def test_cuda_escalation_lane_chunk_equals_the_eager_chunk(cuda_device):
    """The escalation lane's runner (one slot, dense, the gather read, 4x
    the serving S) captures its chunk once, when first asked for.  In a
    served run where every request escalates after its first chunk, each
    lane chunk replayed from that graph equals the eager chunk on a copy
    of its carry, bit for bit; a replay counts one head launch a step, and
    the run captures nothing anew."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.entropy import KernelEntropy
    from repro_torch.launch import steps as S
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models import registry as TM

    cfg = dataclasses.replace(reduced(get_config("qwen2_1_5b")),
                              head_entropy="kernel")
    params = TM.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    eng = ServeEngine(params, cfg, num_slots=2, max_len=32, chunk=4,
                      entropy=KernelEntropy(seed=5), kv_layout="paged",
                      kv_block=4, decode_attn="kernel",
                      prefill_mode="chunked", prefill_chunk=8,
                      device=cuda_device, escalate_mi=0.0)
    runner = eng.escalation_runner(4 * cfg.mc_samples)
    assert runner is eng.escalation_runner(eng.escalate_s)
    assert runner.graph is not None and runner.params is eng.params
    assert runner.captured == {"uncertainty_head": 4}
    graph = runner.graph
    eager = S.build_scan_decode(runner.cfg, entropy=KernelEntropy(seed=5),
                                chunk=4, mi_threshold=0.05, se_threshold=1.0)
    real, seen = runner.scan, []

    def compare(tok, cache, step0, active, flags):
        copy = (tok.clone(), {k: v.clone() for k, v in cache.items()},
                active.clone(), {k: v.clone() for k, v in flags.items()})
        out = real(tok, cache, step0, active, flags)
        step = torch.full((1,), step0, dtype=torch.int32, device=cuda_device)
        want = eager(runner.params, copy[0], copy[1], step, copy[2], copy[3],
                     torch.empty_like(runner.ys))
        assert torch.equal(out[3].view(torch.int32),
                           want[3].view(torch.int32)), step0
        assert torch.equal(out[0], want[0])
        assert all(torch.equal(cache[k], want[1][k]) for k in cache)
        assert all(torch.equal(flags[k], want[2][k]) for k in flags)
        seen.append(step0)
        return out

    r = np.random.default_rng(4)
    reqs = [Request(rid=i, prompt=r.integers(1, 511, size=9).astype(np.int32),
                    max_new_tokens=12) for i in range(3)]
    runner.scan = compare
    launches.reset()
    try:
        res = eng.run(reqs)
    finally:
        del runner.scan
    torch.cuda.synchronize()
    esc = res["escalation"]
    assert esc["escalations"] == 3 and esc["steps"] == 4 * len(seen) > 0
    assert all(q.was_escalated and len(q.tokens) == 12 for q in reqs)
    # the eager comparison launches the head once a step too
    assert launches.snapshot()["uncertainty_head"] \
        == res["spec_decode"]["full_model_calls"] + 2 * esc["steps"]
    assert runner.graph is graph


def _check_replays_against_eager(runner, cuda_device, frames=False,
                                 prefix=False):
    """Replays against the eager chunk; ``frames``: admit each slot
    through chunked prefill (8-token chunks, the first with random encoder
    frames) and hold the cross strips and pools too; ``prefix``: admit
    each slot through batch prefill with random prefix embeds and hold
    the pools too."""
    from repro_torch.launch import steps as S

    assert runner.graph is not None
    r = np.random.default_rng(3)
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        paged = "block_table" in cache
        table = np.full((3, 8), -1, np.int32)
        table[:, :6] = r.permutation(24)[:18].reshape(3, 6)
        if paged:
            runner.write_table(cache, table)
        for slot, step0 in ((0, 0), (1, 4), (2, 8)):
            prompt = r.integers(1, 511, size=9 + slot).astype(np.int32)
            if frames:
                fr = torch.from_numpy(r.standard_normal(
                    (1, 1024, runner.cfg.d_model)).astype(np.float32))
                runner.set_len(cache, slot, 0)
                span = -(-len(prompt) // 4) * 4
                for off in range(0, len(prompt), 8):
                    toks = np.zeros((8,), np.int32)
                    real = min(8, len(prompt) - off)
                    toks[:real] = prompt[off:off + real]
                    runner.prefill_chunk(
                        cache, slot, toks, off, off + real, span,
                        frames=fr.to(cuda_device) if off == 0 else None)
            else:
                emb = torch.from_numpy(r.standard_normal(
                    (1, runner.cfg.num_prefix_embeds, runner.cfg.d_model))
                    .astype(np.float32)).to(cuda_device) if prefix else None
                runner.prefill(cache, slot, prompt,
                               table[slot] if paged else None, emb)
            tok[slot] = int(prompt[-1])
            active[slot] = True
            copy = (tok.clone(), {k: v.clone() for k, v in cache.items()},
                    active.clone(), {k: v.clone() for k, v in flags.items()})
            out = runner.scan(tok, cache, step0, active, flags)
            ys = torch.empty_like(runner.ys)
            step = torch.full((1,), step0, dtype=torch.int32,
                              device=cuda_device)
            want = runner._scan(runner.params, copy[0], copy[1], step,
                                copy[2], copy[3], ys)
            assert torch.equal(out[3].view(torch.int32),
                               want[3].view(torch.int32)), slot
            assert torch.equal(out[0], want[0])
            assert all(torch.equal(cache[k], want[1][k])
                       for k in ("len", "ssm", "conv") if k in cache)
            # the hybrid's pool planes, without the sink block (dropped
            # writes land there in no fixed order; it is never read)
            assert all(torch.equal(cache[k][:, :-1], want[1][k][:, :-1])
                       for k in ("attn_k", "attn_v") if k in cache)
            if frames:
                assert all(torch.equal(cache[k], want[1][k])
                           for k in ("ck", "cv"))
            if frames or prefix:
                assert all(torch.equal(cache[k][:, :-1], want[1][k][:, :-1])
                           for k in ("k", "v"))
            assert all(torch.equal(flags[k], want[2][k]) for k in flags)
            live = out[3][:, S.OUTPUTS.index("MI"), :slot + 1]
            assert torch.isfinite(live).all() and (live >= 0).all()


def test_cuda_widened_table_graph_equals_the_eager_chunk(cuda_device):
    """A request needing more blocks than the build-time table holds
    (prompt 40 + 8 tokens against max_len 24 in blocks of 4): the runner
    moves to a wider device table mid-run and captures the chunk again
    over it; every chunk, those replayed at the widened table included,
    equals the eager chunk bit for bit (outputs, tokens, depths, flags)."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.core.entropy import KernelEntropy
    from repro_torch.launch import steps as S
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models import registry as TM

    cfg = dataclasses.replace(reduced(get_config("qwen2_1_5b")),
                              head_entropy="kernel")
    params = TM.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    eng = ServeEngine(params, cfg, num_slots=2, max_len=24, chunk=4,
                      entropy=KernelEntropy(seed=5), kv_layout="paged",
                      kv_block=4, kv_blocks=24, decode_attn="kernel",
                      prefill_mode="chunked", prefill_chunk=8,
                      device=cuda_device)
    runner = eng.runner
    eager = S.build_scan_decode(eng.cfg, entropy=KernelEntropy(seed=5),
                                chunk=4, mi_threshold=eng.mi_threshold)
    graphed, widths = runner.scan, []
    rows = [S.OUTPUTS.index(k) for k in ("token", "H", "SE", "MI", "p_max")]

    def checked(tok, cache, step0, active, flags):
        widths.append(runner.table_width())
        copy = (tok.clone(), {k: v.clone() for k, v in cache.items()},
                active.clone(), {k: v.clone() for k, v in flags.items()})
        out = graphed(tok, cache, step0, active, flags)
        ys = torch.empty_like(runner.ys)
        step = torch.full((1,), step0, dtype=torch.int32, device=cuda_device)
        e_tok, e_cache, e_flags, ys = eager(eng.params, copy[0], copy[1],
                                            step, copy[2], copy[3], ys)
        assert torch.equal(out[3][:, rows].view(torch.int32),
                           ys[:, rows].view(torch.int32))
        assert torch.equal(out[0], e_tok)
        assert torch.equal(cache["len"], e_cache["len"])
        assert all(torch.equal(flags[k], e_flags[k]) for k in flags)
        return out

    runner.scan = checked
    r = eng.run([Request(rid=0, prompt=np.arange(3, 13, dtype=np.int32),
                         max_new_tokens=8),
                 Request(rid=1, prompt=np.arange(1, 41, dtype=np.int32),
                         max_new_tokens=8, arrival_step=4)])
    assert r["table_growths"] >= 1
    assert max(widths) > runner.table_width0 == min(widths)
    assert sorted(runner._graphs) == sorted(set(widths))
    assert all(len(q.tokens) == 8 for q in r["requests"])


def test_cuda_replays_count_the_captured_launches(cuda_device):
    """A replay calls no wrapper: the runner adds the launches recorded at
    capture (one decode launch a layer a step, here 2 layers x 4 steps,
    and one head a step) once per replay."""
    runner = _graph_runner(cuda_device)
    assert runner.captured == {"paged_decode_attention": 2 * 4,
                               "uncertainty_head": 4}
    launches.reset()
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        for n in range(5):
            runner.scan(tok, cache, 4 * n, active, flags)
    torch.cuda.synchronize()
    got = launches.snapshot()
    assert {k: v for k, v in got.items() if v} == {
        k: 5 * v for k, v in runner.captured.items()}


def test_cuda_moe_chunk_records_no_host_sync(cuda_device):
    """The moe decode chunk, eager and replayed, never synchronises the
    host (no boolean-mask indexing, no one-hot of unknown width), and a
    replay counts one decode launch a layer a step and one head a step;
    so does a moe prompt chunk threading its expert offsets."""
    runner = _graph_runner(cuda_device, arch="deepseek_moe_16b")
    assert runner.captured == {"paged_decode_attention": 2 * 4,
                               "uncertainty_head": 4}
    prompt = np.arange(1, 9, dtype=np.int32)
    table = np.full((3, 8), -1, np.int32)
    table[0, :4] = (3, 9, 1, 7)
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        runner.write_table(cache, table)
        off = runner.expert_offsets()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cache, off = runner.prefill_chunk(cache, 0, prompt, 0, 8, 8,
                                              expert_offsets=off)
            tok[0].fill_(int(prompt[-1]))
            active[0].fill_(True)
            runner.scan(tok, cache, 0, active, flags)
            ys = torch.empty_like(runner.ys)
            runner._scan(runner.params, tok, cache, runner.step0, active,
                         flags, ys)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert off.shape == (2, runner.cfg.num_experts)
    assert (off.sum(-1) == 8 * runner.cfg.top_k).all()
    assert int(cache["len"][0]) == 8 + 2 * runner.chunk
    assert torch.isfinite(ys[:, 3, 0]).all()


def test_cuda_ssm_chunk_records_no_host_sync(cuda_device):
    """The ssm decode chunk, eager and replayed, never synchronises the
    host (each layer's state and conv tail written in place, no tensor
    made from host data inside the step), and neither does the exact-
    length batch prefill into a slot; a replay counts one head a step
    and nothing else; the carry keeps its addresses."""
    runner = _graph_runner(cuda_device, arch="mamba2_370m")
    assert runner.captured == {"uncertainty_head": 4}
    prompt = np.arange(1, 12, dtype=np.int32)
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runner.prefill(cache, 0, prompt, None)
            tok[0].fill_(int(prompt[-1]))
            active[0].fill_(True)
            runner.scan(tok, cache, 0, active, flags)
            ys = torch.empty_like(runner.ys)
            runner._scan(runner.params, tok, cache, runner.step0, active,
                         flags, ys)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert cache["len"].tolist() == [11 + 2 * runner.chunk,
                                     2 * runner.chunk, 2 * runner.chunk]
    assert torch.isfinite(ys[:, 3, 0]).all()
    assert cache["ssm"][:, 0].abs().sum() > 0


def test_cuda_hybrid_chunk_records_no_host_sync(cuda_device):
    """The hybrid decode chunk, eager and replayed, never synchronises the
    host, nor do its prompt chunks threading the recurrent state (a
    16-token chunk and the finalize chunk); a replay counts one decode
    launch an application a step (2 here) and one head a step; the state
    reaches the slot on the finalize chunk; the carry keeps its
    addresses."""
    runner = _graph_runner(cuda_device, arch="zamba2_7b")
    assert runner.captured == {"paged_decode_attention": 2 * 4,
                               "uncertainty_head": 4}
    prompt = np.arange(1, 21, dtype=np.int32)
    table = np.full((3, 8), -1, np.int32)
    table[0, :5] = (3, 9, 1, 7, 11)
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        runner.write_table(cache, table)
        state = runner.prefill_state()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runner.set_len(cache, 0, 0)
            cache, state = runner.prefill_chunk(cache, 0, prompt[:16], 0, 16,
                                                20, state=state)
            runner.scan(tok, cache, 0, active, flags)
            cache, state = runner.prefill_chunk(cache, 0, prompt[16:], 16, 20,
                                                20, state=state,
                                                finalize=True)
            tok[0].fill_(int(prompt[-1]))
            active[0].fill_(True)
            runner.scan(tok, cache, 4, active, flags)
            ys = torch.empty_like(runner.ys)
            runner._scan(runner.params, tok, cache, runner.step0, active,
                         flags, ys)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert int(cache["len"][0]) == 20 + 2 * runner.chunk
    assert state["ssm"].shape == (4, 1, 8, 32, 16)
    assert torch.isfinite(ys[:, 3, 0]).all()
    assert cache["ssm"][:, 0].abs().sum() > 0


def test_cuda_writes_between_chunks_do_not_synchronize(cuda_device):
    """What the engine writes into the graph's carry between replays (the
    block table, a slot's depth, token and flags, a prompt chunk) and the
    replay itself queue without a host sync; an item assignment of a
    Python scalar would sync (it stages the scalar through a host copy)."""
    runner = _graph_runner(cuda_device)
    prompt = np.arange(1, 9, dtype=np.int32)
    table = np.full((3, 8), -1, np.int32)
    table[0, :4] = (3, 9, 1, 7)
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runner.write_table(cache, table)
            runner.set_len(cache, 0, 0)
            runner.prefill_chunk(cache, 0, prompt, 0, 8, 8)
            tok[0].fill_(int(prompt[-1]))
            active[0].fill_(True)
            flags["epistemic"][0].fill_(0)
            runner.scan(tok, cache, 0, active, flags)
            with pytest.raises(RuntimeError):
                tok[1] = 5
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert int(cache["len"][0]) == 8 + runner.chunk
    assert torch.equal(cache["block_table"].cpu(), torch.from_numpy(table))


@pytest.mark.parametrize("offset,span", [(200, 256), (264, 320)])
def test_cuda_prefill_mma_at_prefix_hit_offsets(cuda_device, offset, span):
    """A prefix hit's suffix walk starts mid-block (qwen2-1.5B: H 12,
    Hkv 2, D 128, bf16, 64-token chunks; a 200-token hit of a 256-token
    prompt, a 264-token hit of a 320-token one): the tensor-core kernel
    within 2e-2 of the plain version, no NaN; and the rows a chunk at
    offset 200 shares with the cold walk's chunk at offset 192 are bit
    for bit the same."""
    q, k, v, row = _prefill_bf16(cuda_device, offset, 64, 12, 2, 128, 16,
                                 span)
    for kc in (1024, 64):
        got = PA.paged_prefill_attention_cuda(q, k, v, row, offset, span, kc)
        want = PA.paged_prefill_attention_plain(q, k, v, row, offset, span,
                                                kc)
        assert not torch.isnan(got).any()
        assert_close(got.float(), want.float().cpu(), atol=2e-2)
    if offset == 200:
        cold = PA.paged_prefill_attention_cuda(
            torch.cat([torch.zeros_like(q[:, :8]), q[:, :56]], dim=1), k, v,
            row, 192, span, 1024)
        hit = PA.paged_prefill_attention_cuda(q, k, v, row, 200, span, 1024)
        assert torch.equal(cold[:, 8:].view(torch.int16),
                           hit[:, :56].view(torch.int16))


def test_cuda_copy_block_lands_where_the_captured_chunk_reads(cuda_device):
    """The copy-on-write of a prefix block under a captured decode chunk:
    ``runner.copy_block`` copies in place (no pool is rebound), the slot's
    table swaps to the copy, and the replay, which reads the pools at
    their captured addresses, equals the eager chunk bit for bit even with
    the original block then scribbled over (the slot reads the copy)."""
    runner = _graph_runner(cuda_device, "operand", "kernel")
    r = np.random.default_rng(4)
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        ptrs = {n: t.data_ptr() for n, t in cache.items()}
        table = np.full((3, 8), -1, np.int32)
        table[0, :4] = (5, 2, 9, 14)
        runner.write_table(cache, table)
        prompt = r.integers(1, 511, size=8).astype(np.int32)
        runner.set_len(cache, 0, 0)
        runner.prefill_chunk(cache, 0, prompt, 0, 8, 8)
        runner.copy_block(cache, 2, 11)
        table[0, 1] = 11
        runner.write_table(cache, table)
        assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
        for n in ("k", "v"):
            assert torch.equal(cache[n][:, 11], cache[n][:, 2])
        tok[0].fill_(int(prompt[-1]))
        active[0].fill_(True)
        copy = (tok.clone(), {k: v.clone() for k, v in cache.items()},
                active.clone(), {k: v.clone() for k, v in flags.items()})
        for n in ("k", "v"):
            cache[n][:, 2].fill_(7.0)
        out = runner.scan(tok, cache, 0, active, flags)
        ys = torch.empty_like(runner.ys)
        step = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
        want = runner._scan(runner.params, copy[0], copy[1], step, copy[2],
                            copy[3], ys)
        assert torch.equal(out[3].view(torch.int32), want[3].view(torch.int32))
        assert torch.equal(out[0], want[0])


def test_cuda_spec_round_replay_equals_the_eager_round(cuda_device):
    """A speculative round of depth 4 on a reduced qwen2 runner (operand
    entropy, kernel decode attention): the first round of the depth runs
    eagerly and captures the graph; the next rounds replay it and equal
    the same rounds run eagerly (``runner.spec_fns``) on a copy of the
    carry, bit for bit (proposals, verify outputs, token, depths, pools),
    and count the captured launches."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.launch.engine.runner import ModelRunner
    from repro_torch.models import registry as TM

    cfg = dataclasses.replace(reduced(get_config("qwen2_1_5b")),
                              head_entropy="operand", decode_attn="kernel")
    params = TM.init_params(cfg, torch.Generator(device=cuda_device)
                            .manual_seed(0), cuda_device)
    runner = ModelRunner(params, cfg, num_slots=3, max_len=48, chunk=4,
                         entropy=None, mi_threshold=0.05, se_threshold=1.0,
                         kv_layout="paged", kv_block=4, kv_blocks=36,
                         device=cuda_device, spec_k_max=6)
    r = np.random.default_rng(6)
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        table = np.full((3, 12), -1, np.int32)
        table[:, :10] = r.permutation(36)[:30].reshape(3, 10)
        runner.write_table(cache, table)
        lens0 = np.zeros((3,), np.int32)
        for slot in range(3):
            prompt = r.integers(1, 511, size=9 + slot).astype(np.int32)
            runner.prefill(cache, slot, prompt, table[slot])
            tok[slot].fill_(int(prompt[-1]))
            lens0[slot] = len(prompt)
        assert 4 not in runner.spec_graphs
        runner.spec_round(4, lens0)                 # eager, then captured
        assert 4 in runner.spec_graphs and runner.spec_capture_s[4] > 0
        draft, verify = runner.spec_fns(4)
        for _ in range(2):
            lens0 = cache["len"].cpu().numpy()
            tc = tok.clone()
            cc = {n: t.clone() for n, t in cache.items()}
            launches.reset()
            ys = runner.spec_round(4, lens0).clone()
            assert launches.snapshot()["paged_decode_attention"] \
                == 4 * cfg.num_layers
            hid = torch.empty_like(runner.spec_hid)
            eys = torch.empty_like(runner.spec_ys)
            draft(runner.params, tc, cc, hid, eys, {})
            verify(runner.params, hid, torch.from_numpy(lens0).to(
                cuda_device), eys)
            assert torch.equal(ys.view(torch.int32),
                               eys[:4].view(torch.int32))
            assert torch.equal(tc, tok)
            for n in ("len", "k", "v"):
                a, b = cc[n], cache[n]
                if n != "len":
                    a, b = a[:, :-1], b[:, :-1]
                assert torch.equal(a, b), n


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q", "--noconftest", "-p",
                          "no:cacheprovider"]))
