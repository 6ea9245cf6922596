"""Serve-time tensor parallelism, piece by piece, on the CPU.

The port's serve rule table (``sharding.partition.serve_dims``) against
the JAX package's ``sanitize_pspecs(serve_pspecs(params), params, mesh)``
leaf for leaf, for all six families at M 2 and 4 (a stand-in mesh that
holds only ``.shape``: the JAX rules need no devices); ``shard_params``
then ``gather_rep`` in two spawned gloo ranks giving back every leaf bit
for bit; the rank's parameter and cache shapes; the mesh flag; and the
decode kernel's plain version on a kv-head slice, which equals that
slice of the unsharded call bit for bit given the unsharded split and
not given the rank's own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _mesh_ranks as R
from _torch_parity import meshless_reference  # noqa: F401
from repro.configs.registry import get_config as jget, reduced as jred
from repro.models import registry as JM
from repro.sharding.partition import sanitize_pspecs, serve_pspecs
from repro_torch.configs.registry import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.launch.engine import mesh_check as MC
from repro_torch.models import registry as M
from repro_torch.sharding.partition import (gather_rep, serve_dims,
                                            shard_params, shardable)

ARCHS = ("qwen2_1_5b", "deepseek_moe_16b", "mamba2_370m", "zamba2_7b",
         "seamless_m4t_medium", "phi_3_vision_4_2b")


@pytest.fixture(scope="module")
def ranks():
    with meshlib.Ranks(2, "cpu", timeout_s=120) as r:
        yield r


class _Mesh:
    """The one attribute of a ``jax.sharding.Mesh`` the rules read."""

    def __init__(self, m):
        self.shape = {"data": 1, "model": m}


def _jax_axes(specs, shapes, path=""):
    """{port path: sharded axis or None} of the JAX spec tree; the head's
    GaussianVariational ``q.mu`` / ``q.rho`` map to the port's ``mu`` /
    ``sigma``."""
    from repro.core.bayesian import GaussianVariational
    out = {}
    for k, s in specs.items():
        p = f"{path}/{k}"
        if isinstance(s, GaussianVariational):
            for name, port in (("mu", "mu"), ("rho", "sigma")):
                out[f"{path}/{port}"] = _axis(getattr(s, name))
            continue
        if isinstance(s, dict):
            out.update(_jax_axes(s, shapes[k], p))
            continue
        out[p] = _axis(s)
    return out


def _axis(spec):
    axes = [i for i, d in enumerate(spec) if d is not None]
    assert len(axes) <= 1 and all(spec[i] == "model" for i in axes), spec
    return axes[0] if axes else None


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_dims_equal_the_jax_rules(arch, m):
    jcfg = jred(jget(arch))
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    want = _jax_axes(sanitize_pspecs(serve_pspecs(shapes), shapes,
                                     _Mesh(m)), shapes)
    params = M.init_params(reduced(get_config(arch)),
                           torch.Generator().manual_seed(0), "cpu")
    got = dict(R._leaves(serve_dims(params, m)))
    assert got == want
    # something shards in every family: at least the head's columns
    assert got["/head/mu"] == got["/head/sigma"] == 1


def test_serve_rules_replicate_what_would_split_a_sum():
    """Spelled out for the reduced configs at M 2: the column-parallel
    leaves shard on their last axis, everything else replicates."""
    dense = dict(R._leaves(serve_dims(M.init_params(
        reduced(get_config("qwen2_1_5b")), torch.Generator(), "cpu"), 2)))
    assert {p for p, d in dense.items() if d is not None} == {
        f"/blocks/{n}" for n in ("attn/wq", "attn/wk", "attn/wv", "attn/bq",
                                 "attn/bk", "attn/bv", "mlp/w1", "mlp/w3")
    } | {"/head/mu", "/head/sigma"}
    moe = dict(R._leaves(serve_dims(M.init_params(
        reduced(get_config("deepseek_moe_16b")), torch.Generator(), "cpu"),
        2)))
    assert all(moe[p] is None for p in moe
               if "experts" in p or "router" in p or "/shared/" in p)
    hyb = dict(R._leaves(serve_dims(M.init_params(
        reduced(get_config("zamba2_7b")), torch.Generator(), "cpu"), 2)))
    assert hyb["/shared/attn/wq"] == hyb["/shared/mlp/w1"] == 1
    assert all(hyb[p] is None for p in hyb if p.startswith("/blocks/"))


def test_divisibility_falls_back_to_replication():
    """mamba2's published vocabulary 50280 is not a multiple of 16: the
    head replicates there, as ``sanitize_pspecs`` gives it."""
    params = {"head": {"mu": torch.empty(4, 50280),
                       "sigma": torch.empty(4, 50280)}}
    assert serve_dims(params, 8)["head"]["mu"] == 1
    assert serve_dims(params, 16)["head"] == {"mu": None, "sigma": None}
    assert not shardable(3, 2) and shardable(4, 2)
    assert not shardable(1, 2)     # fewer heads than ranks


def test_shard_params_concatenate_back_to_the_params():
    params = M.init_params(reduced(get_config("qwen2_1_5b")),
                           torch.Generator().manual_seed(0), "cpu")
    dims = serve_dims(params, 4)
    parts = [shard_params(params, r, 4, dims) for r in range(4)]
    for (path, full), (_, d) in zip(R._leaves(params), R._leaves(dims)):
        leaves = [dict(R._leaves(p))[path] for p in parts]
        if d is None:
            assert all(t is full for t in leaves), path
        else:
            assert all(t.is_contiguous() and t.shape[d] == full.shape[d] // 4
                       for t in leaves), path
            assert torch.equal(torch.cat(leaves, dim=d), full), path


def test_gather_rep_is_the_identity_without_a_group():
    x = torch.arange(6.0).reshape(2, 3)
    assert gather_rep(x, None) is x
    one = meshlib.TP(rank=0, size=1, backend="gloo",
                     device=torch.device("cpu"))
    assert gather_rep(x, one) is x


@pytest.mark.parametrize("family", sorted(MC.FAMILIES))
def test_shard_then_gather_gives_back_every_leaf(ranks, family):
    bad = ranks.run(R.gathered_params, family)
    for rank_bad in bad:
        assert rank_bad[:-1] == [], rank_bad
        assert int(rank_bad[-1].split()[1]) >= 5      # sharded leaves


def test_rank_holds_its_columns_and_kv_heads(ranks):
    """Dense (H 4, Hkv 2, D 32, ff 256, V 512) at M 2, operand entropy:
    the column leaves and the head halve, the pools hold one kv head,
    every other leaf keeps its shape.  In kernel entropy the head stays
    whole (the fused kernel takes the whole vocabulary)."""
    lay = ranks.run(R.rank_layout, "dense")[0]
    p, c = lay["params"], lay["cache"]
    assert p["/blocks/attn/wq"] == (2, 128, 64)
    assert p["/blocks/attn/wk"] == p["/blocks/attn/wv"] == (2, 128, 32)
    assert p["/blocks/attn/bk"] == (2, 32)
    assert p["/blocks/attn/wo"] == (2, 128, 128)
    assert p["/blocks/mlp/w1"] == p["/blocks/mlp/w3"] == (2, 128, 128)
    assert p["/blocks/mlp/w2"] == (2, 256, 128)
    assert p["/head/mu"] == p["/head/sigma"] == (128, 256)
    assert p["/embed/table"] == (512, 128)
    assert c["k"] == c["v"] == (2, 13, 8, 1, 32)
    assert c["block_table"] == (2, 4) and c["len"] == (2,)
    kern = ranks.run(R.rank_layout, "dense", "kernel")[1]
    assert kern["params"]["/head/mu"] == (128, 512)
    # encdec: the cross strips shard with the self-attention pools
    enc = ranks.run(R.rank_layout, "encdec")[0]["cache"]
    assert enc["ck"][-2] == enc["cv"][-2] == enc["k"][-2] == 2


@pytest.mark.parametrize("spec,want", [
    (None, None), ("none", None), ("1x2", 2), ("1x4", 4), ("1X1", 1)])
def test_parse_mesh(spec, want):
    assert meshlib.parse_mesh(spec) == want


@pytest.mark.parametrize("spec", ["2x2", "4", "1x0", "axb"])
def test_parse_mesh_refuses(spec):
    with pytest.raises(ValueError):
        meshlib.parse_mesh(spec)


def test_engine_refuses_what_13c_leaves_out():
    """Item 13c is ported, so nothing is refused any more: under a rank's
    ``TP`` the engine builds with speculative decoding (the round's
    buffers at the whole widths: the rank's parameters are sharded, its
    hiddens are not) and with the escalation lane, whose runner holds the
    main runner's share itself (the same tensors, ``data_ptr`` for
    ``data_ptr``: no second copy, no second sharding) and attends every
    head (its one-slot cache whole).  Building runs no collective, so no
    group is needed.  The name is the case's from before the port."""
    cfg = dataclasses.replace(reduced(get_config("qwen2_1_5b")),
                              head_entropy="operand", num_kv_heads=2)
    params = M.init_params(cfg, torch.Generator(), "cpu")
    tp = meshlib.TP(rank=0, size=2, backend="gloo",
                    device=torch.device("cpu"))
    kw = dict(num_slots=2, max_len=16, device="cpu", mesh=tp)
    spec = ServeEngine(params, cfg, spec_decode=True, spec_k=3, **kw)
    r = spec.runner
    assert r.params["head"]["mu"].shape[-1] == cfg.vocab_size // 2
    assert r.spec_hid.shape == (3, 2, cfg.d_model)
    assert r.spec_ys.shape[0] == 3
    lane = ServeEngine(params, cfg, escalate_mi=0.5, **kw)
    esc = lane.escalation_runner(lane.escalate_s)
    assert esc.tp == dataclasses.replace(tp, local_heads=False)
    assert esc.params is lane.runner.params
    assert MC.shares_storage(esc.params, lane.runner.params)
    assert esc.cfg.mc_samples == lane.escalate_s and esc.num_slots == 1
    assert lane.runner.cache["k"].shape[-2] == 1   # the rank's kv head
    assert esc.cache["k"].shape[-2] == 2           # every kv head


def test_engine_refuses_slo_deadlines_under_a_mesh(ranks):
    """SLO deadlines serve under a mesh now (rank 0's submission stamps
    are broadcast, so the ranks rank the queue alike): on two ranks the
    priority policy serves a request with an SLO without raising, and an
    empty prompt still raises ``ValueError`` before anything is served.
    The name is the case's from before the port."""
    for got in ranks.run(R.engine_features):
        assert got["slo_tokens"] == 4
        assert "empty prompt" in got["empty"]
        assert got["spec"] and got["lane_shares"] is True


# (route, dtype, H, Hkv, D, BS, MB): the served decode walk (bf16, D 128,
# qwen2's GQA) and the SIMT walk (f32), B 1, at depths whose split differs
# between 4 kv heads and one rank's 1 (M 4)
SLICE_CASES = {"mma": (torch.bfloat16, 16, 4, 128, 16, 256),
               "simt": (torch.float32, 8, 4, 64, 16, 320)}


@pytest.mark.parametrize("route", sorted(SLICE_CASES))
def test_decode_on_a_head_slice_needs_the_unsharded_split(route):
    dtype, H, Hkv, D, BS, MB = SLICE_CASES[route]
    g = torch.Generator().manual_seed(7)
    depth = MB * BS - 5
    k = torch.randn((MB + 1, BS, Hkv, D), generator=g).to(dtype)
    v = torch.randn((MB + 1, BS, Hkv, D), generator=g).to(dtype)
    q = torch.randn((1, 1, H, D), generator=g).to(dtype)
    table = torch.randperm(MB, generator=g).to(torch.int32)[None]
    lens = torch.tensor([depth], dtype=torch.int32)
    full = ops.paged_decode_attention(q, k, v, table, lens)
    if route == "mma":
        assert PA.decode_tiles(1, Hkv, MB, BS) \
            != PA.decode_tiles(1, 1, MB, BS)
    else:
        assert PA.decode_split(1, Hkv, MB) != PA.decode_split(1, 1, MB)
    rep = H // Hkv
    for h in range(Hkv):                     # rank h of M = Hkv ranks
        qs = q[:, :, h * rep:(h + 1) * rep].contiguous()
        ks, vs = k[:, :, h:h + 1].contiguous(), v[:, :, h:h + 1].contiguous()
        want = full[:, :, h * rep:(h + 1) * rep]
        got = ops.paged_decode_attention(qs, ks, vs, table, lens,
                                         kv_heads=Hkv)
        assert torch.equal(got, want), h
        local = ops.paged_decode_attention(qs, ks, vs, table, lens)
        assert not torch.equal(local, want), h
        np.testing.assert_allclose(local.float().numpy(),
                                   want.float().numpy(), atol=2e-2)
