"""The port's training substrate: checkpoints, the data loader, and the
optimizer's plain properties.

Checkpoints round-trip (bf16 leaves as their bits, the int32 step, a
``GaussianVariational``), ignore a crashed half-write, keep the newest
``keep`` steps, refuse a shape that differs, and a checkpoint the JAX
package's ``save`` wrote at the reduced qwen2 config restores into the
port's training state.  ``ShardedLoader`` gives the JAX loader's
batches and resumes from its cursor exactly.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, dense_pair, meshless_reference,  # noqa: F401
                           to_numpy_tree)
from repro.checkpoint import checkpoint as JC
from repro.configs.registry import get_config as jget
from repro.configs.registry import reduced as jreduced
from repro.data import pipeline as JP
from repro.optim import adamw as JA
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs.registry import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core.bayesian import GaussianVariational
from repro_torch.data import pipeline as P
from repro_torch.models import registry as TM
from repro_torch.optim import adamw as TA


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 3), generator=g),
                       "e": torch.randn((5, 2), generator=g)
                       .to(torch.bfloat16),
                       "q": GaussianVariational(
                           mu=torch.randn((2, 2), generator=g),
                           rho=torch.randn((2, 2), generator=g))},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _zeros(tree):
    return T.map_tree(torch.zeros_like, tree)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = _tree()
        C.save(str(tmp_path), 7, tree, extra={"stream": {"step": 3}})
        restored, extra = C.restore(str(tmp_path), 7, _zeros(tree))
        for (pa, a), (pb, b) in zip(T.items(tree), T.items(restored)):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
        assert extra == {"stream": {"step": 3}}
        with open(tmp_path / "step_000000007" / "meta.msgpack", "rb") as f:
            meta = msgpack.unpackb(f.read())
        assert meta["leaves"]["params/e"] == [[5, 2], "bfloat16"]
        assert meta["leaves"]["params/q/rho"] == [[2, 2], "float32"]

    def test_atomicity_ignores_tmp(self, tmp_path):
        C.save(str(tmp_path), 5, _tree(1))
        os.makedirs(tmp_path / "step_000000009.tmp")     # a crashed write
        assert C.latest_step(str(tmp_path)) == 5
        C.save(str(tmp_path), 9, _tree(1))               # over the leftover
        assert C.list_steps(str(tmp_path)) == [5, 9]
        assert not (tmp_path / "step_000000009.tmp").exists()

    def test_manager_gc_latest_and_async_snapshot(self, tmp_path):
        mgr = C.CheckpointManager(str(tmp_path), keep=2)
        tree = _tree(2)
        w = tree["params"]["w"]
        seen = []
        for s in (1, 2, 3, 4):
            mgr.save_async(s, tree)
            seen.append(w.clone())
            w.add_(1.0)        # the next step writes in place at once
        mgr.wait()
        assert C.list_steps(str(tmp_path)) == [3, 4]
        template = _zeros(tree)
        step, restored, _ = mgr.restore_latest(template)
        assert step == 4 and restored is template
        assert torch.equal(restored["params"]["w"], seen[-1])
        empty = C.CheckpointManager(str(tmp_path / "none"))
        assert empty.restore_latest(template) == (None, None, None)

    def test_shape_mismatch_and_missing_leaf_raise(self, tmp_path):
        C.save(str(tmp_path), 1, {"w": torch.zeros(3)})
        with pytest.raises(ValueError, match="shape mismatch"):
            C.restore(str(tmp_path), 1, {"w": torch.zeros(4)})
        with pytest.raises(KeyError, match="v"):
            C.restore(str(tmp_path), 1, {"v": torch.zeros(3)})

    def test_jax_written_checkpoint_restores_into_the_port(self, tmp_path):
        """The JAX package's ``save`` of its reduced-qwen2 training state
        (parameters + AdamW moments + step, the head as ``q/0``, ``q/1``)
        restores into the port's training state bit for bit; the leaf
        names map in ``checkpoint.reference_name``."""
        jcfg = jreduced(jget("qwen2_1_5b"))
        tcfg = reduced(get_config("qwen2_1_5b"))
        _, jparams, _, _ = dense_pair()
        opt = JA.AdamWConfig()
        jopt = JA.init_state(jparams, opt)
        jopt = dict(jopt, step=jnp.asarray(11, jnp.int32),
                    mu=jax.tree.map(lambda a: a + 0.5, jopt["mu"]))
        JC.save(str(tmp_path), 11, {"params": jparams, "opt": jopt},
                extra={"step": 11, "stream": {"seed": 0, "host": 0,
                                              "num_hosts": 1, "step": 11}})
        params = TM.init_train_params(tcfg, torch.Generator(), CPU)
        state = {"params": params,
                 "opt": TA.init_state(params, TA.AdamWConfig())}
        step, state, extra = C.CheckpointManager(str(tmp_path)) \
            .restore_latest(state)
        assert step == 11 and extra["stream"]["step"] == 11
        assert int(state["opt"]["step"]) == 11
        want = to_numpy_tree(jparams)
        got = state["params"]
        np.testing.assert_array_equal(got["head"]["rho"].numpy(),
                                      want["head"]["q"]["rho"])
        np.testing.assert_array_equal(got["head"]["mu"].numpy(),
                                      want["head"]["q"]["mu"])
        np.testing.assert_array_equal(
            got["blocks"]["attn"]["wq"].numpy(),
            want["blocks"]["attn"]["wq"])
        np.testing.assert_array_equal(
            state["opt"]["mu"]["head"]["rho"].numpy(),
            np.full(want["head"]["q"]["rho"].shape, 0.5, np.float32))
        assert C.reference_name("opt/nu/head/rho") == "opt/nu/head/q/1"
        assert C.reference_name("params/blocks/ln1") == "params/blocks/ln1"


class TestLoader:
    def _cfg(self, arch):
        return reduced(get_config(arch)), jreduced(jget(arch))

    @pytest.mark.parametrize("arch", ["qwen2_1_5b", "phi_3_vision_4_2b"])
    def test_batches_equal_the_jax_loaders(self, arch):
        tcfg, jcfg = self._cfg(arch)
        t = P.ShardedLoader(tcfg, global_batch=4, seq=16, seed=3)
        j = JP.ShardedLoader(jcfg, global_batch=4, seq=16, seed=3)
        try:
            for _ in range(3):
                a, b = next(t), next(j)
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert t.state_dict() == j.state_dict()
        finally:
            t.close()
            j.close()

    def test_deterministic_and_resumable(self):
        cfg, _ = self._cfg("qwen2_1_5b")
        a = P.ShardedLoader(cfg, global_batch=4, seq=8, seed=1)
        first = [next(a) for _ in range(2)]
        cursor = a.state_dict()
        rest = [next(a) for _ in range(2)]
        a.close()
        b = P.ShardedLoader(cfg, global_batch=4, seq=8, seed=1,
                            prefetch=1)
        assert all(np.array_equal(x["tokens"], y["tokens"])
                   for x, y in zip(first, [next(b) for _ in range(2)]))
        b.load_state_dict(cursor)
        again = [next(b) for _ in range(2)]
        b.close()
        for x, y in zip(rest, again):
            np.testing.assert_array_equal(x["tokens"], y["tokens"])
            np.testing.assert_array_equal(x["labels"], y["labels"])
        np.testing.assert_array_equal(first[0]["labels"][:, :-1],
                                      first[0]["tokens"][:, 1:])

    def test_host_shards_and_to_device(self):
        cfg, _ = self._cfg("qwen2_1_5b")
        h0 = P.ShardedLoader(cfg, global_batch=4, seq=8, seed=1, host=0,
                             num_hosts=2)
        h1 = P.ShardedLoader(cfg, global_batch=4, seq=8, seed=1, host=1,
                             num_hosts=2)
        a, b = next(h0), next(h1)
        h0.close()
        h1.close()
        assert a["tokens"].shape == (2, 8)
        assert not np.array_equal(a["tokens"], b["tokens"])
        with pytest.raises(ValueError):
            P.ShardedLoader(cfg, global_batch=3, seq=8, num_hosts=2)
        d = P.to_device(a, CPU)
        assert d["tokens"].dtype == torch.int64
        assert torch.equal(d["tokens"], torch.from_numpy(a["tokens"]).long())


class TestOptimizer:
    def test_converges_on_quadratic(self):
        cfg = TA.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0,
                             schedule="constant")
        p = {"x": torch.tensor([3.0, -2.0])}
        st = TA.init_state(p, cfg)
        for _ in range(200):
            p, st, _ = TA.apply_updates(p, {"x": 2 * p["x"]}, st, cfg)
        assert float(p["x"].abs().max()) < 0.05

    def test_moment_dtype_and_in_place_updates(self):
        cfg = TA.AdamWConfig(moment_dtype="bfloat16", compress_topk=0.5)
        p = {"w": torch.ones((4, 4)), "q": GaussianVariational(
            mu=torch.zeros(3), rho=torch.zeros(3))}
        st = TA.init_state(p, cfg)
        assert st["mu"]["w"].dtype == torch.bfloat16
        assert st["error"]["w"].dtype == torch.float32
        ptr = p["w"].data_ptr()
        g = T.map_tree(torch.ones_like, p)
        p2, st, m = TA.apply_updates(p, g, st, cfg)
        assert p2 is p and p["w"].data_ptr() == ptr
        assert m["compressed"] == 1.0 and int(st["step"]) == 1
        assert not torch.equal(p["q"].mu, torch.zeros(3))   # GV leaves move

    def test_clip_by_global_norm(self):
        g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
        clipped, norm = TA.clip_by_global_norm(g, 1.0)
        assert abs(float(norm) - 10.0) < 1e-5
        assert abs(float(TA.global_norm(clipped)) - 1.0) < 1e-5

    def test_schedule_shapes(self):
        for sched in ("cosine", "linear", "constant"):
            cfg = TA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                 schedule=sched, min_lr_ratio=0.1)
            assert TA.schedule_lr(cfg, 0) == 0.0
            assert abs(TA.schedule_lr(cfg, 10) - 1.0) < 1e-6
            end = TA.schedule_lr(cfg, 100)
            assert abs(end - (1.0 if sched == "constant" else 0.1)) < 1e-6


def test_tree_helpers_walk_in_sorted_order():
    tree = {"b": torch.zeros(1), "a": {"y": torch.ones(1),
                                       "x": torch.full((1,), 2.0)}}
    assert [p for p, _ in T.items(tree)] == ["a/x", "a/y", "b"]
    rebuilt = T.unflatten(tree, [torch.full((1,), float(i))
                                 for i in range(3)])
    assert list(rebuilt) == ["b", "a"] and float(rebuilt["a"]["x"]) == 0.0
    with pytest.raises(ValueError):
        T.unflatten(tree, [torch.zeros(1)] * 4)
