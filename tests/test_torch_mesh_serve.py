"""Serving through a tensor-parallel mesh on the CPU: two spawned gloo
ranks (one group for the module) against the unsharded port engine and
the JAX engine.

``mesh_check``'s four families (dense with the prefix cache and 2 kv
heads, so that its pool shards; moe, hybrid and encdec with 4) served
sharded and unsharded on the paged kernels' plain versions: tokens,
H / SE / MI / p_max and the flag counts bit for bit, in operand entropy,
on the gather read, and in kernel entropy.  Each rank's paged decode and
prefill calls read its own kv head with the split of the unsharded head
count, and no gather read runs in their place.  Dense at 1x2 in operand
entropy against the JAX package's unsharded ``ServeEngine`` with the JAX
xi injected.  The CLI ``serve --device cpu --mesh 1x2``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _mesh_ranks as R
from _torch_parity import meshless_reference, to_numpy_tree  # noqa: F401
from repro.configs.registry import get_config as jget, reduced as jred
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.models import layers as JL
from repro.models import registry as JM
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve as TS
from repro_torch.launch.engine import mesh_check as MC

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks():
    with meshlib.Ranks(2, "cpu", timeout_s=120) as r:
        yield r


@pytest.mark.parametrize("family", sorted(MC.FAMILIES))
def test_mesh_check_family_is_bitwise_the_unsharded_engine(ranks, family):
    out = MC.check(ranks, [family], device="cpu")
    row = out["families"][family]
    assert out["ok"] and row["errors"] == [], row["errors"]
    assert row["gen_tokens"] == sum(MC.GENS)
    assert row["mesh"] == "2 ranks, gloo, cpu"
    if family == "dense":
        assert row["prefix_cache_hits"] >= 1


@pytest.mark.parametrize("entropy,read", [("operand", "gather"),
                                          ("kernel", "kernel")])
def test_mesh_check_dense_on_the_gather_read_and_in_kernel_entropy(
        ranks, entropy, read):
    out = MC.check(ranks, ["dense"], entropy=entropy, decode_attn=read,
                   device="cpu")
    assert out["ok"], out["families"]


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_each_rank_reads_its_own_kv_heads_with_the_unsharded_split(
        ranks, family):
    """dense: 2 kv heads, hybrid: 4, over 2 ranks: every decode call gets
    the rank's share of the pool and the model's head count, every
    prefill call the rank's share, and no call falls back to the gather
    read."""
    hkv = MC.family_config(family).num_kv_heads
    for got in ranks.run(R.served_heads, family):
        assert got["decode"] == [(hkv // 2, hkv)]
        assert got["prefill"] == [hkv // 2]
        assert got["gather_reads"] == 0
        assert got["gen_tokens"] == sum(MC.GENS)


def test_dense_mesh_matches_the_jax_engine(ranks):
    """The JAX engine unsharded (gather read, its own xi) against the
    port's at 1x2 on the same weights and the same xi: the same tokens,
    H / SE / MI / p_max within 2e-5 (as the unsharded port engine is held
    to it, tests/test_torch_serve.py)."""
    jcfg = dataclasses.replace(jred(jget("qwen2_1_5b")),
                               head_entropy="operand", num_kv_heads=2)
    jparams = JM.init_params(jax.random.key(0), jcfg)
    key = jax.random.PRNGKey(17)
    depths = 128                  # past max_len: idle slots keep advancing
    xi = np.stack([np.asarray(JL.decode_head_noise(
        key, jnp.full((2,), d, jnp.int32), jcfg.mc_samples,
        jcfg.vocab_size)) for d in range(depths)])             # (D, S, 2, V)
    table = xi.transpose(2, 0, 1, 3).copy()                    # (2, D, S, V)
    jr = JEngine(jparams, jcfg, **MC.ENGINE, decode_attn="gather",
                 prefix_cache=True).run(
        [JRequest(rid=r.rid, prompt=r.prompt,
                  max_new_tokens=r.max_new_tokens)
         for r in MC.make_traffic(jcfg, "dense")])
    tr = ranks.run(MC.run_family, "dense", decode_attn="gather",
                   params=to_numpy_tree(jparams),
                   head_noise=R.TableNoise(table))[0]
    assert tr["mesh"] == "2 ranks, gloo, cpu"
    assert tr["prefix_cache"]["hits"] == jr["prefix_cache"]["hits"] >= 1
    assert len(tr["requests"]) == len(jr["requests"]) == len(MC.PROMPTS)
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens, a.rid
        for name in ("H", "SE", "MI", "p_max"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=2e-5, err_msg=f"{name} {a.rid}")


def test_mesh_check_cli(capsys):
    """The checker's command line: it asks for the card unless told
    otherwise, raising here before any rank starts; ``--device cpu``
    spawns its own two ranks and exits 0 with the family equal."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MC.main(["--families", "dense", "--mesh", "1x2"])
    threads = torch.get_num_threads()    # main pins one, as in the ranks
    try:
        assert MC.main(["--device", "cpu", "--families", "dense",
                        "--mesh", "1x2", "--json"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["device"] == "cpu"
    assert out["families"]["dense"]["mesh"] == "2 ranks, gloo, cpu"


def test_cli_serves_at_mesh_1x2(tmp_path):
    """The CLI command spawns its two ranks and prints rank 0's result:
    the unsharded serve's MI rows (reduced qwen2: 1 kv head, which no
    mesh shards: q, k and v are gathered and every rank attends over all
    heads)."""
    out = tmp_path / "stats.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    flags = ["--device", "cpu", "--slots", "2", "--num-requests", "3",
             "--prompt-len", "8", "--gen-len", "4", "--chunk", "4",
             "--kv-layout", "paged", "--decode-attn", "kernel", "--prefill",
             "chunked", "--prefill-chunk", "8", "--entropy", "operand"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *flags,
         "--mesh", "1x2", "--stats-json", str(out)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(out.read_text())
    assert got["mesh"] == "2 ranks, gloo, cpu"
    assert "mesh: 2 ranks, gloo, cpu" in proc.stdout
    ref = TS.serve(TS.build_parser().parse_args(flags))
    assert ref["mesh"] == "none"
    assert got["gen_tokens"] == ref["gen_tokens"] == 12
    rows = proc.stdout.split("MI per request:\n")[1].split("  #")[1:]
    assert len(rows) == len(ref["requests"]) == 3
    for row, r in zip(rows, ref["requests"]):
        mi = np.asarray(r.MI)
        assert row.startswith(f"{r.rid} ({r.finish_reason}): "
                              + np.array2string(mi, precision=4)), row
