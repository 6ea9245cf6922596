"""The decode chunk that the runner captures as a CUDA graph, on the CPU.

The port's ``decode_loop_reference`` against the JAX one (operand mode,
the JAX xi injected); the engine's scan against the port's per-token
loop for requests admitted at engine start, bit for bit; one chunk on
the runner's carry keeps every buffer's address and gives the outputs of
the former form that rebound ``len``, the flags and the outputs each
step; and the head's step as an int or a one-element tensor.  The CUDA
graph itself is tested in ``tests/test_torch_kernels_cuda.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_graph_decode.py
"""

import copy
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, dense_pair,  # noqa: F401
                           jax_head_noise, meshless_reference)
from repro.launch.engine.runner import \
    decode_loop_reference as jax_decode_loop_reference
from repro_torch.core.entropy import KernelEntropy
from repro_torch.kernels import ops
from repro_torch.launch import steps as S
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.launch.engine.runner import ModelRunner, \
    decode_loop_reference
from repro_torch.models import registry as TM

UH = importlib.import_module("repro_torch.kernels.uncertainty_head")

KEYS = ("H", "SE", "MI", "p_max")


def _prompts(cfg, B, P, seed=5):
    r = np.random.default_rng(seed)
    return r.integers(1, cfg.vocab_size - 1, size=(B, P)).astype(np.int32)


def test_decode_loop_reference_matches_jax_in_operand_mode():
    jcfg, jparams, tcfg, tparams = dense_pair()
    prompts = _prompts(tcfg, 3, 7)
    want = jax_decode_loop_reference(jparams, jcfg, prompts, 6)
    got = decode_loop_reference(
        tparams, tcfg, prompts, 6,
        decode_fn=S.build_decode_step(tcfg, head_noise=jax_head_noise()))
    np.testing.assert_array_equal(got["token"], np.asarray(want["token"]))
    for k in KEYS:
        assert got[k].shape == (6, 3)
        assert_close(got[k], want[k], atol=2e-5, msg=k)
    assert got["decode_tok_per_s"] > 0 and got["decode_s"] > 0


@pytest.mark.parametrize("kv_layout,entropy", [("dense", "operand"),
                                               ("dense", "kernel"),
                                               ("paged", "operand")])
def test_engine_scan_equals_the_per_token_loop(kv_layout, entropy):
    """Requests admitted at engine start: the engine's chunks (4 steps,
    one batch-1 prefill a slot) replay the per-token loop (one batched
    prefill, one step a token) bit for bit: tokens, H and MI."""
    _, _, tcfg, tparams = dense_pair()
    cfg = dataclasses.replace(tcfg, head_entropy=entropy)
    ent = KernelEntropy(seed=3) if entropy == "kernel" else None
    gen, prompts = 8, _prompts(cfg, 3, 8)
    ref = decode_loop_reference(tparams, cfg, prompts, gen, entropy=ent)
    eng = ServeEngine(tparams, cfg, num_slots=3, max_len=8 + gen, chunk=4,
                      entropy=ent, kv_layout=kv_layout, kv_block=4,
                      device="cpu")
    res = eng.run([Request(rid=i, prompt=prompts[i], max_new_tokens=gen)
                   for i in range(3)])
    for j, req in enumerate(res["requests"]):
        np.testing.assert_array_equal(req.tokens, ref["token"][:, j])
        np.testing.assert_array_equal(np.asarray(req.MI, np.float32),
                                      ref["MI"][:, j])
        np.testing.assert_array_equal(np.asarray(req.H, np.float32),
                                      ref["H"][:, j])


def _rebinding_chunk(params, cfg, token, cache, step0, active, flags, chunk,
                     seed, mi_threshold=0.05, se_threshold=1.0):
    """The chunk as it was before it wrote in place: each step bound a new
    ``len`` (lens + 1), new counters and a new token, and the outputs were
    stacked at the end into (outputs, chunk, B)."""
    rows = []
    epi, alea = flags["epistemic"], flags["aleatoric"]
    for t in range(chunk):
        cache["len"] = cache["len"].clone()     # lens + 1 as a new tensor
        out, cache = TM.decode_step(params, cfg, token, cache,
                                    (seed, step0 + t))
        is_epi = out["MI"] > mi_threshold
        is_alea = (out["SE"] > se_threshold) & ~is_epi
        rows.append(torch.stack([
            out["next_token"].float(), out["H"], out["SE"], out["MI"],
            out["p_max"], is_epi.float(), is_alea.float()]))
        token = out["next_token"]
        epi = epi + (is_epi & active).to(epi.dtype)
        alea = alea + (is_alea & active).to(alea.dtype)
    ys = torch.stack(rows, dim=1)
    return token, cache, {"epistemic": epi, "aleatoric": alea}, ys


@pytest.mark.parametrize("entropy,decode_attn", [("kernel", "kernel"),
                                                 ("operand", "gather")])
def test_one_chunk_keeps_every_buffer_and_the_rebinding_outputs(
        entropy, decode_attn):
    _, _, tcfg, tparams = dense_pair()
    cfg = dataclasses.replace(tcfg, head_entropy=entropy,
                              decode_attn=decode_attn)
    chunk, seed = 4, 9
    runner = ModelRunner(tparams, cfg, num_slots=3, max_len=20, chunk=chunk,
                         entropy=KernelEntropy(seed=seed), mi_threshold=0.05,
                         se_threshold=1.0, kv_layout="paged", kv_block=4,
                         kv_blocks=15, device=CPU)
    with torch.inference_mode():
        tok, cache, active, flags = runner.start()
        prompts = _prompts(cfg, 3, 7)
        rows = np.full((3, 5), -1, np.int32)
        rows[0, :3], rows[1, :3] = (4, 0, 9), (2, 7, 1)  # slot 2 stays idle
        runner.write_table(cache, rows)
        for slot in (0, 1):
            runner.prefill(cache, slot, prompts[slot], rows[slot])
            tok[slot] = int(prompts[slot, -1])
            active[slot] = True
        flags["epistemic"][1] = 2
        old = copy.deepcopy((tok, cache, active, flags))
        held = [tok, runner.ys, *cache.values(), *flags.values()]
        ptrs = [t.data_ptr() for t in held]
        tensors = dict(cache)
        out = runner.scan(tok, cache, 11, active, flags)
        want = _rebinding_chunk(tparams, cfg, *old[:2], 11, *old[2:], chunk,
                                seed)
    assert out[0] is tok and out[1] is cache and out[2] is flags \
        and out[3] is runner.ys
    assert all(cache[k] is t for k, t in tensors.items())
    assert [t.data_ptr() for t in held] == ptrs
    torch.testing.assert_close(out[0], want[0], rtol=0, atol=0)
    for k in ("k", "v", "len", "block_table"):     # the idle slot's NaN
        torch.testing.assert_close(cache[k], want[1][k], rtol=0, atol=0,
                                   equal_nan=True)  # K/V lands in the sink
    for k in flags:
        torch.testing.assert_close(flags[k], want[2][k], rtol=0, atol=0)
    torch.testing.assert_close(out[3], want[3].transpose(0, 1), rtol=0,
                               atol=0, equal_nan=True)
    assert (cache["len"][:2] == 7 + chunk).all() and cache["len"][2] == chunk


def test_plain_head_takes_the_step_as_int_or_tensor():
    r = np.random.default_rng(4)
    x, mu = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
             for s in ((3, 16), (16, 300)))
    sigma = torch.from_numpy((0.2 + 0.3 * r.random((16, 300)))
                             .astype(np.float32))
    want = UH.uncertainty_head_plain(x, mu, sigma, num_samples=4, seed=5,
                                     step=7)
    other = UH.uncertainty_head_plain(x, mu, sigma, num_samples=4, seed=5,
                                      step=8)
    assert not torch.equal(want["H"], other["H"])
    for step, off in ((torch.tensor([7], dtype=torch.int32), 0),
                      (torch.tensor([4], dtype=torch.int32), 3), (5, 2)):
        for got in (UH.uncertainty_head_plain(x, mu, sigma, num_samples=4,
                                              seed=5, step=step,
                                              step_offset=off),
                    ops.uncertainty_head_sampled(x, mu, sigma, 5, step,
                                                 num_samples=4,
                                                 step_offset=off)):
            for k in (*KEYS, "pred"):
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
