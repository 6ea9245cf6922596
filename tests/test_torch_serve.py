"""The port's serving engine against the JAX engine on one request trace
(operand entropy, the JAX xi injected), seeded kernel-mode determinism,
the CLI's ``--stats-json`` schema, and the CLI's long-prompt trace,
whose block tables widen mid-run."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import (dense_pair, jax_head_noise,  # noqa: F401
                           meshless_reference)
from repro.launch import serve as JS
from repro.launch.engine import Request as JRequest
from repro.launch.engine import ServeEngine as JEngine
from repro.launch.engine import SlotScheduler as JScheduler
from repro_torch.core.entropy import KernelEntropy
from repro_torch.launch import serve as TS
from repro_torch.launch.engine import Request as TRequest
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.launch.engine import SlotScheduler as TScheduler

ROOT = Path(__file__).resolve().parent.parent
LENS = (13, 6, 9, 11, 5)


def _requests(cls, cfg, gen=6):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size - 1, size=n)
                .astype(np.int32), max_new_tokens=gen)
            for i, n in enumerate(LENS)]


def _record_admissions(monkeypatch, cls, log):
    """Log (rid, slot, table row) at every admission."""
    admit = cls.admit

    def recording(self):
        placed = admit(self)
        for slot, req in placed:
            row = self.block_tables[slot].tolist() \
                if self.allocator is not None else None
            log.append((req.rid, slot, row))
        return placed

    monkeypatch.setattr(cls, "admit", recording)


@pytest.mark.parametrize("kv_layout,prefill", [("dense", "batch"),
                                               ("paged", "chunked")])
def test_engine_matches_jax_engine(monkeypatch, kv_layout, prefill):
    jcfg, jparams, tcfg, tparams = dense_pair()
    kw = dict(num_slots=2, max_len=24, chunk=4, kv_layout=kv_layout,
              kv_block=4, prefill_mode=prefill, prefill_chunk=8,
              decode_attn="gather")
    jlog, tlog = [], []
    _record_admissions(monkeypatch, JScheduler, jlog)
    _record_admissions(monkeypatch, TScheduler, tlog)
    jr = JEngine(jparams, jcfg, **kw).run(_requests(JRequest, jcfg))
    tr = TEngine(tparams, tcfg, device="cpu", head_noise=jax_head_noise(),
                 **kw).run(_requests(TRequest, tcfg))
    assert tlog == jlog and len(tlog) == len(LENS)
    assert tr["sched_trace"] == jr["sched_trace"]
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens, a.rid
        assert a.finish_reason == b.finish_reason
        for name in ("H", "SE", "MI", "p_max"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=2e-5, err_msg=name)
    for k in ("gen_tokens", "prefill_chunks", "chunks_run", "kv",
              "decode_attn", "preemptions"):
        assert tr[k] == jr[k], k


def _kernel_run(seed, tparams, tcfg):
    import dataclasses
    cfg = dataclasses.replace(tcfg, head_entropy="kernel")
    eng = TEngine(tparams, cfg, num_slots=2, max_len=24, chunk=4,
                  kv_layout="paged", kv_block=4, decode_attn="kernel",
                  prefill_mode="chunked", prefill_chunk=8,
                  entropy=KernelEntropy(seed=seed), device="cpu")
    return eng.run(_requests(TRequest, cfg))


def test_kernel_mode_is_deterministic_per_seed():
    _, _, tcfg, tparams = dense_pair()
    a = _kernel_run(3, tparams, tcfg)
    b = _kernel_run(3, tparams, tcfg)
    c = _kernel_run(4, tparams, tcfg)
    for ra, rb in zip(a["requests"], b["requests"]):
        assert ra.tokens == rb.tokens and ra.MI == rb.MI
    assert [r.MI for r in a["requests"]] != [r.MI for r in c["requests"]]
    for r in a["requests"]:
        assert r.state == "finished" and np.isfinite(r.MI).all()
        assert min(r.MI) >= 0.0


def _keys(tree):
    if isinstance(tree, dict):
        return {str(k): _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return None


def test_cli_stats_json_keys_equal_the_jax_cli(tmp_path):
    flags = ["--slots", "2", "--num-requests", "3", "--prompt-len", "8",
             "--gen-len", "4", "--chunk", "4", "--kv-layout", "paged",
             "--decode-attn", "kernel", "--prefill", "chunked",
             "--prefill-chunk", "8"]
    out = tmp_path / "stats.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         *flags, "--stats-json", str(out)], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(out.read_text())
    jr = JS.serve(TS.build_parser().parse_args(flags))
    want = json.loads(json.dumps({k: v for k, v in jr.items()
                                  if k != "requests"}, default=float))
    assert _keys(got) == _keys(want)
    assert got["gen_tokens"] == want["gen_tokens"] == 12


def test_cli_serve_builds_the_jax_clis_prompts():
    args = TS.build_parser().parse_args(["--device", "cpu",
                                         "--shared-prefix", "3"])
    _, _, tcfg, _ = dense_pair()
    got = TS.make_requests(args, tcfg)
    want = JS.make_requests(args, tcfg)
    assert [r.prompt.tolist() for r in got] \
        == [r.prompt.tolist() for r in want]


LONG = ["--device", "cpu", "--kv-layout", "paged", "--long-prompt", "64"]


@pytest.mark.parametrize("extra", [["--entropy", "operand"],
                                   ["--entropy", "operand", "--prefill",
                                    "chunked", "--decode-attn", "gather"]])
def test_long_prompt_widens_the_tables_as_the_jax_engine(extra):
    """``--long-prompt 64``: request 0 needs more blocks than the
    build-time table holds, so the tables widen mid-run (the device table
    follows the scheduler's width).  The port's engine serves it with the
    JAX xi injected: tokens exact, H / SE / MI / p_max within 2e-5 and
    the same ``table_growths`` as the JAX CLI's engine."""
    args = TS.build_parser().parse_args(LONG + extra)
    _, _, _, tparams = dense_pair()
    built = TS.build_engine(args, params=tparams,
                            head_noise=jax_head_noise())
    tr = TS.serve(args, built)
    jr = JS.serve(args)
    assert tr["table_growths"] == jr["table_growths"] >= 1
    assert len(tr["requests"][0].prompt) == 64
    for a, b in zip(tr["requests"], jr["requests"]):
        assert a.tokens == b.tokens, a.rid
        assert a.finish_reason == b.finish_reason
        for name in ("H", "SE", "MI", "p_max"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=2e-5, err_msg=f"{name} {a.rid}")
    runner = built[0].runner
    w0 = runner.table_width0
    assert runner.table_width() == 2 * w0 and sorted(runner._tables) \
        == [w0, 2 * w0]
    _, cache, _, _ = runner.start()     # the next run starts at w0 again
    assert runner.table_width() == w0 and cache["block_table"].shape[1] \
        == w0 and bool((cache["block_table"] == -1).all())


def test_long_prompt_cli_completes():
    """The CLI command itself runs to its end on the CPU and prints the
    growth."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         *LONG], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "tables: 1 growths" in proc.stdout
