"""The PyTorch port stands alone: no JAX, no ``repro`` imports, and its
entry points never fall back to the CPU quietly."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_parity  # noqa: F401  (pins torch to one thread)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)",
                       re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) > 20
    # the tensor-parallel serving modules and the dry run's are among
    # those checked
    assert {"repro_torch.launch.mesh", "repro_torch.sharding.partition",
            "repro_torch.launch.engine.mesh_check",
            "repro_torch.launch.dryrun", "repro_torch.launch.op_cost",
            "repro_torch.launch.profile_cell"} <= set(mods)


def test_spawned_ranks_load_no_jax_and_no_repro():
    """A mesh's rank processes start from a fresh import (spawn): after
    serving a request trace they hold no module of JAX or of the JAX
    package, and neither does the process that spawned them."""
    code = (
        "import sys\n"
        "import _mesh_ranks as R\n"
        "from repro_torch.launch import mesh\n"
        "with mesh.Ranks(2, 'cpu', timeout_s=120) as ranks:\n"
        "    served = ranks.run(R.served_heads, 'dense')\n"
        "    bad = ranks.run(R.loaded)\n"
        "assert all(s['gen_tokens'] > 0 for s in served), served\n"
        "assert bad == [[], []], bad\n"
        "assert not R.loaded(None), R.loaded(None)\n")
    env = _env()
    env["PYTHONPATH"] += os.pathsep + str(ROOT / "tests")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       *(ROOT / "tools").glob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_source_names_no_jax_or_repro_import(path):
    src = (ROOT / path).read_text()
    assert not IMPORT_RE.findall(src), path


def _needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be seen")


def test_engine_refuses_cuda_without_a_gpu():
    _needs_no_gpu()
    from repro_torch import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cli_defaults_to_cuda_and_raises_without_a_gpu():
    _needs_no_gpu()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--slots", "1",
         "--num-requests", "1", "--prompt-len", "4", "--gen-len", "2"],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_train_cli_defaults_to_cuda_and_raises_without_a_gpu():
    _needs_no_gpu()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "1",
         "--batch", "1", "--seq", "4"],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result(tmp_path):
    _needs_no_gpu()
    runs = [(ROOT, ROOT / "chip_smoke.py")]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    runs.append((tmp_path, alone))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={k: v for k, v in os.environ.items()
                                  if k != "PYTHONPATH"})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# the flags each ported feature needs beside its own: the prefix cache
# shares blocks of the paged pool, speculative decoding needs the operand
# (depth-keyed) head noise, the priority burst a class-0 request arriving
# while class-2 ones decode, the escalation lane its verify S, the mesh
# the paged kernels' path (each rank reads its own heads)
PORTED = {"--prefix-cache": ["--kv-layout", "paged", "--shared-prefix", "12"],
          "--spec-decode": ["--entropy", "operand"],
          "--policy": ["--kv-layout", "paged", "--chunk", "2",
                       "--priorities", "2,2,2,0", "--arrivals", "0,0,0,2"],
          "--escalate-mi": ["--kv-layout", "paged", "--escalate-s", "8"],
          "--mesh": ["--kv-layout", "paged", "--decode-attn", "kernel",
                     "--prefill", "chunked"]}


@pytest.mark.parametrize("flags", [
    ["--prefix-cache", "on"], ["--spec-decode", "on"],
    ["--policy", "priority"], ["--escalate-mi", "0.5"], ["--mesh", "1x4"]])
def test_cli_refuses_unported_features(flags):
    """Every feature these flags name has been ported since the flag was
    refused: the prefix cache, speculative decoding, the priority policy,
    the escalation lane and the tensor-parallel mesh (``--mesh 1x4``: four
    spawned gloo ranks on the CPU) build and serve at the reduced size
    through the same entry points."""
    from repro_torch.launch.serve import build_parser, serve
    args = build_parser().parse_args(
        ["--device", "cpu", "--slots", "2", "--num-requests", "4",
         "--prompt-len", "16", "--gen-len", "4", "--chunk", "4",
         *PORTED[flags[0]], *flags])
    r = serve(args)
    assert r["gen_tokens"] == 16
    assert r["mesh"] == ("4 ranks, gloo, cpu" if flags[0] == "--mesh"
                         else "none")
    if flags[0] == "--prefix-cache":
        # the second wave hits the 12 shared tokens
        pc = r["prefix_cache"]
        assert pc["enabled"] and pc["hits"] == 2
        assert pc["prompt_tokens_saved"] >= 24
    elif flags[0] == "--spec-decode":
        assert r["spec_decode"]["enabled"]
    elif flags[0] == "--policy":
        # the class-0 arrival at step 2 preempts decoding class-2 slots
        # (a slot, then the pool's watermark)
        assert r["policy"] == "priority" and r["preemptions"] >= 1
        assert r["per_class"][2]["preemptions"] == r["preemptions"]
        assert r["per_class"][0]["preemptions"] == 0
    elif flags[0] == "--escalate-mi":
        esc = r["escalation"]
        assert esc["enabled"] and esc["mi_threshold"] == 0.5
        assert esc["verify_samples"] == 8
    else:
        # rank 0's requests: every one served in full
        assert [len(q.tokens) for q in r["requests"]] == [4] * 4
