"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through the JAX package
(the reference) and its counterpart in ``repro_torch``.  Both run on the
CPU here: JAX through its jnp oracles, the port through the plain
PyTorch versions of its kernels.  Tests of the CUDA kernels themselves
take the ``cuda_device`` fixture, which skips where no GPU is present.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

# the suite runs under several pytest-xdist workers on a shared CPU
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The GPU for kernel-vs-plain tests; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def meshless_reference():
    """Run the JAX reference without a mesh context.  The JAX package
    keeps its activation-sharding mesh in a thread-local that its launch
    code sets; a test of that code which fails before resetting it leaves
    the mesh on for every later test in the same worker process, and the
    reference layers then try to shard onto it.  Test modules that call
    the JAX package import this fixture (autouse fixtures act where they
    are imported)."""
    from repro.sharding.partition import set_mesh_context
    set_mesh_context(None)
    yield


def assert_close(got, want, *, atol, rtol=0.0, equal_nan=False, msg=""):
    """Compare a torch tensor (or array) against a numpy/JAX array in f64."""
    g = got.detach().cpu().double().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                               equal_nan=equal_nan, err_msg=msg)


def to_numpy_tree(tree):
    """A JAX parameter tree as nested dicts of numpy arrays; the head's
    ``GaussianVariational`` becomes ``{"mu", "rho"}``."""
    from repro.core.bayesian import GaussianVariational
    if isinstance(tree, GaussianVariational):
        return {"mu": np.asarray(tree.mu), "rho": np.asarray(tree.rho)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def operand_cfgs(arch="qwen2_1_5b"):
    """(JAX cfg, port cfg) of the reduced arch in operand-entropy mode."""
    from repro.configs.registry import get_config as jget, reduced as jred
    from repro_torch.configs.registry import get_config, reduced
    jcfg = dataclasses.replace(jred(jget(arch)), head_entropy="operand")
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               head_entropy="operand")
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def dense_pair(arch="qwen2_1_5b", seed=0):
    """(jcfg, jax params, tcfg, port params) of a reduced dense arch (2
    layers, d 128, 4 query heads of D 32, V 512, f32) from one JAX
    init."""
    import jax
    from repro.models import registry as JM
    from repro_torch.models import registry as TM
    jcfg, tcfg = operand_cfgs(arch)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    tparams = TM.params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def moe_pair(arch="deepseek_moe_16b", seed=0):
    """(jcfg, jax params, tcfg, port params) of a reduced moe arch (E 8,
    top-2, f32; deepseek with 1 shared expert and ``experts_ep``, grok
    with none and ``experts_tp``) from one JAX init."""
    import jax
    from repro.models import registry as JM
    from repro_torch.models import registry as TM
    jcfg, tcfg = operand_cfgs(arch)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    tparams = TM.params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def ssm_pair(arch="mamba2_370m", seed=0):
    """(jcfg, jax params, tcfg, port params) of the reduced ssm arch (4
    layers, d 128, d_inner 256, 8 heads of P 32, N 16, chunk 16, f32)
    from one JAX init."""
    import jax
    from repro.models import registry as JM
    from repro_torch.models import registry as TM
    jcfg, tcfg = operand_cfgs(arch)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    tparams = TM.params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    return jcfg, jparams, tcfg, tparams


def jax_head_noise(key_seed=17):
    """An operand-noise provider for the port that returns the JAX
    package's ``layers.decode_head_noise(PRNGKey(17), ...)`` — the xi the
    JAX engine draws in operand mode."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL

    key = jax.random.PRNGKey(key_seed)

    def provider(seed, cache_len, num_samples, vocab):
        xi = JL.decode_head_noise(key, jnp.asarray(
            cache_len.cpu().numpy().astype(np.int32)), num_samples, vocab)
        return torch.from_numpy(np.asarray(xi).copy())

    return provider


@functools.lru_cache(maxsize=None)
def hybrid_pair(arch="zamba2_7b", seed=0, num_layers=None):
    """(jcfg, jax params, tcfg, port params) of the reduced hybrid arch (4
    layers, the shared block every 2, d 128, 4 MHA heads of D 32, d_inner
    256, 8 SSM heads of P 32, N 16, chunk 16, V 512, f32) from one JAX
    init; ``num_layers`` (e.g. 5: a last group of one layer) replaces the
    depth in both configs."""
    import jax
    from repro.models import registry as JM
    from repro_torch.models import registry as TM
    jcfg, tcfg = operand_cfgs(arch)
    if num_layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
        tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    tparams = TM.params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def encdec_pair(arch="seamless_m4t_medium", seed=0):
    """(jcfg, jax params, tcfg, port params) of the reduced encdec arch (2
    encoder + 2 decoder layers, d 128, 4 MHA heads of D 32, ff 256, gelu,
    V 512, f32) from one JAX init."""
    import jax
    from repro.models import registry as JM
    from repro_torch.models import registry as TM
    jcfg, tcfg = operand_cfgs(arch)
    jparams = JM.init_params(jax.random.key(seed), jcfg)
    tparams = TM.params_from_numpy(to_numpy_tree(jparams), tcfg, CPU)
    return jcfg, jparams, tcfg, tparams


def vlm_pair(seed=0):
    """(jcfg, jax params, tcfg, port params) of the reduced vlm arch
    (phi-3-vision: 2 layers, d 128, 4 MHA heads of D 32, ff 256, silu,
    8 prefix embeds, V 512, f32) from one JAX init."""
    return dense_pair("phi_3_vision_4_2b", seed)
