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


def jax_key(key):
    """The JAX key of a port ``core.keys`` key: ``PRNGKey(seed)`` with the
    key's fold_in / split path applied, as the JAX package derives its
    training keys."""
    import jax
    k = jax.random.PRNGKey(key[0])
    for op in key[1:]:
        if op[0] == "fold":
            k = jax.random.fold_in(k, op[1])
        else:
            k = jax.random.split(k, op[1])[op[2]]
    return k


def jax_train_noise(key, shape, device):
    """A training-noise provider for the port (``nll_loss(noise=)``,
    ``bnn_cnn.nll_fn(noise=)``) returning the JAX package's
    ``jax.random.normal`` at the same key path."""
    import jax
    import jax.numpy as jnp
    eps = jax.random.normal(jax_key(key), tuple(shape), jnp.float32)
    return torch.from_numpy(np.asarray(eps).copy()).to(device)


def train_pair(pair, *args):
    """(jcfg, jax params, tcfg, port TRAINING params) from one JAX init:
    ``pair(*args)`` (``moe_pair``, ``ssm_pair``, ...) with the port's
    head in its training form ``{"mu", "rho"}``."""
    from repro_torch.models import registry as TM
    jcfg, jparams, tcfg, _ = pair(*args)
    return jcfg, jparams, tcfg, TM.train_params_from_numpy(
        to_numpy_tree(jparams), tcfg, CPU)


def train_batch(cfg, B=2, S_len=16, seed=0, step=0, enc_frames=24):
    """(jax batch, port batch): the synthetic token stream's batch at
    ``step`` (inputs and shifted labels), plus ``enc_frames`` random
    frames a row (numpy, seeded; zero frames would make the encoder's
    output 0) for encdec."""
    import jax.numpy as jnp
    from repro_torch.data.synthetic import TokenStreamState, token_batch
    toks, _ = token_batch(TokenStreamState(seed=seed, host=0, num_hosts=1,
                                           step=step), B, S_len + 1,
                          cfg.vocab_size)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        nb["frames"] = np.random.default_rng(seed + 1).standard_normal(
            (B, enc_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v.copy()) for k, v in nb.items()})


def jax_leaf(tree, path):
    """The leaf of a numpy JAX tree at a port path (``head/mu`` is the
    JAX head's ``q/mu``)."""
    node = tree
    for part in path.split("/"):
        node = node["q"][part] if part in ("mu", "rho") and "q" in node \
            else node[part]
    return node


def assert_every_gradient(tparams, grads, jgrads, atol=2e-6, rtol=1e-4):
    """Every leaf's port gradient (``grads``, in ``core.tree`` order)
    against the JAX gradient tree ``jgrads``; returns the leaf paths."""
    import jax
    from repro_torch.core import tree as T
    jgn = to_numpy_tree(jgrads)
    paths = [path for path, _ in T.items(tparams)]
    assert "head/rho" in paths and len(paths) == len(jax.tree.leaves(jgrads))
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), jax_leaf(jgn, path), atol=atol,
                                   rtol=rtol, err_msg=path)
    return paths
