"""The port's kernels: CUDA kernels for Hopper (``csrc/``), each with a
plain PyTorch version beside it, and the public entry points of ``ops``
(CPU tensors take the plain versions, CUDA tensors the kernels).

The library surface is the JAX package's (``repro.kernels``):
``import repro_torch.kernels as K``; ``K.lrt_matmul(x, mu, sigma, xi)``,
``K.flash_attention(q, k, v, causal=True)`` and the rest accept any
shape the kernels take (ragged edges are masked, nothing is padded).

As in the JAX package, the exported functions ``bayes_matmul``,
``photonic_conv``, ``uncertainty_head`` and ``flash_attention`` shadow the
submodules of the same names as attributes of this package: import those
by their full name (``importlib.import_module("repro_torch.kernels.
uncertainty_head")`` or ``from repro_torch.kernels.uncertainty_head
import ...``).  ``ops`` is imported first, while the names still bind the
submodules.
"""

from repro_torch.kernels import ops, ref, rng  # noqa: F401
from repro_torch.kernels.ops import (  # noqa: F401
    bayes_conv2d_im2col, bayes_conv2d_im2col_sampled, bayes_matmul,
    bayes_matmul_sampled, entropy_bytes, flash_attention, lrt_matmul,
    lrt_matmul_sampled, photonic_conv, photonic_conv_sampled,
    uncertainty_head, uncertainty_head_sampled)
