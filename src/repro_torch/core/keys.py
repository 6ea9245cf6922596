"""Noise keys for training draws.

A key is a tuple: the root seed, then the path of ``fold_in`` and
``split`` operations that derived it, mirroring the JAX package's key
derivations (``fold_in(PRNGKey(seed), step)``, ``fold_in(key, i)`` per
micro-batch, ``split(key, n)[s]`` per Monte-Carlo sample).  A draw is a
pure function of its key: ``normal`` seeds a fresh ``torch.Generator``
from a digest of the key, so no generator state carries from one step to
the next and a resumed run draws exactly what the uninterrupted run drew.
The tuple form also lets a test rebuild the JAX key for the same path
and inject the reference's variates instead (the ``noise`` providers of
``models.transformer.nll_loss`` and ``models.bnn_cnn.nll_fn``).
"""

from __future__ import annotations

import hashlib

import torch

# a key: (seed, then ("fold", data) / ("split", num, index) steps)
Key = tuple


def root(seed: int) -> Key:
    return (int(seed),)


def fold_in(key: Key, data: int) -> Key:
    return key + (("fold", int(data)),)


def split(key: Key, num: int) -> list[Key]:
    return [key + (("split", int(num), i),) for i in range(num)]


def key_seed(key: Key) -> int:
    """A 63-bit generator seed digested from the key's path."""
    digest = hashlib.blake2b(repr(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def normal(key: Key, shape: tuple, device) -> torch.Tensor:
    """Standard normals of ``shape`` (float32) on ``device``, a pure
    function of ``key``; on the meta device (``launch.dryrun``) a tensor
    of the shape that holds nothing."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(key_seed(key))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)
