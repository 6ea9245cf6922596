"""The random stream of the reference's BNN training run, for the port.

``tests/test_paper_experiments.py::_train_bnn`` trains the blood-cell BNN
300 steps from ``jax.random.key(0)``: at each step it splits its key in
three, draws the batch's 64 indices from the second and runs the ELBO on
the third, whose probabilistic block (block 3) draws its eps from
``fold_in(split(k, 1)[0], 3)``.  ``reference_stream`` rebuilds those
indices and eps with the JAX package, so the port's ``train_bnn(...,
stream=...)`` replays the reference run's batches and noise.

The GPU machine has no JAX, so ``chip_smoke.py`` reads the same stream
from ``tools/data/bnn_reference_stream.npz``, written by running this
file:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_bnn_stream.py

and pinned against a fresh rebuild by ``tests/test_torch_bnn_train.py``.
With ``--sweep SEED ...`` it prints instead, for each training seed, the
OOD AUROC of MI (the reference test's bar, > 0.7) of the JAX package's
run, of the port on its own stream, and of the port on the JAX run's
stream, all on the CPU (about a minute a seed).
"""

from pathlib import Path

import numpy as np

STREAM_FILE = Path(__file__).resolve().parent.parent / "tools" / "data" / \
    "bnn_reference_stream.npz"
STEPS, BATCH, TRAIN = 300, 64, 3000


def reference_stream(seed=0, steps=STEPS, batch=BATCH, n=TRAIN,
                     shape=(99, 1, 3, 3)):
    """(indices (steps, batch) int32, eps (steps, *shape) float32)."""
    import jax
    key = jax.random.key(seed)
    idx, eps = [], []
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        idx.append(np.asarray(jax.random.randint(k1, (batch,), 0, n)))
        kd = jax.random.fold_in(jax.random.split(k2, 1)[0], 3)
        eps.append(np.asarray(jax.random.normal(kd, shape)))
    return np.stack(idx).astype(np.int32), np.stack(eps).astype(np.float32)


def sweep(seeds):
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import jax
    import jax.numpy as jnp
    import torch
    from test_paper_experiments import _train_bnn
    from repro.core.uncertainty import auroc, predictive_moments
    from repro.data import synthetic as D
    from repro.models import bnn_cnn as JB
    from repro_torch.core import uncertainty as U
    from repro_torch.launch.train import train_bnn
    from repro_torch.models import bnn_cnn as TB

    torch.set_num_threads(1)
    cfg = dict(num_classes=7, in_channels=3, width=16, mc_samples=10)
    xtr, ytr = D.blood_cells(np.random.default_rng(0), TRAIN)
    rng = np.random.default_rng(2)
    xid, _ = D.blood_cells(rng, 250)
    xood, _ = D.blood_cells_ood(rng, 250)

    def port_auroc(params):
        mi = [U.predictive_moments(TB.mc_predict(
            params, TB.BNNConfig(**cfg), torch.from_numpy(x),
            torch.Generator().manual_seed(6), mode="machine"))["MI"]
            for x in (xood, xid)]
        return float(U.auroc(*mi))

    for seed in seeds:
        jp = _train_bnn(JB.BNNConfig(**cfg), xtr, ytr, steps=STEPS,
                        seed=seed)
        key = jax.random.key(6)
        mi = [predictive_moments(JB.mc_predict(
            jp, JB.BNNConfig(**cfg), jnp.asarray(x), key, "machine"))["MI"]
            for x in (xood, xid)]
        own, _ = train_bnn(TB.BNNConfig(**cfg), xtr, ytr, steps=STEPS,
                           seed=seed, device="cpu")
        replay, _ = train_bnn(TB.BNNConfig(**cfg), xtr, ytr, steps=STEPS,
                              seed=seed, device="cpu",
                              stream=reference_stream(seed))
        print(f"seed {seed}: OOD AUROC of MI: JAX {float(auroc(*mi)):.4f}, "
              f"port on its own stream {port_auroc(own):.4f}, port on the "
              f"JAX run's stream {port_auroc(replay):.4f}", flush=True)


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--sweep"]:
        sweep([int(a) for a in sys.argv[2:]])
        sys.exit(0)
    indices, eps = reference_stream()
    STREAM_FILE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(STREAM_FILE, indices=indices, eps=eps)
    print(f"wrote {STREAM_FILE}: indices {indices.shape}, eps {eps.shape}")
