"""The paper's own architecture (Fig. 3): the hybrid Bayesian CNN.

Counterpart of ``repro.configs.paper_bnn``.  Not an LM ``ArchConfig``:
a ``BNNConfig`` for ``models/bnn_cnn.py``, selected through
``configs.registry.get_bnn_config``.  Two presets match the paper's
experiments:

  * ``BLOODCELL``  — 7 classes, RGB 28x28 (Fig. 4, BloodMNIST-like)
  * ``MNIST_LIKE`` — 10 classes, grayscale 28x28 (Fig. 5, DDU benchmark)
"""

from repro_torch.models.bnn_cnn import BNNConfig

BLOODCELL = BNNConfig(
    num_classes=7, in_channels=3, width=16, image_size=28,
    mc_samples=10,              # paper: N = 10 MC samples per prediction
    prob_block=3,               # the probabilistic DWS block (Fig. 3)
    init_sigma=0.08,
)

MNIST_LIKE = BNNConfig(
    num_classes=10, in_channels=1, width=16, image_size=28,
    mc_samples=10, prob_block=3, init_sigma=0.08,
)

CONFIG = BLOODCELL
