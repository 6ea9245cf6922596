"""nemotron-4-15b [arXiv:2402.16819]: 32L, d6144, 48H GQA(kv=8), ff 24576,
vocab 256000, squared-ReLU MLP (non-gated)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=256000,
    mlp_activation="relu2",
)
