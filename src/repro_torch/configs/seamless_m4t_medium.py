"""seamless-m4t-medium [arXiv:2308.11596]: enc-dec, 12+12L, d1024, 16H MHA,
ff 4096, vocab 256206.  Audio frontend is a STUB: the encoder consumes
precomputed frame embeddings (assignment rule)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, encoder_layers=12, decoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206, mlp_activation="gelu",
    fsdp_params=False,
)
