"""qwen2-1.5b [arXiv:2407.10671]: 28L, d1536, 12H GQA(kv=2), ff 8960,
vocab 151936, QKV bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    head_dim=128, d_ff=8960, vocab_size=151936, qkv_bias=True,
    rope_theta=1_000_000.0, fsdp_params=False,
    seq_parallel=True,  # heads don't divide the 16-way model axis:
                        # chunk-sharded attention + seq-parallel stream
)
