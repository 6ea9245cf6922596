"""qwen2-7b [arXiv:2407.10671]: 28L, d3584, 28H GQA(kv=4), ff 18944,
vocab 152064, QKV bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064, qkv_bias=True,
    rope_theta=1_000_000.0,
    seq_parallel=True,  # heads don't divide the 16-way model axis:
                        # chunk-sharded attention + seq-parallel stream
)
