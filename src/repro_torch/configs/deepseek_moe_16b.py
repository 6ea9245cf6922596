"""deepseek-moe-16b [arXiv:2401.06066]: 28L, d2048, 16H MHA, vocab 102400,
fine-grained MoE: 64 routed experts top-6 + 2 shared, expert ff 1408.
64 experts shard cleanly over the 16-way model axis (EP, 4 per group)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1408, vocab_size=102400,
    num_experts=64, top_k=6, num_shared_experts=2, moe_d_ff=1408,
    expert_sharding="ep",
)
