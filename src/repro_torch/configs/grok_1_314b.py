"""grok-1-314b [hf:xai-org/grok-1]: 64L, d6144, 48H GQA(kv=8), ff 32768,
vocab 131072, MoE 8 experts top-2, tanh logits soft-capping.

8 experts < the 16-way model axis, so expert_sharding='tp' (experts
replicated over the axis, per-expert ff tensor-parallel); optimizer
moments in bf16 to keep the 314B-param training state inside HBM
(DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=32768, vocab_size=131072,
    num_experts=8, top_k=2, moe_d_ff=32768, expert_sharding="tp",
    logits_softcap=30.0, mlp_activation="gelu",
    moment_dtype="bfloat16",
    seq_parallel=True,   # capacity: 64L saved residuals (§Perf it.7)
)
