"""zamba2-7b [arXiv:2411.15242]: 81 Mamba2 blocks (d3584, ssm_state=64) +
one SHARED attention block (32H, ff 14336) applied every 6 layers.
Sub-quadratic: runs the long_500k cell."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    head_dim=112, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, attn_every=6,
    subquadratic=True,
)
