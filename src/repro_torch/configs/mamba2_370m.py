"""mamba2-370m [arXiv:2405.21060]: 48L SSD blocks, d1024, attn-free,
d_inner 2048, 32 heads of 64, ssm_state 128, vocab 50280.
Sub-quadratic: runs the long_500k cell with O(1) decode state."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0, head_dim=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    subquadratic=True, fsdp_params=False,
)
