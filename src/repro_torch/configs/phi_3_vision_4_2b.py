"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
backbone — 32L, d3072, 32H MHA, ff 8192, vocab 32064 — with a CLIP patch
frontend STUB: input_specs provides 576 precomputed patch embeddings
prepended to the token sequence (assignment rule)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    head_dim=96, d_ff=8192, vocab_size=32064,
    num_prefix_embeds=576, rope_theta=500_000.0,
)
