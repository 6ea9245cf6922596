"""--arch registry of the port (a copy of the JAX package's registry),
plus ``get_bnn_config`` for the paper's own BNN.

``get_config(name)`` returns the full published config; ``reduced(cfg)``
scales any config down to a CPU-smoke-testable size while preserving the
family's structural features (GQA ratio, QKV bias, activation flavor,
Bayesian head).  ``PORTED_FAMILIES`` is what the port runs: every
family of ``ARCH_IDS``.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = [
    "grok_1_314b",
    "deepseek_moe_16b",
    "qwen2_1_5b",
    "codeqwen1_5_7b",
    "nemotron_4_15b",
    "qwen2_7b",
    "seamless_m4t_medium",
    "zamba2_7b",
    "phi_3_vision_4_2b",
    "mamba2_370m",
]

# families the port's models serve
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def normalize(name: str) -> str:
    return name.replace("-", "_").replace(".", "_").lower()


def get_bnn_config(preset: str = "bloodcell"):
    """The paper's own CNN (configs/paper_bnn.py): not an LM ArchConfig."""
    from repro_torch.configs import paper_bnn
    return {"bloodcell": paper_bnn.BLOODCELL,
            "mnist": paper_bnn.MNIST_LIKE}[preset]


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{normalize(name)}")
    return mod.CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small-but-structurally-identical config for CPU smoke tests."""
    kv_ratio = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1) \
        if cfg.num_heads else 1
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = max(heads // kv_ratio, 1) if heads else 0
    changes = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family in ("ssm", "hybrid")
                       else 2),
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32 if heads else cfg.head_dim,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        attn_q_chunk=64,
        attn_kv_chunk=64,
        remat=False,
        param_dtype="float32",
        mc_samples=4,
    )
    if cfg.is_moe:
        changes.update(num_experts=min(cfg.num_experts, 8),
                       top_k=min(cfg.top_k, 2),
                       num_shared_experts=min(cfg.num_shared_experts, 1),
                       moe_d_ff=64 if cfg.moe_d_ff else 0)
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.family == "hybrid":
        changes.update(attn_every=2)
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, decoder_layers=2)
    if cfg.num_prefix_embeds:
        changes.update(num_prefix_embeds=8)
    return dataclasses.replace(cfg, **changes)
