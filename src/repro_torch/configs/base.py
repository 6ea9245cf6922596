"""Architecture config schema + shape-cell definitions (a copy of the JAX
package's ``configs/base.py``; the port imports nothing of that package).

One ``ArchConfig`` per assigned architecture (``repro_torch/configs/<id>.py``),
selectable with ``--arch <id>`` through ``repro_torch.configs.registry``.

The four assigned input-shape cells (LM family):
    train_4k     seq 4096,   global batch 256   (train_step)
    prefill_32k  seq 32768,  global batch 32    (serve: prefill)
    decode_32k   seq 32768,  global batch 128   (serve: 1 new token w/ KV)
    long_500k    seq 524288, global batch 1     (serve: long-context decode)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert ff (deepseek fine-grained)
    capacity_factor: float = 1.25
    expert_sharding: str = "ep"      # "ep" (experts on model axis) | "tp"

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: shared attn block period

    # --- enc-dec ---
    encoder_layers: int = 0          # 0 -> decoder-only
    decoder_layers: int = 0

    # --- modality frontend stubs (vlm / audio) ---
    num_prefix_embeds: int = 0       # patch/frame embeddings prepended

    # --- flavor ---
    mlp_activation: str = "silu"     # silu | gelu | relu2 (nemotron)
    qkv_bias: bool = False           # qwen-style
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logits_softcap: float = 0.0      # grok-style tanh soft-capping

    # --- paper technique ---
    bayesian_head: bool = True       # Gaussian variational output head
    mc_samples: int = 10             # paper: N=10 MC draws per prediction
    head_init_sigma: float = 0.01
    head_entropy: str = "kernel"     # "kernel": seeded fused head (drawn
                                     # in-kernel on TPU); "operand":
                                     # key-threaded explicit xi tensor
    decode_attn: str = "gather"      # paged decode attention: "kernel"
                                     # reads mapped blocks straight from
                                     # the pool (block-sparse Pallas
                                     # kernel); "gather" materializes the
                                     # full logical span (the bit-exact
                                     # reference path)

    # --- numerics / memory ---
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"    # adam moments (grok: bfloat16)
    remat: bool = True
    remat_group: int = 0             # >0: two-level scan; checkpoint every
                                     # `remat_group` layers (saved-activation
                                     # stack shrinks L -> L/group; §Perf)
    seq_parallel: bool = False       # Korthikanti sequence-parallel residual
                                     # stream: 16x less activation memory,
                                     # +AG/RS transitions (§Perf it.7 —
                                     # wins for capacity-bound and
                                     # chunk-sharded-attention archs)
    scan_layers: bool = True
    attn_q_chunk: int = 512          # flash-style query block
    attn_kv_chunk: int = 1024        # flash-style kv block
    fsdp_params: bool = True         # shard weights over data axis too

    # --- long context applicability ---
    subquadratic: bool = False       # True only for ssm / hybrid

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        dense_mlp = 3 * d * ff if self.mlp_activation in ("silu", "gelu") \
            else 2 * d * ff
        if self.is_moe:
            eff = self.moe_d_ff or ff
            moe = self.num_experts * 3 * d * eff \
                + self.num_shared_experts * 3 * d * eff + d * self.num_experts
            block = attn + moe
        elif self.family in ("ssm",):
            din = self.ssm_expand * d
            h = din // self.ssm_head_dim
            block = d * (2 * din + 2 * self.ssm_state + h) \
                + din * d + din * self.ssm_conv_width
        elif self.family == "hybrid":
            din = self.ssm_expand * d
            h = din // self.ssm_head_dim
            # mamba-only blocks; the shared attn+mlp block is counted once
            block = d * (2 * din + 2 * self.ssm_state + h) + din * d \
                + din * self.ssm_conv_width
        else:
            block = attn + dense_mlp
        n_blocks = self.num_layers if not self.encoder_layers else \
            self.encoder_layers + self.decoder_layers
        total = emb + n_blocks * block
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * d * ff  # one shared attention+mlp block
        if self.encoder_layers:  # cross attention in decoder
            total += self.decoder_layers * attn
        return total

    @property
    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count
        eff = self.moe_d_ff or self.d_ff
        inactive = (self.num_experts - self.top_k) * 3 * self.d_model * eff
        return self.param_count - self.num_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Assignment rule: long_500k only for sub-quadratic archs."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch; 500k dense KV "
                       "cache exceeds per-pod memory (see DESIGN.md)")
    return True, ""
