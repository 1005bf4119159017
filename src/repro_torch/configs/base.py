"""Architecture + shape configuration dataclasses.

One ``ArchConfig`` per assigned architecture lives in
``repro_torch/configs/<id>.py`` (exact public-literature dims); smoke tests build
``reduced()`` variants of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    dense_d_ff: int = 0
    # "gather": tokens routed into expert slots via gather/scatter (cheap,
    # the optimized path); "einsum": GShard-style one-hot dispatch matmuls
    # (the faithful baseline — costs 2*S*E*C*d extra FLOPs per group).
    dispatch: str = "gather"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128             # N
    head_dim: int = 64               # P
    expand: int = 2                  # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256                 # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # transformer | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    norm: str = "rms"
    mlp_kind: str = "swiglu"
    rope: str = "1d"                 # 1d | 2d | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()
    window: int = 0                  # sliding-window attention (mixtral)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a shared attention block every k mamba blocks
    shared_attn_every: int = 0
    # enc-dec (seamless)
    encoder_layers: int = 0
    # modality frontend stub: "none" | "vision" | "audio"
    frontend: str = "none"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # long-context support class, used for shape-skip decisions:
    # "full" (quadratic attn) | "window" | "ssm" | "hybrid"
    context_class: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding shards
        evenly on a 16-way model axis."""
        return -(-self.vocab // 256) * 256


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_supported(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention state (DESIGN.md §4)."""
    if shape.name == "long_500k" and arch.context_class == "full":
        return False, ("skip: full-attention architecture — 500k-token KV "
                       "state is the quadratic-attention regime the "
                       "assignment excludes")
    return True, ""
