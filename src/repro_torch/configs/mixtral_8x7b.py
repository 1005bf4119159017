"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, sliding-window attention  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=32000, head_dim=128, rope="1d", rope_theta=1e6,
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    context_class="window",
)
