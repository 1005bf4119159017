"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, head_dim=128, rope="1d", rope_theta=10000.0,
    moe=MoEConfig(num_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual=True, dense_d_ff=4864),
    context_class="full",
)
