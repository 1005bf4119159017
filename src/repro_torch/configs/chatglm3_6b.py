"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2D RoPE  [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="transformer",
    num_layers=28, d_model=4096, n_heads=32, n_kv=2, d_ff=13696,
    vocab=65024, head_dim=128, rope="2d", rope_theta=10000.0,
    context_class="full",
)
