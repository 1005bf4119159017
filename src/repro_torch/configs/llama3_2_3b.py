"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256  [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="transformer",
    num_layers=28, d_model=3072, n_heads=24, n_kv=8, d_ff=8192,
    vocab=128256, head_dim=128, rope="1d", rope_theta=500000.0,
    context_class="full",
)
