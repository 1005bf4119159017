"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="transformer",
    num_layers=40, d_model=2048, n_heads=32, n_kv=8, d_ff=8192,
    vocab=49155, head_dim=64, rope="1d", rope_theta=10000.0,
    tie_embeddings=True, context_class="full",
)
