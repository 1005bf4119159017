"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000  [arXiv:2401.02385; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="transformer",
    num_layers=22, d_model=2048, n_heads=32, n_kv=4, d_ff=5632,
    vocab=32000, head_dim=64, rope="1d", rope_theta=10000.0,
    context_class="full",
)
