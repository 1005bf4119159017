"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206, enc-dec (speech frontend stubbed: precomputed frame
embeddings)  [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=8192, vocab=256206, head_dim=64, rope="1d",
    frontend="audio", context_class="full",
)
