"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE, dynamic resolution (vision frontend stubbed)
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="transformer",
    num_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568,
    vocab=152064, head_dim=128, rope="mrope",
    mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision", context_class="full",
)
