"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240,
    vocab=32000, head_dim=80, rope="1d",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    shared_attn_every=6, context_class="hybrid",
)
