"""mamba2-780m [ssm] — 48L d_model=1536 (attn-free) vocab=50280
ssm_state=128, SSD  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, n_heads=48, n_kv=0, d_ff=0,
    vocab=50280, head_dim=64, rope="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    context_class="ssm",
)
