"""mamba2-2.7b [ssm] — pure SSD (state-space duality), attention-free
[arXiv:2405.21060].

d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads, state N=128.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    attn_kind="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    source="arXiv:2405.21060 (Mamba2 / SSD)",
)
