"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    source="arXiv:2407.21783 (Llama 3 405B)",
)
