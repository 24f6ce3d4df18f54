"""qwen3-1.7b [dense] — GQA + per-head qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (qk_norm, GQA)",
)
