"""zamba2-2.7b [hybrid] — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242].

54 Mamba2 layers in groups of 6; after each group one *shared* (single set
of weights) GQA attention+MLP block is applied. Per-application KV caches
remain distinct. (The per-application LoRA adapters of the real model are
omitted, as in the reference.)
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    source="arXiv:2411.15242 (Zamba2)",
)
