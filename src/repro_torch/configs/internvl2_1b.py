"""internvl2-1b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

Language/decoder transformer only; the vision frontend is a stub: the
caller passes 256 precomputed patch embeddings of width d_model as
`batch["prefix_embeds"]`.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    prefix_len=256,
    rope_theta=1e6,
    source="arXiv:2404.16821 (InternVL2); InternLM2 LM backbone",
)
