"""minicpm3-4b [dense] — MLA attention [hf:openbmb/MiniCPM3-4B].

MLA with q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64 (model
card values for the 40-head geometry).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    source="hf:openbmb/MiniCPM3-4B (MLA)",
)
