"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE
[arXiv:2405.04434].

64 routed experts top-6 + 2 shared experts, expert d_ff=1408. (The
assignment line lists both "64e top-6" and "160 routed"; DeepSeek-V2-Lite's
published config is 64 routed — the model card is followed. The real model
keeps layer 0 dense; the reference makes all layers MoE to keep its scanned
stack homogeneous, and the port follows the reference.)
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
)
