"""granite-3-8b [dense] — GQA dense decoder [hf:ibm-granite/granite-3.0-2b-base family]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-2b-base (GQA)",
)
