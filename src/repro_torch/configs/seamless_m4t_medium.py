"""seamless-m4t-medium [audio] — encoder-decoder, multimodal
[arXiv:2308.11596].

Transformer backbone only: the mel-spectrogram + conv feature extractor is
a stub; the caller passes precomputed frame embeddings (B, S_enc, d) as
`encoder_embeds`. 12 encoder + 12 decoder layers. Decode runs the decoder
against the encoder memory's cross k/v, projected once per layer.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    source="arXiv:2308.11596 (SeamlessM4T medium)",
)
