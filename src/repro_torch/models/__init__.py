"""The language models of the port: the dense GQA decoder (qwen3-1.7b)
with its prefill through the flash-attention kernel."""
