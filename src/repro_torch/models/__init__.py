"""The language models of the port: decoder-only GQA and MLA models with
dense or MoE layers, their prefill through the flash-attention kernel."""
