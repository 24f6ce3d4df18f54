"""K4: the flash-attention forward (online softmax, causal and sliding-window
masks, grouped-query heads), the prefill attention of the LM serving path."""
