"""K1: the fused random-Fourier featurizer (matmul + cos in one pass)."""
