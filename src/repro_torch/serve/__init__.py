"""Serving: the batched LM engine (prefill, then greedy or sampled decode).
The many-model kernel server is ROADMAP.md Queue 1 item 13."""
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
