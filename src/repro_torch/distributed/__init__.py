"""The ring consensus runtime (`consensus.py`): the spmd backend and the
fused backend's fallback."""
