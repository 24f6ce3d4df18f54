"""The ring consensus runtime (`consensus.py`): the spmd backend and the
fused backend's fallback; and big-D feature sharding (`sharding.py`): the
reference's spec rules and the blocked layout a mesh runs on."""
