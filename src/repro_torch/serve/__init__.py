"""Serving: the batched LM engine (prefill, then greedy or sampled decode),
and many-model kernel serving (`KernelServer` over a `ThetaStore` of
resident thetas paged against a `ModelRegistry`)."""
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
from repro_torch.serve.kernel_server import (KernelServeConfig,  # noqa: F401
                                             KernelServer)
from repro_torch.serve.registry import ModelRegistry  # noqa: F401
from repro_torch.serve.theta_store import ThetaStore  # noqa: F401
