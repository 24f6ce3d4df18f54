"""Run configurations of the paper's workload."""
from repro_torch.configs.coke_krr import KRRConfig, PAPER_SETUPS  # noqa: F401
