"""Run configurations: the paper's workload and the LM architectures."""
from repro_torch.configs.coke_krr import KRRConfig, PAPER_SETUPS  # noqa: F401
from repro_torch.configs.registry import get_config, get_krr_config, list_archs  # noqa: F401,E501
