"""Run configurations: the paper's workload, the LM architectures and
their input shapes."""
from repro_torch.configs.coke_krr import KRRConfig, PAPER_SETUPS  # noqa: F401
from repro_torch.configs.registry import get_config, get_krr_config, list_archs  # noqa: F401,E501
from repro_torch.configs.shapes import SHAPES, input_specs, long_context_mode  # noqa: F401,E501
