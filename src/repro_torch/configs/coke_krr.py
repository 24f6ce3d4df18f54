"""The paper's own workload as a config: decentralized kernel ridge
regression (COKE / DKLA) — the Section 5 setups, as in the reference.

`KRRConfig` is the problem half of the run description: compose it into a
`repro_torch.api.FitConfig` and run it with `repro_torch.api.fit`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KRRConfig:
    name: str = "coke-krr"
    dataset: str = "synthetic"      # synthetic | heterogeneous |
                                    # toms_hardware | twitter |
                                    # twitter_large | energy | air_quality
    num_agents: int = 20
    samples_per_agent: int = 500
    num_tasks: int = 3              # heterogeneous only: K latent tasks
    num_features: int = 100         # L random features
    bandwidth: float = 1.0          # training kernel bandwidth (Sec 5.3)
    lam: float = 5e-5               # regularization lambda
    rho: float = 1e-2               # ADMM penalty/step
    censor_v: float = 1.0           # h(k) = v * mu^k
    censor_mu: float = 0.95
    graph_p: float = 0.3            # ER attachment probability
    num_iters: int = 1000
    seed: int = 0
    mapping: str = "cos_bias"       # Eq. (13); "cos_sin" = Eq. (12)


# Table/figure parameterizations from Section 5.3 (real-data tables use
# h(k) = c * mu^k with the listed c, mu, lambda, bandwidth, L).
PAPER_SETUPS = {
    "synthetic": KRRConfig(dataset="synthetic", num_agents=20, lam=5e-5,
                           rho=1e-2, censor_v=1.0, censor_mu=0.95,
                           bandwidth=1.0, num_features=100),
    "twitter_large": KRRConfig(dataset="twitter_large", num_agents=10,
                               lam=1e-3, rho=1e-2, censor_v=0.5,
                               censor_mu=0.98, bandwidth=1.0,
                               num_features=100),
    "toms_hardware": KRRConfig(dataset="toms_hardware", num_agents=10,
                               lam=1e-2, rho=1e-2, censor_v=0.5,
                               censor_mu=0.95, bandwidth=1.0,
                               num_features=100),
    "energy": KRRConfig(dataset="energy", num_agents=10, lam=1e-3,
                        rho=1e-2, censor_v=0.5, censor_mu=0.98,
                        bandwidth=0.1, num_features=100),
    "air_quality": KRRConfig(dataset="air_quality", num_agents=10, lam=1e-5,
                             rho=1e-2, censor_v=0.9, censor_mu=0.97,
                             bandwidth=0.1, num_features=200),
}

CONFIG = PAPER_SETUPS["synthetic"]
