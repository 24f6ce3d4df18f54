"""repro_torch.api — the port's entry points.

    from repro_torch.api import FitConfig, KRRConfig, fit

    cfg = FitConfig(algorithm="coke", backend="fused", primal="gradient",
                    graph="ring", krr=KRRConfig(num_features=4096))
    result = fit(cfg)                          # device=None -> "cuda"
    model = result.to_model()
    y_hat = model.predict(x_new, backend="fused")

Ported so far: `fit` on the fused backend (the megakernel path for `dkla`
and `coke`, and its fallback to the ring runtime on a non-quadratic loss)
and on the spmd backend (`dkla`, `coke`, `cta`), `build_problem`, and
`KernelModel` (predict / evaluate / save / load). Anything else raises
NotImplementedError naming its ROADMAP.md item.
"""
from repro_torch.api.config import (BACKENDS, FitConfig,  # noqa: F401
                                    FitResult, SolveContext)
from repro_torch.api.fit import fit, fit_stream  # noqa: F401
from repro_torch.api.model import (KernelModel, PREDICT_BACKENDS,  # noqa: F401
                                   predict)
from repro_torch.api.problems import (BuiltProblem, build_graph,  # noqa: F401
                                      build_problem)
from repro_torch.api.registry import (get_solver, list_solvers,  # noqa: F401
                                      register_solver)
from repro_torch.api.sweep import sweep  # noqa: F401
from repro_torch.configs.coke_krr import KRRConfig, PAPER_SETUPS  # noqa: F401
from repro_torch.core.admm import Problem, make_problem  # noqa: F401
from repro_torch.core.censor import CensorSchedule  # noqa: F401
from repro_torch.core.comm import (Censor, Chain, CommState,  # noqa: F401
                                   Drop, Quantize)
