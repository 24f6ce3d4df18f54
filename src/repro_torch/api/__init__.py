"""repro_torch.api — the port's entry points.

    from repro_torch.api import FitConfig, KRRConfig, fit

    cfg = FitConfig(algorithm="coke", backend="fused", primal="gradient",
                    graph="ring", krr=KRRConfig(num_features=4096))
    result = fit(cfg)                          # device=None -> "cuda"
    model = result.to_model()
    y_hat = model.predict(x_new, backend="fused")

Ported so far: `fit` on the simulator backend (`dkla`, `coke`, `cta`,
`ridge_oracle`, and the streaming solvers over a rotating minibatch
window; the Cholesky, CG and gradient primals), on the fused
backend (the megakernel path for `dkla` and `coke`, and its fallback to
the ring runtime on a non-quadratic loss or the CG primal) and on the spmd
backend (`dkla`, `coke`, `cta`), each with any comm chain (`Censor`,
`Quantize`, `Drop`) and, on the simulator and spmd, a `TopologySchedule`;
`build_problem`, and `KernelModel` (predict / evaluate / save / load /
partial_fit); `sweep` (a policy grid as one lane-batched simulator loop,
`SweepResult` evaluate / select / models); `fit_stream` with
`online_dkla`, `online_coke` and `qc_odkla` on the simulator and spmd
(`build_stream`, `stream_from_arrays`); gossip execution
(`FitConfig(exec="gossip", participation=0.25)`, or `gossip_size=k`) for
all of these, on every backend, with `ChurnSchedule` scripting straggler
slowdowns and join/leave events on the simulator and spmd; personalization
(`FitConfig(personalization=Personalization(k=3, every=5, warmup=15))`:
a learned mutual top-k collaboration graph) for `fit`, `fit_stream` and
`sweep` on the simulator and spmd, sync and gossip, deployed per agent by
`FitResult.to_models()` (K1 in each model's fused predict), on the
clustered `heterogeneous` dataset, scored by `graph_recovery`; big-D
feature sharding (`fit(..., mesh=make_host_mesh(data, model))` on the
simulator, spmd and fused backends, `KernelModel.shard(mesh)`, and
`ThetaStore` / `KernelServer` with `mesh=`).
Admission is the reference's capability table (`api/capabilities.py`);
what is not ported yet raises NotImplementedError naming its ROADMAP.md
item.
"""
from repro_torch.api.config import (BACKENDS, FitConfig,  # noqa: F401
                                    FitResult, SolveContext)
from repro_torch.api.fit import fit, fit_stream  # noqa: F401
from repro_torch.api.model import (KernelModel, PREDICT_BACKENDS,  # noqa: F401
                                   predict)
from repro_torch.api.problems import (BuiltProblem, BuiltStream,  # noqa: F401
                                      StreamProblem, build_graph,
                                      build_problem, build_stream,
                                      stream_from_arrays)
from repro_torch.api.registry import (get_solver, list_solvers,  # noqa: F401
                                      register_solver)
from repro_torch.api.sweep import SweepResult, sweep  # noqa: F401
from repro_torch.configs.coke_krr import KRRConfig, PAPER_SETUPS  # noqa: F401
from repro_torch.core.admm import Problem, make_problem  # noqa: F401
from repro_torch.core.censor import CensorSchedule  # noqa: F401
from repro_torch.core.comm import (Censor, Chain, CommState,  # noqa: F401
                                   Drop, Quantize)
from repro_torch.core.gossip import (ChurnSchedule,  # noqa: F401
                                     GossipPlan, NeighborTable)
from repro_torch.core.graph import TopologySchedule  # noqa: F401
from repro_torch.core.personalize import (Personalization,  # noqa: F401
                                          graph_recovery)
from repro_torch.data.synthetic import heterogeneous  # noqa: F401
