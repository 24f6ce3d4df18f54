"""The solver x backend x exec x workload capability table, as in the
reference's `api/capabilities.py`.

Every cross-axis admission rule lives here as declarative data.
`FitConfig.__post_init__` consults CONFIG_RULES (no solver needed); the
drivers consult RUN_RULES through `check_fit` / `check_stream` /
`check_sweep` once the solver is resolved. `Rule`, CONFIG_RULES and
RUN_RULES are the reference's, word for word: a combination the reference
rejects raises the same ValueError here, and every combination it admits
runs (with or without `mesh=`). `python -m repro_torch.api.capabilities`
writes the port's support matrix, decided by these same rules, into its
block of the README.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Rule:
    """One unsupported region of the axis space, declaratively.

    when        — ((axis, match), ...): the rule fires when EVERY axis in
                  the view matches (a tuple match means "value is one of").
    reason      — why the combination cannot run; `{axis}` placeholders
                  format from the view (legacy error substrings preserved —
                  they are test contracts).
    alternative — the nearest supported combination, appended to the
                  error so every rejection names a way forward.
    """

    id: str
    when: tuple[tuple[str, Any], ...]
    reason: str
    alternative: str

    def matches(self, view: dict[str, Any]) -> bool:
        for axis, want in self.when:
            have = view[axis]
            if isinstance(want, tuple):
                if have not in want:
                    return False
            elif have != want:
                return False
        return True


#: rules FitConfig.__post_init__ can decide alone (no solver resolution)
CONFIG_RULES: tuple[Rule, ...] = (
    Rule(
        id="sync-gossip-knobs",
        when=(("exec", "sync"), ("gossip_knobs", True)),
        reason="participation/gossip_size/churn are gossip-execution "
               "knobs; set exec='gossip' to use them",
        alternative="exec='gossip' with the same knobs",
    ),
    Rule(
        id="comm-censor-knobs",
        when=(("comm", True), ("censor_knobs", True)),
        reason="censor_v/censor_mu are the legacy spelling of "
               "comm=Chain([Censor(v, mu)]); pass one or the other, "
               "not both",
        alternative="fold the thresholds into the comm chain and drop "
                    "censor_v/censor_mu",
    ),
    Rule(
        id="personalization-topology",
        when=(("personalization", True), ("topology", True)),
        reason="personalization learns its own collaboration graph; it "
               "does not compose with a scripted FitConfig.topology "
               "schedule",
        alternative="drop FitConfig.topology (keep the learned graph) or "
                    "drop personalization (keep the schedule)",
    ),
    Rule(
        id="personalization-churn",
        when=(("personalization", True), ("churn", True)),
        reason="personalization does not compose with churn: a learned "
               "graph over a changing population is ill-defined (joiners "
               "restart at theta = 0, hijacking the affinity ranking)",
        alternative="personalization with exec='gossip' participation "
                    "sampling (no churn), or churn without "
                    "personalization",
    ),
)

#: rules needing the resolved solver; `mode` scopes each rule to the
#: driver(s) it applies to ("batch" = fit, "stream" = fit_stream,
#: "sweep" = sweep — which runs the batch admission first)
RUN_RULES: tuple[Rule, ...] = (
    Rule(
        id="solver-backend",
        when=(("mode", "batch"), ("backend_supported", False)),
        reason="solver {algorithm} supports backends {solver_backends}, "
               "not {backend}",
        alternative="backend='simulator' (every solver runs there)",
    ),
    Rule(
        id="comm-unaware-solver",
        when=(("mode", "batch"), ("comm", True), ("solver_comm", False)),
        reason="solver {algorithm} does not thread a communication "
               "policy (it transmits unconditionally); drop "
               "FitConfig.comm or pick a comm-aware algorithm "
               "(dkla/coke/online_coke)",
        alternative="algorithm='coke' with the same comm chain",
    ),
    Rule(
        id="topology-unaware-solver",
        when=(("mode", "batch"), ("topology", True),
              ("solver_topology", False)),
        reason="solver {algorithm} does not support a time-varying "
               "topology schedule; drop FitConfig.topology or pick "
               "dkla/coke",
        alternative="algorithm='coke' with the same schedule",
    ),
    Rule(
        id="primal-unaware-solver",
        when=(("primal", ("cholesky", "cg")), ("solver_primal", False)),
        reason="solver {algorithm} has no (21a) primal subproblem for "
               "primal={primal} to solve; leave primal='auto' or pick an "
               "ADMM solver (dkla/coke)",
        alternative="algorithm='coke' with the same primal mode",
    ),
    Rule(
        id="gossip-unaware-solver",
        when=(("exec", "gossip"), ("solver_gossip", False)),
        reason="solver {algorithm} has no gossip execution semantics; "
               "use exec='sync' or pick the ADMM (dkla/coke) or "
               "streaming (online_dkla/online_coke/qc_odkla) families",
        alternative="algorithm='coke' under exec='gossip'",
    ),
    Rule(
        id="gossip-topology",
        when=(("exec", "gossip"), ("topology", True)),
        reason="gossip execution samples participants on a static "
               "consensus graph; drop FitConfig.topology or use "
               "exec='sync'",
        alternative="exec='sync' with the same topology schedule",
    ),
    Rule(
        id="churn-fused",
        when=(("churn", True), ("backend", "fused")),
        reason="churn makes the graph degrees traced data; the fused "
               "Pallas kernels (the coke_megastep megakernel and the "
               "coke_update combine) bake the degree in as a static "
               "parameter",
        alternative="backend='spmd' (alive-masked ring permutes) or "
                    "'simulator' with the same ChurnSchedule",
    ),
    Rule(
        id="churn-cholesky",
        when=(("churn", True), ("primal", "cholesky")),
        reason="churn makes the graph degrees time-varying; the "
               "prefactored Cholesky primal cannot follow them — use "
               "primal='auto', 'cg' or 'gradient'",
        alternative="primal='cg' (exact and degree-tracking)",
    ),
    Rule(
        id="personalization-unaware-solver",
        when=(("personalization", True), ("solver_pz", False)),
        reason="solver {algorithm} has no consensus-penalty term for a "
               "learned collaboration graph to reweight; pick the ADMM "
               "(dkla/coke) or streaming (online_dkla/online_coke/"
               "qc_odkla) families, or drop FitConfig.personalization",
        alternative="algorithm='coke' with the same Personalization",
    ),
    Rule(
        id="personalization-fused",
        when=(("personalization", True), ("backend", "fused")),
        reason="the fused Pallas kernels bake the graph degree and ring "
               "offsets in as static parameters; a learned graph is "
               "time-varying — use backend='simulator' or 'spmd'",
        alternative="backend='spmd' with the same Personalization",
    ),
    Rule(
        id="personalization-cholesky",
        when=(("personalization", True), ("primal", "cholesky")),
        reason="a learned collaboration graph makes the degrees time-"
               "varying; the prefactored Cholesky primal cannot follow "
               "them — use primal='auto', 'cg' or 'gradient'",
        alternative="primal='cg' (exact and degree-tracking)",
    ),
    Rule(
        id="stream-batch-solver",
        when=(("mode", "stream"), ("solver_streaming", False)),
        reason="solver {algorithm} is a batch algorithm; fit_stream "
               "drives the streaming family (online_dkla/online_coke/"
               "qc_odkla) — use fit() instead",
        alternative="fit() with the same config",
    ),
    Rule(
        id="stream-backend",
        when=(("mode", "stream"), ("solver_streaming", True),
              ("stream_backend_supported", False)),
        reason="streaming solver {algorithm} supports backends "
               "{stream_backends}, not {backend}",
        alternative="backend='simulator' or 'spmd' via fit_stream",
    ),
    Rule(
        id="stream-topology",
        when=(("mode", "stream"), ("topology", True)),
        reason="the streaming solvers run on a static consensus graph; "
               "drop FitConfig.topology or use the batch ADMM solvers",
        alternative="algorithm='coke' through fit() with the schedule",
    ),
    Rule(
        id="sweep-streaming",
        when=(("mode", "sweep"), ("solver_streaming", True)),
        reason="sweep vmaps the batch fit program; streaming solver "
               "{algorithm} takes a StreamProblem",
        alternative="fit_stream() per policy cell, or sweep a batch "
                    "solver (dkla/coke)",
    ),
    Rule(
        id="sweep-backend",
        when=(("mode", "sweep"), ("backend", ("spmd", "fused"))),
        reason="sweep vmaps the in-process simulator loop; run backend="
               "{backend} cells individually through fit()",
        alternative="backend='simulator' (the whole grid is one compiled "
                    "program)",
    ),
)


def _config_view(config) -> dict[str, Any]:
    return {
        "exec": config.exec,
        "backend": config.backend,
        "primal": config.primal,
        "comm": config.comm is not None,
        "censor_knobs": (config.censor_v is not None
                         or config.censor_mu is not None),
        "gossip_knobs": (config.participation != 1.0
                         or config.gossip_size is not None
                         or config.churn is not None),
        "churn": config.churn is not None,
        "topology": config.topology is not None,
        "personalization": config.personalization is not None,
    }


def _run_view(config, solver, mode: str) -> dict[str, Any]:
    view = _config_view(config)
    stream_backends = getattr(solver, "stream_backends", ())
    view.update({
        "mode": mode,
        "algorithm": repr(config.algorithm),
        "solver_backends": repr(tuple(solver.backends)),
        "stream_backends": repr(tuple(stream_backends)),
        "backend_supported": config.backend in solver.backends,
        "stream_backend_supported": config.backend in stream_backends,
        "solver_comm": getattr(solver, "comm_aware", False),
        "solver_topology": getattr(solver, "topology_aware", False),
        "solver_primal": getattr(solver, "primal_aware", False),
        "solver_gossip": getattr(solver, "gossip_aware", False),
        "solver_pz": getattr(solver, "personalization_aware", False),
        "solver_streaming": getattr(solver, "streaming", False),
    })
    return view


def _enforce(view: dict[str, Any], rules: tuple[Rule, ...]) -> None:
    for rule in rules:
        if rule.matches(view):
            raise ValueError(
                rule.reason.format(**view)
                + f" — nearest supported: {rule.alternative}")


def check_config(config) -> None:
    """The solver-free cross-axis admission — FitConfig.__post_init__."""
    _enforce(_config_view(config), CONFIG_RULES)


def check_fit(config, solver) -> None:
    """The batch-driver admission (fit)."""
    _enforce(_run_view(config, solver, "batch"), RUN_RULES)


def check_stream(config, solver) -> None:
    """The streaming-driver admission (fit_stream)."""
    _enforce(_run_view(config, solver, "stream"), RUN_RULES)


def check_sweep(config, solver) -> None:
    """The sweep admission: a cell must pass both the sweep- and the
    batch-scoped rules, as in the reference."""
    _enforce(_run_view(config, solver, "sweep"), RUN_RULES)
    _enforce(_run_view(config, solver, "batch"), RUN_RULES)


# ---------------------------------------------------------------------------
# The port's README support matrix, generated from the same table
# ---------------------------------------------------------------------------

BEGIN_MARK = ("<!-- BEGIN port-support-matrix (generated: python -m "
              "repro_torch.api.capabilities) -->")
END_MARK = "<!-- END port-support-matrix -->"

#: the reference's probe columns
_FEATURE_PROBES: tuple[tuple[str, dict[str, Any]], ...] = (
    ("`exec=\"sync\"`", {}),
    ("`exec=\"gossip\"`", {"exec": "gossip", "participation": 0.5}),
    ("`+ churn`", {"exec": "gossip", "churn": True}),
    ("`personalization`", {"personalization": True}),
    ("`topology`", {"topology": True}),
    ("`sweep()`", {"sweep": True}),
)


def _cell(solver, backend: str, probe: dict[str, Any]) -> str:
    """✅ when the drivers run the combination, — when they reject it
    (the reference's ValueError)."""
    from repro_torch.api.config import FitConfig
    from repro_torch.core.gossip import ChurnSchedule
    from repro_torch.core.graph import TopologySchedule
    from repro_torch.core.personalize import Personalization

    kw: dict[str, Any] = {"backend": backend, "algorithm": solver.name,
                          "exec": probe.get("exec", "sync")}
    if probe.get("participation"):
        kw["participation"] = probe["participation"]
    if probe.get("churn"):
        kw["churn"] = ChurnSchedule(leave=((2, 0),))
    if probe.get("personalization"):
        kw["personalization"] = Personalization()
    if probe.get("topology"):
        kw["topology"] = TopologySchedule.circulant_cycle(8, [(1,)])
    try:
        config = FitConfig(**kw)
        if probe.get("sweep"):
            check_sweep(config, solver)
        elif getattr(solver, "streaming", False):
            check_stream(config, solver)
        else:
            check_fit(config, solver)
    except ValueError:
        return "—"
    return "✅"


def support_matrix() -> str:
    """The solver x backend x exec/feature matrix of the port as markdown,
    each cell decided by the admission rules themselves."""
    from repro_torch.api.config import BACKENDS
    from repro_torch.api.registry import get_solver, list_solvers

    header = ("| solver | backend | "
              + " | ".join(label for label, _ in _FEATURE_PROBES) + " |")
    sep = "|---|---|" + "---|" * len(_FEATURE_PROBES)
    lines = [BEGIN_MARK, "", header, sep]
    for name in list_solvers():
        solver = get_solver(name)
        streaming = getattr(solver, "streaming", False)
        backends = (getattr(solver, "stream_backends", ())
                    if streaming else solver.backends)
        driver = "`fit_stream`" if streaming else "`fit`"
        for backend in BACKENDS:
            if backend not in backends:
                continue
            cells = " | ".join(_cell(solver, backend, probe)
                               for _, probe in _FEATURE_PROBES)
            lines.append(f"| `{name}` ({driver}) | `{backend}` "
                         f"| {cells} |")
    lines += ["", END_MARK]
    return "\n".join(lines)


def update_readme(path: str) -> bool:
    """Rewrite the README block between the port's markers from the
    table; returns True when the file changed."""
    with open(path) as f:
        text = f.read()
    start = text.index(BEGIN_MARK)
    end = text.index(END_MARK) + len(END_MARK)
    new = text[:start] + support_matrix() + text[end:]
    if new == text:
        return False
    with open(path, "w") as f:
        f.write(new)
    return True


if __name__ == "__main__":
    import os

    readme = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "..", "..", "README.md")
    changed = update_readme(os.path.normpath(readme))
    print("README port support matrix "
          + ("updated" if changed else "already in sync"))
