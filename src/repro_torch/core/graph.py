"""Network topology for the decentralized problem (numpy, equal to the
reference's adjacencies).

The paper assumes an undirected, connected graph G = (N, C, A)
(Assumption 1). Erdos-Renyi graphs are the paper's synthetic setup;
ring / k-circulant graphs are what the fused ring runtime implements
(neighbours i +- o, read by index). `metropolis_weights` gives the CTA
baseline's mixing matrix. `TopologySchedule` is a time-varying topology:
a stack of graphs cycled per iteration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected connected graph with dense adjacency (small N)."""

    adjacency: np.ndarray  # (N, N) 0/1 symmetric, zero diagonal

    @property
    def num_agents(self) -> int:
        return self.adjacency.shape[0]

    @property
    def num_edges(self) -> int:
        return int(self.adjacency.sum()) // 2

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.adjacency[i])[0]

    # ---- incidence matrices (Shi et al. 2014 notation) -------------------
    def edge_list(self) -> list[tuple[int, int]]:
        N = self.num_agents
        return [(i, n) for i in range(N) for n in range(i + 1, N)
                if self.adjacency[i, n]]

    def incidence(self) -> tuple[np.ndarray, np.ndarray]:
        """(S_plus, S_minus): the unsigned and signed edge-node incidence,
        one row per directed edge (both orientations), 2|C| x N."""
        edges = self.edge_list()
        E = len(edges)
        S_plus = np.zeros((2 * E, self.num_agents))
        S_minus = np.zeros((2 * E, self.num_agents))
        for e, (i, n) in enumerate(edges):
            for row, (src, dst) in ((e, (i, n)), (e + E, (n, i))):
                S_plus[row, src] = 1.0
                S_plus[row, dst] = 1.0
                S_minus[row, src] = 1.0
                S_minus[row, dst] = -1.0
        return S_plus, S_minus

    def sigma_terms(self) -> tuple[float, float]:
        """(sigma_max(S_+), sigma_min_nonzero(S_-)) for the Theorem-2 rho
        bound."""
        S_plus, S_minus = self.incidence()
        smax = float(np.linalg.svd(S_plus, compute_uv=False)[0])
        sv = np.linalg.svd(S_minus, compute_uv=False)
        return smax, float(sv[sv > 1e-9][-1])

    def is_connected(self) -> bool:
        N = self.num_agents
        seen = {0}
        frontier = [0]
        while frontier:
            i = frontier.pop()
            for n in np.nonzero(self.adjacency[i])[0]:
                if int(n) not in seen:
                    seen.add(int(n))
                    frontier.append(int(n))
        return len(seen) == N


def erdos_renyi(num_agents: int, p: float, seed: int = 0) -> Graph:
    """Connected ER graph (redraw until connected — paper's synthetic setup)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        upper = rng.random((num_agents, num_agents)) < p
        adj = np.triu(upper, 1).astype(np.float64)
        adj = adj + adj.T
        g = Graph(adjacency=adj)
        if g.is_connected():
            return g
    raise RuntimeError("failed to draw a connected ER graph; increase p")


def ring(num_agents: int) -> Graph:
    """1-D ring."""
    return circulant(num_agents, offsets=(1,))


def circulant(num_agents: int, offsets: tuple[int, ...]) -> Graph:
    """k-regular circulant graph: agent i ~ i +/- o for each offset o."""
    adj = np.zeros((num_agents, num_agents))
    for o in offsets:
        if not 0 < o < num_agents:
            raise ValueError(f"offset {o} out of range for N={num_agents}")
        for i in range(num_agents):
            adj[i, (i + o) % num_agents] = 1.0
            adj[(i + o) % num_agents, i] = 1.0
    return Graph(adjacency=adj)


def fully_connected(num_agents: int) -> Graph:
    adj = np.ones((num_agents, num_agents)) - np.eye(num_agents)
    return Graph(adjacency=adj)


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """Time-varying consensus topology: iteration k (1-based) runs on graph
    `adjacencies[(k - 1) % M]`, cycling through the M stacked graphs.

    `offsets` is the circulant form the ring runtime (spmd) runs, one
    offset tuple per graph; None for general (e.g. Erdos-Renyi) schedules,
    which only the simulator runs. k is a host int: picking the graph reads
    nothing from the device.
    """

    adjacencies: torch.Tensor  # (M, N, N) float32
    offsets: tuple[tuple[int, ...], ...] | None = None

    def __post_init__(self):
        if self.offsets is not None:
            object.__setattr__(
                self, "offsets", tuple(tuple(o) for o in self.offsets))

    @property
    def num_graphs(self) -> int:
        return self.adjacencies.shape[0]

    @property
    def num_agents(self) -> int:
        return self.adjacencies.shape[-1]

    def index(self, k: int) -> int:
        """Graph index for the (1-based) iteration k."""
        return (k - 1) % self.num_graphs

    def at(self, k: int) -> torch.Tensor:
        """Adjacency in effect at iteration k."""
        return self.adjacencies[self.index(k)]

    def to(self, device, dtype=None) -> "TopologySchedule":
        return dataclasses.replace(
            self, adjacencies=self.adjacencies.to(device=device, dtype=dtype))

    @classmethod
    def from_graphs(cls, graphs, offsets=None,
                    device: torch.device | str = "cpu"
                    ) -> "TopologySchedule":
        """Stack a sequence of `Graph`s (equal N) into a schedule."""
        adj = torch.stack([torch.as_tensor(g.adjacency, dtype=torch.float32)
                           for g in graphs]).to(device)
        return cls(adjacencies=adj, offsets=offsets)

    @classmethod
    def circulant_cycle(cls, num_agents: int, offset_variants,
                        device: torch.device | str = "cpu"
                        ) -> "TopologySchedule":
        """Cycle through circulant graphs: the schedule form the ring
        runtime runs, one offset tuple per graph."""
        variants = tuple(tuple(v) for v in offset_variants)
        return cls.from_graphs(
            [circulant(num_agents, off) for off in variants],
            offsets=variants, device=device)


def metropolis_weights(graph: Graph) -> np.ndarray:
    """Doubly-stochastic mixing matrix of the CTA diffusion baseline:
    w_in = 1 / (1 + max(d_i, d_n)) on each edge, the rest on the diagonal."""
    A = graph.adjacency
    deg = graph.degrees
    N = graph.num_agents
    W = np.zeros((N, N))
    for i in range(N):
        for n in range(N):
            if A[i, n]:
                W[i, n] = 1.0 / (1.0 + max(deg[i], deg[n]))
        W[i, i] = 1.0 - W[i].sum()
    return W


def admissible_rho(graph: Graph, m_R: float, M_R: float, nu: float = 2.0,
                   eta1: float = 1.0, eta2: float = 1.0,
                   eta3: float | None = None) -> float:
    """The largest rho the Theorem-2 bound (Eqs. 23/32) admits. eta3
    defaults to half the value that keeps the third term positive,
    eta3 < m_R sigma_min^2(S_-) / (nu M_R^2); raises ValueError where no
    rho is admissible."""
    smax, smin = graph.sigma_terms()
    if eta3 is None:
        eta3 = 0.5 * m_R * smin**2 / (nu * M_R**2)
    t1 = 4.0 * m_R / eta1
    t2 = (nu - 1.0) * smin**2 / (nu * eta3 * smax**2)
    gap = m_R - eta3 * nu * M_R**2 / smin**2
    t3 = gap / (eta1 / 4.0 + eta2 * smax**2 / 8.0)
    rho = min(t1, t2, t3)
    if rho <= 0:
        raise ValueError("no admissible rho; loosen eta constants")
    return rho
