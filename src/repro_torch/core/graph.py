"""Network topology for the decentralized problem (numpy, equal to the
reference's adjacencies).

The paper assumes an undirected, connected graph G = (N, C, A)
(Assumption 1). Erdos-Renyi graphs are the paper's synthetic setup;
ring / k-circulant graphs are what the fused ring runtime implements
(neighbours i +- o, read by index).
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
