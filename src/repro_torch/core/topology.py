"""Network topologies and combination matrices (paper §II, Assumption 1).

A combination matrix ``A = [a_{lk}]`` scales information sent from agent l to
agent k.  Assumption 1 requires A symmetric, left-stochastic (hence doubly
stochastic) and primitive.  We provide the standard constructions used in the
diffusion literature plus validation helpers.

The port's own copy of ``repro.core.topology`` (numpy only): the port may
not import the JAX package, and the tests hold both copies bit-equal.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np

__all__ = [
    "ring_adjacency",
    "grid_adjacency",
    "full_adjacency",
    "erdos_renyi_adjacency",
    "scale_free_adjacency",
    "small_world_adjacency",
    "metropolis_weights",
    "averaging_matrix",
    "laplacian_weights",
    "is_doubly_stochastic",
    "is_symmetric",
    "is_primitive",
    "perron_vector",
    "spectral_gap",
    "Topology",
    "TOPOLOGY_KINDS",
    "make_topology",
]


# ---------------------------------------------------------------------------
# adjacency constructions (boolean, self-loops always included)
# ---------------------------------------------------------------------------

def ring_adjacency(K: int, hops: int = 1) -> np.ndarray:
    """Ring lattice: each agent connects to ``hops`` neighbors on each side."""
    if K < 1:
        raise ValueError("K must be >= 1")
    adj = np.eye(K, dtype=bool)
    for h in range(1, hops + 1):
        idx = np.arange(K)
        adj[idx, (idx + h) % K] = True
        adj[idx, (idx - h) % K] = True
    return adj


def grid_adjacency(rows: int, cols: int) -> np.ndarray:
    """2-D grid (torus-free) with 4-neighborhood."""
    K = rows * cols
    adj = np.eye(K, dtype=bool)
    for r in range(rows):
        for c in range(cols):
            k = r * cols + c
            if r + 1 < rows:
                adj[k, k + cols] = adj[k + cols, k] = True
            if c + 1 < cols:
                adj[k, k + 1] = adj[k + 1, k] = True
    return adj


def full_adjacency(K: int) -> np.ndarray:
    return np.ones((K, K), dtype=bool)


def erdos_renyi_adjacency(K: int, p: float, seed: int = 0,
                          ensure_connected: bool = True) -> np.ndarray:
    """Erdős–Rényi G(K, p), symmetrized, self-loops added.

    When ``ensure_connected`` we overlay a ring so the graph is always
    strongly connected (the paper assumes primitivity).
    """
    rng = np.random.default_rng(seed)
    upper = rng.random((K, K)) < p
    adj = np.triu(upper, 1)
    adj = adj | adj.T | np.eye(K, dtype=bool)
    if ensure_connected:
        adj = adj | ring_adjacency(K, 1)
    return adj


def _connected(adj: np.ndarray) -> bool:
    """Connectivity of a boolean adjacency by repeated squaring."""
    adj = np.asarray(adj, dtype=bool) | np.eye(adj.shape[0], dtype=bool)
    reach = adj
    for _ in range(int(np.ceil(np.log2(max(adj.shape[0], 2)))) + 1):
        reach = (reach.astype(np.float32) @ reach.astype(np.float32)) > 0
        if reach.all():
            return True
    return bool(reach.all())


def scale_free_adjacency(K: int, m: int = 2, seed: int = 0) -> np.ndarray:
    """Barabási–Albert preferential attachment, self-loops added.

    Starts from a complete seed graph on ``m + 1`` nodes (connected by
    construction, so the result is always connected) and attaches each new
    node to ``m`` distinct existing nodes with probability proportional to
    degree — the classic repeated-nodes urn.  Degree distribution is a
    power law: expect O(sqrt(K))-degree hubs, so ``max_degree`` (and the
    ``(K, D)`` neighbor table) is NOT O(1) in K on these graphs.
    """
    if K < 2:
        raise ValueError("scale_free: K must be >= 2")
    m = int(min(max(m, 1), K - 1))
    rng = np.random.default_rng(seed)
    adj = np.eye(K, dtype=bool)
    m0 = m + 1
    adj[:m0, :m0] = True
    # urn of endpoints: each edge contributes both ends, so a draw is
    # degree-proportional
    urn = [i for i in range(m0) for _ in range(m0 - 1)]
    for v in range(m0, K):
        targets: set[int] = set()
        while len(targets) < m:
            targets.add(int(urn[rng.integers(len(urn))]))
        for t in targets:
            adj[v, t] = adj[t, v] = True
            urn.extend((v, t))
    return adj


def small_world_adjacency(K: int, hops: int = 2, rewire: float = 0.1,
                          seed: int = 0,
                          ensure_connected: bool = True) -> np.ndarray:
    """Watts–Strogatz small world, self-loops added.

    A ring lattice with ``hops`` neighbors per side; each clockwise lattice
    edge is rewired to a uniform random target with probability ``rewire``.
    Rewiring can (rarely) disconnect the graph; ``ensure_connected``
    overlays the 1-hop ring in that case (same convention as
    :func:`erdos_renyi_adjacency`) so Assumption 1's primitivity holds.
    """
    if K < 3:
        raise ValueError("small_world: K must be >= 3")
    hops = int(min(max(hops, 1), (K - 1) // 2))
    rng = np.random.default_rng(seed)
    adj = np.eye(K, dtype=bool)
    for h in range(1, hops + 1):
        for i in range(K):
            j = (i + h) % K
            if rng.random() < rewire:
                # rewire i -> j to i -> t, avoiding self and duplicates
                choices = np.flatnonzero(~adj[i])
                if len(choices):
                    j = int(choices[rng.integers(len(choices))])
            adj[i, j] = adj[j, i] = True
    if ensure_connected and not _connected(adj):
        adj = adj | ring_adjacency(K, 1)
    return adj


# ---------------------------------------------------------------------------
# weight rules
# ---------------------------------------------------------------------------

def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings rule: symmetric doubly stochastic for any graph.

    a_lk = 1 / max(deg_l, deg_k) for neighbors l != k; self weight completes
    the column to one.  Degrees exclude the self-loop.

    Fully vectorized (no Python loops): the per-block Metropolis reweighting
    of the dynamic graph processes (core/graphs.py) and validation at
    K in the hundreds both lean on this being O(K^2) numpy ops.
    """
    adj = np.asarray(adj, dtype=bool)
    K = adj.shape[0]
    off = adj & ~np.eye(K, dtype=bool)
    deg = off.sum(axis=1)
    pair_deg = np.maximum(deg[:, None], deg[None, :])
    A = np.where(off, 1.0 / (1.0 + pair_deg), 0.0)
    np.fill_diagonal(A, 1.0 - A.sum(axis=0))
    return A


def averaging_matrix(K: int) -> np.ndarray:
    """(1/K) 11^T — the FedAvg server in matrix form (paper eq. 39-40)."""
    return np.full((K, K), 1.0 / K, dtype=np.float64)


def laplacian_weights(adj: np.ndarray, eps: float | None = None) -> np.ndarray:
    """A = I - eps * L with L the graph Laplacian; eps < 1/deg_max."""
    adj = np.asarray(adj, dtype=bool)
    K = adj.shape[0]
    off = adj & ~np.eye(K, dtype=bool)
    deg = off.sum(axis=1)
    if eps is None:
        eps = 1.0 / (deg.max() + 1.0)
    L = np.diag(deg).astype(np.float64) - off.astype(np.float64)
    return np.eye(K) - eps * L


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def is_symmetric(A: np.ndarray, tol: float = 1e-10) -> bool:
    return bool(np.allclose(A, A.T, atol=tol))


def is_doubly_stochastic(A: np.ndarray, tol: float = 1e-8) -> bool:
    A = np.asarray(A)
    ok_nonneg = bool((A >= -tol).all())
    ok_cols = bool(np.allclose(A.sum(axis=0), 1.0, atol=tol))
    ok_rows = bool(np.allclose(A.sum(axis=1), 1.0, atol=tol))
    return ok_nonneg and ok_cols and ok_rows


def is_primitive(A: np.ndarray, max_power: int | None = None) -> bool:
    """A^m > 0 entrywise for some m (Assumption 1).

    Reachability closure by repeated squaring — O(log max_power) boolean
    matmuls instead of max_power dense products, so validating K in the
    hundreds costs milliseconds (every realized dynamic graph can afford
    the check, see core/graphs.py).
    """
    A = np.asarray(A, dtype=np.float64)
    K = A.shape[0]
    if max_power is None:
        max_power = K * K + 1

    def bool_matmul(X, Y):
        return (X.astype(np.float32) @ Y.astype(np.float32)) > 0

    # exponentiation by squaring of the self-loop-closed pattern: result
    # is reachability within EXACTLY max_power steps (the same walk-length
    # bound the original per-step loop enforced), in O(log) matmuls
    base = (A > 0) | np.eye(K, dtype=bool)
    result = np.eye(K, dtype=bool)
    n = int(max_power)
    while n:
        if n & 1:
            result = bool_matmul(result, base)
            if result.all():
                return True
        n >>= 1
        if n:
            base = bool_matmul(base, base)
            if base.all():
                return True
    return bool(result.all())


def perron_vector(A: np.ndarray) -> np.ndarray:
    """Right Perron eigenvector, normalized to sum 1.

    For doubly-stochastic A this is (1/K) 1 (paper, after Assumption 1).
    """
    vals, vecs = np.linalg.eig(np.asarray(A, dtype=np.float64))
    idx = int(np.argmax(vals.real))
    p = np.abs(vecs[:, idx].real)
    return p / p.sum()


def spectral_gap(A: np.ndarray) -> float:
    """1 - |lambda_2(A)| — mixing rate of the network.

    A disconnected doubly-stochastic matrix has ``|lambda_2| = 1`` and the
    gap degenerates to 0 — that used to return silently, which downstream
    consumers (choco_gamma floors, MSD surrogates) read as "never mixes".
    We warn instead of raising because non-doubly-stochastic callers may
    legitimately probe arbitrary matrices.
    """
    vals = np.linalg.eigvals(np.asarray(A, dtype=np.float64))
    mags = np.sort(np.abs(vals))[::-1]
    gap = float(1.0 - (mags[1] if len(mags) > 1 else 0.0))
    if len(mags) > 1 and gap <= 1e-12:
        warnings.warn(
            "spectral_gap: |lambda_2| ~= 1 — the graph is disconnected (or "
            "periodic), so the mixing-rate gap is 0; check the topology "
            "seed / connectivity before using this value",
            stacklevel=2)
    return gap


# ---------------------------------------------------------------------------
# high-level factory
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Topology:
    """A validated combination matrix plus its adjacency."""

    name: str
    A: np.ndarray          # (K, K) float64, symmetric doubly stochastic
    adjacency: np.ndarray  # (K, K) bool

    @property
    def num_agents(self) -> int:
        return int(self.A.shape[0])

    @property
    def max_degree(self) -> int:
        off = self.adjacency & ~np.eye(self.num_agents, dtype=bool)
        return int(off.sum(axis=1).max()) if self.num_agents > 1 else 0

    def neighbor_table(self, *, dmax_cap: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Static bounded-degree gather table ``(idx, valid)``.

        ``idx`` is (K, D) int32 with ``D = max_degree + 1``: slot 0 is the
        agent itself, the following slots list the base-graph neighbors
        that can ever contribute to it (column support of the adjacency),
        and padding slots repeat the self index.  ``valid`` is the (K, D)
        bool mask of real slots — a padding slot gathers the agent's own
        row but its realized weight ``A_eff[idx[k, j], k] * valid[k, j]``
        is exactly zero, so padding is inert by construction.

        The table is exhaustive for every realized matrix of a graph
        process with ``within_base_support`` (link dropout, gossip
        matchings, the static graph): masked combination only *removes*
        edges and renormalizes the diagonal, and self is always slot 0.
        It is NOT valid for processes that realize edges outside the base
        adjacency (tv_erdos) — ``check_mixer_support`` guards that.

        ``dmax_cap`` guards consumers that materialize O(K * D) state (the
        async staleness buffer, the gather mixers): on heavy-tailed degree
        distributions (``scale_free``) ``max_degree`` grows with K, so the
        "bounded-degree" table silently degenerates toward dense.  When the
        cap is exceeded the table REFUSES (with the hub degree named)
        rather than capping — dropping a hub's edges would change the
        realized combination matrix.
        """
        K = self.num_agents
        D = self.max_degree + 1
        if dmax_cap is not None and self.max_degree > dmax_cap:
            raise ValueError(
                f"{self.name}: max degree {self.max_degree} exceeds the "
                f"neighbor-table cap {dmax_cap} — hub degrees on this "
                "topology make the (K, D) table quasi-dense; use a dense "
                "mixer / engine or a bounded-degree topology")
        off = self.adjacency & ~np.eye(K, dtype=bool)
        idx = np.tile(np.arange(K, dtype=np.int32)[:, None], (1, D))
        valid = np.zeros((K, D), dtype=bool)
        valid[:, 0] = True                      # slot 0: self, always heard
        for k in range(K):
            nbrs = np.flatnonzero(off[:, k])    # contributors l -> target k
            idx[k, 1:1 + len(nbrs)] = nbrs
            valid[k, 1:1 + len(nbrs)] = True
        return idx, valid

    def neighbor_offsets_ring(self) -> Sequence[int]:
        """For ring-like topologies: signed hop offsets with nonzero weight.

        Used by the sparse ppermute mixing path (core/sharded.py).
        """
        K = self.num_agents
        offsets = set()
        for l in range(K):
            for k in range(K):
                if self.adjacency[l, k] and l != k:
                    d = (l - k) % K
                    offsets.add(d if d <= K // 2 else d - K)
        return tuple(sorted(offsets))

    def validate(self) -> None:
        if not is_symmetric(self.A):
            raise ValueError(f"{self.name}: A not symmetric")
        if not is_doubly_stochastic(self.A):
            raise ValueError(f"{self.name}: A not doubly stochastic")
        if self.num_agents > 1 and not is_primitive(self.A):
            raise ValueError(f"{self.name}: A not primitive")


TOPOLOGY_KINDS = ("erdos", "fedavg", "full", "grid", "ring", "scale_free",
                  "small_world")


def make_topology(kind: str, K: int, *, seed: int = 0, p: float = 0.3,
                  hops: int = 1, rows: int | None = None, m: int = 2,
                  rewire: float = 0.1) -> Topology:
    """Factory: ``kind`` in :data:`TOPOLOGY_KINDS`.

    ``m`` is the Barabási–Albert attachment count (``scale_free``);
    ``hops``/``rewire`` parameterize the Watts–Strogatz lattice
    (``small_world`` reuses the ring's per-side neighbor count).
    """
    if kind == "ring":
        adj = ring_adjacency(K, hops=hops)
        A = metropolis_weights(adj)
    elif kind == "grid":
        r = rows if rows is not None else int(np.floor(np.sqrt(K)))
        c = K // r
        if r * c != K:
            raise ValueError(f"grid: K={K} not divisible into {r} rows")
        adj = grid_adjacency(r, c)
        A = metropolis_weights(adj)
    elif kind == "full":
        adj = full_adjacency(K)
        A = metropolis_weights(adj)
    elif kind == "fedavg":
        adj = full_adjacency(K)
        A = averaging_matrix(K)
    elif kind == "erdos":
        adj = erdos_renyi_adjacency(K, p, seed=seed)
        A = metropolis_weights(adj)
    elif kind == "scale_free":
        adj = scale_free_adjacency(K, m=m, seed=seed)
        A = metropolis_weights(adj)
    elif kind == "small_world":
        adj = small_world_adjacency(K, hops=max(hops, 2), rewire=rewire,
                                    seed=seed)
        A = metropolis_weights(adj)
    else:
        raise ValueError(f"unknown topology kind {kind!r} — valid kinds: "
                         f"{list(TOPOLOGY_KINDS)}")
    topo = Topology(name=f"{kind}(K={K})", A=A, adjacency=adj)
    topo.validate()
    return topo
