"""Device graphs for CD-BFL and their gossip schedules (numpy, copied).

A copy of ``repro/core/topology.py``: the nine graph families of
:data:`GRAPHS`, all connectivity-repaired so Ω is always ergodic; the
Metropolis-Hastings / max-degree weights (Xiao & Boyd '04); the spectral
diagnostics; and the decomposition of a sparse symmetric Ω into a diagonal
plus edge matchings, each an involutive permutation, which
``core/gossip.py`` executes (with a circulant fast path of rolls). The
arithmetic and the draws of ``numpy.random`` are the reference's, so the
adjacency, Ω, perms, weights, shifts and coefficients are bit-identical to
its for the same config and ``seed``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config import TopologyConfig

GRAPHS = ("full", "ring", "chain", "star", "grid", "torus", "k_regular",
          "erdos_renyi", "geometric")


# --------------------------------------------------------------------------
# Graph generators (0/1 adjacency, no self loops, always connected)
# --------------------------------------------------------------------------

def _components(a: np.ndarray) -> List[List[int]]:
    k = a.shape[0]
    seen = np.zeros(k, dtype=bool)
    comps = []
    for s in range(k):
        if seen[s]:
            continue
        stack, comp = [s], []
        seen[s] = True
        while stack:
            i = stack.pop()
            comp.append(i)
            for j in np.nonzero(a[i])[0]:
                if not seen[j]:
                    seen[j] = True
                    stack.append(int(j))
        comps.append(sorted(comp))
    return comps


def _repair_connectivity(a: np.ndarray,
                         pos: Optional[np.ndarray] = None) -> np.ndarray:
    """Bridge disconnected components (closest pair when positions exist).

    A radio deployment would re-plan an isolated node rather than run a
    diverging consensus; repairing keeps every generated Ω ergodic.
    """
    comps = _components(a)
    while len(comps) > 1:
        c0, c1 = comps[0], comps[1]
        if pos is not None:
            d = np.linalg.norm(pos[c0][:, None, :] - pos[c1][None, :, :],
                               axis=-1)
            i0, i1 = np.unravel_index(np.argmin(d), d.shape)
            i, j = c0[i0], c1[i1]
        else:
            i, j = c0[0], c1[0]
        a[i, j] = a[j, i] = 1.0
        comps = [sorted(c0 + c1)] + comps[2:]
    return a


def _grid_adjacency(k: int, wrap: bool) -> np.ndarray:
    """2D lattice on an r×c factorization of k (square when possible)."""
    r = int(np.sqrt(k))
    while r > 1 and k % r:
        r -= 1
    c = k // r
    if r == 1 and k > 3:
        import warnings
        warnings.warn(
            f"{'torus' if wrap else 'grid'} with k={k} (prime) factorizes "
            f"as 1×{k} and degenerates to a {'ring' if wrap else 'chain'}",
            stacklevel=3)
    a = np.zeros((k, k), dtype=np.float64)
    for i in range(k):
        rr, cc = divmod(i, c)
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nr, nc = rr + dr, cc + dc
            if wrap:
                nr, nc = nr % r, nc % c
            elif not (0 <= nr < r and 0 <= nc < c):
                continue
            j = nr * c + nc
            if j != i:
                a[i, j] = a[j, i] = 1.0
    return a


def graph_adjacency(graph: str, k: int, *, degree: int = 4,
                    edge_prob: float = 0.3, radius: float = 0.45,
                    seed: int = 0) -> np.ndarray:
    """0/1 adjacency for any supported family (connected, no self loops)."""
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    a = np.zeros((k, k), dtype=np.float64)
    if k == 1:
        return a
    if graph == "full":
        a = np.ones((k, k)) - np.eye(k)
    elif graph == "ring":
        for i in range(k):
            a[i, (i + 1) % k] = a[i, (i - 1) % k] = 1.0
    elif graph == "chain":
        for i in range(k - 1):
            a[i, i + 1] = a[i + 1, i] = 1.0
    elif graph == "star":
        a[0, 1:] = a[1:, 0] = 1.0
    elif graph == "grid":
        a = _grid_adjacency(k, wrap=False)
    elif graph == "torus":
        a = _grid_adjacency(k, wrap=True)
    elif graph == "k_regular":
        # circulant: neighbors at offsets ±1..±d/2 (d even, clipped to k-1)
        d = max(2, min(degree, k - 1))
        d -= d % 2
        half = max(1, d // 2)
        for i in range(k):
            for s in range(1, half + 1):
                a[i, (i + s) % k] = a[i, (i - s) % k] = 1.0
    elif graph == "erdos_renyi":
        rng = np.random.default_rng(seed)
        up = rng.random((k, k)) < edge_prob
        a = np.triu(up, 1).astype(np.float64)
        a = a + a.T
        a = _repair_connectivity(a)
    elif graph == "geometric":
        rng = np.random.default_rng(seed)
        pos = rng.random((k, 2))
        d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
        a = ((d <= radius) & ~np.eye(k, dtype=bool)).astype(np.float64)
        a = _repair_connectivity(a, pos)
    else:
        raise ValueError(f"unknown graph {graph!r}; known: {GRAPHS}")
    return a


# --------------------------------------------------------------------------
# Mixing weights + spectral diagnostics
# --------------------------------------------------------------------------

def mixing_weights(adj: np.ndarray, rule: str = "metropolis") -> np.ndarray:
    """Symmetric doubly-stochastic Ω from an adjacency (Xiao & Boyd '04)."""
    k = adj.shape[0]
    if k == 1:
        return np.ones((1, 1))
    deg = adj.sum(axis=1)
    w = np.zeros_like(adj, dtype=np.float64)
    if rule == "metropolis":
        nz = np.nonzero(adj)
        w[nz] = 1.0 / (1.0 + np.maximum(deg[nz[0]], deg[nz[1]]))
    elif rule in ("max_degree", "uniform"):
        # uniform is only doubly stochastic on regular graphs; same formula
        w = adj / (deg.max() + 1.0)
    else:
        raise ValueError(f"unknown mixing rule {rule!r}")
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def lambda2(omega: np.ndarray) -> float:
    """Second-largest eigenvalue modulus |λ₂| (CHOCO-bound quantity)."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(omega)))[::-1]
    return float(ev[1]) if len(ev) > 1 else 0.0


def spectral_gap(omega: np.ndarray) -> float:
    """1 - |λ₂|: governs consensus speed (Ω^t x → x̄ at rate |λ₂|^t)."""
    return 1.0 - lambda2(omega)


# --------------------------------------------------------------------------
# Topology: one built graph + its Ω and diagnostics
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Topology:
    """Materialized graph for one :class:`TopologyConfig`: adjacency, Ω, spectral gap, schedule. Pure in the config — same config (and ``topo_seed``), same adjacency and Ω bits."""
    config: TopologyConfig
    k: int
    adjacency: np.ndarray           # (K, K) 0/1, symmetric, hollow
    omega: np.ndarray               # (K, K) symmetric doubly stochastic

    @property
    def max_degree(self) -> int:
        return int(self.adjacency.sum(axis=1).max()) if self.k > 1 else 0

    @property
    def num_edges(self) -> int:
        return int(self.adjacency.sum() // 2)

    @property
    def lambda2(self) -> float:
        return lambda2(self.omega)

    @property
    def spectral_gap(self) -> float:
        return spectral_gap(self.omega)

    def describe(self) -> str:
        return (f"{self.config.graph}(K={self.k}, deg≤{self.max_degree}, "
                f"|E|={self.num_edges}, gap={self.spectral_gap:.4f})")


def build_topology(cfg: TopologyConfig, k: int) -> Topology:
    adj = graph_adjacency(cfg.graph, k, degree=cfg.degree,
                          edge_prob=cfg.edge_prob, radius=cfg.radius,
                          seed=cfg.seed)
    return Topology(config=cfg, k=k, adjacency=adj,
                    omega=mixing_weights(adj, cfg.rule))


def resolve_topology(fed_cfg) -> TopologyConfig:
    """TopologyConfig from a FedConfig (or duck-typed equivalent).

    ``topology_cfg`` wins when present; otherwise the legacy string fields
    map onto a static TopologyConfig.
    """
    tc = getattr(fed_cfg, "topology_cfg", None)
    if tc is not None:
        return tc
    return TopologyConfig(graph=getattr(fed_cfg, "topology", "full"),
                          rule=getattr(fed_cfg, "mixing", "metropolis"),
                          seed=getattr(fed_cfg, "seed", 0))


# --------------------------------------------------------------------------
# Schedule decomposition: Ω = diag + Σ_m (matching permutation)
# --------------------------------------------------------------------------

def circulant_coefficients(omega: np.ndarray,
                           atol: float = 1e-12) -> Optional[np.ndarray]:
    """c with Ω[i,j] = c[(j-i) mod K] when Ω is circulant, else None."""
    k = omega.shape[0]
    c = omega[0]
    for i in range(1, k):
        if not np.allclose(omega[i], np.roll(c, i), atol=atol):
            return None
    return c.copy()


def edge_matchings(adj: np.ndarray) -> List[List[Tuple[int, int]]]:
    """Greedy edge coloring: partition E into ≤ 2·deg-1 matchings.

    Each matching is a set of vertex-disjoint edges, i.e. an involutive
    permutation of the nodes; Vizing guarantees deg+1 colors exist and the
    greedy pass stays within 2·deg-1 (in practice ~deg for these families).
    """
    k = adj.shape[0]
    edges = [(i, j) for i in range(k) for j in range(i + 1, k) if adj[i, j]]
    matchings: List[List[Tuple[int, int]]] = []
    used: List[set] = []
    for (i, j) in edges:
        for m, u in enumerate(used):
            if i not in u and j not in u:
                matchings[m].append((i, j))
                u.update((i, j))
                break
        else:
            matchings.append([(i, j)])
            used.append({i, j})
    return matchings


@dataclass(frozen=True)
class MixSchedule:
    """Static decomposition of a sparse symmetric doubly-stochastic Ω.

    General form (always valid):
        Ω x = x + Σ_m w_m ⊙ (x[perm_m] - x)
    where ``perm_m`` is the involutive permutation of matching m and
    ``w_m[i] = Ω[i, perm_m[i]]`` (0 on fixed points). The Laplacian form is
    what makes time variation safe: masking any subset of edges
    symmetrically leaves the realized Ω_t symmetric doubly stochastic.

    The diagonal of Ω is implicit in both executions (the Laplacian form
    keeps ``x`` and subtracts edge weights; the circulant path carries it
    as the shift-0 coefficient), so only the matchings are stored.

    Circulant fast path: when Ω[i,j] depends only on (j-i) mod K,
    ``shifts``/``coeffs`` hold the equivalent ``Σ_s c_s·roll(x, -s)``.

    Deterministic in Ω: the greedy coloring uses no RNG, so the matching decomposition is reproducible.
    """
    k: int
    perms: np.ndarray               # (M, K) int32, each row an involution
    weights: np.ndarray             # (M, K) float32, per-node edge weight
    shifts: Optional[Tuple[int, ...]] = None
    coeffs: Optional[Tuple[float, ...]] = None

    @property
    def num_perms(self) -> int:
        return int(self.perms.shape[0])

    def wire_bytes(self, payload_bytes: float) -> float:
        """Per-node per-round wire bytes: one payload per active matching
        (each lowers to one collective-permute) — O(deg·p), vs the dense
        all-gather's (K-1)·payload."""
        return float(self.num_perms) * float(payload_bytes)


def dense_wire_bytes(k: int, payload_bytes: float) -> float:
    """Per-node wire bytes of the dense-Ω all-gather: (K-1)·payload."""
    return float(max(0, k - 1)) * float(payload_bytes)


def build_schedule(omega: np.ndarray, atol: float = 1e-8) -> MixSchedule:
    """Decompose Ω; verifies the reconstruction matches Ω exactly."""
    om = np.asarray(omega, dtype=np.float64)
    k = om.shape[0]
    if not np.allclose(om, om.T, atol=atol):
        raise ValueError("Ω must be symmetric")
    if not np.allclose(om.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("Ω must be doubly stochastic")
    adj = (np.abs(om) > atol) & ~np.eye(k, dtype=bool)
    ms = edge_matchings(adj.astype(np.float64))
    perms = np.tile(np.arange(k, dtype=np.int32), (max(len(ms), 1), 1))
    weights = np.zeros((max(len(ms), 1), k), dtype=np.float32)
    if not ms:   # K=1 or fully disconnected: identity mix
        perms = perms[:0]
        weights = weights[:0]
    for m, edges in enumerate(ms):
        for (i, j) in edges:
            perms[m, i], perms[m, j] = j, i
            weights[m, i] = weights[m, j] = om[i, j]
    # verify: diag + Σ_m matching terms reconstructs Ω
    rec = np.diag(np.diag(om)).astype(np.float64)
    for m in range(len(ms)):
        for i in range(k):
            j = perms[m, i]
            if j != i:
                rec[i, j] += weights[m, i]
    if not np.allclose(rec, om, atol=1e-6):
        raise AssertionError("schedule decomposition failed to reconstruct Ω")

    c = circulant_coefficients(om)
    shifts = coeffs = None
    if c is not None:
        nz = [s for s in range(k) if abs(c[s]) > atol or s == 0]
        shifts = tuple(nz)
        coeffs = tuple(float(c[s]) for s in nz)
    return MixSchedule(k=k, perms=perms, weights=weights,
                       shifts=shifts, coeffs=coeffs)
