"""Closed-form steady-state MSD (paper Theorem 5, eq. 190/77).

Counterpart of ``repro.core.msd``: the port's own numpy copy (it imports
numpy and the port's participation module, and the port's graphs where a
graph law is asked for), so the theory runs beside the port without JAX.

For quadratic risks (the paper's own experimental setting, eq. 81) the
Hessians are constant, so the long-term model (70) is *exact* and the
steady-state second moment solves a discrete Lyapunov equation.

Block recursion of the long-term error (paper eq. 161, sign-resolved):

    x_{i+1} = F_i x_i + u_i
    F_i = A_i^T P_i^T,                    P_i = I - M_i H   (T-th power)
    u_i = G_i (s-part) - G_i_b b,         G_i = A_i^T sum_{t=0}^{T-1} P_i^t M_i

with A_i the eq.(20) masked combination matrix, M_i the random step sizes,
H = blockdiag(H_k), b = col{-grad J_k(w^o)} ... we carry the explicit minus
sign of eq. (59) so the cross term is handled exactly.

The fixed point satisfies (vec = column-major):

    m_inf  = -(I - E[F])^{-1} E[G] b_vec
    vec(S_inf) = (I - E[F(x)F])^{-1} ( E[G(x)G] vec(b b^T)
                 - E[G(x)F] vec(m b^T) - E[F(x)G] vec(b m^T)
                 + sum_t E[(A^T P^t M)(x)(A^T P^t M)] vec(S_noise) )

    MSD = tr(S_inf) / K                                   (eq. 77)

Expectations over the activation mask are Monte-Carlo estimated (exact
enumeration is 2^K) with a deterministic seed; for K <= 12 we enumerate
exactly.  ``(x)`` denotes the Kronecker product (the paper's block-Kronecker
``(x)_b`` reduces to the ordinary Kronecker once everything is expressed on
the stacked KM-dimensional state, which is what we do).

Dynamic graphs (Theorem 5 over a
:class:`repro_torch.core.graphs.GraphProcess`):
the base matrix ``A`` generalizes to the LAW of the realized combination
matrix — a finite list of ``(weight, A_g)`` pairs built by
:func:`graph_matrix_law` — and every operator expectation runs over the
product law (graph draw x activation mask; the two are independent by
construction, the engines fold separate keys).  For
:class:`~repro_torch.core.graphs.LinkDropout` the law is EXACT: all 2^E
link up/down masks of the base edge set, each Metropolis-reweighted as the
process does (``corr > 0`` shares the stationary per-block
marginal, so the per-block expectations are exact but the block-to-block
independence Theorem 5 factorizes over is an approximation — bursty
outages correlate consecutive F_i draws).  Other processes fall back to a
deduplicated Monte-Carlo matrix law through the process's own ``sample``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable

import numpy as np

from repro_torch.core import participation as part

__all__ = ["QuadraticProblem", "theoretical_msd", "theoretical_curve",
           "mask_batches", "graph_matrix_law", "dp_injected_variance",
           "compressor_injected_variance"]


def dp_injected_variance(clip: float, noise_multiplier: float) -> float:
    """Per-coordinate gradient-noise variance injected by the DP tier.

    The privacy transform (:mod:`repro_torch.core.privacy`) adds
    ``N(0, (noise_multiplier * clip)^2)`` per coordinate to every agent's
    local-update gradient — i.i.d. across steps and agents, exactly the
    shape of the gradient-noise term Theorem 5 integrates through
    ``S_noise``.  Feed the result to ``theoretical_msd(...,
    injected_variance=...)`` (the clipping itself is ignored: at the
    steady state the true gradients are small against any sane ``clip``,
    so the transform is noise-dominated — the same regime DP-SGD analyses
    assume)."""
    return float(noise_multiplier * clip) ** 2


def compressor_injected_variance(kind: str, *, ratio: float = 1.0,
                                 sigma: float = 0.0,
                                 signal_power: float = 1.0,
                                 q: float | np.ndarray = 1.0):
    """Per-coordinate variance surrogate for an UNBIASED wire compressor.

    Unbiased compressors satisfy ``E||C(x) - x||^2 = omega ||x||^2`` with
    a kind-specific relative variance ``omega`` (rand-k with rescaling:
    ``1/ratio - 1``; the Gaussian mask adds ``sigma^2`` per kept
    coordinate on top of its rand-k core).  Theorem 5 sees the wire error
    as one more zero-mean noise source, entering the recursion where the
    gradient noise does — so the surrogate maps it onto the same
    ``S_noise`` injection with per-coordinate variance ``q * omega *
    signal_power`` (``signal_power`` = per-coordinate second moment of
    the wire payload; ``q`` weights by the participation rate, an
    inactive agent puts nothing on the wire).  Biased compressors (top-k,
    int8's EF-corrected path) are error-compensated — their steady-state
    wire error is not white and this surrogate does not apply.
    """
    if kind == "randk":
        omega = 1.0 / ratio - 1.0
    elif kind == "gauss":
        omega = (1.0 / ratio - 1.0) + sigma ** 2 / ratio
    else:
        raise ValueError(
            f"compressor kind {kind!r} has no unbiased-variance surrogate "
            "(randk|gauss are unbiased; topk/int8 run error feedback, "
            "whose steady-state wire error is not white noise)")
    return np.asarray(q, dtype=np.float64) * omega * float(signal_power)


@dataclasses.dataclass
class QuadraticProblem:
    """Per-agent ridge-regression risks (paper eq. 81).

    J_k(w) = (1/N_k) sum_n (d_n - u_n^T w)^2 + rho ||w||^2
    """

    U: list[np.ndarray]   # K arrays (N_k, M) of inputs
    d: list[np.ndarray]   # K arrays (N_k,) of outputs
    rho: float

    @property
    def num_agents(self) -> int:
        return len(self.U)

    @property
    def dim(self) -> int:
        return int(self.U[0].shape[1])

    # per-agent moments ----------------------------------------------------
    def R_u(self, k: int) -> np.ndarray:
        Uk = np.asarray(self.U[k], dtype=np.float64)
        return Uk.T @ Uk / Uk.shape[0]

    def r_du(self, k: int) -> np.ndarray:
        Uk = np.asarray(self.U[k], dtype=np.float64)
        dk = np.asarray(self.d[k], dtype=np.float64)
        return Uk.T @ dk / Uk.shape[0]

    def hessian(self, k: int) -> np.ndarray:
        """H_k = grad^2 J_k = 2 (R_{u,k} + rho I) — constant (quadratic)."""
        return 2.0 * (self.R_u(k) + self.rho * np.eye(self.dim))

    def grad(self, k: int, w: np.ndarray) -> np.ndarray:
        return self.hessian(k) @ w - 2.0 * self.r_du(k)

    def sample_grad(self, k: int, w: np.ndarray, n: int) -> np.ndarray:
        u = np.asarray(self.U[k][n], dtype=np.float64)
        d = float(self.d[k][n])
        return 2.0 * u * (u @ w - d) + 2.0 * self.rho * w

    # optimal models ---------------------------------------------------------
    def w_opt(self, q: np.ndarray | None = None) -> np.ndarray:
        """w^o of the (possibly drifted) problem eq. (27); q=None =>
        eq. (1)."""
        K = self.num_agents
        qv = np.ones(K) if q is None else np.asarray(q, dtype=np.float64)
        Hbar = sum(qv[k] * self.hessian(k) for k in range(K))
        rbar = sum(qv[k] * 2.0 * self.r_du(k) for k in range(K))
        return np.linalg.solve(Hbar, rbar)

    def grad_noise_cov(self, k: int, w: np.ndarray,
                       batch: int = 1) -> np.ndarray:
        """R_k = E[s s^T] at w for uniform single-sample gradients / batch."""
        g_full = self.grad(k, w)
        N = self.U[k].shape[0]
        S = np.zeros((self.dim, self.dim))
        for n in range(N):
            g = self.sample_grad(k, w, n) - g_full
            S += np.outer(g, g)
        return S / (N * batch)


def mask_batches(K: int, q: np.ndarray, num_samples: int, seed: int,
                 chunk: int = 64) -> Iterable[np.ndarray]:
    """Yield (chunk, K) activation-mask batches; exact enumeration for small K.

    For K <= 12 yields every mask with an attached probability weight encoded
    by repetition-free enumeration (handled by caller via weights); here we
    keep the MC path uniform: for small K we enumerate and the caller weights
    — to keep one code path we *always* MC sample, but with antithetic pairs
    for variance reduction.
    """
    rng = np.random.default_rng(seed)
    done = 0
    while done < num_samples:
        n = min(chunk, num_samples - done)
        u = rng.random((n, K))
        yield (u < q[None, :]).astype(np.float64)
        done += n


def _exact_masks(K: int, q: np.ndarray):
    """All 2^K masks and their probabilities (for K <= 12)."""
    masks = np.array(list(itertools.product([0.0, 1.0], repeat=K)))
    pm = np.prod(np.where(masks > 0.5, q[None, :], 1.0 - q[None, :]), axis=1)
    return masks, pm


def _metropolis_np(off_adj: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`repro_torch.core.graphs.
    metropolis_weights_torch` — same ``1 / (1 + max(deg_l, deg_k))`` rule,
    so the enumerated law reproduces the realized matrices."""
    off = np.asarray(off_adj, dtype=np.float64)
    deg = off.sum(axis=1)
    pair = np.maximum(deg[:, None], deg[None, :])
    W = off / (1.0 + pair)
    return W + np.diag(1.0 - W.sum(axis=0))


def graph_matrix_law(graph=None, *, A=None, max_edges: int = 12,
                     num_samples: int = 256, seed: int = 0):
    """The law of the realized combination matrix as ``[(weight, A_g)]``.

    * ``graph=None`` (or a static graph): the singleton ``[(1.0, A)]`` —
      Theorem 5 exactly as before.
    * :class:`~repro_torch.core.graphs.LinkDropout`: EXACT enumeration of
      all 2^E link up/down masks of the base edge set (requires ``E <=
      max_edges``), each realized adjacency Metropolis-reweighted with the
      same rule the process applies.  At ``drop = 0`` this
      collapses to the single base matrix, so the dynamic law degenerates
      to the static one exactly (gated in tests/test_msd_theory.py).
      ``corr > 0`` is handled through the stationary per-link marginal
      (up-probability ``1 - drop``): per-block expectations stay exact,
      block-to-block independence becomes an approximation.
    * any other process: deduplicated Monte-Carlo — ``num_samples`` draws
      through the process's own ``sample`` from a host
      ``torch.Generator`` seeded with ``seed``,
      identical realized matrices collapsed into one weighted atom (the
      gossip matching law on small graphs has few atoms, so this is
      near-exact at modest sample counts).
    """
    from repro_torch.core import graphs as graphs_lib  # local: msd is numpy
    if graph is None or isinstance(graph, graphs_lib.StaticGraph):
        if A is None and graph is None:
            raise ValueError("graph_matrix_law needs a graph or a matrix A")
        base = (A if A is not None
                else graph.base_matrix().cpu().numpy())
        return [(1.0, np.asarray(base, dtype=np.float64))]
    if isinstance(graph, graphs_lib.LinkDropout):
        off = graph._base_off.cpu().numpy().astype(np.float64)
        K = off.shape[0]
        iu, ju = np.nonzero(np.triu(off, k=1))
        E = len(iu)
        if E > max_edges:
            raise ValueError(
                f"LinkDropout law enumerates 2^E link masks but the base "
                f"graph has E={E} edges (> max_edges={max_edges}) — raise "
                "max_edges (cost doubles per edge) or use a smaller base "
                "graph")
        up = 1.0 - graph.drop
        law = []
        for bits in itertools.product((0, 1), repeat=E):
            w = float(np.prod([up if b else graph.drop for b in bits]))
            if w == 0.0:
                continue
            adj = np.zeros((K, K))
            for b, i, j in zip(bits, iu, ju):
                if b:
                    adj[i, j] = adj[j, i] = 1.0
            law.append((w, _metropolis_np(adj)))
        return law
    # generic fallback: MC through the process's own sampler, dedup exact
    # repeats (finite-support processes collapse to few atoms)
    import torch
    key = torch.Generator().manual_seed(seed)
    state = graph.init_state(key)
    atoms: dict[bytes, list] = {}
    for _ in range(num_samples):
        A_t, state = graph.sample(state, key)
        A_np = np.round(A_t.cpu().numpy().astype(np.float64), 9)
        k = A_np.tobytes()
        if k in atoms:
            atoms[k][0] += 1.0 / num_samples
        else:
            atoms[k] = [1.0 / num_samples, A_np]
    return [(w, Ag) for w, Ag in atoms.values()]


#: (mask, graph atom) terms accumulated by one matrix product each
_CHUNK = 128


def _kron_sum(w: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """``sum_n w_n kron(X_n, Y_n)`` for stacks X (n, a, b), Y (n, c, d):
    one (ab, n) x (n, cd) product, then the Kronecker index order."""
    n, a, b = X.shape
    _, c, d = Y.shape
    outer = (X.reshape(n, a * b) * w[:, None]).T @ Y.reshape(n, c * d)
    return (outer.reshape(a, b, c, d).transpose(0, 2, 1, 3)
            .reshape(a * c, b * d))


def _accumulate(acc: dict, terms: dict) -> None:
    """Add a chunk of weighted terms (``w``, ``F``, ``G``, and ``wN``,
    ``N`` for the noise terms) into the expectations in ``acc``, in
    place, and empty the chunk."""
    if not terms["w"]:
        return
    w = np.asarray(terms["w"])
    F, G = np.stack(terms["F"]), np.stack(terms["G"])
    acc["EF"] += np.tensordot(w, F, 1)
    acc["EG"] += np.tensordot(w, G, 1)
    acc["EFF"] += _kron_sum(w, F, F)
    acc["EGG"] += _kron_sum(w, G, G)
    acc["EGF"] += _kron_sum(w, G, F)
    acc["EFG"] += _kron_sum(w, F, G)
    N = np.stack(terms["N"])
    acc["ENN"] += _kron_sum(np.asarray(terms["wN"]), N, N)
    for v in terms.values():
        v.clear()


def _mask_expectation_operators(problem: QuadraticProblem, *, A: np.ndarray,
                                q: np.ndarray, mu: float, T: int,
                                batch: int = 1,
                                drift_correction: bool = False,
                                num_mask_samples: int = 400, seed: int = 0,
                                exact_threshold: int = 12,
                                A_law=None, injected_variance=None) -> dict:
    """All Theorem-5 operators: E[F], E[G], E[F⊗F], E[G⊗G], E[G⊗F],
    E[F⊗G], Σ_t E[N_t⊗N_t], plus H, b, S_noise, w_o.

    ``A_law`` (a ``[(weight, A_g)]`` list from :func:`graph_matrix_law`)
    replaces the static ``A`` with the realized-matrix law; expectations
    run over the independent product with the activation-mask law."""
    K = problem.num_agents
    M = problem.dim
    KM = K * M
    q = np.asarray(q, dtype=np.float64)
    I_M = np.eye(M)
    I_KM = np.eye(KM)

    w_o = problem.w_opt(None if drift_correction else q)
    H = np.zeros((KM, KM))
    b = np.zeros(KM)
    S_noise = np.zeros((KM, KM))
    # extra per-agent white noise riding the gradient-noise channel —
    # the DP tier's clip+Gaussian transform and the unbiased-compressor
    # surrogate both land here (see dp_injected_variance /
    # compressor_injected_variance)
    v_inj = np.zeros(K)
    if injected_variance is not None:
        v_inj = np.broadcast_to(
            np.asarray(injected_variance, dtype=np.float64), (K,)).copy()
        if (v_inj < 0).any():
            raise ValueError("injected_variance must be nonnegative")
    for k in range(K):
        sl = slice(k * M, (k + 1) * M)
        H[sl, sl] = problem.hessian(k)
        b[sl] = -problem.grad(k, w_o)                      # eq. (58)
        S_noise[sl, sl] = (problem.grad_noise_cov(k, w_o, batch)
                           + v_inj[k] * I_M)

    # expectations over the activation mask ---------------------------------
    EF = np.zeros((KM, KM))
    EG = np.zeros((KM, KM))
    EFF = np.zeros((KM * KM, KM * KM))
    EGG = np.zeros_like(EFF)
    EGF = np.zeros_like(EFF)
    EFG = np.zeros_like(EFF)
    ENN = np.zeros_like(EFF)

    if K <= exact_threshold:
        masks, weights = _exact_masks(K, q)
        batches = [(masks, weights)]
    else:
        batches = [(m, np.full(m.shape[0], 1.0 / num_mask_samples))
                   for m in mask_batches(K, q, num_mask_samples, seed)]

    if A_law is None:
        A_law = [(1.0, np.asarray(A, dtype=np.float64))]

    # the (mask, graph atom) terms are gathered in chunks, and each chunk's
    # expectations of Kronecker products are summed by one matrix product
    # (:func:`_accumulate`), not by one kron a term
    acc = {"EF": EF, "EG": EG, "EFF": EFF, "EGG": EGG, "EGF": EGF,
           "EFG": EFG, "ENN": ENN}
    terms: dict[str, list] = {"w": [], "F": [], "G": [], "wN": [], "N": []}
    for masks_b, w_b in batches:
        for mask, wgt in zip(masks_b, w_b):
            # the local-update factors depend on the mask only — hoist
            # them out of the graph-law loop
            mus = mu * mask / q if drift_correction else mu * mask
            Mi = np.kron(np.diag(mus), I_M)
            P = I_KM - Mi @ H
            # powers of P: P^t for t = 0..T
            Pt = [I_KM]
            for _ in range(T):
                Pt.append(Pt[-1] @ P)
            PT = Pt[T]
            Psum_M = sum(Pt[t] for t in range(T)) @ Mi
            PtM = [Pt[t] @ Mi for t in range(T)]
            for g_w, A_g in A_law:
                w = wgt * g_w
                A_i = part.masked_combination_np(A_g, mask)
                Ai = np.kron(A_i.T, I_M)                   # (A_i^T (x) I_M)
                terms["w"].append(w)
                terms["F"].append(Ai @ PT)
                terms["G"].append(Ai @ Psum_M)
                for t in range(T):
                    terms["wN"].append(w)
                    terms["N"].append(Ai @ PtM[t])
                if len(terms["w"]) >= _CHUNK:
                    _accumulate(acc, terms)
    _accumulate(acc, terms)

    # steady-state mean (paper eq. 175) --------------------------------------
    m_inf = -np.linalg.solve(I_KM - EF, EG @ b)

    # steady-state second moment (Lyapunov fixed point) ----------------------
    def vecc(X):
        return X.flatten(order="F")

    # cross terms: E[F x u^T] = -E[F m b^T G^T]  =>  -(G (x) F) vec(m b^T)
    #              E[u x^T F^T] = -E[G b m^T F^T] => -(F (x) G) vec(b m^T)
    rhs = (EGG @ vecc(np.outer(b, b))
           - EGF @ vecc(np.outer(m_inf, b))
           - EFG @ vecc(np.outer(b, m_inf))
           + ENN @ vecc(S_noise))
    # note: vec(F m b^T G^T) = (G (x) F) vec(m b^T); cross terms carry -1 from
    # u_i's bias part -G b.
    lhs = np.eye(KM * KM) - EFF
    vec_S = np.linalg.solve(lhs, rhs)
    S_inf = vec_S.reshape(KM, KM, order="F")

    rho_EFF = (float(np.max(np.abs(np.linalg.eigvals(EFF)))) if KM <= 60
               else float("nan"))
    return {
        "msd": float(np.trace(S_inf) / K),
        "w_opt": w_o,
        "m_inf": m_inf,
        "S_inf": S_inf,
        "rho_EFF": rho_EFF,
        "ops": {"EF": EF, "EG": EG, "EFF": EFF, "EGG": EGG, "EGF": EGF,
                "EFG": EFG, "ENN": ENN, "b": b, "S_noise": S_noise,
                "K": K, "M": M},
    }


def theoretical_msd(problem: QuadraticProblem, *, A: np.ndarray | None = None,
                    q: np.ndarray, mu: float, T: int, batch: int = 1,
                    drift_correction: bool = False,
                    num_mask_samples: int = 400, seed: int = 0,
                    exact_threshold: int = 12, graph=None,
                    max_graph_edges: int = 12,
                    num_graph_samples: int = 256,
                    injected_variance=None) -> dict:
    """Evaluate Theorem 5's MSD for a quadratic problem.

    With the default ``graph=None`` this is the static Theorem 5 over the
    base matrix ``A``.  Passing a :class:`repro_torch.core.graphs.GraphProcess`
    evaluates the dynamic-graph law instead: every operator expectation
    runs over the product of the activation-mask law and the realized-
    matrix law from :func:`graph_matrix_law` (exact for LinkDropout with
    ``E <= max_graph_edges`` base edges, deduplicated MC with
    ``num_graph_samples`` draws otherwise — see that function for the
    ``corr > 0`` caveat).  ``A`` is then optional (defaults to the
    process's base matrix, used only for w_opt-independent bookkeeping).

    ``injected_variance`` (scalar or (K,), per-coordinate) adds extra
    per-agent white noise to the gradient-noise covariance ``S_noise`` —
    the surrogate channel for the DP tier's Gaussian perturbation
    (:func:`dp_injected_variance`) and for unbiased wire compressors
    (:func:`compressor_injected_variance`): both enter the long-term
    recursion exactly where the gradient noise does, so the predicted MSD
    rises linearly in the injected variance at fixed operators.

    Returns dict with msd, w_opt, m_inf (steady-state mean error), the
    spectral radius of E[F (x) F] (sanity: < 1 for stability), and the
    raw mask-expectation operators for transient analysis.
    """
    A_law = None
    if graph is not None:
        A_law = graph_matrix_law(graph, A=A, max_edges=max_graph_edges,
                                 num_samples=num_graph_samples, seed=seed)
        if A is None:
            A = A_law[0][1]
    elif A is None:
        raise ValueError("theoretical_msd needs A= (static) or graph= "
                         "(dynamic law)")
    return _mask_expectation_operators(
        problem, A=A, q=q, mu=mu, T=T, batch=batch,
        drift_correction=drift_correction,
        num_mask_samples=num_mask_samples, seed=seed,
        exact_threshold=exact_threshold, A_law=A_law,
        injected_variance=injected_variance)


def theoretical_curve(theory: dict, w0: np.ndarray,
                      num_blocks: int) -> np.ndarray:
    """Predicted learning curve MSD_i = (1/K) E||w_iT - w^o||^2 (transient).

    Iterates the exact mean/second-moment recursions of the long-term model
    from the deterministic initial condition ``w0`` (each agent starts at
    w0): this extends the paper's steady-state Theorem 5 to the full
    trajectory (same operators, no extra assumptions).
    """
    ops = theory["ops"]
    K, M = ops["K"], ops["M"]
    KM = K * M
    b, S_noise = ops["b"], ops["S_noise"]

    def vecc(X):
        return X.flatten(order="F")

    w_tilde0 = np.tile(theory["w_opt"] - np.asarray(w0, dtype=np.float64), K)
    m = w_tilde0.copy()
    Sigma = np.outer(m, m)
    vS = vecc(Sigma)
    vbb = vecc(np.outer(b, b))
    vSn = vecc(S_noise)
    out = np.empty(num_blocks)
    for i in range(num_blocks):
        out[i] = np.trace(vS.reshape(KM, KM, order="F")) / K
        rhs = (ops["EGG"] @ vbb
               - ops["EGF"] @ vecc(np.outer(m, b))
               - ops["EFG"] @ vecc(np.outer(b, m))
               + ops["ENN"] @ vSn)
        vS = ops["EFF"] @ vS + rhs
        m = ops["EF"] @ m - ops["EG"] @ b
    return out
