"""Differential-privacy tier: clip-and-noise, RDP accounting, secure-agg.

Counterpart of ``repro.core.privacy``, with its three pillars:

1. **Per-agent clip-then-Gaussian-noise** (:class:`PrivateGradients`) on
   the engines' ``grad_transform`` seam, the seam the Byzantine attacks
   use.  The composition order is the reference's (``repro.api.build``;
   here ``repro_torch.launch.train``):

       raw grads -> attack corrupts -> privacy clips + noises -> optimizer

2. **An RDP accountant** (:meth:`Privacy.advance` /
   :meth:`Privacy.epsilon`) whose state lives in
   ``EngineState.privacy_state``.  Each block adds the Renyi divergence of
   the subsampled Gaussian mechanism at the *realized* participation rate
   ``mean(active)``, over a fixed integer orders grid (Mironov et al.
   2019, eq. 3):

       A(alpha) = sum_k C(alpha,k) (1-q)^(alpha-k) q^k
                  exp((k^2 - k) / (2 sigma^2))
       rdp(alpha) += T * log A(alpha) / (alpha - 1)

   with ``T`` the local steps of a block: the mechanism fires at every
   local step with fresh noise.  The numpy twins (:func:`rdp_increment_np`,
   :func:`epsilon_from_rdp_np`, :func:`calibrate_noise_multiplier`) are the
   reference's, verbatim; :meth:`Privacy.advance` is their float32 twin in
   one vectorised pass (a padded (orders, max order + 1) log-term table and
   one ``logsumexp``).  (epsilon, delta) follows Balle et al. 2020.

3. **Pairwise-canceling secure-aggregation masks** (:func:`make_secure_agg`)
   as the identity-mode stage of :class:`repro_torch.core.mixing.
   CommPipeline`: for each receiver, consecutive live senders share a
   Gaussian mask, and each sender ships ``A_eff[j, k] x_j + eta_j -
   eta_prev(j)``.  ``prev`` is a bijection on the live set, so the masks
   telescope to zero and the combination stays exact up to float
   accumulation.

Random streams.  torch cannot replay JAX's threefry keys.  The gradient
noise of local step ``t`` comes from one generator on the gradients' device
seeded by ``(seed, t)`` (as :mod:`repro_torch.core.attacks` seeds its
noise adversary), leaf after leaf; the masks of block ``t`` from one
generator on the parameters' device seeded by ``(seed, t, 0x5EC)``, tile
after tile.  For replay, both take the reference's realized normals
instead (:class:`repro_torch.core.compression.Draws`).  The counters are
0-d int64 tensors on the host, so reading them costs no device sync.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import compression as comp_lib
from repro_torch.core import participation as part
from repro_torch.device import resolve_device
from repro_torch.optim import GradTransform, sgd
from repro_torch.sharding.agents import current_shard
from repro_torch.tree import tree_leaves, tree_unflatten

PyTree = Any

__all__ = [
    "DEFAULT_ORDERS",
    "MASK_TILE_ELEMS",
    "Privacy",
    "PrivateGradients",
    "clip_and_noise",
    "compile_privacy",
    "calibrate_noise_multiplier",
    "rdp_increment_np",
    "epsilon_from_rdp_np",
    "make_secure_agg",
    "mask_generator",
    "mask_tiles",
    "noise_generator",
    "predecessors",
]

#: integer RDP orders — dense where the subsampled-Gaussian optimum
#: usually lives, sparse tail for tiny-epsilon / large-noise regimes
DEFAULT_ORDERS = tuple(range(2, 65)) + (80, 96, 128, 160, 192, 256, 384, 512)

#: float32 elements of one (K, K, C) mask tile of the secure-agg stage
#: (256 MiB); the stage holds a few tensors of this size at once
MASK_TILE_ELEMS = 1 << 26

# the mask stream's tag beside (seed, block) in its generator's seed
_MASK_TAG = 0x5EC


# ---------------------------------------------------------------------------
# RDP of the sampled Gaussian mechanism (integer orders): numpy twins
# ---------------------------------------------------------------------------

def _order_constants(alpha: int, sigma: float) -> np.ndarray:
    """The q-independent part of the log-terms of A(alpha): per k in
    0..alpha, ``log C(alpha, k) + (k^2 - k) / (2 sigma^2)``."""
    ks = np.arange(alpha + 1, dtype=np.float64)
    logc = (math.lgamma(alpha + 1)
            - np.array([math.lgamma(k + 1) + math.lgamma(alpha - k + 1)
                        for k in range(alpha + 1)]))
    return logc + (ks * ks - ks) / (2.0 * sigma * sigma)


def rdp_increment_np(q: float, sigma: float,
                     orders=DEFAULT_ORDERS) -> np.ndarray:
    """One invocation's per-order RDP of the Poisson-subsampled Gaussian
    mechanism at sampling rate ``q`` and noise multiplier ``sigma``."""
    q = float(min(max(q, 0.0), 1.0))
    out = np.zeros(len(orders), dtype=np.float64)
    for i, alpha in enumerate(orders):
        ks = np.arange(alpha + 1, dtype=np.float64)
        terms = _order_constants(alpha, sigma)
        with np.errstate(divide="ignore", invalid="ignore"):
            a = np.where(ks == 0, 0.0, ks * np.log(q))
            b = np.where(ks == alpha, 0.0, (alpha - ks) * np.log1p(-q))
        terms = terms + a + b
        m = terms.max()
        if not np.isfinite(m):
            out[i] = 0.0
            continue
        out[i] = (m + np.log(np.exp(terms - m).sum())) / (alpha - 1)
    return out


def epsilon_from_rdp_np(rdp: np.ndarray, delta: float,
                        orders=DEFAULT_ORDERS) -> float:
    """(epsilon, delta)-DP implied by accumulated per-order RDP
    (Balle et al. 2020 conversion, min over orders, clamped at 0)."""
    a = np.asarray(orders, dtype=np.float64)
    rdp = np.asarray(rdp, dtype=np.float64)
    eps = rdp + np.log((a - 1.0) / a) - (np.log(delta) + np.log(a)) / (a - 1.0)
    return float(max(eps.min(), 0.0))


def calibrate_noise_multiplier(epsilon: float, delta: float, q: float,
                               steps: int,
                               orders=DEFAULT_ORDERS) -> float:
    """Smallest noise multiplier whose spent epsilon after ``steps``
    mechanism invocations (blocks x local steps) at participation rate
    ``q`` stays <= ``epsilon`` (bisection; epsilon falls as sigma grows)."""
    if epsilon <= 0:
        raise ValueError(f"epsilon={epsilon} must be > 0 to calibrate")

    def spent(sigma):
        return epsilon_from_rdp_np(
            steps * rdp_increment_np(q, sigma, orders), delta, orders)

    lo, hi = 1e-2, 1.0
    while spent(hi) > epsilon:
        hi *= 2.0
        if hi > 1e6:
            raise ValueError(
                f"cannot reach epsilon={epsilon} at delta={delta} over "
                f"{steps} mechanism invocations (rate q={q}) with any "
                "reasonable noise multiplier — raise the budget or "
                "shorten the run")
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if spent(mid) > epsilon:
            lo = mid
        else:
            hi = mid
    return hi


# ---------------------------------------------------------------------------
# clip-then-noise gradient transform (the grad_transform seam)
# ---------------------------------------------------------------------------

def noise_generator(seed: int, t: int, device) -> torch.Generator:
    """The generator of local step ``t``'s gradient noise on ``device``:
    one seed per (seed, t)."""
    return comp_lib.seeded_generator(device, seed, t)


def mask_generator(seed: int, t: int, device) -> torch.Generator:
    """The generator of block ``t``'s secure-agg masks on ``device``."""
    return comp_lib.seeded_generator(device, seed, t, _MASK_TAG)


def clip_and_noise(grads: PyTree, key, *, clip: float,
                   noise_multiplier: float) -> PyTree:
    """Per-agent global-L2 clip to ``clip``, then i.i.d. Gaussian noise of
    std ``noise_multiplier * clip`` on every coordinate.  Leaves are
    stacked (K, ...); the norm is per agent across all leaves, summed in
    float32.  The scale ``min(1, clip / |g|)`` is rounded to each leaf's
    dtype before the multiply, and the noise is drawn in float32, scaled,
    then cast, as the reference orders them.

    ``key`` is a ``torch.Generator`` (leaf ``i``'s standard normals are its
    ``i``-th draw) or :class:`~repro_torch.core.compression.Draws` whose
    ``noise[i]`` is leaf ``i``'s (replay).  With ``noise_multiplier == 0``
    nothing is drawn."""
    leaves = tree_leaves(grads)
    K = leaves[0].shape[0]
    sq = torch.zeros((K,), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        sq = sq + torch.sum(leaf.float().reshape(K, -1) ** 2, dim=1)
    scale = torch.clamp(clip / torch.sqrt(torch.clamp(sq, min=1e-24)),
                        max=1.0)
    std = noise_multiplier * clip
    out = []
    for i, leaf in enumerate(leaves):
        s = scale.reshape((K,) + (1,) * (leaf.ndim - 1)).to(leaf.dtype)
        clipped = leaf * s
        if std:
            normal = comp_lib._draw(key, "noise", i, leaf.shape, leaf.device)
            clipped = clipped + (std * normal).to(leaf.dtype)
        out.append(clipped)
    return tree_unflatten(grads, out)


class PrivateGradients:
    """GradTransform-protocol wrapper: clip + noise, then the inner
    transform.  State is ``{"t": counter, "inner": inner_state}``; the
    counter is a 0-d int64 host tensor advanced in place, one per local
    step, and seeds that step's noise (:func:`noise_generator`).

    ``noise``: optional ``noise(t) -> key`` giving local step ``t``'s draws
    in place of the port's stream, a generator or injected
    :class:`~repro_torch.core.compression.Draws` (replay of the reference's
    ``normal(fold_in(fold_in(PRNGKey(seed), t), i))``)."""

    def __init__(self, clip: float, noise_multiplier: float, seed: int = 0,
                 inner: GradTransform | None = None,
                 noise: Callable[[int], Any] | None = None):
        if clip <= 0:
            raise ValueError(f"clip={clip} must be > 0")
        if noise_multiplier < 0:
            raise ValueError(
                f"noise_multiplier={noise_multiplier} must be >= 0")
        self.clip = float(clip)
        self.noise_multiplier = float(noise_multiplier)
        self.seed = int(seed)
        self.inner = inner if inner is not None else sgd()
        self.noise = noise

    def init(self, params: PyTree) -> PyTree:
        return {"t": torch.zeros((), dtype=torch.int64),
                "inner": self.inner.init(params)}

    def update(self, grads: PyTree, state: PyTree, params: PyTree):
        if state is None:
            raise ValueError(
                "PrivateGradients needs its counter state; build opt_state "
                "with engine.optimizer.init(params) (the composed privacy "
                "transform replaces the optimizer surface)")
        t = int(state["t"])
        key = (self.noise(t) if self.noise is not None else
               noise_generator(self.seed, t, tree_leaves(grads)[0].device))
        shard = current_shard()
        if shard is not None:
            # agent-sharded local updates: the noise of all K rows, sliced
            key = shard.draws(key)
        noised = clip_and_noise(grads, key, clip=self.clip,
                                noise_multiplier=self.noise_multiplier)
        updates, inner_state = self.inner.update(noised, state["inner"],
                                                 params)
        state["t"].add_(1)
        state["inner"] = inner_state
        return updates, state

    def as_transform(self) -> GradTransform:
        return GradTransform(init=self.init, update=self.update)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PrivateGradients(clip={self.clip}, "
                f"noise_multiplier={self.noise_multiplier})")


# ---------------------------------------------------------------------------
# secure-aggregation wire masks (CommPipeline stage)
# ---------------------------------------------------------------------------

def predecessors(live: np.ndarray) -> np.ndarray:
    """``prev[k, i]``: the nearest live sender strictly before ``i``,
    cyclically, within receiver ``k``'s live set (``live[k, j]``: j sends
    to k), as the reference's ``argmin`` over cyclic distances: distance 0
    counts as K (an agent is its own predecessor only as the sole live
    sender), non-live entries as K + 1, and ties take the first index (an
    empty live set gives 0)."""
    live = np.asarray(live, dtype=bool)
    K = live.shape[0]
    idx = np.arange(K)
    dist = (idx[:, None] - idx[None, :]) % K
    dist = np.where(dist == 0, K, dist)
    dd = np.where(live[:, None, :], dist[None, :, :], K + 1)
    return np.argmin(dd, axis=-1)


def mask_tiles(num_agents: int, M: int) -> int:
    """Column tiles of one secure-agg combination of a (K, M) stack."""
    cols = max(1, MASK_TILE_ELEMS // (num_agents * num_agents))
    return -(-int(M) // cols)


def make_secure_agg(num_agents: int, *, seed: int = 0,
                    mask_scale: float = 1.0):
    """Build the pairwise-canceling mask-and-combine stage.

    Returns ``stage(params, active, A_t, t, *, eta=None) -> mixed``, the
    eq.-20 combination through per-edge masked payloads: for each receiver
    k with live sender set ``L_k`` (the support of column k of
    ``masked_combination(A_t, active)``, self excluded), sender j ships

        payload[j -> k] = A_eff[j, k] * x_j + eta[k, j] - eta[k, prev_k(j)]

    with ``prev_k`` the cyclic predecessor on ``L_k``
    (:func:`predecessors`).  The masks telescope to zero, so the sum over
    j equals ``[A_eff^T X]_k`` up to float accumulation.  Inactive
    receivers keep their rows bit-exactly; a receiver with one live sender
    gets it in the clear.

    The flattened stack goes through the column-tiled flatten of
    :mod:`repro_torch.core.mixing` in tiles of C columns with K^2 C <=
    :data:`MASK_TILE_ELEMS` (the reference materialises (K, K, M) per leaf,
    which at full model width does not fit a card).  Each tile draws its
    own standard normals from :func:`mask_generator` ``(seed, t)``, and
    every tile telescopes over the same ``prev``.  ``eta``: the realized
    standard normals instead, one (K, K, M) tensor over the flattened stack
    (the reference's per-leaf draws concatenated along the last axis), or
    :class:`~repro_torch.core.compression.Draws` holding it as ``noise``.
    ``shard``: an agent row split (:class:`repro_torch.sharding.agents.
    AgentShard`) when ``params`` hold one rank's rows; each tile is
    gathered to all K rows, masked and combined as on one rank, and cut
    back to the local rows.
    """
    if num_agents < 2:
        raise ValueError("secure-agg masks need num_agents >= 2 (a single "
                         "agent has no wire to mask)")
    from repro_torch.core.mixing import _tiled

    K = int(num_agents)
    eye = np.eye(K, dtype=bool)
    cols = max(1, MASK_TILE_ELEMS // (K * K))

    def stage(params: PyTree, active: torch.Tensor, A_t: torch.Tensor,
              t, *, eta=None, shard=None) -> PyTree:
        if isinstance(eta, comp_lib.Draws):
            eta = eta.noise
        leaves = tree_leaves(params)
        device = leaves[0].device
        A_eff = part.masked_combination(
            A_t.to(device=device, dtype=torch.float32), active)
        W = A_eff.T.contiguous()                 # W[k, j] = A_eff[j, k]
        live_np = (W.cpu().numpy() != 0) & ~eye
        prev = torch.as_tensor(predecessors(live_np), device=device)
        live = torch.as_tensor(live_np, device=device)
        gen = (mask_generator(seed, int(t), device) if eta is None
               else None)
        M = sum(leaf[0].numel() for leaf in leaves)

        def fn(x, start):
            if shard is not None:
                # agent-sharded: the local rows of the tile, gathered
                x = shard.gather(x)
            w = x.shape[1]
            if eta is None:
                e = torch.randn((K, K, w), generator=gen, device=device)
            else:
                e = eta[:, :, start:start + w].to(device=device,
                                                  dtype=torch.float32)
            if mask_scale != 1.0:
                e = mask_scale * e
            # eta[k, j] - eta[k, prev[k, j]], zero off the live support
            e = torch.where(live[:, :, None],
                            e - torch.gather(e, 1, prev[:, :, None]
                                             .expand(K, K, w)), 0.0)
            payload = W[:, :, None] * x[None, :, :]
            payload.add_(e)
            del e
            out = payload.sum(dim=1)
            return (out if shard is None else shard.local(out),)

        return tree_unflatten(params, _tiled(leaves, fn, cols=min(cols, M),
                                             width=M, outputs=1)[0])

    stage.num_agents = K
    stage.mask_scale = float(mask_scale)
    return stage


# ---------------------------------------------------------------------------
# the compiled privacy tier
# ---------------------------------------------------------------------------

class Privacy:
    """The privacy tier: the resolved mechanism (clip, noise multiplier),
    the accountant (per-order RDP increments at the realized participation
    rate), the epsilon budget and the optional secure-agg stage.  One
    instance is shared by the engine (state threading and the accountant),
    the pipeline (wire masks) and the train driver (banner, budget
    halt)."""

    def __init__(self, *, num_agents: int, clip: float,
                 noise_multiplier: float, delta: float,
                 epsilon_budget: float | None = None, seed: int = 0,
                 secure_agg: bool = False, mask_scale: float = 1.0,
                 steps_per_block: int = 1, orders=DEFAULT_ORDERS):
        if clip <= 0:
            raise ValueError(f"privacy clip={clip} must be > 0")
        if steps_per_block < 1:
            raise ValueError(
                f"steps_per_block={steps_per_block} must be >= 1 (the "
                "number of local mechanism invocations per block)")
        if noise_multiplier <= 0:
            raise ValueError(
                f"noise_multiplier={noise_multiplier} must be > 0 — give "
                "the noise multiplier directly or a positive epsilon to "
                "derive it from")
        if not (0.0 < delta < 1.0):
            raise ValueError(f"delta={delta} must lie in (0, 1)")
        self.num_agents = int(num_agents)
        self.clip = float(clip)
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.epsilon_budget = (float(epsilon_budget)
                               if epsilon_budget else None)
        self.seed = int(seed)
        self.secure_agg = bool(secure_agg)
        self.mask_scale = float(mask_scale)
        self.steps_per_block = int(steps_per_block)
        self.orders = tuple(int(a) for a in orders)
        # the q-independent log-term constants, one row per order, padded
        # with -inf past k = alpha; rounded to float32 as the reference's
        n = max(self.orders) + 1
        consts = np.full((len(self.orders), n), -np.inf)
        for r, a in enumerate(self.orders):
            consts[r, :a + 1] = _order_constants(a, self.noise_multiplier)
        self._consts = torch.as_tensor(consts, dtype=torch.float32)
        a = np.asarray(self.orders, np.float64)
        self._eps_shift = torch.as_tensor(
            np.log((a - 1.0) / a) - (np.log(self.delta) + np.log(a))
            / (a - 1.0), dtype=torch.float32)
        self._on: dict = {}

    def _tables(self, device: torch.device) -> tuple:
        """(constants, ks, alphas, valid, eps shift) on ``device``."""
        key = str(device)
        if key not in self._on:
            n = self._consts.shape[1]
            alphas = torch.tensor(self.orders, dtype=torch.float32)[:, None]
            ks = torch.arange(n, dtype=torch.float32)[None, :]
            self._on[key] = tuple(x.to(device) for x in (
                self._consts, ks, alphas, ks <= alphas, self._eps_shift))
        return self._on[key]

    # -- grad transform ------------------------------------------------------
    def wrap(self, inner: GradTransform) -> GradTransform:
        """Compose clip+noise in front of ``inner``."""
        return PrivateGradients(self.clip, self.noise_multiplier,
                                seed=self.seed, inner=inner).as_transform()

    # -- accountant state (EngineState.privacy_state) ------------------------
    def init_state(self, device=None) -> PyTree:
        """``{"rdp": (orders,) float32, "steps": 0-d int64}`` on
        ``device`` (``None`` means CUDA)."""
        device = resolve_device(device)
        return {"rdp": torch.zeros((len(self.orders),), dtype=torch.float32,
                                   device=device),
                "steps": torch.zeros((), dtype=torch.int64, device=device)}

    def advance(self, pstate: PyTree, active: torch.Tensor) -> PyTree:
        """One block of accounting at the realized rate ``mean(active)``,
        times ``steps_per_block`` (the float32 twin of
        :func:`rdp_increment_np`, all orders in one ``logsumexp``)."""
        rdp = pstate["rdp"]
        consts, ks, alphas, valid, _ = self._tables(rdp.device)
        q = torch.clamp(active.to(device=rdp.device, dtype=torch.float32)
                        .sum() / self.num_agents, 0.0, 1.0)
        logq, log1mq = torch.log(q), torch.log1p(-q)
        a = torch.where(ks == 0, 0.0, ks * logq)
        b = torch.where(ks == alphas, 0.0, (alphas - ks) * log1mq)
        la = torch.logsumexp(torch.where(valid, consts + a + b, -math.inf),
                             dim=1)
        inc = torch.where(torch.isfinite(la), la, 0.0) / (alphas[:, 0] - 1)
        return {"rdp": rdp + self.steps_per_block * inc,
                "steps": pstate["steps"] + 1}

    def epsilon(self, pstate: PyTree) -> torch.Tensor:
        """Spent (epsilon, self.delta)-DP of the accumulated RDP (float32;
        min over orders, clamped at 0)."""
        shift = self._tables(pstate["rdp"].device)[4]
        return torch.clamp(torch.min(pstate["rdp"] + shift), min=0.0)

    def epsilon_np(self, pstate: PyTree) -> float:
        return epsilon_from_rdp_np(
            pstate["rdp"].detach().cpu().double().numpy(), self.delta,
            self.orders)

    # -- wire masks ----------------------------------------------------------
    def make_mask_stage(self):
        """The CommPipeline secure-agg stage, or None when not requested."""
        if not self.secure_agg:
            return None
        return make_secure_agg(self.num_agents, seed=self.seed,
                               mask_scale=self.mask_scale)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Privacy(clip={self.clip}, "
                f"noise_multiplier={self.noise_multiplier:.4g}, "
                f"delta={self.delta}, budget={self.epsilon_budget}, "
                f"steps_per_block={self.steps_per_block}, "
                f"secure_agg={self.secure_agg})")


def compile_privacy(num_agents: int, q_vector, *, blocks: int,
                    local_steps: int, enabled: bool = True,
                    epsilon: float = 0.0, delta: float = 1e-5,
                    clip: float = 1.0, noise_multiplier: float = 0.0,
                    secure_agg: bool = False, mask_scale: float = 1.0,
                    seed: int = 0) -> Privacy | None:
    """The reference's ``compile_privacy`` on plain arguments: K, the
    per-agent participation rates, the run's blocks and local steps, and
    the fields of its ``PrivacySpec``.  ``None`` when not ``enabled``.

    A positive ``noise_multiplier`` is used as given (a positive
    ``epsilon`` then only sets the budget); otherwise a positive
    ``epsilon`` derives it by calibrating the accountant over ``blocks *
    local_steps`` invocations at the mean rate.  Heterogeneous rates are
    refused: the accountant tracks one population epsilon, which
    understates the budget of any agent sampled more often than the mean.
    """
    if not enabled:
        return None
    qv = np.asarray(q_vector, np.float64).reshape(-1)
    if qv.size and float(qv.max() - qv.min()) > 1e-9:
        raise ValueError(
            "PrivacySpec requires a homogeneous participation rate, got "
            f"per-agent rates in [{qv.min():g}, {qv.max():g}]: the "
            "accountant tracks ONE epsilon at the population rate, which "
            "understates the budget spent by any agent sampled more "
            "often than the mean — use a uniform q (the (epsilon, delta) "
            "guarantee is per-agent) or disable privacy")
    steps_per_block = max(int(local_steps), 1)
    if noise_multiplier > 0:
        sigma = float(noise_multiplier)
    elif epsilon > 0:
        sigma = calibrate_noise_multiplier(
            epsilon, delta, float(np.mean(qv)),
            max(int(blocks), 1) * steps_per_block)
    else:
        raise ValueError(
            "PrivacySpec is enabled but neither noise_multiplier nor "
            "epsilon is positive — set one (the other is derived)")
    return Privacy(num_agents=num_agents, clip=clip, noise_multiplier=sigma,
                   delta=delta,
                   epsilon_budget=epsilon if epsilon > 0 else None,
                   seed=seed, secure_agg=secure_agg, mask_scale=mask_scale,
                   steps_per_block=steps_per_block)
