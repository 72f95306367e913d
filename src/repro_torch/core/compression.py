"""Pluggable communication compressors for the combination step.

Counterpart of ``repro.core.compression``.  A :class:`Compressor` maps the
agent-stacked parameter tree (leaves ``(K, ...)``) to the messages that
move on the wire during the combination step;
:class:`repro_torch.core.mixing.CommPipeline` exchanges and combines them
through one of its modes (direct correction for quantization, the
CHOCO-style reference difference for sparsification), all of which keep
the eq.-20 invariants: inactive agents keep their parameters exactly, and
doubly-stochastic mixing keeps the network mean.

Compressors (the reference's names, guards and arithmetic):

* :class:`Identity` — dense float32 messages, no compression.
* :class:`TopK` — keep the largest-magnitude ``ratio`` fraction per agent
  per leaf (deterministic, biased, contractive).
* :class:`RandK` — a uniform random subset per agent per leaf; ``encode``
  rescales by ``n/k`` (unbiased), ``encode_contractive`` does not.
* :class:`Int8Stochastic` — 8-bit stochastic quantization with a
  per-agent scale per leaf (unbiased).  With the fused mixer the engines
  quantize per column tile instead and run the fused dequantize+mix kernel
  (:func:`repro_torch.kernels.diffusion_mix_int8.diffusion_mix_int8`).
* :class:`GaussianMask` — rand-k plus zero-mean Gaussian noise on the kept
  coordinates; ``sigma = 0`` is rand-k, with the same draws.
* :class:`ErrorFeedback` — the residual memory e' = (psi + e) - C(psi + e)
  around any stateless compressor.

Random draws.  torch cannot replay JAX's threefry streams, so every draw
is a tensor the caller may hand in.  Wherever the reference takes a PRNG
key, the port takes either a ``torch.Generator`` (the draws are realized
on the generator's device, leaf after leaf) or a :class:`Draws` holding
realized draws (the uniforms of the int8 rounding and of the rand-k
subset, and the Gaussian noise, per leaf).  :func:`device_stream` turns a
block's host generator into a generator on the parameters' device with one
draw, so the card never waits for host random numbers.

Wire accounting (:meth:`Compressor.wire_bytes`) counts the value payload,
``bits/8`` bytes per transmitted coordinate, as the reference does.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["Compressor", "Identity", "TopK", "RandK", "Int8Stochastic",
           "GaussianMask", "ErrorFeedback", "CompressedGradients", "Draws",
           "make_compressor", "dense_wire_bytes", "device_stream",
           "quantize_int8", "seeded_generator"]


class Draws:
    """Realized random draws, handed in where a generator would go.

    Args:
      u: the uniforms in [0, 1): a list with one float32 tensor per leaf,
        shaped like the leaf's ``(K, n)`` flattening (the int8 rounding and
        the rand-k subset), or, for the fused int8 path
        (:meth:`repro_torch.core.mixing.PallasFusedMixer.mix_int8`), one
        ``(K, M_padded)`` tensor over its padded flatten layout.
      noise: one float32 standard-normal ``(K, n)`` tensor per leaf (the
        Gaussian mask).
    """

    def __init__(self, u=None, noise=None):
        self.u = u
        self.noise = noise

    def leaf(self, kind: str, i: int, shape, device) -> torch.Tensor:
        src = self.u if kind == "u" else self.noise
        if src is None:
            raise ValueError(f"the injected draws hold no {kind!r}")
        return src[i].to(device=device, dtype=torch.float32).reshape(shape)


def _draw(key, kind: str, i: int, shape, device) -> torch.Tensor:
    """Leaf ``i``'s uniforms (``kind="u"``) or standard normals
    (``"noise"``), injected or drawn from the generator ``key``."""
    if key is None:
        raise ValueError("this compressor draws random numbers: pass a "
                         "torch.Generator or injected Draws")
    if isinstance(key, Draws):
        return key.leaf(kind, i, shape, device)
    fn = torch.rand if kind == "u" else torch.randn
    return fn(tuple(shape), generator=key, device=key.device).to(device)


def device_stream(key: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded by one draw from ``key``: each
    device realizes its own numbers from the seed, and ``key`` advances by
    the same single draw on every device."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=key))
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def seeded_generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded by the integers ``words`` (one
    numpy ``SeedSequence`` of them): a stream of its own per tuple, the
    same on every call."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def _weak(c: float, t: torch.Tensor) -> torch.Tensor:
    """The Python scalar ``c`` in ``t``'s dtype, as JAX converts a weakly
    typed scalar before the operation (in bfloat16, ``c * t`` otherwise
    multiplies by the float32 value and rounds once)."""
    return torch.tensor(c, dtype=t.dtype, device=t.device)


def _num_kept(n: int, ratio: float) -> int:
    """Coordinates kept per agent by a sparsifier: floor(ratio n), >= 1."""
    return max(1, min(n, int(ratio * n)))


def quantize_int8(x: torch.Tensor, key=None, axis: int = -1, *,
                  u: torch.Tensor | None = None):
    """Stochastic int8 quantization: ``q = clip(floor(x / s + u), +/-127)``
    with ``s = max|x| / 127`` reduced over ``axis`` (1 where the maximum
    is 0) and ``u ~ U[0, 1)`` (unbiased).  Returns ``(q, scale)``: q
    float32-valued in [-127, 127], scale keeping the reduced axis as 1.

    ``u`` is the realized uniforms of x's shape; without it they are drawn
    from the generator ``key``.  The one definition of the quantizer: the
    per-leaf path (:class:`Int8Stochastic`) and the per-tile fused path
    both call it.
    """
    amax = x.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the correctly rounded
    # quotient the CPU and the reference compute
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    if u is None:
        u = _draw(key, "u", 0, x.shape, x.device)
    # the quotient is a fresh tensor: round it in place
    q = x / scale
    q.add_(u).floor_().clamp_(-127.0, 127.0)
    return q, scale


#: columns per chunk when ties are counted (:func:`_top_k_mask`)
_SCAN_CHUNK = 4096


def _top_k_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the k largest entries of each row of ``x`` (K, n),
    ties at the k-th value going to the lower index: the set
    ``jax.lax.top_k`` selects, on the CPU and on CUDA alike.

    ``torch.topk`` has no tie rule (its CPU and CUDA versions differ), so
    it gives only the threshold, each row's k-th largest value (the values
    it returns do not depend on ties).  Every entry above the threshold is
    kept and, of those equal to it, the first k - #above by index.  Ties
    are counted per chunk of :data:`_SCAN_CHUNK` columns: every tie in a
    chunk before the one that holds the last kept tie is kept, and only
    that chunk takes a cumsum (PyTorch's CUDA cumsum scans a long row in one
    block: a whole-row scan took 0.6 s over smollm's leaves at K = 8).  No
    step waits for the host.
    """
    K, n = x.shape
    thr = torch.topk(x, k, dim=1, sorted=False).values.amin(dim=1,
                                                            keepdim=True)
    above = x > thr
    tie = x == thr
    need = k - above.sum(dim=1, dtype=torch.int32)         # >= 1 per row
    chunks = -(-n // _SCAN_CHUNK)
    if chunks * _SCAN_CHUNK != n:
        padded = tie.new_zeros((K, chunks * _SCAN_CHUNK))
        padded[:, :n] = tie
        tie = padded
    tie = tie.view(K, chunks, _SCAN_CHUNK)
    counts = tie.sum(dim=2, dtype=torch.int32)
    upto = torch.cumsum(counts, dim=1, dtype=torch.int32)
    cut = (upto < need[:, None]).sum(dim=1)    # the chunk of the last kept tie
    rows = torch.arange(K, device=x.device)
    edge = tie[rows, cut]
    room = need - (upto[rows, cut] - counts[rows, cut])
    keep = tie & (torch.arange(chunks, device=x.device)[None, :, None]
                  < cut[:, None, None])
    keep[rows, cut] = edge & (torch.cumsum(edge, dim=1, dtype=torch.int32)
                              <= room[:, None])
    return above.logical_or_(keep.view(K, -1)[:, :n])


def _rand_subset_mask(u: torch.Tensor, flat: torch.Tensor,
                      k: int) -> torch.Tensor:
    """{0,1} mask (flat's dtype) of the k largest uniforms of each row:
    a uniform k-subset per agent.  The one definition of the rand-k mask,
    shared by RandK and GaussianMask."""
    return _top_k_mask(u, k).to(flat.dtype)


def dense_wire_bytes(params: PyTree) -> int:
    """float32 payload of the uncompressed combination step."""
    return sum(4 * leaf.numel() for leaf in tree_leaves(params))


class Compressor:
    """Encoder stage of the combination pipeline.

    ``encode(params, state, key) -> (messages, state)`` with ``messages``
    of params' structure and dtypes; stateless compressors pass ``state``
    through, and only ``needs_key`` compressors read ``key`` (a
    ``torch.Generator`` or :class:`Draws`).
    """

    name = "base"
    stateful = False
    needs_key = False
    bits = 32

    def init_state(self, params: PyTree) -> PyTree:
        return ()

    def encode(self, params: PyTree, state: PyTree, key=None):
        raise NotImplementedError

    def encode_contractive(self, params: PyTree, key=None) -> PyTree:
        """Contractive (not rescaled) encoding for the diff mode."""
        msgs, _ = self.encode(params, (), key)
        return msgs

    def wire_bytes(self, params: PyTree) -> int:
        """Value-payload bytes moved per combination step."""
        return sum((self.bits // 8) * leaf.numel()
                   for leaf in tree_leaves(params))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}()"


class Identity(Compressor):
    """Dense float32 messages: the uncompressed baseline (the pipeline
    short-circuits it to the plain mixer)."""

    name = "none"

    def encode(self, params, state, key=None):
        return params, state


class TopK(Compressor):
    """Keep the largest-magnitude ``ratio`` fraction per agent per leaf.

    Selects the reference's ``jax.lax.top_k`` set, ties at the threshold
    going to the lower index (:func:`_top_k_mask`).
    """

    name = "topk"

    def __init__(self, ratio: float):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"ratio={ratio} must lie in (0, 1]")
        self.ratio = float(ratio)

    def _leaf(self, x: torch.Tensor) -> torch.Tensor:
        K = x.shape[0]
        flat = x.reshape(K, -1)
        n = flat.shape[1]
        k = _num_kept(n, self.ratio)
        if k >= n:
            return x
        mask = _top_k_mask(flat.abs().float(), k).to(flat.dtype)
        return (flat * mask).reshape(x.shape)

    def encode(self, params, state, key=None):
        return tree_map(self._leaf, params), state

    def wire_bytes(self, params):
        return sum(4 * leaf.shape[0]
                   * _num_kept(leaf[0].numel(), self.ratio)
                   for leaf in tree_leaves(params))


class RandK(Compressor):
    """A uniform random ``k``-subset per agent per leaf, rescaled by
    ``n/k`` in :meth:`encode` (unbiased) and not in
    :meth:`encode_contractive`."""

    name = "randk"
    needs_key = True

    def __init__(self, ratio: float):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"ratio={ratio} must lie in (0, 1]")
        self.ratio = float(ratio)

    def _leaf(self, x: torch.Tensor, key, i: int,
              rescale: bool = True) -> torch.Tensor:
        K = x.shape[0]
        flat = x.reshape(K, -1)
        n = flat.shape[1]
        k = _num_kept(n, self.ratio)
        if k >= n:
            return x
        u = _draw(key, "u", i, flat.shape, flat.device)
        out = flat * _rand_subset_mask(u, flat, k)
        if rescale:
            out = out * _weak(n / k, out)
        return out.reshape(x.shape)

    def _encode(self, params, key, rescale: bool) -> PyTree:
        if key is None:
            raise ValueError(f"{type(self).__name__} needs a generator or "
                             "injected Draws")
        leaves = tree_leaves(params)
        return tree_unflatten(params, [self._leaf(leaf, key, i, rescale)
                                       for i, leaf in enumerate(leaves)])

    def encode(self, params, state, key=None):
        return self._encode(params, key, True), state

    def encode_contractive(self, params, key=None):
        return self._encode(params, key, False)

    wire_bytes = TopK.wire_bytes


class Int8Stochastic(Compressor):
    """8-bit stochastic quantization with a per-agent scale per leaf."""

    name = "int8"
    needs_key = True
    bits = 8

    def encode_quantized(self, params, key):
        """``(q, scales)`` trees: ``q`` int8 ``(K, n)`` per leaf, ``scales``
        the per-agent float32 ``(K, 1)`` scale per leaf.  :meth:`dequantize`
        rebuilds :meth:`encode`'s messages bit for bit."""
        if key is None:
            raise ValueError("Int8Stochastic.encode_quantized needs a "
                             "generator or injected Draws")
        qs, ss = [], []
        for i, leaf in enumerate(tree_leaves(params)):
            flat = leaf.reshape(leaf.shape[0], -1).float()
            u = _draw(key, "u", i, flat.shape, flat.device)
            q, scale = quantize_int8(flat, axis=1, u=u)
            del u
            qs.append(q.to(torch.int8))
            ss.append(scale)
        return tree_unflatten(params, qs), tree_unflatten(params, ss)

    def dequantize(self, q: PyTree, scales: PyTree, like: PyTree) -> PyTree:
        """The message tree (``like``'s structure and dtypes)."""
        return tree_map(lambda qi, si, li: (qi.float() * si)
                        .reshape(li.shape).to(li.dtype), q, scales, like)

    def encode(self, params, state, key=None):
        if key is None:
            raise ValueError("Int8Stochastic.encode needs a generator or "
                             "injected Draws")
        q, scales = self.encode_quantized(params, key)
        return self.dequantize(q, scales, params), state


class GaussianMask(RandK):
    """Sparse differential Gaussian masking (Zhang et al.,
    arXiv:2001.03836): rand-k plus noise of standard deviation ``sigma`` on
    the kept coordinates.  ``sigma = 0`` draws no noise, so it is rand-k
    with the same draws."""

    name = "gauss"

    def __init__(self, ratio: float, sigma: float = 0.0):
        super().__init__(ratio)
        if sigma < 0.0:
            raise ValueError(f"sigma={sigma} must be >= 0")
        self.sigma = float(sigma)

    def _leaf(self, x, key, i, rescale=True):
        K = x.shape[0]
        flat = x.reshape(K, -1)
        n = flat.shape[1]
        k = _num_kept(n, self.ratio)
        if self.sigma == 0.0:
            return super()._leaf(x, key, i, rescale)
        if k >= n:
            kept, mask = flat, torch.ones_like(flat)
        else:
            # the mask the kept values are selected with
            mask = _rand_subset_mask(_draw(key, "u", i, flat.shape,
                                           flat.device), flat, k)
            kept = flat * mask
            if rescale:
                kept = kept * _weak(n / k, kept)
        noise = _draw(key, "noise", i, flat.shape, flat.device)
        return (kept + (self.sigma * noise * mask).to(flat.dtype)
                ).reshape(x.shape)


class ErrorFeedback(Compressor):
    """Residual memory: c = C(psi + e), e' = (psi + e) - c, with e in the
    parameters' dtype."""

    stateful = True

    def __init__(self, inner: Compressor):
        if inner.stateful:
            raise ValueError("ErrorFeedback wraps stateless compressors")
        self.inner = inner

    @property
    def name(self) -> str:
        return self.inner.name + "+ef"

    @property
    def needs_key(self) -> bool:
        return self.inner.needs_key

    @property
    def bits(self) -> int:
        return self.inner.bits

    def init_state(self, params: PyTree) -> PyTree:
        return tree_map(torch.zeros_like, params)

    def encode(self, params, state, key=None):
        target = tree_map(lambda p, e: p + e.to(p.dtype), params, state)
        msgs, _ = self.inner.encode(target, (), key)
        return msgs, tree_map(lambda t, m: t - m, target, msgs)

    def encode_contractive(self, params, key=None):
        return self.inner.encode_contractive(params, key)

    def wire_bytes(self, params):
        return self.inner.wire_bytes(params)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ErrorFeedback({self.inner!r})"


class CompressedGradients:
    """Gradient compression as an engine ``grad_transform``.

    State is ``(step counter, compressor state)``.  Each call draws from a
    generator on the gradients' device seeded by ``seed`` and the counter,
    so the transform replays from its state.  As the port's optimizers do
    (:mod:`repro_torch.optim`), it advances the state in place.
    """

    def __init__(self, compressor: Compressor, seed: int = 0):
        self.compressor = compressor
        self.seed = int(seed)

    def init(self, params: PyTree) -> PyTree:
        device = tree_leaves(params)[0].device
        return (torch.zeros((), dtype=torch.int64, device=device),
                self.compressor.init_state(params))

    def __call__(self, grads, state, params):
        counter, cstate = state
        key = None
        if self.compressor.needs_key:
            device = tree_leaves(grads)[0].device
            key = torch.Generator(device=device).manual_seed(
                (self.seed << 32) + int(counter))
        msgs, new = self.compressor.encode(grads, cstate, key)
        for old, n in zip(tree_leaves(cstate), tree_leaves(new)):
            old.copy_(n)
        counter.add_(1)
        return msgs, state


_NAMES = ("none", "identity", "topk", "randk", "int8", "gauss", "gaussian")


def make_compressor(name: str | Compressor | None, *, ratio: float = 1.0,
                    error_feedback: bool = False,
                    sigma: float = 0.0) -> Compressor:
    """Build a compressor stage.

    Args:
      name: "none"/"identity" | "topk" | "randk" | "int8" |
        "gauss"/"gaussian", a :class:`Compressor` (returned as it is, but
        wrapped by ``error_feedback`` if not already stateful), or None.
      ratio: kept fraction of the sparsifiers.
      error_feedback: wrap the result in :class:`ErrorFeedback`; Identity
        is never wrapped (its residual is identically zero).
      sigma: the Gaussian mask's noise scale.
    """
    if isinstance(name, Compressor):
        comp = name
    elif name is None or name in ("none", "identity"):
        comp = Identity()
    elif name == "topk":
        comp = TopK(ratio)
    elif name == "randk":
        comp = RandK(ratio)
    elif name == "int8":
        comp = Int8Stochastic()
    elif name in ("gauss", "gaussian"):
        comp = GaussianMask(ratio, sigma)
    else:
        raise ValueError(f"unknown compressor {name!r} "
                         f"(expected one of {_NAMES})")
    if (error_feedback and not comp.stateful
            and not isinstance(comp, Identity)):
        comp = ErrorFeedback(comp)
    return comp
