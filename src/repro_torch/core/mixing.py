"""Mixing backends for the combination step (paper eq. 20).

Counterpart of ``repro.core.mixing``.  Every backend implements the same
contract: given an agent-stacked parameter tree with leaves ``(K, ...)``,
an activation mask ``(K,)`` and the realized ``(K, K)`` combination matrix
``A_t``, apply the per-sample-path masked combination

    w_k  <-  sum_l  a_lk(mask, A_t)  psi_l .

Ported backends:

* :class:`DenseMixer` — einsum against the realized (K, K) matrix.
* :class:`PallasFusedMixer` — flatten the tree to one float32 (K, M)
  buffer and run the fused kernel
  (:func:`repro_torch.kernels.diffusion_mix.diffusion_mix`, CUDA on Hopper;
  the plain version for CPU tensors).  The mix-kind string stays
  ``"pallas"`` so flag values match the reference.
* :class:`NullMixer` — identity.

:class:`CommPipeline` stages the combination step of the engines; the port
runs its identity mode (no compression), where the pipeline is the mixer.

``make_mixer("auto")`` resolves to the fused kernel on CUDA, as the
reference's TPU branch does, and follows the reference's non-TPU policy
elsewhere.  The sparse, gather and robust backends are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import participation as part
from repro_torch.core import topology as topo_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["Mixer", "NullMixer", "DenseMixer", "PallasFusedMixer",
           "CommPipeline", "make_mixer", "mix_dense"]

# the reference's "auto" thresholds (repro.core.mixing)
_AUTO_SPARSE_MAX_OFFSETS = 8
_AUTO_GATHER_HEADROOM = 2

#: mixer kinds of the reference that this port does not run yet
_PENDING = {
    "sparse": "ROADMAP.md queue 1 item 19 (sparse and gather mixers)",
    "gather": "ROADMAP.md queue 1 item 19 (sparse and gather mixers) and "
              "queue 2 kernel 4 (gather_mix)",
    "trimmed_mean": "ROADMAP.md queue 1 item 21 (robust aggregation)",
    "median": "ROADMAP.md queue 1 item 21 (robust aggregation)",
    "adaptive_trim": "ROADMAP.md queue 1 item 21 (robust aggregation)",
}


def mix_dense(A_eff: torch.Tensor, params: PyTree) -> PyTree:
    """Combination step  w_k <- sum_l a_lk psi_l  over stacked agents.

    In stacked form with leaves (K, ...), this is ``w' = A_eff^T w``.
    """
    def mix_leaf(p: torch.Tensor) -> torch.Tensor:
        flat = p.reshape(p.shape[0], -1)
        mixed = torch.einsum("lk,lm->km",
                             A_eff.to(device=flat.device, dtype=flat.dtype),
                             flat)
        return mixed.reshape(p.shape)
    return tree_map(mix_leaf, params)


class Mixer:
    """Combination-step backend: ``mixer(params, active, A_t) -> params``.

    Linear backends equal ``mix_dense(masked_combination(A_t, active),
    params)``.
    """

    name = "base"

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor) -> PyTree:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}()"


class NullMixer(Mixer):
    """Identity combination step (K = 1 or mixing disabled)."""

    name = "none"

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor | None = None) -> PyTree:
        return params


class DenseMixer(Mixer):
    """Dense einsum against the realized (K, K) matrix (baseline)."""

    name = "dense"

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor) -> PyTree:
        A_eff = part.masked_combination(A_t, active)
        return mix_dense(A_eff, params)


class _Layout(NamedTuple):
    """Flatten/unflatten spec of one tree."""

    sizes: tuple[int, ...]   # per-leaf inner size (leaf.numel() // K)
    M: int                   # total inner size


class PallasFusedMixer(Mixer):
    """Fused mask+mix kernel over the flattened parameter tree.

    The agent-stacked tree is flattened to one float32 (K, M) buffer; the
    kernel rebuilds the eq.-20 masked matrix per block and streams the
    buffer once.  The CUDA kernel takes any M, so unlike the TPU layout
    there is no padding.  (The reference caches its layout to spare jit
    retraces; eager PyTorch has none to spare, so the layout is recomputed
    from the leaf shapes on each call.)

    Peak memory is the stack, the float32 buffer, the kernel's output and
    the unflattened copy: the buffer is filled leaf by leaf in place
    (``copy_`` converts the dtype without a temporary) and dropped as soon
    as the kernel has consumed it.
    """

    name = "pallas"

    @staticmethod
    def _layout(leaves) -> _Layout:
        sizes = tuple(int(np.prod(leaf.shape[1:], dtype=np.int64))
                      for leaf in leaves)
        return _Layout(sizes=sizes, M=int(sum(sizes)))

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor) -> PyTree:
        from repro_torch.kernels.diffusion_mix import diffusion_mix

        leaves = tree_leaves(params)
        lay = self._layout(leaves)
        buf = self._flatten(leaves, lay)
        mixed = diffusion_mix(A_t.float(), active, buf)
        del buf
        return tree_unflatten(params, self._unflatten(mixed, leaves, lay))

    def _flatten(self, leaves, lay) -> torch.Tensor:
        K = leaves[0].shape[0]
        buf = torch.empty((K, lay.M), dtype=torch.float32,
                          device=leaves[0].device)
        off = 0
        for leaf, n in zip(leaves, lay.sizes):
            buf[:, off:off + n].copy_(leaf.reshape(K, n))
            off += n
        return buf

    def _unflatten(self, buf, leaves, lay) -> list:
        # copy=True: a float32 leaf must not stay a view of ``buf``, or the
        # whole (K, M) buffer would live as long as that leaf does
        outs, off = [], 0
        for leaf, n in zip(leaves, lay.sizes):
            outs.append(buf[:, off:off + n].reshape(leaf.shape)
                        .to(leaf.dtype, copy=True))
            off += n
        return outs


def _resolve_auto(topology: topo_lib.Topology | None,
                  device: torch.device) -> str:
    """Pick a backend name, as ``repro.core.mixing._resolve_auto`` does;
    CUDA takes the reference's TPU branch (the fused kernel)."""
    if device.type == "cuda":
        return "pallas"
    if topology is None:
        return "dense"
    offsets = (topology.neighbor_offsets_ring()
               if topology.max_degree < topology.num_agents - 1 else None)
    if offsets and len(offsets) <= _AUTO_SPARSE_MAX_OFFSETS:
        return "sparse"
    if (_AUTO_GATHER_HEADROOM * (topology.max_degree + 1)
            <= topology.num_agents):
        return "gather"
    return "dense"


def make_mixer(name: str | Mixer, topology: topo_lib.Topology | None = None,
               *, num_agents: int | None = None,
               device: str | torch.device | None = None) -> Mixer:
    """Build a mixing backend.

    Args:
      name: "dense" | "pallas" | "auto" | "none", or an existing
        :class:`Mixer` (returned unchanged).  The reference's "sparse",
        "gather", "trimmed_mean", "median" and "adaptive_trim" raise
        ``NotImplementedError`` naming their ROADMAP item.
      topology: informs the "auto" policy and K.
      num_agents: disables mixing when 1 (returns :class:`NullMixer`);
        defaults to the topology's K.
      device: where the stack lives; "auto" picks the fused kernel on CUDA.
        ``None`` means CUDA when a card is present.
    """
    if isinstance(name, Mixer):
        return name
    if num_agents is None and topology is not None:
        num_agents = topology.num_agents
    if name == "none" or (num_agents is not None and num_agents <= 1):
        return NullMixer()
    if name == "auto":
        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        name = _resolve_auto(topology, dev)
    if name in _PENDING:
        raise NotImplementedError(
            f"mixer {name!r} is not ported yet: see {_PENDING[name]}")
    if name == "dense":
        return DenseMixer()
    if name == "pallas":
        return PallasFusedMixer()
    raise ValueError(f"unknown mixer {name!r} (expected dense|sparse|"
                     "pallas|gather|auto|none|trimmed_mean|median|"
                     "adaptive_trim)")


_COMPRESSION_ITEM = "ROADMAP.md queue 1 item 20 (compression)"


class CommPipeline:
    """The staged combination step of the engines, in identity mode.

    Counterpart of ``repro.core.mixing.CommPipeline``.  Without compression
    the pipeline IS the mixer (the reference's identity mode, bit-identical
    to the plain mixer): ``pipeline(params, active, A_t, comm_state)``
    returns ``(mixer(params, active, A_t), comm_state)``.  The combination
    runs under ``torch.no_grad()``.

    A compressor, error feedback and the ``direct``/``diff`` exchange modes
    are not ported yet and raise ``NotImplementedError`` naming ROADMAP.md
    item 20; secure-aggregation masks name item 22.  The reference's
    ``gamma`` and ``base_A`` belong to the compressed modes and come with
    them.
    """

    def __init__(self, mixer: Mixer, compressor=None, *, mode: str = "auto",
                 secure_agg=None):
        if compressor not in (None, "none"):
            raise NotImplementedError(f"compressor {compressor!r} is not "
                                      f"ported yet: see {_COMPRESSION_ITEM}")
        if mode in ("direct", "diff"):
            raise NotImplementedError(f"the {mode!r} exchange mode is not "
                                      f"ported yet: see {_COMPRESSION_ITEM}")
        if mode not in ("auto", "identity"):
            raise ValueError(f"unknown pipeline mode {mode!r} "
                             "(expected identity|direct|diff|auto)")
        if secure_agg is not None:
            raise NotImplementedError("secure-aggregation wire masks are not "
                                      "ported yet: see ROADMAP.md queue 1 "
                                      "item 22 (privacy)")
        self.mixer = mixer
        self.mode = "identity"

    #: the identity pipeline carries no memory between blocks
    stateful = False

    def init_state(self, params: PyTree) -> PyTree:
        return ()

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor, comm_state: PyTree = (), key=None):
        """Apply the combination step; returns ``(params, comm_state)``."""
        with torch.no_grad():
            return self.mixer(params, active, A_t), comm_state
