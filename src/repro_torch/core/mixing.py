"""Mixing backends for the combination step (paper eq. 20).

Counterpart of ``repro.core.mixing``.  Every backend implements the same
contract: given an agent-stacked parameter tree with leaves ``(K, ...)``,
an activation mask ``(K,)`` and the realized ``(K, K)`` combination matrix
``A_t``, apply the per-sample-path masked combination

    w_k  <-  sum_l  a_lk(mask, A_t)  psi_l .

Ported backends:

* :class:`DenseMixer` — einsum against the realized (K, K) matrix.
* :class:`SparseCirculantMixer` — circulant offsets and ``torch.roll``;
  ``skip_dead`` skips an offset whose coefficient row is all zero (a
  host-side check, numerically the same).
* :class:`PallasFusedMixer` — the fused eq.-20 kernel
  (:func:`repro_torch.kernels.diffusion_mix.diffusion_mix`, CUDA on
  Hopper; the plain version for CPU tensors) over the column-tiled flatten
  (:func:`tiled_apply`).  The mix-kind string stays ``"pallas"`` so flag
  values match the reference.
* :class:`NeighborGatherMixer` — the bounded-degree path: each target
  gathers its D = dmax + 1 rows through the base topology's neighbor table;
  on CUDA the gather kernel
  (:func:`repro_torch.kernels.gather_mix.gather_mix`) over the tiled
  flatten.
* :class:`TrimmedMeanMixer` / :class:`CoordinateMedianMixer` /
  :class:`AdaptiveTrimMixer` — robust order-statistic aggregation (SLSGD),
  global or per realized neighborhood, with the all-slots sort or the
  neighbor-table gather; :class:`FusedNeighborhoodMixer` runs the
  neighborhood scope through the fused gather-sort kernel
  (:func:`repro_torch.kernels.gather_robust_mix.gather_robust_mix`).
* :class:`NullMixer` — identity.

The three kernel mixers share one column-tiled flatten: the stack is
copied into a float32 (K, m) tile a few columns at a time (at most
:data:`TILE_ELEMS` elements, so a tile may span parts of several leaves),
the kernel runs on the tile, and its columns are written straight into new
leaves of each leaf's dtype.  Every output column depends on its own input
column only, so the result is bit-identical to one whole-stack buffer,
while the combination holds two stacks and two tiles instead of two
(K, M) float32 buffers besides.

:class:`CommPipeline` stages the combination step of the engines,

    encode (Compressor) --> exchange/combine (Mixer) --> correct

with the compressors of :mod:`repro_torch.core.compression`.  Without
compression the pipeline IS the mixer; with int8 and the fused mixer the
encode and combine stages fuse into the dequantize+mix kernel
(:meth:`PallasFusedMixer.mix_int8`), whose column tiles are cut at
multiples of the int8 tile over the zero-padded width.  The tiled
flatten and the fused int8 path mark their stages with
``torch.profiler.record_function`` ranges (``tiled.gather``,
``tiled.scatter``; ``mix_int8.draw``, ``.quantize``, ``.cast``,
``.kernel``, ``.messages``), so a profiler trace can group a
combination's device time by stage.

``make_mixer("auto")`` resolves to the fused kernel on CUDA, as the
reference's TPU branch does, and follows the reference's non-TPU policy
elsewhere; the neighborhood-robust backends take the fused gather-sort
kernel on CUDA the same way.  The reference's agent-axis sharding hooks
come with ROADMAP.md item 25.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import compression as comp_lib
from repro_torch.core.compression import _weak
from repro_torch.core import participation as part
from repro_torch.core import topology as topo_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["Mixer", "NullMixer", "DenseMixer", "SparseCirculantMixer",
           "PallasFusedMixer", "NeighborGatherMixer", "FusedNeighborhoodMixer",
           "TrimmedMeanMixer", "CoordinateMedianMixer", "AdaptiveTrimMixer",
           "CommPipeline", "INT8_TILE", "TILE_ELEMS", "choco_gamma",
           "count_live_offsets", "int8_layout", "make_mixer",
           "make_pipeline", "mix_dense", "mix_gather", "mix_sparse",
           "num_tiles", "tiled_apply"]

# the reference's "auto" thresholds (repro.core.mixing)
_AUTO_SPARSE_MAX_OFFSETS = 8
_AUTO_GATHER_HEADROOM = 2

# the all-slots neighborhood sort above this K is the O(K^2 M log K) path
# the gather table exists to avoid: warn once per mixer when it runs anyway
_NEIGHBORHOOD_WARN_K = 512

#: float32 elements of one tile buffer of the column-tiled flatten (1 GiB);
#: the plain robust paths bound their per-leaf temporaries by it too
TILE_ELEMS = 1 << 28

#: columns to one int8 scale of the fused int8 path (the reference's
#: default ``tile_m``; a stack narrower than it takes M rounded up to 128)
INT8_TILE = 512

_ROBUST = ("trimmed_mean", "median", "adaptive_trim")

_INF = float("inf")


# ---------------------------------------------------------------------------
# functional primitives
# ---------------------------------------------------------------------------

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


def _bcast(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A (K,) vector in p's dtype, shaped to broadcast against (K, ...)."""
    return v.to(p.dtype).reshape((v.shape[0],) + (1,) * (p.ndim - 1))


def mix_sparse(A_eff: torch.Tensor, params: PyTree, offsets: Sequence[int],
               *, skip_dead: bool = False) -> PyTree:
    """Circulant-offset mixing: w'_k = sum_o c_o[k] * w_{(k+o) mod K}.

    Valid whenever every nonzero off-diagonal of the base topology lies on a
    circulant offset in ``offsets``; entries of A_eff outside the true
    neighborhood are zero, so wrap-around reads are annihilated.

    ``skip_dead`` skips every offset whose coefficient row is all zero
    (on a realized dynamic graph an offset whose every edge failed this
    block contributes exact zeros).  The reference guards each roll with a
    ``lax.cond``; here the check runs on the host once per call.  The
    result is the same.
    """
    K = A_eff.shape[0]
    idx = torch.arange(K, device=A_eff.device)
    # c_o[k] = A_eff[(k + o) % K, k]
    coeffs = {o: A_eff[(idx + o) % K, idx] for o in (0, *offsets)}
    live = [o for o in offsets
            if not skip_dead or bool((coeffs[o] != 0).any())]

    def mix_leaf(p: torch.Tensor) -> torch.Tensor:
        out = _bcast(coeffs[0], p) * p
        for o in live:
            out = out + _bcast(coeffs[o], p) * torch.roll(p, shifts=-o,
                                                          dims=0)
        return out

    return tree_map(mix_leaf, params)


def mix_gather(A_eff: torch.Tensor, params: PyTree, idx: torch.Tensor,
               valid: torch.Tensor) -> PyTree:
    """Bounded-degree combination through a static neighbor table.

    ``idx`` / ``valid`` come from
    :meth:`repro_torch.core.topology.Topology.neighbor_table`: each target
    row k reads only its ``D = max_degree + 1`` possible contributor rows
    and contracts them with the realized weights ``A_eff[idx[k, j], k]``.
    Padding slots gather the self row with weight exactly zero, so the
    result matches :func:`mix_dense` whenever every nonzero of ``A_eff``
    lies on the base support.
    """
    idx = idx.to(device=A_eff.device, dtype=torch.long)
    gw = _gather_weights(A_eff, idx, valid)

    def mix_leaf(p: torch.Tensor) -> torch.Tensor:
        flat = p.reshape(idx.shape[0], -1)
        mixed = torch.einsum("kd,kdm->km", gw.to(flat.dtype), flat[idx])
        return mixed.reshape(p.shape)

    return tree_map(mix_leaf, params)


def count_live_offsets(A_eff: torch.Tensor,
                       offsets: Sequence[int]) -> torch.Tensor:
    """How many circulant offsets carry any nonzero coefficient in this
    realized matrix: the rolls the ``skip_dead`` sparse path runs (int32
    scalar)."""
    K = A_eff.shape[0]
    idx = torch.arange(K, device=A_eff.device)
    live = [(A_eff[(idx + int(o)) % K, idx] != 0).any() for o in offsets]
    return (torch.stack(live).sum().to(torch.int32) if live else
            torch.zeros((), dtype=torch.int32, device=A_eff.device))


def _gather_weights(A_eff: torch.Tensor, idx: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """(K, D) realized weight per table slot; padding slots exactly 0."""
    K = idx.shape[0]
    idx = idx.to(device=A_eff.device, dtype=torch.long)
    cols = torch.arange(K, device=A_eff.device)[:, None]
    return A_eff[idx, cols] * valid.to(device=A_eff.device,
                                       dtype=A_eff.dtype)


def tile_columns(K: int) -> int:
    """Columns of one tile of the column-tiled flatten of a K-agent
    stack: as many as :data:`TILE_ELEMS` float32 elements hold."""
    return max(1, TILE_ELEMS // max(int(K), 1))


def num_tiles(K: int, M: int, int8: bool = False) -> int:
    """Tiles (kernel launches) of one tiled combination of a (K, M)
    stack; with ``int8``, of the fused int8 path, whose column tiles are
    cut at multiples of the int8 tile over the padded width
    (:func:`int8_layout`)."""
    if not int8:
        return -(-int(M) // tile_columns(K))
    _, width, cols = int8_layout(K, int(M))
    return -(-width // cols)


def int8_layout(K: int, M: int) -> tuple[int, int, int]:
    """(effective tile, padded width, column-tile width) of the fused int8
    layout of a (K, M) stack.  As the reference's ``_layout``: the tile is
    :data:`INT8_TILE`, or M rounded up to 128 if smaller, and the width M
    rounded up to the tile; the column tiles hold as many whole int8 tiles
    as :data:`TILE_ELEMS` allows (at least one)."""
    tile = min(INT8_TILE, _round_up(max(M, 1), 128))
    width = _round_up(max(M, 1), tile)
    return tile, width, min(max(tile, tile_columns(K) // tile * tile), width)


def tiled_apply(leaves: list,
                fn: Callable[[torch.Tensor], torch.Tensor]) -> list:
    """``unflatten(fn(flatten(leaves)))``, one column tile at a time.

    ``leaves`` are (K, ...) tensors on one device; ``fn`` maps a
    contiguous float32 (K, m) tile to a (K, m) result.  The tile buffer
    (at most :data:`TILE_ELEMS` elements) is allocated once and refilled:
    a tile may span parts of several leaves, and ``copy_`` converts each
    leaf's dtype on the way in.  The result's columns are written straight
    into new leaves, allocated once with each leaf's shape and dtype
    (``copy_`` rounds float32 to the leaf's dtype, as ``.to`` does).  When
    ``fn`` is column-wise, as the kernels are, the result does not depend
    on the tile size.
    """
    K = leaves[0].shape[0]
    M = sum(int(np.prod(leaf.shape[1:], dtype=np.int64)) for leaf in leaves)
    return _tiled(leaves, lambda tile, start: (fn(tile),),
                  cols=min(tile_columns(K), max(M, 1)), width=M,
                  outputs=1)[0]


def _tiled(leaves: list, fn, *, cols: int, width: int,
           outputs: int) -> list:
    """The column-tiled flatten under :func:`tiled_apply` and the fused
    int8 path: the flattened stack, padded with zero columns up to
    ``width``, in tiles of ``cols`` columns (the last may be narrower);
    ``fn(tile, start)`` returns ``outputs`` (K, m) results, each written
    into its own new leaves (padding columns dropped).  Returns one list
    of leaves per output."""
    K = leaves[0].shape[0]
    sizes = [int(np.prod(leaf.shape[1:], dtype=np.int64)) for leaf in leaves]
    flats = [leaf.reshape(K, n) for leaf, n in zip(leaves, sizes)]
    outs = [[torch.empty((K, n), dtype=leaf.dtype, device=leaf.device)
             for leaf, n in zip(leaves, sizes)] for _ in range(outputs)]
    buf = torch.empty(K * cols, dtype=torch.float32,
                      device=leaves[0].device)
    i = off = 0                          # the next input column: leaf, offset
    for a in range(0, width, cols):
        w = min(cols, width - a)
        tile = buf[:K * w].view(K, w)
        segs, t = [], 0
        with record_function("tiled.gather"):
            while t < w and i < len(sizes):
                n = min(sizes[i] - off, w - t)
                if n:
                    tile[:, t:t + n].copy_(flats[i][:, off:off + n])
                    segs.append((i, off, t, n))
                t, off = t + n, off + n
                if off == sizes[i]:
                    i, off = i + 1, 0
            if t < w:
                tile[:, t:].zero_()      # the padding, in the last tile only
        res = fn(tile, a)
        with record_function("tiled.scatter"):
            for r, out in zip(res, outs):
                for j, o, t0, n in segs:
                    out[j][:, o:o + n].copy_(r[:, t0:t0 + n])
        del res
    return [[o.reshape(leaf.shape) for o, leaf in zip(out, leaves)]
            for out in outs]


# ---------------------------------------------------------------------------
# Mixer interface
# ---------------------------------------------------------------------------

class Mixer:
    """Combination-step backend: ``mixer(params, active, A_t) -> params``.

    Linear backends (``linear = True``) equal ``mix_dense(
    masked_combination(A_t, active), params)``; the robust backends set
    ``linear = False``.  ``uses_matrix = False`` marks a backend that
    accepts ``A_t`` and ignores it (global robust aggregation, none).
    """

    name = "base"
    linear = True
    uses_matrix = True

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor) -> PyTree:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}()"


class NullMixer(Mixer):
    """Identity combination step (K = 1 or mixing disabled)."""

    name = "none"
    uses_matrix = False

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


class SparseCirculantMixer(Mixer):
    """Circulant roll path for bounded-degree topologies.

    Only the offsets are constructor state; the realized matrix is a
    per-call operand.  Valid whenever every nonzero off-diagonal of A_t
    lies on a base circulant offset
    (:func:`repro_torch.core.graphs.check_mixer_support` rejects graphs
    that leave it).  ``skip_dead=None`` is an auto decision that
    ``check_mixer_support`` re-derives per build (on for dynamic graphs).
    """

    name = "sparse"

    def __init__(self, offsets: Sequence[int],
                 skip_dead: bool | None = None):
        self.offsets = tuple(int(o) for o in offsets)
        self.skip_dead = skip_dead
        self._skip_dead_auto = skip_dead is None

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor) -> PyTree:
        A_eff = part.masked_combination(A_t, active)
        return mix_sparse(A_eff, params, self.offsets,
                          skip_dead=bool(self.skip_dead))

    def live_offsets(self, active: torch.Tensor,
                     A_t: torch.Tensor) -> torch.Tensor:
        """Realized roll count for this (mask, matrix) draw."""
        return count_live_offsets(part.masked_combination(A_t, active),
                                  self.offsets)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class PallasFusedMixer(Mixer):
    """The fused mask+mix kernel over the column-tiled flatten.

    Each tile of the flattened stack goes through
    :func:`repro_torch.kernels.diffusion_mix.diffusion_mix`, which rebuilds
    the eq.-20 masked matrix and streams the tile once: one launch per tile
    (:func:`num_tiles`).  The CUDA kernel takes any M, so the float32 path
    needs no padding.

    :meth:`mix_int8` is the compressed combination: the reference's
    per-tile int8 layout (:func:`int8_layout`, :data:`INT8_TILE` columns to
    a scale), through the fused dequantize+mix kernel.
    """

    name = "pallas"

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor) -> PyTree:
        from repro_torch.kernels.diffusion_mix import diffusion_mix

        A = A_t.float()
        return tree_unflatten(params, tiled_apply(
            tree_leaves(params), lambda tile: diffusion_mix(A, active, tile)))

    def mix_int8(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor, key=None, *, want_messages: bool = False,
                 u: torch.Tensor | None = None):
        """Compressed combination: per-tile int8 stochastic quantization of
        the flattened stack (one scale per agent and tile of the padded
        layout; a tile may span leaves), then the fused dequantize+mask+mix
        kernel (:func:`repro_torch.kernels.diffusion_mix_int8.
        diffusion_mix_int8`) with ``subtract_identity``.

        Returns ``(delta, messages)``: ``delta`` the tree of combination
        deltas ``[(A_eff - I)^T c]_k`` and ``messages`` the dequantized
        transmitted tree c (what the kernel dequantizes; the error-feedback
        residual needs it) or None unless ``want_messages``, both in the
        leaves' dtypes.

        The rounding uniforms are ``u``, (K, M_padded) over the padded
        layout (the reference's (K, tiles, tile_m) draw reshaped), or are
        drawn from the generator ``key`` column tile by column tile.  The
        column tiles are cut at multiples of the int8 tile, so with ``u``
        the result does not depend on the cut.
        """
        from repro_torch.kernels.diffusion_mix_int8 import diffusion_mix_int8

        leaves = tree_leaves(params)
        K = leaves[0].shape[0]
        M = sum(leaf[0].numel() for leaf in leaves)
        tile, width, cols = int8_layout(K, M)
        if u is not None:
            u = u.reshape(K, width)
        elif key is None:
            raise ValueError("mix_int8 draws its rounding uniforms: pass a "
                             "generator or u=")
        A = A_t.float()

        def fn(x, start):
            w = x.shape[1]
            x3 = x.view(K, w // tile, tile)
            with record_function("mix_int8.draw"):
                if u is None:
                    uu = torch.rand(x3.shape, generator=key,
                                    device=key.device).to(x.device)
                else:
                    uu = u[:, start:start + w].to(
                        device=x.device,
                        dtype=torch.float32).reshape(x3.shape)
            with record_function("mix_int8.quantize"):
                q, scale = comp_lib.quantize_int8(x3, axis=2, u=uu)
            del uu
            with record_function("mix_int8.cast"):
                wq = q.to(torch.int8).view(K, w)
                sc = scale[:, :, 0].contiguous()
            with record_function("mix_int8.kernel"):
                delta = diffusion_mix_int8(A, active, wq, sc, tile_m=tile,
                                           subtract_identity=True)
            del wq, sc
            if not want_messages:
                return (delta,)
            # the integer-valued float32 q times its scale: exactly the
            # values the kernel dequantizes
            with record_function("mix_int8.messages"):
                return delta, q.mul_(scale).view(K, w)

        outs = _tiled(leaves, fn, cols=cols, width=width,
                      outputs=2 if want_messages else 1)
        delta = tree_unflatten(params, outs[0])
        return delta, (tree_unflatten(params, outs[1]) if want_messages
                       else None)


class _NeighborTable:
    """The base topology's (K, D) neighbor table ``(idx, valid)``
    (:meth:`~repro_torch.core.topology.Topology.neighbor_table`), kept on
    the host and copied once to each device that asks for it."""

    def __init__(self, topology: topo_lib.Topology):
        idx, valid = topology.neighbor_table()
        self.idx = torch.as_tensor(idx)              # (K, D) int32
        self.valid = torch.as_tensor(valid)          # (K, D) bool
        self._on: dict = {}
        self._plans: dict = {}

    @property
    def slots(self) -> int:
        return int(self.idx.shape[1])

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = (self.idx.to(device), self.valid.to(device))
        return self._on[key]

    def plan(self, device):
        """The gather kernels' plan of this table on ``device``
        (:func:`repro_torch.kernels.gather_mix.stage_plan`), computed
        once per device."""
        from repro_torch.kernels.gather_mix import stage_plan

        key = str(torch.device(device))
        if key not in self._plans:
            self._plans[key] = stage_plan(self.idx).to(device)
        return self._plans[key]


class NeighborGatherMixer(Mixer):
    """Bounded-degree linear combination: the scale path for large K.

    Holds the static neighbor table of the base topology and runs
    :func:`mix_gather`: each target row reads only its ``D = dmax + 1``
    possible contributor rows.  Valid whenever the realized graphs stay
    ``within_base_support``.

    ``fused=None`` resolves per call: on CUDA the gather kernel
    (:func:`repro_torch.kernels.gather_mix.gather_mix`) over the
    column-tiled flatten, one launch per tile; on the CPU the per-leaf
    gather einsum.  ``fused=True`` forces the tiled path (with the kernel's
    plain version on the CPU, where the reference would run its kernel in
    interpret mode); ``fused=False`` forces the einsum.
    """

    name = "gather"

    def __init__(self, topology: topo_lib.Topology, *,
                 fused: bool | None = None):
        if topology is None:
            raise ValueError("NeighborGatherMixer needs the base topology "
                             "(source of the static neighbor table)")
        self.table = _NeighborTable(topology)
        self.num_agents = topology.num_agents
        self.max_degree = topology.max_degree
        self.fused = fused

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor) -> PyTree:
        A_eff = part.masked_combination(A_t.float(), active)
        idx, valid = self.table.on(A_eff.device)
        leaves = tree_leaves(params)
        fused = (leaves[0].device.type == "cuda" if self.fused is None
                 else bool(self.fused))
        if not fused:
            return mix_gather(A_eff, params, idx, valid)
        from repro_torch.kernels.gather_mix import gather_mix

        gw = _gather_weights(A_eff, idx, valid)
        plan = (self.table.plan(idx.device) if idx.device.type == "cuda"
                else None)
        return tree_unflatten(params, tiled_apply(
            leaves, lambda tile: gather_mix(idx, gw, tile, plan)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"NeighborGatherMixer(K={self.num_agents}, "
                f"D={self.max_degree + 1}, fused={self.fused})")


# ---------------------------------------------------------------------------
# robust aggregation (SLSGD, arXiv:1903.06996)
# ---------------------------------------------------------------------------

def _robust_leaf(p: torch.Tensor, active: torch.Tensor,
                 agg: Callable[[torch.Tensor], torch.Tensor],
                 per_column: int) -> torch.Tensor:
    """One leaf of a plain robust path: ``agg`` maps float32 (K, w)
    columns to their (K, w) or (1, w) aggregate; active rows take it in
    the leaf's dtype and inactive rows keep the leaf exactly.  Columns go
    through ``agg`` in slices whose temporaries (``per_column`` float32
    elements per column) stay within :data:`TILE_ELEMS`; columns are
    independent, so the slices do not change the result."""
    K = p.shape[0]
    x = p.reshape(K, -1)
    out = torch.empty_like(x)
    keep = active.to(device=p.device, dtype=torch.float32).reshape(K, 1) > 0
    width = max(1, TILE_ELEMS // max(per_column, 1))
    for a in range(0, x.shape[1], width):
        cols = x[:, a:a + width]
        out[:, a:a + width] = torch.where(keep, agg(cols.float()).to(p.dtype),
                                          cols)
    return out.reshape(p.shape)


def _weighted_slots(srt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum over the slot axis (-2) of ``where(w > 0, srt, 0) * w``: the
    where keeps 0 * inf = nan out of the contraction."""
    zero = torch.zeros((), dtype=srt.dtype, device=srt.device)
    return (torch.where(w > 0, srt, zero) * w).sum(dim=-2)



class _SortedRobustMixer(Mixer):
    """Shared machinery for order-statistic (robust) combination backends.

    * ``scope="global"``: every active agent receives the same
      coordinate-wise robust aggregate of the realized active set (A_t is
      ignored, ``uses_matrix = False``).
    * ``scope="neighborhood"``: each active agent k aggregates over its
      realized neighborhood, the support of column k of
      ``masked_combination(A_t, active)`` (self always included).

    Inactive agents keep their parameters exactly.  Per coordinate (and
    per target in the neighborhood scope) the contributor values are
    sorted with non-contributors pushed to +inf, so the S contributors
    occupy the first S slots; subclasses supply the weights over those
    sorted slots.

    With a neighbor table attached (:meth:`attach_neighbor_table`) the
    neighborhood scope gathers only the ``D = max_degree + 1`` rows that
    can contribute to each target and sorts those; without one the
    all-slots sort runs, with a one-time warning above
    ``_NEIGHBORHOOD_WARN_K`` agents.  Both sort the same finite multiset
    per (target, coordinate).
    """

    linear = False
    uses_matrix = False       # per instance: True for scope="neighborhood"

    def __init__(self, num_agents: int, scope: str = "global"):
        if num_agents < 1:
            raise ValueError(f"num_agents={num_agents} must be >= 1")
        if scope not in ("global", "neighborhood"):
            raise ValueError(f"scope={scope!r} must be 'global' or "
                             "'neighborhood'")
        self.num_agents = int(num_agents)
        self.scope = scope
        self.uses_matrix = scope == "neighborhood"
        self._table: _NeighborTable | None = None
        # "auto": graphs.check_mixer_support attaches/detaches the table
        # per build; "table"/"off" are explicit choices it never touches
        self._gather_mode = "auto"
        self._warned_dense = False

    def attach_neighbor_table(self, topology: topo_lib.Topology) -> None:
        """Enable the bounded-degree gather for the neighborhood scope.

        ``topology`` must be the BASE topology of the graph process, and
        every realized matrix must stay within its support.
        """
        if topology.num_agents != self.num_agents:
            raise ValueError(
                f"neighbor table is for K={topology.num_agents} agents; "
                f"this mixer has num_agents={self.num_agents}")
        self._table = _NeighborTable(topology)

    def detach_neighbor_table(self) -> None:
        """Drop the gather table (the graph may leave the base support)."""
        self._table = None

    def _slot_weights(self, S: torch.Tensor,
                      slots: int | None = None) -> torch.Tensor:
        """Weights over ascending sorted slots given S contributors: shape
        ``S.shape + (slots,)``; ``slots`` defaults to ``num_agents`` (the
        all-slots sort) and is D on the gather path.  Zero on every slot
        >= S, and on every slot when S = 0."""
        raise NotImplementedError

    def _slot_index(self, S: torch.Tensor, slots: int | None):
        n = self.num_agents if slots is None else int(slots)
        S = S.to(torch.float32).unsqueeze(-1)
        return S, torch.arange(n, dtype=torch.float32, device=S.device)

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor | None = None) -> PyTree:
        if self.scope == "neighborhood":
            if A_t is None:
                raise ValueError(
                    f"{type(self).__name__}(scope='neighborhood') "
                    "aggregates over the realized neighborhood and needs "
                    "the A_t operand")
            return self._neighborhood(params, active, A_t)
        return self._global(params, active)

    def _global(self, params: PyTree, active: torch.Tensor) -> PyTree:
        K = self.num_agents
        m = active.to(torch.float32)
        w = self._slot_weights(m.sum())[:, None]           # (K, 1)
        mem = m.reshape(K, 1) > 0

        def agg(x):
            srt = torch.sort(torch.where(mem, x, _INF), dim=0).values
            return _weighted_slots(srt, w)[None]

        return tree_map(lambda p: _robust_leaf(p, m, agg, 3 * K), params)

    def _neighborhood(self, params: PyTree, active: torch.Tensor,
                      A_t: torch.Tensor) -> PyTree:
        if self._table is not None:
            return self._neighborhood_gather(params, active, A_t)
        if self.num_agents > _NEIGHBORHOOD_WARN_K and not self._warned_dense:
            self._warned_dense = True
            warnings.warn(
                f"{type(self).__name__}(scope='neighborhood') is running "
                f"the all-slots sort at K={self.num_agents}: O(K^2 M log K) "
                "work per block.  If the graph process stays "
                "within_base_support, attach the bounded-degree gather "
                "table (mixer.attach_neighbor_table(topology), or build "
                "through make_mixer(..., topology)/check_mixer_support) "
                "for O(K dmax M log dmax).", stacklevel=3)
        return self._neighborhood_dense(params, active, A_t)

    def _dense_members(self, active, A_t):
        """(target, contributor) membership of the all-slots sort and its
        per-target count: l contributes to k iff A_eff[l, k] != 0, and
        self is forced (the renormalized self weight can hit 0)."""
        K = self.num_agents
        A_eff = part.masked_combination(A_t.to(torch.float32), active)
        member = (A_eff != 0) | torch.eye(K, dtype=torch.bool,
                                          device=A_eff.device)
        return member.T, member.to(torch.float32).sum(dim=0)

    def _gather_members(self, active, A_t):
        """The table's rows, (K, D) membership and per-target count: slot
        0 is self and always a member; padding slots never are."""
        A_eff = part.masked_combination(A_t.to(torch.float32), active)
        idx, valid = self._table.on(A_eff.device)
        member = _gather_weights(A_eff, idx, valid) != 0
        member[:, 0] = True
        return idx, member, member.to(torch.float32).sum(dim=1)

    def _neighborhood_dense(self, params: PyTree, active: torch.Tensor,
                            A_t: torch.Tensor) -> PyTree:
        K = self.num_agents
        mem_t, S = self._dense_members(active, A_t)
        w = self._slot_weights(S)[:, :, None]              # (K, K, 1)

        def agg(x):
            vals = torch.where(mem_t[:, :, None], x[None], _INF)
            return _weighted_slots(torch.sort(vals, dim=1).values, w)

        return tree_map(lambda p: _robust_leaf(p, active, agg, 3 * K * K),
                        params)

    def _neighborhood_gather(self, params: PyTree, active: torch.Tensor,
                             A_t: torch.Tensor) -> PyTree:
        from repro_torch.kernels.ref import gather_robust_mix_ref

        K = self.num_agents
        idx, member, S = self._gather_members(active, A_t)
        D = idx.shape[1]
        w = self._slot_weights(S, D)

        def agg(x):
            return gather_robust_mix_ref(idx, member, w, active, x)

        return tree_map(lambda p: _robust_leaf(p, active, agg, 3 * K * D),
                        params)


class TrimmedMeanMixer(_SortedRobustMixer):
    """Coordinate-wise trimmed mean (SLSGD eq. 4), global or per
    neighborhood.

    Per coordinate, drop the ``trim`` smallest and ``trim`` largest values
    among the S contributions and average the rest; with fewer than
    ``2 trim + 1`` contributors the trim is clipped to ``floor((S - 1) /
    2)``.  ``trim = 0`` is the plain mean over the contributors.
    """

    name = "trimmed_mean"

    def __init__(self, num_agents: int, trim: int = 1,
                 scope: str = "global"):
        super().__init__(num_agents, scope=scope)
        if not 0 <= trim < max(num_agents, 1):
            raise ValueError(f"trim={trim} must lie in [0, {num_agents})")
        self.trim = int(trim)

    def _slot_weights(self, S, slots=None):
        S, idx = self._slot_index(S, slots)
        b = torch.clamp(torch.clamp(torch.floor((S - 1.0) / 2.0),
                                    max=float(self.trim)), min=0.0)
        keep = ((idx >= b) & (idx < S - b)).to(torch.float32)
        return keep / torch.clamp(keep.sum(dim=-1, keepdim=True), min=1.0)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TrimmedMeanMixer(K={self.num_agents}, trim={self.trim}, "
                f"scope={self.scope!r})")


class CoordinateMedianMixer(_SortedRobustMixer):
    """Coordinate-wise median (breakdown point 1/2), global or per
    neighborhood: SLSGD's b -> (S - 1)/2 limit."""

    name = "median"

    def _slot_weights(self, S, slots=None):
        S, idx = self._slot_index(S, slots)
        lo = torch.clamp(torch.floor((S - 1.0) / 2.0), min=0.0)
        hi = torch.clamp(torch.ceil((S - 1.0) / 2.0), min=0.0)
        w = 0.5 * ((idx == lo).to(torch.float32)
                   + (idx == hi).to(torch.float32))
        # S = 0: nothing to aggregate, the weights die
        w = w * (S >= 1.0).to(torch.float32)
        return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"CoordinateMedianMixer(K={self.num_agents}, "
                f"scope={self.scope!r})")


class AdaptiveTrimMixer(TrimmedMeanMixer):
    """Trimmed mean with a per-coordinate, data-dependent trim count.

    Over the S contributors: the coordinate median and the MAD (median
    absolute deviation, consistency factor 1.4826); a contribution further
    than ``mad_thresh`` consistent MADs from the median is flagged, and
    ``b_lo = min(#low flags, cap)`` / ``b_hi = min(#high flags, cap)``
    slots are dropped per side, ``cap = min(trim, floor((S - 1) / 2))``.
    Flagging is strict, so an exactly tied majority (MAD = 0) never flags
    equal values.  The weights depend on the data per coordinate, so the
    fused gather-sort kernel (precomputed per-row slot weights) does not
    apply: this backend runs plain torch only.
    """

    name = "adaptive_trim"

    def __init__(self, num_agents: int, trim: int = 1,
                 scope: str = "global", mad_thresh: float = 3.0):
        super().__init__(num_agents, trim=trim, scope=scope)
        if mad_thresh <= 0:
            raise ValueError(f"mad_thresh={mad_thresh} must be > 0")
        self.mad_thresh = float(mad_thresh)

    def _adaptive_weights(self, srt: torch.Tensor,
                          S: torch.Tensor) -> torch.Tensor:
        """Per-coordinate keep weights over ascending sorted slots.

        ``srt``: (..., n, w) sorted along the slot axis -2, +inf beyond the
        S live slots; ``S``: (...) contributor counts.  Returns weights
        shaped like ``srt``, zero on dead slots and on the flagged tails,
        renormalized to sum to 1 per coordinate.
        """
        n = srt.shape[-2]
        S = S.to(torch.float32).reshape(S.shape + (1, 1))
        ranks = torch.arange(n, dtype=torch.float32,
                             device=srt.device).reshape(n, 1)
        live = (ranks < S).to(torch.float32)
        lo_i = torch.clamp(torch.floor((S - 1.0) / 2.0), min=0.0).long()
        hi_i = torch.clamp(torch.ceil((S - 1.0) / 2.0), min=0.0).long()

        def take(t, i):
            return torch.gather(t, -2, i.expand(t.shape[:-2]
                                                + (1, t.shape[-1])))

        zero = torch.zeros((), device=srt.device)
        has = S >= 1.0
        med = torch.where(has, 0.5 * (take(srt, lo_i) + take(srt, hi_i)),
                          zero)
        # the MAD needs a second sort: |x - med| is not monotone in x
        dev = torch.where(live > 0, (srt - med).abs(), _INF)
        dev_srt = torch.sort(dev, dim=-2).values
        mad = torch.where(has, 0.5 * (take(dev_srt, lo_i)
                                      + take(dev_srt, hi_i)), zero)
        thr = self.mad_thresh * 1.4826 * mad
        lo_out = (live * (srt < med - thr)).sum(dim=-2, keepdim=True)
        hi_out = (live * (srt > med + thr)).sum(dim=-2, keepdim=True)
        cap = torch.clamp(torch.clamp(torch.floor((S - 1.0) / 2.0),
                                      max=float(self.trim)), min=0.0)
        b_lo = torch.minimum(lo_out, cap)
        b_hi = torch.minimum(hi_out, cap)
        keep = live * (ranks >= b_lo) * (ranks < S - b_hi)
        return keep / torch.clamp(keep.sum(dim=-2, keepdim=True), min=1.0)

    def _adaptive(self, vals: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
        srt = torch.sort(vals, dim=-2).values
        return _weighted_slots(srt, self._adaptive_weights(srt, S))

    # the three paths of the base class, with the per-row slot weights
    # replaced by per-coordinate weights computed from the sorted values
    def _global(self, params: PyTree, active: torch.Tensor) -> PyTree:
        K = self.num_agents
        m = active.to(torch.float32)
        S = m.sum()
        mem = m.reshape(K, 1) > 0

        def agg(x):
            return self._adaptive(torch.where(mem, x, _INF), S)[None]

        return tree_map(lambda p: _robust_leaf(p, m, agg, 8 * K), params)

    def _neighborhood_dense(self, params: PyTree, active: torch.Tensor,
                            A_t: torch.Tensor) -> PyTree:
        K = self.num_agents
        mem_t, S = self._dense_members(active, A_t)

        def agg(x):
            return self._adaptive(
                torch.where(mem_t[:, :, None], x[None], _INF), S)

        return tree_map(lambda p: _robust_leaf(p, active, agg, 8 * K * K),
                        params)

    def _neighborhood_gather(self, params: PyTree, active: torch.Tensor,
                             A_t: torch.Tensor) -> PyTree:
        K = self.num_agents
        idx, member, S = self._gather_members(active, A_t)
        rows = idx.long()

        def agg(x):
            return self._adaptive(
                torch.where(member[:, :, None], x[rows], _INF), S)

        return tree_map(
            lambda p: _robust_leaf(p, active, agg, 8 * K * idx.shape[1]),
            params)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"AdaptiveTrimMixer(K={self.num_agents}, trim={self.trim}, "
                f"mad_thresh={self.mad_thresh}, scope={self.scope!r})")


class FusedNeighborhoodMixer(Mixer):
    """Neighborhood-robust aggregation through the fused gather-sort
    kernel (:func:`repro_torch.kernels.gather_robust_mix.
    gather_robust_mix`) over the column-tiled flatten, one launch per
    tile.

    Wraps a neighborhood-scope trimmed mean or median with a gather table
    attached.  The membership mask, contributor count and slot weights are
    computed outside the kernel on (K, D) tensors, so only the O(K D M)
    gather/sort/contract runs fused.  ``use_kernel=None`` is an auto
    decision that :func:`repro_torch.core.graphs.check_mixer_support`
    turns off (delegating to the inner mixer's all-slots sort) when the
    graph leaves the base support; an explicit ``True`` makes that a
    build-time error.  On the CPU the kernel's plain version runs.
    """

    linear = False
    uses_matrix = True

    def __init__(self, inner: _SortedRobustMixer,
                 topology: topo_lib.Topology, *,
                 use_kernel: bool | None = None):
        if inner.scope != "neighborhood":
            raise ValueError(
                "FusedNeighborhoodMixer fuses the neighborhood scope; got "
                f"scope={inner.scope!r}")
        if isinstance(inner, AdaptiveTrimMixer):
            raise ValueError("adaptive_trim weights depend on the data per "
                             "coordinate; the fused kernel takes per-row "
                             "slot weights")
        if topology is None:
            raise ValueError("FusedNeighborhoodMixer needs the base "
                             "topology (source of the neighbor table)")
        inner.attach_neighbor_table(topology)
        self.inner = inner
        self.name = inner.name
        self.num_agents = inner.num_agents
        self.use_kernel = use_kernel
        self._use_kernel_auto = use_kernel is None

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor) -> PyTree:
        use = True if self.use_kernel is None else bool(self.use_kernel)
        if not use or self.inner._table is None:
            return self.inner(params, active, A_t)
        from repro_torch.kernels.gather_robust_mix import (gather_robust_mix,
                                                           share_sorts)

        idx, member, S = self.inner._gather_members(active, A_t)
        wslot = self.inner._slot_weights(S, idx.shape[1])
        act = active.to(device=idx.device, dtype=torch.float32)
        plan = (share_sorts(self.inner._table.plan(idx.device), idx, member,
                            wslot, act) if idx.device.type == "cuda"
                else None)
        # the kernel's inactive branch returns the agent's own float32 row;
        # the round trip is exact for bf16/f16/f32 leaves
        return tree_unflatten(params, tiled_apply(
            tree_leaves(params), lambda tile: gather_robust_mix(
                idx, member, wslot, act, tile, plan)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FusedNeighborhoodMixer({self.inner!r}, "
                f"use_kernel={self.use_kernel})")


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def _resolve_auto(topology: topo_lib.Topology | None,
                  offsets: Sequence[int] | None, device: torch.device):
    """Pick a backend name, as ``repro.core.mixing._resolve_auto`` does;
    CUDA takes the reference's TPU branch (the fused kernel).  Returns
    (name, offsets) so the sparse branch is built with exactly the offsets
    the decision was based on."""
    if device.type == "cuda":
        return "pallas", offsets
    if topology is not None and topology.max_degree < topology.num_agents - 1:
        offsets = topology.neighbor_offsets_ring()
    if offsets and 0 < len(offsets) <= _AUTO_SPARSE_MAX_OFFSETS:
        return "sparse", offsets
    if (topology is not None
            and _AUTO_GATHER_HEADROOM * (topology.max_degree + 1)
            <= topology.num_agents):
        return "gather", offsets
    return "dense", offsets


def make_mixer(name: str | Mixer, topology: topo_lib.Topology | None = None,
               *, A=None, offsets: Sequence[int] | None = None,
               num_agents: int | None = None, trim: int = 1, scope: str = "global", gather: str = "auto",
               device: str | torch.device | None = None) -> Mixer:
    """Build a mixing backend.

    Args:
      name: "dense" | "sparse" | "pallas" | "gather" | "auto" | "none" |
        "trimmed_mean" | "median" | "adaptive_trim", or an existing
        :class:`Mixer` (returned unchanged).
      topology: source of the circulant offsets / neighbor table / auto
        policy / K.
      A: (K, K) base matrix, used only to infer ``num_agents``.
      offsets: circulant offsets override for the sparse path.
      num_agents: disables mixing when 1 (returns :class:`NullMixer`).
      trim: per-side trim for "trimmed_mean"; per-side trim cap for
        "adaptive_trim".
      scope: robust-aggregation scope, "global" or "neighborhood".
      gather: bounded-degree policy for the neighborhood-robust scope:
        "auto" (attach the neighbor table when a topology is given, and on
        CUDA fuse through :class:`FusedNeighborhoodMixer`), "table"
        (gathered plain torch, topology required), "fused" (the gather-sort
        kernel, topology required), or "off" (the all-slots sort, valid
        even off base support).
      device: where the stack lives; "auto" picks the fused kernels on
        CUDA.  ``None`` means CUDA when a card is present.
    """
    if isinstance(name, Mixer):
        return name
    if num_agents is None:
        if topology is not None:
            num_agents = topology.num_agents
        elif A is not None:
            num_agents = int(np.asarray(A).shape[0])
    if name == "none" or (num_agents is not None and num_agents <= 1):
        return NullMixer()
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if name in _ROBUST:
        if num_agents is None:
            raise ValueError(f"{name!r} mixer needs num_agents "
                             "(or a topology / A to infer it from)")
        if gather not in ("auto", "table", "fused", "off"):
            raise ValueError(f"gather={gather!r} must be auto|table|"
                             "fused|off")
        if name == "adaptive_trim" and gather == "fused":
            raise ValueError(
                "adaptive_trim computes data-dependent per-coordinate "
                "weights: the fused kernel precomputes slot weights per "
                "row and cannot apply it; use gather=table|auto|off")
        mixer = (TrimmedMeanMixer(num_agents, trim=trim, scope=scope)
                 if name == "trimmed_mean"
                 else AdaptiveTrimMixer(num_agents, trim=trim, scope=scope)
                 if name == "adaptive_trim"
                 else CoordinateMedianMixer(num_agents, scope=scope))
        if scope != "neighborhood":
            return mixer
        if gather == "off":
            mixer._gather_mode = "off"
            return mixer
        if gather in ("table", "fused") and topology is None:
            raise ValueError(
                f"gather={gather!r} needs the base topology (source of "
                "the neighbor table): pass topology=")
        if topology is None:
            # auto without structure: the all-slots sort for now;
            # check_mixer_support attaches a table from graph.topology
            return mixer
        if name != "adaptive_trim" and (
                gather == "fused" or (gather == "auto"
                                      and dev.type == "cuda")):
            # the inner mixer stays "auto", so an off-support graph
            # degrades to the all-slots sort instead of erroring
            return FusedNeighborhoodMixer(mixer, topology)
        mixer.attach_neighbor_table(topology)
        if gather == "table":
            mixer._gather_mode = "table"
        return mixer
    if name == "auto":
        name, offsets = _resolve_auto(topology, offsets, dev)
    if name == "dense":
        return DenseMixer()
    if name == "sparse":
        if offsets is None:
            if topology is None:
                raise ValueError("sparse mixer needs circulant offsets "
                                 "(pass offsets= or a topology)")
            offsets = topology.neighbor_offsets_ring()
        return SparseCirculantMixer(offsets)
    if name == "gather":
        if topology is None:
            raise ValueError("gather mixer needs the base topology "
                             "(source of the neighbor table)")
        return NeighborGatherMixer(topology)
    if name == "pallas":
        return PallasFusedMixer()
    raise ValueError(f"unknown mixer {name!r} (expected dense|sparse|"
                     "pallas|gather|auto|none|trimmed_mean|median|"
                     "adaptive_trim)")


def _tree_sq_norm(tree: PyTree) -> torch.Tensor:
    """Sum of squares over every leaf (float32 scalar)."""
    return sum(torch.sum(torch.square(leaf.float()))
               for leaf in tree_leaves(tree))


def choco_gamma(spectral_gap: float, delta: float, beta: float) -> float:
    """The CHOCO-Gossip consensus step size (Koloskova et al. 2019, Thm. 2):

        gamma* = rho^2 delta / (16 rho + rho^2 + 4 beta^2
                                + 2 rho beta^2 - 8 rho delta)

    with ``rho`` the spectral gap 1 - |lambda_2(A)|, ``delta`` the
    compressor contraction and ``beta = ||I - A||_2``, clipped to
    [1e-4, 1].  The adaptive pipeline uses it as the floor.
    """
    rho = float(spectral_gap)
    delta = float(delta)
    beta = float(beta)
    denom = (16.0 * rho + rho ** 2 + 4.0 * beta ** 2
             + 2.0 * rho * beta ** 2 - 8.0 * rho * delta)
    return float(np.clip(rho ** 2 * delta / max(denom, 1e-12), 1e-4, 1.0))


class CommPipeline:
    """Staged combination step with pluggable compression.

    Counterpart of ``repro.core.mixing.CommPipeline``, with its three
    exchange modes (``mode="auto"`` picks per compressor: identity for
    none, diff for the sparsifiers, direct otherwise):

    * ``"identity"`` — no compression: the pipeline IS the mixer.
    * ``"direct"`` — transmit the compressed iterate and correct locally:
      ``c = C(psi [+ e])``, ``w_k = psi_k + gamma ([A_eff^T c]_k - c_k)``.
      With int8 and the fused mixer, quantization and combination go
      through :meth:`PallasFusedMixer.mix_int8` (the fused dequantize+mix
      kernel); every other mixer or compressor takes the generic branch
      (``comp.encode``: int8 with per-leaf scales, then the mixer).  Error
      feedback threads the residual e through ``comm_state``.
    * ``"diff"`` — CHOCO's reference difference: ``c =
      C_contractive(psi - ref)``, ``ref' = ref + c``, ``w_k = psi_k +
      gamma ([A_eff^T ref']_k - ref'_k)``; an error-feedback wrapper is
      dropped (the reference copy is the feedback).

    ``gamma``: a float, ``None`` (1.0 for direct mode and lossless ratios,
    0.5 for top-k, ``ratio`` for rand-k and the Gaussian mask) or
    ``"auto"`` (diff mode only; elsewhere it warns and takes the default):
    the CHOCO floor (:func:`choco_gamma` from ``base_A``'s spectral gap
    and ``||I - A||_2``) annealed toward 1 by an EMA of the observed
    contraction over active agents, kept in ``comm_state["delta"]``.

    Inactive agents transmit nothing: their EF residual and reference copy
    are kept exactly (the ``masked`` select).  ``key`` is a
    ``torch.Generator`` or :class:`~repro_torch.core.compression.Draws`
    (for the fused int8 branch, ``Draws(u=...)`` with one (K, M_padded)
    tensor).  The combination runs under ``torch.no_grad()``.  Robust
    mixers take the identity mode only; the reference's ``mesh`` (sharded
    int8 wire) comes with ROADMAP.md item 25.

    With ``secure_agg`` (a stage from
    :func:`repro_torch.core.privacy.make_secure_agg`) the identity-mode
    combination runs through pairwise-canceling per-edge wire masks in
    place of the mixer: the payloads are noise to an honest-but-curious
    receiver and the combination stays exact up to float accumulation.
    The pipeline then carries the block counter (the mask epoch) in
    ``comm_state``; ``key`` may hold the realized masks
    (``Draws(noise=eta)``, replay).  The masks presume a linear combination
    of uncompressed payloads, so compressed modes, the null mixer and
    robust mixers are refused.
    """

    def __init__(self, mixer: Mixer, compressor=None, *, mode: str = "auto",
                 gamma=None, base_A=None, secure_agg=None):
        self.mixer = mixer
        self.compressor = (compressor if compressor is not None
                           else comp_lib.Identity())
        base = self._base()
        if mode == "auto":
            if isinstance(base, comp_lib.Identity) and not self._ef():
                mode = "identity"
            elif isinstance(base, (comp_lib.TopK, comp_lib.RandK,
                                   comp_lib.GaussianMask)):
                mode = "diff"
            else:
                mode = "direct"
        if mode not in ("identity", "direct", "diff"):
            raise ValueError(f"unknown pipeline mode {mode!r} "
                             "(expected identity|direct|diff|auto)")
        if mode != "identity" and not mixer.linear:
            raise ValueError(
                f"{type(mixer).__name__} is a robust (non-linear) backend; "
                "the compressed exchange modes correct through mix(c) - c, "
                "which presumes linear mixing: use compress='none'")
        if mode == "identity" and (self._ef() or not isinstance(
                base, comp_lib.Identity)):
            raise ValueError("identity mode requires the Identity "
                             "compressor without error feedback")
        if mode == "diff" and self._ef():
            # the reference copy is the feedback in diff mode
            self.compressor = base
        self.mode = mode
        self.secure_agg = secure_agg
        if secure_agg is not None:
            # the masks telescope to zero inside each receiver's linear
            # weighted sum of uncompressed payloads, and nowhere else
            if mode != "identity":
                raise ValueError(
                    f"secure-agg wire masks require the uncompressed "
                    f"identity-mode pipeline; this pipeline runs {mode!r} "
                    "mode — use compress='none' (or drop secure_agg)")
            if isinstance(mixer, NullMixer):
                raise ValueError(
                    "secure-agg wire masks need a real combination step "
                    "(K >= 2, mixing enabled) — there is no wire to mask")
            if not mixer.linear:
                raise ValueError(
                    f"{type(mixer).__name__} is a robust (non-linear) "
                    "backend; per-edge masks only cancel inside a linear "
                    "combination — use a linear mixer kind (dense/sparse/"
                    "pallas/gather/auto) or drop secure_agg")
        self.adaptive = (gamma == "auto" and mode == "diff"
                         and not isinstance(mixer, NullMixer))
        if gamma == "auto" and not self.adaptive:
            warnings.warn(
                f'comm_gamma="auto" anneals the diff-mode consensus step; '
                f"this pipeline runs {mode!r} mode, so the fixed default "
                "gamma is used instead", stacklevel=2)
            gamma = None
        if self.adaptive:
            if base_A is None:
                raise ValueError(
                    'comm_gamma="auto" derives its floor from the base '
                    "topology's spectral gap: pass base_A (or build the "
                    "pipeline through an engine / make_pipeline with a "
                    "topology)")
            A0 = np.asarray(base_A, np.float64)
            rho = topo_lib.spectral_gap(A0)
            beta = float(1.0 - np.linalg.eigvalsh(A0).min())  # ||I - A||_2
            self._delta0 = float(min(max(getattr(base, "ratio", 1.0),
                                         1e-3), 1.0))
            self.gamma_floor = choco_gamma(rho, self._delta0, beta)
            self.spectral_gap = float(rho)
            self.gamma = "auto"
        elif gamma is None:
            ratio = getattr(base, "ratio", 1.0)
            if mode != "diff" or ratio >= 1.0:
                gamma = 1.0
            elif isinstance(base, comp_lib.TopK):
                gamma = 0.5
            else:
                gamma = float(ratio)
            self.gamma = float(gamma)
        else:
            self.gamma = float(gamma)

    def _ef(self) -> bool:
        return isinstance(self.compressor, comp_lib.ErrorFeedback)

    def _base(self) -> comp_lib.Compressor:
        c = self.compressor
        return c.inner if isinstance(c, comp_lib.ErrorFeedback) else c

    @property
    def stateful(self) -> bool:
        if isinstance(self.mixer, NullMixer):
            return False
        if self.secure_agg is not None:
            return True           # the block counter (mask epoch)
        if self.mode == "diff":
            return True
        return self.mode == "direct" and self.compressor.stateful

    @property
    def needs_key(self) -> bool:
        return self.compressor.needs_key

    def init_state(self, params: PyTree) -> PyTree:
        if not self.stateful:
            return ()
        if self.secure_agg is not None:
            # a host counter: it seeds the mask stream without a device sync
            return {"t": torch.zeros((), dtype=torch.int64)}
        if self.mode == "diff":
            state = {"ref": tree_map(torch.zeros_like, params)}
            if self.adaptive:
                device = tree_leaves(params)[0].device
                state["delta"] = torch.tensor(self._delta0,
                                              dtype=torch.float32,
                                              device=device)
            return state
        return self.compressor.init_state(params)

    def annealed_gamma(self, comm_state: PyTree) -> torch.Tensor:
        """The adaptive pipeline's consensus step for ``comm_state``: the
        CHOCO floor annealed toward 1 by sqrt of the contraction EMA."""
        if not self.adaptive:
            raise ValueError("annealed_gamma is defined for the adaptive "
                             '(gamma="auto") diff-mode pipeline only')
        d = torch.sqrt(torch.clamp(comm_state["delta"], 0.0, 1.0))
        return self.gamma_floor + (1.0 - self.gamma_floor) * d

    def wire_bytes(self, params: PyTree) -> int:
        """Value-payload bytes per combination step."""
        if isinstance(self.mixer, NullMixer) or self.mode == "identity":
            return (0 if isinstance(self.mixer, NullMixer)
                    else comp_lib.dense_wire_bytes(params))
        return self.compressor.wire_bytes(params)

    def __call__(self, params: PyTree, active: torch.Tensor,
                 A_t: torch.Tensor, comm_state: PyTree = (), key=None):
        """Apply the pipeline; returns ``(params, comm_state)``."""
        with torch.no_grad():
            return self._apply(params, active, A_t, comm_state, key)

    def _apply(self, params, active, A_t, comm_state, key):
        if self.mode == "identity":
            if self.secure_agg is not None:
                # the combination through per-edge masked payloads
                t = comm_state["t"]
                eta = key.noise if isinstance(key, comp_lib.Draws) else None
                return (self.secure_agg(params, active, A_t, t, eta=eta),
                        {"t": t + 1})
            return self.mixer(params, active, A_t), comm_state
        if isinstance(self.mixer, NullMixer):
            return params, comm_state
        comp = self.compressor
        base = self._base()
        if comp.needs_key and key is None:
            raise ValueError(f"{comp!r} needs a generator or Draws; pass "
                             "key=")
        keep = active > 0

        def masked(new, old):
            """Active agents take ``new``; inactive ones keep ``old``
            exactly (they transmit nothing)."""
            return tree_map(
                lambda n, o: torch.where(
                    keep.reshape((n.shape[0],) + (1,) * (n.ndim - 1)), n, o),
                new, old)

        if self.mode == "diff":
            ref_prev = comm_state["ref"]
            diff = tree_map(lambda p, r: p - r.to(p.dtype), params, ref_prev)
            c = base.encode_contractive(diff, key)
            ref = masked(tree_map(lambda r, ci: r + ci.to(r.dtype),
                                  ref_prev, c), ref_prev)
            del c
            mixed = self.mixer(ref, active, A_t)
            if self.adaptive:
                def act(tree):
                    return tree_map(lambda l: l * _bcast(active, l), tree)
                pre = _tree_sq_norm(act(diff))
                post = _tree_sq_norm(act(tree_map(
                    lambda p, r: p - r.to(p.dtype), params, ref)))
                delta_obs = torch.clamp(
                    1.0 - torch.sqrt(post / torch.clamp(pre, min=1e-30)),
                    0.0, 1.0)
                delta_obs = torch.where(pre > 1e-30, delta_obs,
                                        comm_state["delta"])
                delta = 0.9 * comm_state["delta"] + 0.1 * delta_obs
                g = self.annealed_gamma({"delta": delta})
                # g is a float32 tensor: the product is taken in float32
                out = tree_map(
                    lambda p, mx, r: p + (g * (mx - r).float()).to(p.dtype),
                    params, mixed, ref)
                return out, {"ref": ref, "delta": delta}
            del diff
            g = self.gamma
            out = tree_map(
                lambda p, mx, r: p + _weak(g, p) * (mx - r).to(p.dtype),
                params, mixed, ref)
            return out, {"ref": ref}
        g = self.gamma
        ef = self._ef()
        if (isinstance(base, comp_lib.Int8Stochastic)
                and isinstance(self.mixer, PallasFusedMixer)):
            target = (tree_map(lambda p, e: p + e.to(p.dtype), params,
                               comm_state) if ef else params)
            u = key.u if isinstance(key, comp_lib.Draws) else None
            delta, msgs = self.mixer.mix_int8(
                target, active, A_t, None if u is not None else key,
                want_messages=ef, u=u)
            # the results are fresh stacks in the leaves' dtypes: the new
            # residual and iterate overwrite them, so the combination holds
            # no stack beyond target, delta and messages
            if ef:
                dead = ~keep
                for t, m, e in zip(tree_leaves(target), tree_leaves(msgs),
                                   tree_leaves(comm_state)):
                    m.sub_(t).neg_()            # t - m: negation is exact
                    m[dead] = e[dead]           # inactive agents keep theirs
                comm_state = msgs
            del target, msgs
            for p, d in zip(tree_leaves(params), tree_leaves(delta)):
                d.mul_(_weak(g, d)).add_(p)     # p + g d, rounded as p's dtype
            return delta, comm_state
        msgs, new_state = comp.encode(params, comm_state, key)
        if ef:
            new_state = masked(new_state, comm_state)
        mixed = self.mixer(msgs, active, A_t)
        out = tree_map(lambda p, mx, m: p + _weak(g, p) * (mx - m),
                       params, mixed, msgs)
        return out, new_state

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"CommPipeline({self.mixer!r}, {self.compressor!r}, "
                f"mode={self.mode!r}, gamma={self.gamma})")


def make_pipeline(mix: str | Mixer, topology: topo_lib.Topology | None = None,
                  *, compress=None, compress_ratio: float = 1.0,
                  error_feedback: bool = False, sigma: float = 0.0,
                  mode: str = "auto", gamma=None, A=None,
                  offsets: Sequence[int] | None = None,
                  num_agents: int | None = None, trim: int = 1, scope: str = "global", gather: str = "auto",
                  device: str | torch.device | None = None) -> CommPipeline:
    """The full combination pipeline: ``make_mixer`` with the mixer
    arguments, ``make_compressor`` with the compression ones, and
    :class:`CommPipeline` with ``mode``/``gamma`` and the base matrix
    (``A``, else the topology's)."""
    mixer = make_mixer(mix, topology, A=A, offsets=offsets,
                       num_agents=num_agents, trim=trim,
                       scope=scope, gather=gather, device=device)
    compressor = comp_lib.make_compressor(compress, ratio=compress_ratio,
                                          error_feedback=error_feedback,
                                          sigma=sigma)
    if A is None and topology is not None:
        A = topology.A
    return CommPipeline(mixer, compressor, mode=mode, gamma=gamma, base_A=A)
