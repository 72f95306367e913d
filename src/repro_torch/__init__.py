"""PyTorch/CUDA port of :mod:`repro`, slice by slice (see ROADMAP.md).

Module paths and public names mirror the JAX package, so each counterpart
is found at the same place.  The port imports ``torch``, numpy and the
standard library only — never ``jax`` and nothing of ``repro``.

Entry points take ``device=None``, which means ``"cuda"``: without a card
they raise unless the caller asks for ``"cpu"`` (:func:`resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
