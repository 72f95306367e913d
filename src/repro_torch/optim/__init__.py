"""Gradient transformations for the diffusion engines."""
from repro_torch.optim.optimizers import GradTransform, adam, momentum, sgd

__all__ = ["GradTransform", "adam", "momentum", "sgd"]
