"""The benchmark's plain reference: one module per model family
(``reference/<family>.py``, found by the configuration's ``family``) and
the block arithmetic they share (:mod:`portbench.reference.common`).
Nothing here imports the program under test."""
import importlib


def family(name: str):
    """The reference module of model family ``name``."""
    return importlib.import_module(f"portbench.reference.{name}")
