"""Registry-driven extension: a third-party time-varying graph kind.

Registers a custom :class:`repro_torch.core.graphs.GraphProcess` — a
*rotating hub*: each block one agent acts as the hub of a star graph and
everyone averages through it, with the hub role cycling deterministically
(the hub index is carried in ``EngineState.graph_state``, so the example
also exercises stateful-graph checkpoint threading).  One
``@GRAPHS.register("hub_rotate")`` decorator is the entire integration:
after that the kind is reachable from a plain ``--spec`` JSON file (and
any other GraphSpec site — checkpoints embed it, serve rebuilds it), with
no changes to the engines, the CLI, or the checkpoint format.

Run:
    PYTHONPATH=src python -m repro_torch.examples.custom_graph [--device cpu]

Counterpart of ``examples/custom_graph.py``.  The port's graph builders
take ``(spec, topology, K, device)``; the hub index lives on the host, the
realized matrices on the engine's device.  Importing this module
registers the kind, and a registry refuses a second registration of one
name, so import it once per process.  :func:`run` returns what
:func:`main` prints.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.api import GRAPHS, ExperimentSpec, build
from repro_torch.core import variants
from repro_torch.core.diffusion import network_msd
from repro_torch.core.graphs import GraphProcess, metropolis_weights_torch
from repro_torch.data.synthetic import (make_block_sampler,
                                        make_regression_problem)
from repro_torch.device import resolve_device

__all__ = ["BLOCKS", "RotatingHub", "SPEC_JSON", "main", "run"]

BLOCKS = 400


class RotatingHub(GraphProcess):
    """Star graph whose hub cycles through the agents, one per block.

    Every realized matrix is the Metropolis weighting of a star centred on
    the current hub — symmetric doubly stochastic like every GraphProcess
    draw, but the *information route* changes each block (agent k talks to
    everyone once every K blocks).  Deterministic and stateful: the hub
    index is the graph state.
    """

    name = "hub_rotate"
    stateful = True
    within_base_support = False        # the star leaves ring supports

    def __init__(self, num_agents: int, device=None):
        self._K = int(num_agents)
        self.device = None if device is None else torch.device(device)

    @property
    def num_agents(self) -> int:
        return self._K

    def base_matrix(self) -> torch.Tensor:
        # average over one full rotation — what theory surrogates consume
        A = sum(self._star(h).numpy() for h in range(self._K))
        return self._out(torch.as_tensor(A / self._K, dtype=torch.float32))

    def _star(self, hub) -> torch.Tensor:
        K = self._K
        idx = torch.arange(K)
        off = ((idx[:, None] == hub) | (idx[None, :] == hub)).to(
            torch.float32) * (1.0 - torch.eye(K, dtype=torch.float32))
        return metropolis_weights_torch(off)

    def init_state(self, key, *, u=None) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32)

    def sample(self, state, key, *, u=None):
        hub = torch.remainder(state, self._K)
        return self._out(self._star(hub)), state + 1


@GRAPHS.register("hub_rotate")
def _build_hub_rotate(spec, topology, K, device=None):
    return RotatingHub(K, device=device)


# the spec arrives as plain JSON — exactly what --spec consumes — and the
# custom kind resolves through the registry like any built-in
SPEC_JSON = json.dumps({
    "topology": {"kind": "ring"},
    "graph": {"kind": "hub_rotate"},
    "participation": {"kind": "iid", "q": 0.9},
    "run": {"num_agents": 8, "local_steps": 2, "step_size": 0.02},
})


def run(blocks: int = BLOCKS, device=None) -> dict:
    """The rotating hub and the static ring for ``blocks`` blocks each on
    ``device`` (``None`` means CUDA), printing the reference's lines and
    holding its check (the hub's steady MSD below 50x the ring's).
    Returns the steady MSDs by label, the hub index after the run
    (``hub_index``) and the MSD histories."""
    dev = resolve_device(device)
    K, M = 8, 2
    data = make_regression_problem(K=K, N=60, M=M, rho=0.1, seed=0)
    w_opt = torch.as_tensor(data.problem().w_opt(np.full(K, 0.9)),
                            dtype=torch.float32, device=dev)
    sampler = make_block_sampler(data, T=2, batch=2, device=dev)

    spec = ExperimentSpec.from_json(SPEC_JSON)
    print("spec.graph:", spec.graph)

    results, histories, hub_index = {}, {}, None
    for label, s in (("hub_rotate", spec),
                     ("static ring", variants.asynchronous_diffusion(
                         K, mu=0.02, q=0.9).replace(run=spec.run))):
        eng = build(s, data.loss_fn(), device=dev, grad_fn=data.grad_fn())
        state = eng.init_state(torch.zeros((K, M), device=dev),
                               key=torch.Generator().manual_seed(1))
        key = torch.Generator().manual_seed(0)
        hist = []
        for _ in range(blocks):
            state, _ = eng.step(state, sampler(key), key)
            hist.append(float(network_msd(state.params, w_opt)))
        results[label] = float(np.mean(hist[-blocks // 4:]))
        histories[label] = hist
        print(f"{label:12s} graph={eng.graph!r:30s} "
              f"steady MSD={results[label]:.4e}")
        if label == "hub_rotate":
            if state.graph_state is None:
                raise AssertionError("the rotating hub carried no state")
            hub_index = int(state.graph_state)
            print(f"{'':12s} hub index after {blocks} blocks:", hub_index)
    # the rotating hub routes everything through one agent per block —
    # slower mixing than the ring, but it must still converge
    if not results["hub_rotate"] < 50 * results["static ring"]:
        raise AssertionError(
            f"the rotating hub's steady MSD {results['hub_rotate']:.4e} is "
            f"not below 50x the ring's {results['static ring']:.4e}")
    print("CUSTOM_GRAPH_OK")
    return {"steady": results, "hub_index": hub_index,
            "history": histories}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
