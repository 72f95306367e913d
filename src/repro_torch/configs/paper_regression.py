"""The paper's own experimental setting (§VII): K=20 agents, 2-dim ridge
regression, mu=0.01, rho=0.1, T=5, non-IID means and noise variances.

Counterpart of ``repro.configs.paper_regression``.  Like the reference's,
it is not a model arch: :func:`repro_torch.configs.get_config` does not
list it.
"""
from repro_torch.core.diffusion import DiffusionConfig

K = 20
N = 100
M = 2
MU = 0.01
RHO = 0.1
T = 5

CITATION = "Paper §VII experimental setup (Figs. 5-7)"


def diffusion_config(T: int = T, participation=0.9,
                     topology: str = "erdos") -> DiffusionConfig:
    return DiffusionConfig(num_agents=K, local_steps=T, step_size=MU,
                           topology=topology, participation=participation)
