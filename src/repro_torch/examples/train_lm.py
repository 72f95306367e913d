"""End-to-end driver: train a language model with Algorithm 1.

Runs the reduced smollm config by default (CPU-friendly); on a real mesh the
same code path trains the full configs.  A few hundred blocks of training on
a fixed synthetic dataset demonstrates the full pipeline: data -> per-agent
local steps -> masked combination -> loss tracking -> checkpoint.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --blocks 100 \
        [--device cpu]

Counterpart of ``examples/train_lm.py``, with its flags and defaults and
``--device`` (default CUDA, never a fallback).  The reference's keys
become host generators: seed 0 draws the K agents' initial parameters one
after another and then each block's draws, seed 9 the fixed dataset, so
the card and the CPU train the same run.  The step runs eagerly.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.diffusion import DiffusionConfig
from repro_torch.core.sharded import make_block_step
from repro_torch.data.synthetic import lm_token_batch
from repro_torch.device import resolve_device
from repro_torch.launch.train import init_stacked
from repro_torch.models import transformer as tf
from repro_torch.optim import adam
from repro_torch.tree import tree_map

__all__ = ["eval_loss", "main", "make_step", "parser"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--blocks", type=int, default=100)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--participation", type=float, default=0.8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint", default="/tmp/repro_lm_ckpt.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    return ap


def make_step(args, device):
    """(smoke config, block step, Adam) of the flags ``args``: Algorithm 1
    on a ring with the sparse mixer and Adam through ``grad_transform``."""
    cfg = get_config(args.arch).smoke
    K, T = args.agents, args.local_steps
    dcfg = DiffusionConfig(num_agents=K, local_steps=T, step_size=args.lr,
                           topology="ring", participation=args.participation)
    topo = dcfg.make_topology()
    opt = adam()

    def loss_fn(p, b, r):
        return tf.train_loss(p, cfg, b, remat=False)

    block_step = make_block_step(
        loss_fn, dcfg, torch.as_tensor(topo.A, dtype=torch.float32),
        mix="sparse", offsets=topo.neighbor_offsets_ring(),
        grad_transform=opt.update, device=device)
    return cfg, block_step, opt


def eval_loss(params, cfg, batch) -> torch.Tensor:
    """Each agent's loss on its own (B, S) batch: a (K,) float32 tensor."""
    K = batch["tokens"].shape[0]
    with torch.no_grad():
        return torch.stack([
            tf.train_loss(tree_map(lambda x, k=k: x[k], params), cfg,
                          tree_map(lambda x, k=k: x[k], batch), remat=False)
            for k in range(K)])


def main(argv=None) -> dict:
    """Train; returns the config, the final state, the printed losses by
    block (``losses``), every block's realized mask (``active``) and the
    checkpoint path."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, block_step, opt = make_step(args, dev)
    K, T = args.agents, args.local_steps

    key = torch.Generator().manual_seed(0)
    params = init_stacked(key, cfg, K, dev)
    state = block_step.init_state(params, opt.init(params))
    data = {name: x.to(dev) for name, x in lm_token_batch(
        torch.Generator().manual_seed(9), (T, K, args.batch, args.seq),
        cfg.vocab_size).items()}
    losses, active = {}, []
    t0 = time.time()
    for i in range(args.blocks):
        state, metrics = block_step(state, data, key)
        active.append(metrics["active"].cpu())
        if i % 10 == 0:
            l = eval_loss(state.params, cfg, tree_map(lambda x: x[0], data))
            losses[i] = float(l.mean())
            print(f"block {i:4d} active={int(metrics['active'].sum())}/{K} "
                  f"loss={losses[i]:.4f} t={time.time() - t0:.1f}s")
    save_checkpoint(args.checkpoint, state.params, step=args.blocks,
                    metadata={"arch": args.arch})
    print("checkpoint saved to", args.checkpoint)
    return {"cfg": cfg, "state": state, "losses": losses, "active": active,
            "checkpoint": args.checkpoint}


if __name__ == "__main__":
    main()
