"""Per-agent data pipeline: partitions, token corpora, replayable blocks,
and the training driver's block providers.

Counterpart of ``repro.data.pipeline`` and of the block providers of
``repro.api.build``.  Diffusion learning's statistics depend on who holds
which data, so the pipeline does two jobs:

1. **Partitioning** a corpus across K agents: label-Dirichlet
   (:func:`dirichlet_partition`, the federated non-IID protocol) or
   contiguous shards (:func:`contiguous_partition`).
2. **Block iteration** (:class:`BlockIterator`): (T, K, B, S) blocks in
   the engines' layout, each a pure function of ``(seed, block index,
   agent)``, so any block can be re-derived after a resume.

Everything up to the last step is host numpy, the reference's draws in the
reference's order, so partitions and blocks are bit-equal to the
reference's; the blocks then become int32 tensors on the iterator's device
(``None`` means CUDA).

The providers (:func:`make_block_provider`) are the data half of the
training loop, ``provider(block_index, key) -> batch``: ``"iid"`` draws
fresh uniform tokens from the host generator ``key`` every block (the
port's own stream, :func:`repro_torch.data.synthetic.lm_token_batch`),
``"dirichlet"`` and ``"shards"`` partition a seeded Zipf corpus
(:meth:`TokenDataset.synthetic`) and replay any block from its index.
They take plain arguments in place of the reference's ``DataSpec`` and
``ExperimentSpec`` and keep the reference's names.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DATA_KINDS", "BlockIterator", "TokenDataset",
           "contiguous_partition", "dirichlet_partition",
           "make_block_provider", "train_block_struct"]

#: the partition kinds of the training driver's ``--data``
DATA_KINDS = ("iid", "dirichlet", "shards")

#: the reference's stubbed vision-encoder output width (image prefixes)
VISION_DIM = 1024


def dirichlet_partition(labels: np.ndarray, K: int, alpha: float,
                        seed: int = 0,
                        min_per_agent: int = 1) -> list[np.ndarray]:
    """Label-Dirichlet non-IID split (Hsu et al. protocol).

    For each class c, proportions p_c ~ Dir(alpha · 1_K) split the class's
    indices across agents; alpha -> inf recovers IID, alpha -> 0 gives
    one-class agents.  Agents short of ``min_per_agent`` take the last
    index of the largest one.  Returns K index arrays.
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    buckets: list[list[int]] = [[] for _ in range(K)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(K, alpha))
        cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for k, part_idx in enumerate(np.split(idx, cuts)):
            buckets[k].extend(part_idx.tolist())
    out = [np.asarray(sorted(b), dtype=np.int64) for b in buckets]
    for k in range(K):
        while len(out[k]) < min_per_agent:
            donor = int(np.argmax([len(o) for o in out]))
            out[k] = np.append(out[k], out[donor][-1])
            out[donor] = out[donor][:-1]
    return out


def contiguous_partition(n: int, K: int) -> list[np.ndarray]:
    """Contiguous equal shards: document-locality non-IIDness."""
    cuts = np.linspace(0, n, K + 1).astype(int)
    return [np.arange(cuts[k], cuts[k + 1], dtype=np.int64) for k in range(K)]


@dataclasses.dataclass
class TokenDataset:
    """A flat token corpus and its sequence-window view."""

    tokens: np.ndarray          # (N,) int32
    seq_len: int

    @property
    def num_windows(self) -> int:
        return max(0, (len(self.tokens) - 1) // self.seq_len)

    def window(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s = i * self.seq_len
        x = self.tokens[s:s + self.seq_len]
        y = self.tokens[s + 1:s + self.seq_len + 1]
        return x, y

    @classmethod
    def synthetic(cls, vocab: int, n_tokens: int, seq_len: int,
                  seed: int = 0, zipf_a: float = 1.2) -> "TokenDataset":
        """Zipf-distributed synthetic corpus."""
        rng = np.random.default_rng(seed)
        ranks = rng.zipf(zipf_a, size=n_tokens)
        return cls(tokens=(np.minimum(ranks, vocab) - 1).astype(np.int32),
                   seq_len=seq_len)


class BlockIterator:
    """Deterministic (T, K, B, S) block batches for the diffusion engines.

    Agent k draws only from its partition; the window indices are a pure
    function of ``(seed, block index, k)`` (:meth:`windows`), so iteration
    replays from any block after a restore.  ``block`` returns int32
    tensors on ``device`` (``None`` means CUDA).
    """

    def __init__(self, dataset: TokenDataset, partitions: list[np.ndarray],
                 *, local_steps: int, per_agent_batch: int, seed: int = 0,
                 device=None):
        self.ds = dataset
        self.parts = [np.asarray(p) for p in partitions]
        if any(len(p) == 0 for p in self.parts):
            raise ValueError("every agent needs at least one window")
        self.T = local_steps
        self.B = per_agent_batch
        self.seed = seed
        self.device = resolve_device(device)

    @property
    def num_agents(self) -> int:
        return len(self.parts)

    def windows(self, index: int) -> np.ndarray:
        """(K, T, B) corpus window indices of block ``index``: agent k's
        from its partition, by a generator seeded ``(seed, index, k)``."""
        out = np.empty((self.num_agents, self.T, self.B), np.int64)
        for k, part in enumerate(self.parts):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, index, k]))
            out[k] = part[rng.integers(0, len(part), size=(self.T, self.B))]
        return out

    def block(self, index: int) -> dict:
        K, T, B, S = self.num_agents, self.T, self.B, self.ds.seq_len
        tokens = np.empty((T, K, B, S), np.int32)
        labels = np.empty((T, K, B, S), np.int32)
        for k, draw in enumerate(self.windows(index)):
            for t in range(T):
                for b in range(B):
                    x, y = self.ds.window(int(draw[t, b]))
                    tokens[t, k, b], labels[t, k, b] = x, y
        return {"tokens": torch.from_numpy(tokens).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.block(i)
            i += 1


# ---------------------------------------------------------------------------
# the training driver's block providers
# ---------------------------------------------------------------------------

def train_block_struct(cfg, *, T: int, K: int, batch: int,
                       seq: int) -> dict:
    """``{name: (shape, dtype)}`` of one (T, K, B, S[, C]) training block:
    the one place the engines' block layout is written down."""
    tok_shape = (T, K, batch, seq)
    if cfg.num_codebooks:
        tok_shape = tok_shape + (cfg.num_codebooks,)
    out = {"tokens": (tok_shape, torch.int32),
           "labels": (tok_shape, torch.int32)}
    if cfg.img_tokens:
        out["img_embeds"] = ((T, K, batch, cfg.img_tokens, VISION_DIM),
                             torch.float32)
    return out


def _token_struct(cfg, **shape) -> dict:
    """:func:`train_block_struct` of a text-only config: the image-prefix
    archs (llava) come with ROADMAP.md queue 1 item 17."""
    if cfg.img_tokens:
        raise NotImplementedError("image-prefix blocks are not ported yet: "
                                  "see ROADMAP.md queue 1 item 17")
    return train_block_struct(cfg, **shape)


def _iid_provider(cfg, *, num_agents: int, local_steps: int, batch: int,
                  seq: int, device=None):
    """Fresh uniform tokens every block from the host generator ``key``
    (the block index is ignored)."""
    from repro_torch.data.synthetic import lm_token_batch

    device = resolve_device(device)
    shape = _token_struct(cfg, T=local_steps, K=num_agents, batch=batch,
                          seq=seq)["tokens"][0]

    def provider(index: int, key: torch.Generator) -> dict:
        return {name: x.to(device) for name, x in lm_token_batch(
            key, shape, cfg.vocab_size).items()}

    return provider


def _corpus_provider(kind: str, cfg, partition_fn, *, num_agents: int,
                     local_steps: int, batch: int, seq: int, seed: int,
                     corpus_tokens: int, device=None):
    """The partitioned-corpus kinds: a seeded Zipf :class:`TokenDataset`,
    per-agent window partitions from ``partition_fn(n_windows, K)``, and
    an index-replayable :class:`BlockIterator`.  The provider carries
    ``.iterator``, ``.partitions`` and ``.dataset``."""
    if cfg.num_codebooks:
        raise ValueError(
            f"data kind {kind!r} partitions a flat token corpus, "
            "which has no codebook axis — multi-codebook archs take the "
            'synthetic stream (data kind "iid")')
    _token_struct(cfg, T=local_steps, K=num_agents, batch=batch, seq=seq)
    ds = TokenDataset.synthetic(cfg.vocab_size, corpus_tokens, seq,
                                seed=seed)
    parts = partition_fn(ds.num_windows, num_agents)
    it = BlockIterator(ds, parts, local_steps=local_steps,
                       per_agent_batch=batch, seed=seed, device=device)

    def provider(index: int, key: torch.Generator) -> dict:
        return it.block(index)

    provider.iterator = it
    provider.partitions = parts
    provider.dataset = ds
    return provider


def _dirichlet_provider(cfg, *, num_agents: int, local_steps: int,
                        batch: int, seq: int, alpha: float = 1.0,
                        clusters: int = 4, seed: int = 0,
                        corpus_tokens: int = 65536, device=None):
    """Label-Dirichlet skew over ``clusters`` latent classes: corpus
    windows are labelled by contiguous cluster (document locality), then
    dealt to agents by per-class Dirichlet(alpha) draws."""
    def partition(n_windows, K):
        if n_windows < K:
            raise ValueError(
                f"corpus of {n_windows} windows cannot cover {K} agents — "
                "raise DataSpec.corpus_tokens or shrink RunSpec.seq")
        C = max(1, clusters)
        labels = (np.arange(n_windows) * C) // n_windows
        return dirichlet_partition(labels, K, alpha, seed=seed)

    return _corpus_provider(
        "dirichlet", cfg, partition, num_agents=num_agents,
        local_steps=local_steps, batch=batch, seq=seq, seed=seed,
        corpus_tokens=corpus_tokens, device=device)


def _shards_provider(cfg, *, num_agents: int, local_steps: int, batch: int,
                     seq: int, shards_per_agent: int = 1, seed: int = 0,
                     corpus_tokens: int = 65536, device=None):
    """Contiguous disjoint shards: the corpus splits into K x
    ``shards_per_agent`` equal shards, dealt ``shards_per_agent`` per agent
    in a seeded order."""
    def partition(n_windows, K):
        S = max(1, shards_per_agent)
        if n_windows < K * S:
            raise ValueError(
                f"corpus of {n_windows} windows cannot cover {K} agents x "
                f"{S} shards — raise DataSpec.corpus_tokens or shrink "
                "RunSpec.seq/DataSpec.shards_per_agent")
        shards = contiguous_partition(n_windows, K * S)
        deal = np.random.default_rng(seed).permutation(K * S)
        return [np.concatenate([shards[j] for j in deal[k * S:(k + 1) * S]])
                for k in range(K)]

    return _corpus_provider(
        "shards", cfg, partition, num_agents=num_agents,
        local_steps=local_steps, batch=batch, seq=seq, seed=seed,
        corpus_tokens=corpus_tokens, device=device)


_PROVIDERS = {"iid": _iid_provider, "dirichlet": _dirichlet_provider,
              "shards": _shards_provider}


def make_block_provider(kind: str, cfg, *, num_agents: int,
                        local_steps: int, batch: int, seq: int,
                        device=None, **kwargs):
    """``provider(block_index, key) -> batch`` of data kind ``kind`` (one
    of :data:`DATA_KINDS`); ``kwargs`` are the kind's own fields
    (``alpha``, ``clusters``, ``shards_per_agent``, ``seed``,
    ``corpus_tokens``)."""
    if kind not in _PROVIDERS:
        raise ValueError(f"unknown data kind {kind!r} — valid kinds: "
                         f"{sorted(_PROVIDERS)}")
    return _PROVIDERS[kind](cfg, num_agents=num_agents,
                            local_steps=local_steps, batch=batch, seq=seq,
                            device=device, **kwargs)
