"""Deterministic, shardable, checkpointable data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only), so a batch is
byte-identical to the JAX package's for the same (seed, step, shard).

Production posture: the loader is a pure function of (seed, step, shard), so
* any worker can reproduce any batch — restart/elastic-rescale safe,
* no coordinator state beyond the step counter (which rides the checkpoint),
* per-pod sharding falls out of slicing the global batch.

Two sources:
  * ``SyntheticLM`` — Zipf-distributed token documents with EOS framing and
    a learnable-structure flavor (repeated n-grams) so loss actually falls
    during the example runs; used by tests/examples/benchmarks.
  * ``MemmapLM`` — flat token file (np.memmap) with deterministic strided
    sampling; drop-in for real corpora.

Batches are {"tokens": (B, S[, K]) int32, "targets": same, "mask": f32}.
Targets are tokens shifted one position (next-token prediction); the final
position is masked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    vocab: int = 32000
    num_codebooks: int = 1
    path: Optional[str] = None      # set => MemmapLM
    ngram_vocab: int = 64           # synthetic structure strength


class SyntheticLM:
    """Deterministic synthetic corpus: batch = f(seed, step, shard)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard])
        )
        shape = (self.local_batch, cfg.seq_len + 1)
        if cfg.num_codebooks > 1:
            shape = shape + (cfg.num_codebooks,)
        # Zipf body with periodic structure: documents repeat a small n-gram
        # alphabet so a capable model can reduce loss quickly.
        zipf = rng.zipf(1.3, size=shape)
        tokens = (zipf % max(cfg.vocab - 2, 2)) + 1
        # overlay: every other document is a repeated 8-gram
        motif_len = 8
        motif = rng.integers(1, min(cfg.ngram_vocab, cfg.vocab - 1),
                             size=(self.local_batch, motif_len) + shape[2:])
        reps = -(-(cfg.seq_len + 1) // motif_len)
        pattern = np.tile(motif, (1, reps) + (1,) * (len(shape) - 2))[:, : cfg.seq_len + 1]
        structured = rng.random(self.local_batch) < 0.5
        tokens[structured] = pattern[structured]
        tokens = tokens.astype(np.int32)
        inputs = tokens[:, :-1]
        targets = tokens[:, 1:]
        mask = np.ones(targets.shape[:2], np.float32)
        return {"tokens": inputs, "targets": targets, "mask": mask}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLM:
    """Flat-token-file corpus with deterministic strided sampling."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        if cfg.path is None:
            raise ValueError("MemmapLM needs DataConfig.path")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard])
        )
        idx = rng.integers(0, self.n_windows, size=self.local_batch)
        starts = idx * cfg.seq_len
        rows = np.stack([self.data[s : s + cfg.seq_len + 1] for s in starts])
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "targets": rows[:, 1:].astype(np.int32),
            "mask": np.ones((self.local_batch, cfg.seq_len), np.float32),
        }


def make_pipeline(cfg: DataConfig, shard: int = 0, num_shards: int = 1):
    if cfg.path:
        return MemmapLM(cfg, shard, num_shards)
    return SyntheticLM(cfg, shard, num_shards)


def data_config_for(model: ModelConfig, seq_len: int, global_batch: int,
                    seed: int = 0) -> DataConfig:
    return DataConfig(
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
        vocab=model.vocab,
        num_codebooks=model.num_codebooks,
    )
