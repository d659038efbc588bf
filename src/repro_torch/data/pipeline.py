"""Deterministic, shardable LM token pipeline.

Requirements at 1000-node scale (system brief):
  * deterministic + seekable — fault-tolerant restart must be able to replay
    to an exact step, so batches are a pure function of (seed, step, shard);
  * per-host sharding — each host materializes only its slice of the global
    batch; the global batch is assembled by the mesh's data axis;
  * no state on the iterator other than the step counter (checkpoint stores
    just the int).

The offline container has no real corpus, so the source is either a memory-
mapped token file (``.bin`` of uint16/uint32) or a synthetic Zipfian stream —
both behind the same interface.

A copy of the reference's module (framework-free numpy): batches are
numpy arrays, bit-equal to the reference's for the same (seed, step,
shard); the train loop moves them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    shard_index: int = 0      # this host's index on the data axis
    shard_count: int = 1      # total data-axis hosts
    seed: int = 0
    token_file: Optional[str] = None


class TokenPipeline:
    """Stateless-by-construction pipeline; ``batch_at(step)`` is pure."""

    def __init__(self, cfg: PipelineConfig):
        assert cfg.global_batch % cfg.shard_count == 0, (
            f"global batch {cfg.global_batch} not divisible by "
            f"{cfg.shard_count} data shards")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.shard_count
        self._tokens = None
        if cfg.token_file is not None:
            self._tokens = np.memmap(cfg.token_file, dtype=np.uint32,
                                     mode="r")
        self.step = 0

    # -- pure access ------------------------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        if self._tokens is not None:
            toks = self._file_batch(step)
        else:
            toks = self._synthetic_batch(step)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def _file_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        n = self._tokens.shape[0] - (cfg.seq_len + 1)
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n, size=cfg.global_batch)
        starts = starts[cfg.shard_index::cfg.shard_count]
        return np.stack([self._tokens[s:s + cfg.seq_len + 1] for s in starts])

    def _synthetic_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.shard_index))
        # Zipfian unigram stream: realistic softmax/embedding access skew
        ranks = rng.zipf(1.3, size=(self.local_batch, cfg.seq_len + 1))
        return np.minimum(ranks - 1, cfg.vocab_size - 1).astype(np.uint32)

    # -- iterator protocol (training loop convenience) ---------------------
    def __iter__(self):
        return self

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.step = int(st["step"])


def make_token_pipeline(vocab_size: int, seq_len: int, global_batch: int,
                        **kw) -> TokenPipeline:
    return TokenPipeline(PipelineConfig(vocab_size, seq_len, global_batch,
                                        **kw))
