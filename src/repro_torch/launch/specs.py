"""Parameter and cache specs on the ``meta`` device: every tensor of a
config's parameter tree or decode caches with its shape and dtype, and
nothing allocated, so a full config is counted on any host.
``input_specs`` waits for the dry-run tooling (ROADMAP item 5)."""

from __future__ import annotations

from repro_torch.models import ModelConfig, init_caches, init_params
from repro_torch.models.common import count_params


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as meta tensors."""
    return init_params(cfg, device="meta")


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode caches of ``cfg`` as meta tensors."""
    return init_caches(cfg, batch, max_len, device="meta")


def count_params_analytic(cfg: ModelConfig) -> int:
    return count_params(param_specs(cfg))
