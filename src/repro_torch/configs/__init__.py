"""Workload configurations of the port.  ``drim_ann`` is the paper's
ANN config; the LM registry (``registry``) is not ported yet."""

from repro_torch.configs.drim_ann import DrimAnnConfig, config

__all__ = ["DrimAnnConfig", "config"]
