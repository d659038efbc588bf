"""Workload configurations of the port: ``drim_ann``, the paper's ANN
config, and the LM registry (``registry``: the ten architectures, each
with ``config()`` and ``smoke_config()``, and the input-shape cells)."""

from repro_torch.configs.drim_ann import DrimAnnConfig, config
from repro_torch.configs.registry import (ARCH_IDS, SHAPES, SHAPES_BY_NAME,
                                          SUBQUADRATIC, ShapeCell, get_arch,
                                          get_config, cells_for, all_cells)

__all__ = ["DrimAnnConfig", "config",
           "ARCH_IDS", "SHAPES", "SHAPES_BY_NAME", "SUBQUADRATIC",
           "ShapeCell", "get_arch", "get_config", "cells_for", "all_cells"]
