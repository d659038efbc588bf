"""LM architecture registry: the ten architectures the JAX package carries
(the paper's own engine config is ``configs/drim_ann.py``).

Each arch module provides ``config()`` (exact published shape) and
``smoke_config()`` (reduced same-family config for CPU smoke tests).  The
input-shape cells (train_4k / prefill_32k / decode_32k / long_500k) are
defined here once; per-arch applicability (``long_500k`` sub-quadratic rule,
enc-dec decode semantics) is resolved by ``cells_for``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

ARCH_IDS = (
    "recurrentgemma_2b", "qwen3_14b", "command_r_plus_104b",
    "phi3_medium_14b", "minitron_4b", "mamba2_2p7b", "qwen2_moe_a2p7b",
    "deepseek_v2_236b", "whisper_base", "llama32_vision_11b",
)

# archs with sub-quadratic temporal mixing (run long_500k)
SUBQUADRATIC = {"recurrentgemma_2b", "mamba2_2p7b"}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def get_arch(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod


def get_config(arch_id: str, smoke: bool = False):
    mod = get_arch(arch_id)
    return mod.smoke_config() if smoke else mod.config()


def cells_for(arch_id: str):
    """The (arch x shape) cells this arch runs; skips are recorded with a
    reason."""
    cells = []
    for s in SHAPES:
        if s.name == "long_500k" and arch_id not in SUBQUADRATIC:
            cells.append((s, "SKIP: quadratic full attention at 512k"))
        else:
            cells.append((s, None))
    return cells


def all_cells():
    out = []
    for a in ARCH_IDS:
        for s, skip in cells_for(a):
            out.append((a, s, skip))
    return out
