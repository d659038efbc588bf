"""Model-zoo foundation: configs and parameter trees.

Parameters are plain nested dicts of tensors under the reference's names
(``params["groups"][g]["l0"]["attn"]["wq"]``); the reference's stacked
``(n_groups, ...)`` leaves are a list of per-group dicts here, so a layer's
tensors are its own and decode caches can be written in place.  Beside
the parameters, :class:`TreeBuilder` records the reference's twin tree of
logical axes (``("embed", "heads", "head_dim")`` for ``wq``), which
``launch/mesh.py``'s rules turn into shardings; a group's axes are the
per-group ones, and the reference's ``("layers",) + axes`` is what the
stacked view of the same leaf carries.

Initialisation draws ``trunc_normal(-2, 2) * 1/sqrt(fan_in)`` from one
explicit :class:`torch.Generator` on the target device, tensor by tensor
(the reference's distribution, not its bits: ``jax.random`` and torch's
generators differ).  On the ``meta`` device nothing is drawn or
allocated, which is how ``launch.specs`` counts a full config.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0            # expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0               # 0 -> d_model
    conv_width: int = 4
    block_width: int = 0         # diagonal-block input projections


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 128
    # per-layer temporal-mixer types, len == n_layers:
    #   "attn" | "attn_local" | "mla" | "rglru" | "ssd" | "cross_attn"
    layer_types: Tuple[str, ...] = ()
    ffn: str = "swiglu"          # "swiglu" | "geglu" | "gelu"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int = 4096           # local attention window
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    moe_layer_types: Tuple[str, ...] = ()   # "" dense / "moe" per layer
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper): encoder stack config
    encoder_layers: int = 0
    encoder_ctx: int = 1500      # stub frontend: frames after conv stem
    cross_every: int = 0         # vlm: one cross-attn layer each N layers
    vision_ctx: int = 1601       # stub frontend: image patch tokens
    dtype: Any = torch.bfloat16
    # activation recompute in training, by group (transformer.forward):
    # "none" | "half" (every other group) | anything else: every group;
    # inference paths never recompute
    remat: str = "full"
    # groups layers by the pattern's period (see transformer.group_structure)
    scan_layers: bool = True

    def __post_init__(self):
        if not self.layer_types:
            object.__setattr__(self, "layer_types",
                               ("attn",) * self.n_layers)
        if len(self.layer_types) != self.n_layers:
            raise ValueError(f"{self.name}: {len(self.layer_types)} layer "
                             f"types for {self.n_layers} layers")
        if self.moe and not self.moe_layer_types:
            object.__setattr__(self, "moe_layer_types",
                               ("moe",) * self.n_layers)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def vocab_padded(self) -> int:
        """Embedding / LM-head rows padded to a multiple of 512; padded
        logits are masked in ``unembed``."""
        return -(-self.vocab_size // 512) * 512

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)


# ---------------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------------

class TreeBuilder:
    """Builds a nested dict of parameters on ``device``, drawing every
    random tensor from ``generator`` (None on the ``meta`` device), and
    its twin tree of logical axes (a tuple of names, one per dim)."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device):
        self.generator = generator
        self.device = torch.device(device)
        self.params: dict = {}
        self.axes: dict = {}

    def add(self, name, shape, axes: Tuple[Optional[str], ...], dtype,
            scale: Optional[float] = None,
            init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A trunc-normal(-2, 2) tensor times ``scale`` (default 1 /
        sqrt(fan_in), fan_in = shape[-2], or shape[-1] for a vector), drawn
        in f32 and cast to ``dtype``; or ``init`` as given.  ``axes``
        names the logical axis of each dim."""
        if len(axes) != len(shape):
            raise ValueError(f"{name}: axes {axes} for shape {shape}")
        if init is not None:
            arr = init.to(self.device, dtype)
        elif self.device.type == "meta":
            arr = torch.empty(shape, dtype=dtype, device=self.device)
        else:
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            arr = torch.empty(shape, dtype=torch.float32, device=self.device)
            torch.nn.init.trunc_normal_(arr, 0.0, 1.0, -2.0, 2.0,
                                        generator=self.generator)
            arr = arr.mul_(scale).to(dtype)
        self.params[name] = arr
        self.axes[name] = tuple(axes)
        return arr

    def ones(self, name, n: int, axes) -> torch.Tensor:
        """An f32 vector of ones (norm scales)."""
        return self.add(name, (n,), axes, torch.float32,
                        init=torch.ones(n, device=self.device))

    def zeros(self, name, n: int, axes, dtype=torch.float32) -> torch.Tensor:
        return self.add(name, (n,), axes, dtype,
                        init=torch.zeros(n, device=self.device))

    def sub(self, name) -> "TreeBuilder":
        child = TreeBuilder(self.generator, self.device)
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return []


def tree_map(fn, tree):
    """``fn`` over every tensor of a nested dict / list / NamedTuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def cast_tree(tree, dtype):
    """Every tensor of ``tree`` cast to ``dtype`` (a new tree; the
    reference's ``jax.tree.map(lambda x: x.astype(dtype), tree)``)."""
    return tree_map(lambda x: x.to(dtype), tree)
