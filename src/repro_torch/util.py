"""Small shared helpers for the PyTorch port."""

from __future__ import annotations

import torch


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1).

    The repo's padding convention: block sizes, k_pad, and miss-batch
    shapes are all rounded up to a power of two so the set of distinct
    shapes stays logarithmic in the observed size range.
    """
    return 1 << (max(int(x), 1) - 1).bit_length()


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; asking for CUDA where there
    is none raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available; pass device='cpu' explicitly")
    return dev


def ieee_f32_matmul() -> None:
    """Keep float32 GEMMs in full IEEE float32 on the card.

    A TF32 GEMM keeps ~10 mantissa bits: in CL that reorders probes, in
    k-means and ``exact_search`` it moves assignments and ground truth.
    ``allow_tf32 = False`` is the same switch as
    ``torch.set_float32_matmul_precision("highest")``.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
