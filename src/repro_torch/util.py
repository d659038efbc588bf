"""Small shared helpers for the PyTorch port."""

from __future__ import annotations

import contextlib
import os

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


def fsync_dir(path) -> None:
    """fsync a directory so a rename / replace inside it is durable.

    Platforms without directory fds (or filesystems that reject fsync on
    them) are best-effort: the rename itself is still atomic.
    """
    try:
        fd = os.open(os.fspath(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path, mode: str = "wb"):
    """Crash-safe file write: tmp in the same directory -> flush -> fsync
    -> ``os.replace`` -> directory fsync.

    Readers never observe a torn file: either the old content or the
    complete new one is visible, and a crash at any point leaves at worst
    a ``.tmp.*`` orphan next to the target.  Yields the open file object;
    the commit happens only if the body exits cleanly -- an exception
    unlinks the tmp file and re-raises.
    """
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".tmp.{os.path.basename(path)}.{os.getpid()}")
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    f.close()
    os.replace(tmp, path)
    fsync_dir(d)


def atomic_write_bytes(path, data: bytes) -> None:
    """Write ``data`` to ``path`` with :func:`atomic_write` semantics."""
    with atomic_write(path, "wb") as f:
        f.write(data)


def atomic_write_text(path, text: str) -> None:
    """Write ``text`` to ``path`` with :func:`atomic_write` semantics."""
    with atomic_write(path, "w") as f:
        f.write(text)
