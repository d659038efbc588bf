"""The shard mesh of the DRIM-ANN engine.

The port of ``repro/launch/mesh.py::make_shard_mesh``.  The reference's
mesh is a ``jax.sharding.Mesh`` whose ``"shards"`` axis is the DPU
analogue: its sharded steps run one program per mesh device under
``shard_map``.  Here a mesh is one process over a tuple of
``torch.device`` entries, and each CUDA entry owns a CUDA stream: the
sharded steps (``core/sharded_search.py::make_sharded_step``) issue entry
``s``'s program on entry ``s``'s device and stream, so the entries run
concurrently on the card (or cards) and the host joins them for the
merge.  There is no collective between entries, as in the reference,
whose in and out specs are ``P("shards")`` with the replicated inputs
``P()``.

An entry may repeat a device: ``[torch.device("cpu")] * 8`` holds eight
entries on the CPU, and ``[torch.device("cuda", 0)] * 64`` sixty-four
concurrent programs on one card, the counterpart of XLA's
``--xla_force_host_platform_device_count``.

The rest of the reference's module (the production mesh and the
logical-axis sharding rules of the LM stack) is not ported yet.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A 1-D grid of ``torch.device`` entries on the axis ``"shards"``.

    ``devices`` is a numpy object array of the entries (names as on
    ``jax.sharding.Mesh``), ``shape`` maps the axis name to its size and
    ``size`` counts the entries.  ``streams`` holds one CUDA stream per
    entry, the entry's own, or None for an entry that is not on a CUDA
    device.  :meth:`close` waits for the work on those streams and
    destroys them; dropping the last reference to the mesh does the same.
    """

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = list(devices)
        self.axis_names = ("shards",)
        self.streams = tuple(_own_stream(d) if d.type == "cuda" else None
                             for d in self.devices)
        owned = [s for s in self.streams if s is not None]
        self._finalizer = weakref.finalize(self, _destroy_streams, owned)
        self._finalizer.atexit = False

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def closed(self) -> bool:
        return not self._finalizer.alive

    def close(self) -> None:
        """Wait for the work queued on the entries' streams and destroy
        them.  No step runs on the mesh after this."""
        self._finalizer()


def _own_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A CUDA stream for one entry alone.  ``torch.cuda.Stream()`` hands
    out the streams of a pool, 32 a device and priority in turn, so more
    entries than that on one card would share streams; this one comes
    from ``cudaStreamCreate``."""
    handle = ctypes.c_void_p(0)
    with torch.cuda.device(device):
        err = int(torch.cuda.cudart().cudaStreamCreate(
            ctypes.addressof(handle)))
    if err != 0 or not handle.value:
        raise RuntimeError(f"cudaStreamCreate on {device} failed: CUDA "
                           f"error {err}")
    return torch.cuda.ExternalStream(handle.value, device=device)


def _destroy_streams(streams) -> None:
    """Destroy a mesh's own streams once the work queued on them is done,
    so that a stream created later with the same handle never overlaps it.
    Only these streams are waited for, not the rest of the device."""
    for stream in streams:
        stream.synchronize()
        with torch.cuda.device(stream.device):
            torch.cuda.cudart().cudaStreamDestroy(stream.cuda_stream)


def _device(d) -> torch.device:
    """A torch.device with its index resolved (``cuda`` -> ``cuda:<current>``),
    so that entries compare equal to the devices of tensors on them."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_shard_mesh(n_shards: int,
                    devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh of ``n_shards`` entries on axis ``"shards"``.

    By default the entries are the visible CUDA devices, the first
    ``n_shards`` of them; with fewer visible this raises, as the
    reference asserts, and it never falls back to the CPU.  ``devices``
    names the entries explicitly, exactly ``n_shards`` of them, and may
    repeat a device (several programs on one card, or on the CPU in
    tests)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        n = torch.cuda.device_count()
        if n < n_shards:
            raise ValueError(f"make_shard_mesh({n_shards}) needs "
                             f"{n_shards} CUDA devices, {n} visible; pass "
                             f"devices= to place several entries on one")
        devices = [torch.device("cuda", i) for i in range(n_shards)]
    devices = [_device(d) for d in devices]
    if len(devices) != n_shards:
        raise ValueError(f"make_shard_mesh({n_shards}) got {len(devices)} "
                         f"devices, one per entry")
    return Mesh(devices)
