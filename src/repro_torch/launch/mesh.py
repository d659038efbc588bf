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

The rest of the reference's module is the LM's production mesh and its
logical-axis rules.  :func:`make_production_mesh` is a
``torch.distributed.device_mesh.DeviceMesh`` of the reference's shapes,
(16, 16) on ``("data", "model")`` or (2, 16, 16) with a leading ``"pod"``,
over the ranks of the default process group: the H100 counterpart of a
256-chip pod is one NVLink domain of 256 GPUs (a DGX SuperPOD with the
NVLink Switch System), and two of them over InfiniBand are the pod mesh.
``BASE_RULES``, :func:`rules_for` and :func:`resolve_pspec` are the
reference's; a :class:`PartitionSpec` becomes DTensor placements through
:class:`NamedSharding` (an entry ``("pod", "data")`` on dim *i* is
``Shard(i)`` on both mesh dims, pod-major as in JAX).
:func:`distribute_tree` is the counterpart of ``jax.device_put(tree,
shardings)``: every rank slices its own part, with no broadcast.
:func:`fake_world` runs one process as rank 0 of a larger world (the
"fake" process group: collectives are no-ops with the right shapes),
which is how the dry-run runs rank 0's program on one card.  Importing
this module touches no process group.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import weakref
from typing import Dict, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# the LM's production mesh
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16 x 16 = 256 GPUs on ``("data", "model")``, or 2 pods = 512 with
    a leading ``"pod"`` axis, as a ``DeviceMesh`` over the first ranks of
    the default process group, so a 512-rank world builds the one-pod mesh
    too.  Raises when the world is smaller, or when ``device_type`` is
    ``"cuda"`` and there is no card; the CPU only when named."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised "
                           "default process group (see fake_world)")
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_production_mesh(device_type='cuda') needs "
                           "a CUDA device; pass device_type='cpu' for the "
                           "CPU")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(n: int, device_type="cuda"):
    """Initialise the default process group as rank 0 of a world of ``n``
    on the "fake" backend, and destroy it on exit.  Every collective
    is a no-op with the right shapes: the local program runs for real, the
    values after a collective are not meaningful."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fake_world(device_type='cuda') needs a CUDA "
                           "device")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# logical axis -> mesh axis rules
# ---------------------------------------------------------------------------

# Base rules: tensor-parallel over "model"; batch over ("pod", "data").
# "embed" is the FSDP axis: None for small models (pure replication),
# "data" for >= ~8B params so weights + Adam moments shard ZeRO-3 style.
BASE_RULES: Dict[Optional[str], Optional[object]] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "mlp2": None,
    "experts": "model",
    "embed": None,
    # head_dim acts as the TP fallback: when heads/kv_heads don't divide
    # the model axis (qwen3's 40 q-heads, GQA kv=8 vs model=16), the
    # 128-wide head_dim carries the sharding instead (per-axis single-use
    # in resolve_pspec prevents double-sharding when heads succeeded).
    "head_dim": "model",
    "layers": None,
    None: None,
}


def rules_for(cfg, fsdp: bool) -> Dict:
    rules = dict(BASE_RULES)
    if fsdp:
        rules["embed"] = "data"
    if cfg is not None and cfg.moe is not None:
        # EP when divisible; else experts stay replicated-dim and the
        # expert MLP dim carries TP (resolve_pspec falls back per-dim).
        rules["experts"] = "model"
    return rules


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a dim, a
    mesh axis name, a tuple of names (major to minor) or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of any object with the
    ``jax.sharding.Mesh`` names (``axis_names``, ``devices.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve_pspec(shape: Tuple[int, ...], axes: Tuple, rules: Dict, mesh):
    """Logical axes tuple -> PartitionSpec, honoring divisibility and
    one-use-per-mesh-axis; indivisible dims fall back to replication."""
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for dim, name in zip(shape, axes):
        rule = rules.get(name, None)
        cand = rule if isinstance(rule, tuple) else (rule,) if rule else ()
        picked = None
        for mesh_ax in cand:
            if mesh_ax is None or mesh_ax in used:
                continue
            if mesh_ax not in sizes or dim % sizes[mesh_ax] != 0:
                continue
            picked = mesh_ax
            used.add(mesh_ax)
            break
        # tuple rules (batch over ("pod","data")) shard over ALL listed axes
        if isinstance(rule, tuple):
            group = [a for a in rule if a in sizes and a not in used]
            total = math.prod(sizes[a] for a in group) if group else 1
            if group and dim % total == 0:
                out.append(tuple(group) if len(group) > 1 else group[0])
                used.update(group)
                continue
            picked = None
        out.append(picked)
    return P(*out)


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: ``placements`` are the
    DTensor placements it names, one a mesh dim."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = P(*spec)
        self.sizes = axis_sizes(mesh)
        names = list(self.sizes)
        seen = set()
        for entry in self.spec:
            group = entry if isinstance(entry, tuple) else (entry,)
            idx = [names.index(a) for a in group if a is not None]
            if idx != sorted(idx):
                raise ValueError(f"{spec}: axes of one dim must follow the "
                                 f"mesh's order {tuple(names)}")
            if seen & set(idx):
                raise ValueError(f"{spec}: a mesh axis used twice")
            seen |= set(idx)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    __hash__ = object.__hash__

    def _dim_of(self) -> Dict[str, int]:
        out = {}
        for i, entry in enumerate(self.spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    out[a] = i
        return out

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        dim_of = self._dim_of()
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in self.sizes)

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The local shape of a tensor of ``global_shape`` (each dim
        divided by its axes' sizes, rounded up as DTensor's chunks are)."""
        out = list(global_shape)
        for i, entry in enumerate(self.spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    out[i] = -(-out[i] // self.sizes[a])
        return tuple(out)

    def local_slices(self, global_shape, coordinate=None) -> tuple:
        """The slice of each dim this rank holds; ``coordinate`` is the
        rank's place on the mesh (default: ``mesh.get_coordinate()``)."""
        if coordinate is None:
            coordinate = self.mesh.get_coordinate()
        coord = dict(zip(self.sizes, coordinate))
        lo = [0] * len(global_shape)
        hi = list(global_shape)
        for i, entry in enumerate(self.spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is None:
                    continue
                size = hi[i] - lo[i]
                step = -(-size // self.sizes[a])
                start = min(lo[i] + coord[a] * step, hi[i])
                lo[i], hi[i] = start, min(start + step, hi[i])
        return tuple(slice(a, b) for a, b in zip(lo, hi))


def map_twin(fn, tree, twin):
    """``fn(leaf, twin_leaf)`` over a tree of tensors (dict / list /
    NamedTuple) and its twin of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, twin)
    if isinstance(tree, dict):
        return {k: map_twin(fn, v, twin[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_twin(fn, v, t) for v, t in zip(tree, twin)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_twin(fn, v, t) for v, t in zip(tree, twin))
    return tree


def shardings_for_tree(shapes_tree, axes_tree, rules, mesh):
    """A tree of tensors (meta ones included) and its twin of logical axes
    -> the twin tree of :class:`NamedSharding`."""
    return map_twin(
        lambda t, axes: NamedSharding(
            mesh, resolve_pspec(tuple(t.shape), axes, rules, mesh)),
        shapes_tree, axes_tree)


def to_dtensor(local: torch.Tensor, sharding: NamedSharding, global_shape):
    """Wrap this rank's ``local`` part of a tensor of ``global_shape``."""
    from torch.distributed.tensor import DTensor
    global_shape = tuple(global_shape)
    stride = tuple(math.prod(global_shape[i + 1:])
                   for i in range(len(global_shape)))
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(global_shape),
                              stride=stride)


def distribute_tree(tree, shardings, device=None):
    """``jax.device_put(tree, shardings)``: every leaf becomes a DTensor of
    this rank's slice, cut from the leaf this rank holds (no broadcast), on
    ``device`` (default: the mesh's device type, this rank's card)."""
    def one(t, sh):
        dev = device
        if dev is None:
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if sh.mesh.device_type == "cuda" else
                   torch.device(sh.mesh.device_type))
        local = t[sh.local_slices(t.shape)].detach().to(dev).clone(
            memory_format=torch.contiguous_format)
        return to_dtensor(local, sh, t.shape)
    return map_twin(one, tree, shardings)
