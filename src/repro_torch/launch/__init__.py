"""Launchers of the port: ``serve`` (``python -m
repro_torch.launch.serve``: the LM decode loop, the ANN serving tier and
the RAG path joining them), ``train`` (``python -m
repro_torch.launch.train``: the LM training driver) over ``steps`` (train,
prefill and decode steps), and ``specs`` (parameter, cache and input specs
on the meta device), and ``mesh`` (``make_shard_mesh``: the DRIM-ANN
engine's shard mesh, one program per shard).  The rest of the
reference's ``mesh.py`` (the production mesh and the LM's logical-axis
rules) and its TPU dry-run tools are not ported yet."""

from repro_torch.launch.mesh import Mesh, make_shard_mesh

__all__ = ["Mesh", "make_shard_mesh"]
