"""Launchers of the port: ``serve`` (``python -m
repro_torch.launch.serve``: the LM decode loop, the ANN serving tier and
the RAG path joining them) and ``specs`` (parameter and cache specs on the
meta device).  The training launchers and the TPU mesh / dry-run tools are
not ported (ROADMAP items 13, 4a and 5)."""
