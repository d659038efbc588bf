"""Launchers of the port: ``serve`` (``python -m
repro_torch.launch.serve``: the LM decode loop, the ANN serving tier and
the RAG path joining them), ``train`` (``python -m
repro_torch.launch.train``: the LM training driver) over ``steps`` (train,
prefill and decode steps), and ``specs`` (parameter, cache and input specs
on the meta device).  The TPU mesh / dry-run tools are not ported
(ROADMAP queue items 2 and 3)."""
