"""Launchers of the port: ``serve`` (the ANN serving entry point,
``python -m repro_torch.launch.serve --ann``).  The LM launchers and the
TPU mesh / dry-run tools are not ported (ROADMAP item 13)."""
