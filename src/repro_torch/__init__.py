"""DRIM-ANN in PyTorch for NVIDIA Hopper: the port of the ``repro`` package.

Same layout and contracts as ``repro`` (``repro_torch/core/search.py`` is
the counterpart of ``repro/core/search.py``), written for PyTorch with
hand-written CUDA kernels for the LC and DC phases
(``repro_torch/kernels/csrc``).  Entry points take an explicit
``device`` (default ``"cuda"``); asking for CUDA where there is none
raises.  Importing the package builds no kernel.
"""
