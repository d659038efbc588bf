"""Hand-written CUDA kernels for the LC and DC phases (``csrc/``), their
wrappers (``ops``) and plain oracles (``ref``).  Importing this package
builds nothing: a kernel is compiled at its first launch."""
