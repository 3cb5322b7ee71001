"""Hand-written Hopper kernels (``csrc/*.cu``, built by ``build``) with
their plain PyTorch versions (``ref``) and model-layout wrappers (``ops``).
Importing this package builds nothing: the CUDA library is compiled and
loaded at the first launch."""
