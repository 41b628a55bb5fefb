"""FIRA in PyTorch with hand-written CUDA kernels for the NVIDIA H100: the
port of the JAX package ``fira_tpu``, laid out module for module like it
and held against it in ``tests/test_torch_*.py``. Imports torch and numpy,
never JAX or anything of ``fira_tpu``."""
