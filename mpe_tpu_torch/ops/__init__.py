"""Env-minor step math and the fused rollouts: plain PyTorch versions and
their CUDA kernels (``csrc/mpe_kernels.cu``, built by ``ops/_build.py``)."""
