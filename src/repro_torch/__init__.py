"""PyTorch port of the CD-BFL reference package ``repro``, for NVIDIA Hopper.

The module layout mirrors ``repro/`` so each counterpart is easy to find.
The package imports ``torch`` and numpy only: nothing of JAX and nothing of
``repro``. Its kernels are hand-written CUDA for ``sm_90a`` (``kernels/``),
each beside a plain PyTorch version that CPU tensors run.
"""
