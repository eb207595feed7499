"""PyTorch / CUDA port of the Superfast Selection UDT (``repro``).

Mirrors ``src/repro`` module by module; imports torch and numpy, never jax
and nothing of ``repro``.  Entry points run on CUDA unless the caller
passes ``device="cpu"``; the hand-written kernels live in ``csrc/`` and are
built with nvcc at first use (``kernels/_build.py``).
"""
