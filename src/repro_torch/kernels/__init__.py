"""Hand-written CUDA kernels (``csrc/``) for Superfast Selection's two hot
spots, with their plain PyTorch versions:

  histogram.py   node/feature/bin histogram (atomics; four modes)
  split_scan.py  fused prefix-sum -> heuristic -> argmax selection scan

``ops.py`` is the public surface (CUDA tensors launch the kernels, CPU
tensors take the plain versions); ``ref.py`` holds the test oracles;
``_build.py`` builds the CUDA library with nvcc at first use.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
