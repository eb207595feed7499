"""Hand-written CUDA kernels (``csrc/``) for Superfast Selection's two hot
spots, the score walk and the LM's linear recurrence, with their plain
PyTorch versions:

  histogram.py    node/feature/bin histogram (atomics; four modes)
  split_scan.py   fused prefix-sum -> heuristic -> argmax selection scan
  linear_scan.py  h_t = a_t * h_{t-1} + b_t and its backward, as
                  ``torch.library`` custom ops (the RG-LRU and the sLSTM)
  walk.py         the score walk of Algorithm 7: T trees' leaf labels for
                  every row in one launch

``ops.py`` is the public surface (CUDA tensors launch the kernels, CPU
tensors take the plain versions); ``ref.py`` holds the test oracles;
``_build.py`` builds the CUDA library with nvcc at first use.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
