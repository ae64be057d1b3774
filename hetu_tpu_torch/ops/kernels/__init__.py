"""Hand-written Hopper kernels of the port, one module per TPU kernel of
``hetu_tpu/ops/pallas/`` (CUDA sources under ``hetu_tpu_torch/csrc/``).

Importing these modules builds nothing: a kernel is built (``nvcc``) or
compiled (Triton) on its first launch.
"""
