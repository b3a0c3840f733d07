"""PyTorch/CUDA port of ConfigNet (the JAX package ``confignet_tpu`` is the
reference it is held against).

The package layout mirrors ``confignet_tpu`` module for module.  It imports
torch, numpy and the standard library only; the hand-written CUDA kernels in
``csrc/`` are compiled and loaded the first time a CUDA tensor reaches their
wrapper, so importing the package needs neither ``nvcc`` nor a GPU.
"""
