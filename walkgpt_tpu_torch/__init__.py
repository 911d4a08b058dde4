"""walkgpt_tpu_torch: the PyTorch + CUDA port of walkgpt_tpu for NVIDIA Hopper.

Same parameter trees, function names and module layout as the JAX package
(core/, ops/, models/, runtime/), which stays the reference. The attention
kernels of the main path are hand-written CUDA (csrc/), built with nvcc at
first use; importing the package needs neither CUDA nor nvcc.
"""
