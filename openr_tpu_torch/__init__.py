"""openr_tpu_torch — the PyTorch/CUDA port of openr_tpu's route computation.

A second package beside the JAX one: the Decision module's cold
single-area solve (``decision/gpu_solver.GpuSpfSolver``) runs on an
NVIDIA GPU through hand-written CUDA kernels (``csrc/``), with a plain
PyTorch version beside each kernel for the CPU. The package keeps its
own copy of every host module it needs and imports nothing of the JAX
package.
"""

__version__ = "0.1.0"
