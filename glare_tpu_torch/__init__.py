"""GLARE on PyTorch/CUDA: the port of ``glare_tpu`` for NVIDIA Hopper.

Same sub-packages and file names as the JAX package so each counterpart is
easy to find; plain tensor code is PyTorch, and the three kernels the JAX
package wrote in Pallas are hand-written CUDA C++ under ``csrc/``
(``ops/vq.py``, ``ops/attn.py``, ``ops/dcn.py`` hold their wrappers, plain
PyTorch versions and launch counters).

Precision, stated once: float32 matrix products and float32 convolutions
run in full float32 (no TF32), which is what the JAX package's tests run
at (``highest``). cuDNN's TF32 default would cost about three decimal
digits in every f32 convolution.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
