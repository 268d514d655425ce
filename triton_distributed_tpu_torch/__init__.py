"""PyTorch + CUDA port of triton_distributed_tpu for NVIDIA Hopper.

The JAX package ``triton_distributed_tpu`` is the reference; this
package mirrors its module tree where a counterpart exists. It imports
``torch`` and numpy only. CUDA kernels live in ``csrc/`` and are
compiled on first use (``kernels/_build.py``); importing the package
needs neither a GPU nor ``nvcc``. Serving and generation run from
``models`` / ``serving`` / ``tools``; training from ``train`` (the
dp×tp×cp ``Trainer``) and ``Transformer.train_step``.
"""

__version__ = "0.1.0"
