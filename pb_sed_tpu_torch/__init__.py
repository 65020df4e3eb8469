"""pb_sed_tpu_torch: the PyTorch/CUDA port of pb_sed_tpu.

It mirrors the JAX package's layout (``ops/``, ``models/base/``,
``models/weak_label/``, ``models/net_configs.py``) and keeps its data and
parameter layouts, so the weights of a JAX checkpoint load through
``bridge.py``. The TPU kernels of the serving path are hand-written CUDA
kernels for Hopper under ``csrc/``, wrapped in ``ops/kernels/``.
"""
__version__ = '0.1.0'
