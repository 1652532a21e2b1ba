"""PyTorch / CUDA port of ``centroids_reid_tpu`` for NVIDIA Hopper GPUs.

Imports ``torch`` and never ``jax``; subpackages mirror the JAX package's
layout (``models/resnet.py``, ``ops/retrieval.py``,
``inference/service.py``, ...). Importing the package loads nothing.
"""
