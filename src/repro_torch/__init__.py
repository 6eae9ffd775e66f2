"""PyTorch/CUDA port of the DeepCABAC serving path (``repro`` is the JAX
reference).  Imports ``torch``, never ``jax``, and nothing of ``repro``."""
