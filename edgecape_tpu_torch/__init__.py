"""PyTorch + CUDA port of edgecape_tpu (the JAX package stays the
reference). Imports torch, never jax."""

__version__ = "0.1.0"
