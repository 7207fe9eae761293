"""PyTorch + CUDA port of edgecape_tpu (the JAX package stays the
reference). Imports torch, never jax."""
