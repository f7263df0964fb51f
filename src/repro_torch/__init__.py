"""PyTorch + CUDA port of the CiFHER CKKS stack (the JAX package ``repro`` is
the reference it is held against, bit for bit)."""
