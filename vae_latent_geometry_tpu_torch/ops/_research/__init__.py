"""Kernels kept as layout experiments (not dispatched by the optimizer), as
``vae_latent_geometry_tpu.ops._research`` keeps them in the JAX package."""
