"""StyleGAN2 networks and the JAX-variables bridge."""
