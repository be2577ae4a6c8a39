"""Device-side ops: the JAX equivalents of the reference's GLSL corpus."""
