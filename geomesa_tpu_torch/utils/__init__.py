"""Small helpers of the port (the JAX package's ``utils/`` copies)."""
