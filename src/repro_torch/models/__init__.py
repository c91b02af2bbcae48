"""Parameter names, shapes and carry-across from the JAX package."""
