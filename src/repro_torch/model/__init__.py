"""The served model: layers, assembly, and weights carried across from the
JAX package."""
