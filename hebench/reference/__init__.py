"""Plain references of the benchmark's networks, in NumPy: they import
neither JAX, nor the JAX package, nor anything of the port."""
