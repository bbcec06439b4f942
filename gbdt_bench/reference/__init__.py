"""The plain reference the benchmark judges the port by.  It imports neither
JAX nor the JAX package nor anything of the port."""
