"""Dense-family model: layers, parameter init, serving passes, and the
weight converter from the JAX package's parameter tree."""
