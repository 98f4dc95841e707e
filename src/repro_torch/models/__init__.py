"""The model: layers, the mixture-of-experts FFN, parameter init, serving
passes, and the weight converter from the JAX package's parameter tree."""
