"""The model: layers, the mixture-of-experts FFN, the SSD mixer, the
multi-head latent attention, parameter init, serving passes, and the
weight converter from the JAX package's parameter tree."""
