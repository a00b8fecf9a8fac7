"""The HiT-SIR-Pro network and weight conversion from the JAX package."""
