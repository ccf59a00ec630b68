"""RON-320 detector modules (NCHW inside, the JAX layout at the outputs)."""
