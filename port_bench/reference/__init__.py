"""Plain PyTorch references the benchmark judges the port against.  They
import neither ``jax`` nor the JAX package nor anything of the port, and
take only what the benchmark made (weights, deltas, inputs) and the
program's outputs that they judge."""
