"""Circuit IR, 2Q-block consolidation and the basic analytic decomposition
pass (JAX transpile/)."""
