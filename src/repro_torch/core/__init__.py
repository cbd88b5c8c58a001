"""Core of the port: workload, carry planes, the cluster scan runner and
the sweep grid (see the JAX package's ``repro.core`` for the full
simulator)."""
