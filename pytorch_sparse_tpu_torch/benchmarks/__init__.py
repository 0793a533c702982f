"""Measurement scripts of the port (counterparts of the JAX package's
``benchmarks/``): ``timing.device_time`` and the on-chip gather probe
``probe_vmem_gather``."""
