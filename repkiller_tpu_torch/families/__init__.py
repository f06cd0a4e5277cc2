"""Repeat-family clustering (a copy of repkiller_tpu.families): the
streamed host path, and the device path on the run's CUDA device, taken
by default for tables large enough."""

from .cluster import cluster_families  # noqa: F401
