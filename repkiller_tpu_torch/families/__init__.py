"""Repeat-family clustering on the host (a copy of repkiller_tpu.families,
host path only)."""

from .cluster import cluster_families  # noqa: F401
