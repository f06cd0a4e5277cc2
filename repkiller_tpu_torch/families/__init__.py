"""Repeat-family clustering (a copy of repkiller_tpu.families): the
streamed host path, and the opt-in device path on the run's torch device."""

from .cluster import cluster_families  # noqa: F401
