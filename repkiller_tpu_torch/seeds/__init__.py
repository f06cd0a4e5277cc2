"""Seed hits and diagonal thinning of the self-comparison (torch)."""
