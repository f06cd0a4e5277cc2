"""Scan and sort helpers of the torch port."""
