"""CSV, BED and family-summary writers (copies of repkiller_tpu.report)."""
