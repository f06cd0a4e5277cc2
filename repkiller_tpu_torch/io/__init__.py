"""FASTA reading and base codes (copies of repkiller_tpu.io)."""
