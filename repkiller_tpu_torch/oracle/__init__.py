"""The numpy reference pipeline behind backend="oracle" (a copy of
repkiller_tpu.oracle)."""
