"""k-mer extraction and the canonical self-comparison index (torch)."""
