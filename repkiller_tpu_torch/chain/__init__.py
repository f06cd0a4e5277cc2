"""Coverage gating and fragment merge/accept (torch)."""
