"""Banded seed extension: kernel K1 (CUDA), its plain torch version and
the two-phase wrappers around it."""
