"""Fused LSQ fake-quantization: plain version, kernel wrapper, entry point."""
