"""Bit-serial noisy TD-VMM: reference oracles, kernel wrapper, entry point."""
