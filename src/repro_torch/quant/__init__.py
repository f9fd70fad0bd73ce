"""LSQ quantization and bit-serial helpers (port of `repro.quant`)."""
