"""Fused GQA flash-attention forward: kernel wrapper and entry point."""
