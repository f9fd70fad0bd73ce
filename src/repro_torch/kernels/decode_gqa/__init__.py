"""Fused GQA decode attention: kernel wrapper and entry point."""
