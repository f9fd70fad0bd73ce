"""Data pipeline of the port: the synthetic token stream and its prefetch
loader."""
