"""Device sizing of the port: the serving engine's KV-cache plan."""
