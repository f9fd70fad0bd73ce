"""Launchers of the port: serve steps and the fixed-batch serve loop."""
