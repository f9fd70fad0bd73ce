"""Launchers of the port: the train and serve steps, the train driver and
the fixed-batch serve loop."""
