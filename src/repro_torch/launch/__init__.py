"""Launchers of the port: the train and serve steps, the train driver, the
fixed-batch serve loop and the continuous-batching engine."""
