"""Host utilities of the port: the metrics bus and the stage timer."""
