"""Host utilities of the port: result export and the ATE metric."""
