"""Models of the port (``small``: MLP and LeNet)."""
