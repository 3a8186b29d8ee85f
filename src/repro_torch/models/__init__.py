"""Models of the port: the dense attention decoder."""
