"""The plain reference the port is checked against: PyTorch only, nothing
of the port."""
