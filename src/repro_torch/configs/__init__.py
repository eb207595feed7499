"""Training configurations of the port."""
