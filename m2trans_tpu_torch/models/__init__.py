"""Model of the port."""
