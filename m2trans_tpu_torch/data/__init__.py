"""Training and evaluation data of the port."""
