"""Weight bridge and checkpoint loading of the port."""
