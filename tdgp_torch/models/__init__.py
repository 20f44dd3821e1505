"""Generator modules of the port."""
