"""Command-line entry points of the port, run as `python3 -m tdgp_torch.scripts.<name>`."""
