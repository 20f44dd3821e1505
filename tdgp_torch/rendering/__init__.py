"""Cameras, rays and the two-pass volume renderer of the port."""
