"""Containers shared by the port."""
