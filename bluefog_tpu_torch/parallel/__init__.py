"""Parallelism of the port: the switch-routed mixture of experts."""
