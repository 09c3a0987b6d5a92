"""Schedules, collectives and kernels of the port."""
