"""Utilities of the port (``bluefog_tpu/utils/`` counterparts)."""
