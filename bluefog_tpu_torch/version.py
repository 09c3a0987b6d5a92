"""The port's version: the JAX package's ``bluefog_tpu/version.py``,
copied (the port imports nothing of that package)."""
__version__ = "0.1.0"
