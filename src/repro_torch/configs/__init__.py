"""Architecture configs of the port (every family of the JAX package;
see ``base.py``)."""
