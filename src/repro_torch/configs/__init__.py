"""Architecture configs of the port (dense family; see ``base.py``)."""
