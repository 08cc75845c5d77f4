"""Architecture configs of the port (dense, MoE, SSM and hybrid families;
see ``base.py``)."""
