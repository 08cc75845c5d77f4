"""Model topologies and weights (port of ``repro.models``)."""
