"""Synthetic data pipelines (port of ``repro.data``): GTSRB-like images for
CNN-A and a checkpointable Zipfian token stream for the LM stack."""
