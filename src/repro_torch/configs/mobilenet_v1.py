"""MobileNetV1 variants — the paper's CNN-B1/B2 (§V-A1) (port of
``repro/configs/mobilenet_v1.py``)."""
CNN_B1 = dict(
    name="cnn-b1", kind="cnn", width_mult=0.5, resolution=128,
    n_classes=1000, macs=49_000_000,
)
CNN_B2 = dict(
    name="cnn-b2", kind="cnn", width_mult=1.0, resolution=224,
    n_classes=1000, macs=569_000_000,
)
