"""CNN-A — the paper's own small network (§V-A1): GTSRB, 43 classes, ~9M MACs
(port of ``repro/configs/cnn_a.py``).

Not an LM ArchConfig; a plain spec beside ``models/cnn.py``'s ``CNN_A_SPECS``.
"""
CONFIG = dict(
    name="cnn-a",
    kind="cnn",
    input_shape=(48, 48, 3),
    n_classes=43,
    macs=9_000_000,  # paper's headline figure; exact count in cnn.cnn_a_macs()
    layers=[
        ("conv", dict(filters=5, kernel=(7, 7), in_ch=3)),
        ("pool", dict(factor=2)),
        ("conv", dict(filters=150, kernel=(4, 4), in_ch=5)),
        ("pool", dict(factor=6)),
        ("dense", dict(inp=1350, out=340)),
        ("dense", dict(inp=340, out=490)),
        ("dense", dict(inp=490, out=43)),
    ],
)
