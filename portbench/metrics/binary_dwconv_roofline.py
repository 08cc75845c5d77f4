"""binary_dwconv's share of its roofline (%), over the traced window.

Its launches are the device spans named ``binary_dwconv_kernel``
(``csrc/binary_dwconv.cu``); each is counted as the configuration's layers of
kinds ("dwconv",) at the cell's batch and levels (``network.work``).
"""
from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "binary_dwconv_kernel", ("dwconv",))
