"""binary_conv's share of its roofline (%), over the traced window.

Its launches are the device spans named ``binary_conv_kernel``
(``csrc/binary_conv.cu``); each is counted as the configuration's layers of
kinds ("conv",) at the cell's batch and levels (``network.work``).
"""
from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "binary_conv_kernel", ("conv",))
