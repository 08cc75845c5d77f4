"""binary_matmul's share of its roofline (%), over the traced window.

Its launches are the device spans named ``binary_matmul_kernel``
(``csrc/binary_matmul.cu``); each is counted as the configuration's layers of
kinds ("linear",) at the cell's batch and levels (``network.work``).
"""
from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "binary_matmul_kernel", ("linear",))
