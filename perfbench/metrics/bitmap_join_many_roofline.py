"""bitmap_join_many's share of its HBM roofline in the window, in %."""
from perfbench.readers import kernel_roofline


def read(rd):
    return kernel_roofline(rd, "bitmap_join_many")
