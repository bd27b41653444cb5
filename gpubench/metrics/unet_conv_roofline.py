"""unet_conv_roofline: the UNet's convolutions that the kernels of
families/conv3x3.json serve (its "work" kinds), in the traced stretch, at
their roofline bound, as a share of those kernels' device time."""

from gpubench.roofline import share


def read(run, name):
    return share(run, "conv3x3")
