"""unet_attention_roofline: the UNet's attention calls (self and cross) in
the traced stretch, at their roofline bound, as a share of the device time
of the kernels in families/attention.json."""

from gpubench.roofline import share


def read(run, name):
    return share(run, "attention")
