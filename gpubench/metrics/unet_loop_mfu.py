"""unet_loop_mfu: the UNet's model operations of the denoise loops that ran
inside the window (each loop's real images: its requests, or its rows
outside the engine, doubled under CFG, every step; counted by the
configuration's work module as unet_step_mfu counts them) over the sum of
the loops' device intervals (their ``pipeline.loop`` spans), as a share of
the card's dense peak in the UNet's dtype."""

from gpubench import spans


def read(run, name):
    peaks = run.spec.peaks(run.device_kind)
    got = spans.window(run)
    if not peaks or not got:
        return None
    work = run.spec.work()
    flops, seconds = 0, 0.0
    for s in spans.named(got, "pipeline.loop"):
        if s.device is None:
            continue
        a = s.attrs
        real = len(s.requests) or a["rows"]
        batch = run.unet_batch(real, {"guidance_scale": a["guidance_scale"]})
        flops += a["steps"] * work.evaluation_flops(run.cfg["unet"], batch, a["lat_h"], a["lat_w"])
        seconds += spans.device_s(s)
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / seconds / peaks["flops"][run.cfg["dtypes"]["unet"]]
