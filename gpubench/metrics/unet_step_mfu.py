"""unet_step_mfu: the UNet's model operations for every evaluation of the
groups that started inside the window (each group's real images, doubled
under CFG, every step), over the time from the window's start to the last
of them completing, as a share of the card's dense peak in the UNet's
dtype. The operations are counted by the configuration's work module."""


def read(run, name):
    peaks = run.spec.peaks(run.device_kind)
    if not peaks:
        return None
    work = run.spec.work()
    groups, reqs, span = run.counted_groups()
    where = run.group_of()
    flops = 0
    for g in groups:
        real = sum(1 for r in reqs if r.seed in g["seeds"] and where[r.seed][0] is g)
        if real:
            flops += g["steps"] * work.evaluation_flops(
                run.cfg["unet"], run.unet_batch(real, g), *run.lat_hw(g))
    if not flops or span <= 0:
        return None
    return 100.0 * flops / span / peaks["flops"][run.cfg["dtypes"]["unet"]]
