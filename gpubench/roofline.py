"""The reduction the roofline readers share: the least time the card needs
for the UNet calls that a family's kernels serve in the traced stretch (for
each call the longer of its operations at the dense peak of the UNet's
dtype and its bytes at the memory rate, summed over every evaluation of the
stretch's groups, padded rows included), as a share of the device time of
that family's kernels."""


def share(run, family: str):
    st = run.stretch
    peaks = run.spec.peaks(run.device_kind)
    if st is None or not peaks or not st.family_s.get(family):
        return None
    kinds = set(run.spec.families()[family]["work"])
    work = run.spec.work()
    peak = peaks["flops"][run.cfg["dtypes"]["unet"]]
    bound = 0.0
    for g in st.groups:
        calls = work.unet_calls(run.cfg["unet"], run.unet_batch(len(g["seeds"]), g),
                                *run.lat_hw(g))
        bound += g["steps"] * sum(max(c["flops"] / peak, c["bytes"] / peaks["bytes_per_s"])
                                        for c in calls if c["kind"] in kinds)
    return 100.0 * bound / st.family_s[family]
