"""device_idle: the share of the traced stretch (whole groups or requests,
from the first submit to the last completion) in which no operation ran on
the device."""


def read(run, name):
    st = run.stretch
    if st is None or st.busy_s <= 0 or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
