"""graph_capture_s: the seconds the set-up spent capturing the cell's
graphs: the sum over every captured graph of the port's own timers (its
eager warm-up, the capture's entry, the captured call, the capture's end
and the instantiation)."""


def read(run, name):
    if not run.captured:
        return None
    return sum(c.warmup_s + c.enter_s + c.capture_s + c.end_s + c.instantiate_s
               for c in run.captured)
