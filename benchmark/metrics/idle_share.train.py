"""Share of the traced training window in which no operation ran on the
card: 1 - the union of the device events' intervals (``torch.profiler``)
over the window. Unit %."""


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
