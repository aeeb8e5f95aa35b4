"""idle_share.<suffix>: the share of the device-only trace's window in which
no operation ran on the device (%)."""


def read(run):
    t = run.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
