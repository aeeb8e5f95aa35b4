"""launches_per_frame.<suffix>: kernel launches in the device-only trace
(copies, fills and the window's marks left out) per frame set."""


def read(run):
    t = run.get("trace")
    if not t:
        return None
    return t["kernels"] / (t["calls"] * run["items_per_call"])
