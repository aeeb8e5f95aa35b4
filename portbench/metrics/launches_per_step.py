"""launches_per_step.<suffix>: kernel launches in the device-only trace
(copies, fills and the window's marks left out) per train step."""


def read(run):
    t = run.get("trace")
    if not t:
        return None
    return t["kernels"] / t["calls"]
