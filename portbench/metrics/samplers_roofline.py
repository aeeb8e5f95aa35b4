"""samplers_roofline.<suffix>: the least time the traced calls' sampling
could take (the bytes it needs, ``core/flops.py``, at the HBM peak) over the
device time of the program's sampler kernels (names holding
``sample_view``) in the device-only trace (%)."""

from portbench.core import peaks


def read(run):
    t = run.get("trace")
    if not t or t["sampler_s"] <= 0:
        return None
    need = run["sampler_bytes_per_call"] * t["calls"] / peaks.HBM_BYTES_PER_S
    return 100.0 * need / t["sampler_s"]
