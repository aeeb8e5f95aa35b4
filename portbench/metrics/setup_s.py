"""setup_s: process start to the first timed call (imports, the kernels'
build on a fresh checkout, the model, the weights, the input pool, the
warm-up calls), on the host clock."""


def read(run):
    return run["setup_s"]
