"""peak_mem_gib.<suffix>: ``torch.cuda.max_memory_allocated`` over the
measured window, after a reset at its start (GiB)."""


def read(run):
    b = run.get("peak_window_bytes")
    return b / 2 ** 30 if b else None
