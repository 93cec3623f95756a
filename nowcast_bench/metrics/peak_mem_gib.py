"""peak_mem_gib.<mix kind>: torch.cuda.max_memory_allocated after a reset
at the window's start, in GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
