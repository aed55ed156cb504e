"""peak_mem_gb (GB), end to end: ``torch.cuda.max_memory_allocated()``
over the window, after ``reset_peak_memory_stats()`` at its start."""

LAYER = "device"


def read(run):
    return run.peak_mem_bytes / 1e9
