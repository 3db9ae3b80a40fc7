"""device_mem_peak_gb: torch.cuda.max_memory_allocated() over set-up and
window, in 10^9 bytes."""


def read(run):
    return run.mem_peak_bytes / 1e9 if run.mem_peak_bytes else None
