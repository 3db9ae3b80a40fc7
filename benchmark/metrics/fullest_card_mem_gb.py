"""fullest_card_mem_gb: the device memory of the mesh's fullest card, in
10^9 bytes: the largest StatsHolder.card_mem_peak_bytes (each call's
largest torch.cuda.max_memory_allocated over the mesh's cards, read at
its end) of the window's calls.  device_mem_peak_gb reads the current
card alone.  None where the program does not record it (no mesh, no
card, or a program without it)."""


def read(run):
    if not run.calls or any("card_mem_peak_bytes" not in c.stats
                            for c in run.calls):
        return None
    peak = max(c.stats["card_mem_peak_bytes"] for c in run.calls)
    return peak / 1e9 if peak else None
