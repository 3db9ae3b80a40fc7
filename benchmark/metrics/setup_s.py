"""setup_s: process start to window start: data generation, mkindexp,
index load and upload, warm-up (host clock)."""


def read(run):
    return run.setup_s
