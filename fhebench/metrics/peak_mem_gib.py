"""torch.cuda.max_memory_allocated() over the timed window, reset just
before it."""


def read(run):
    b = run.window_peak_bytes
    return b / 2**30 if b else None
