"""The modular matrix product kernel's share of its roofline: the least
time of a forward's two products (roofline/ffn.py: int8 tensor-core
ceiling, or bytes) over the device time of the kernels named
``matmul_k`` in the trace, per forward, in %.  A program without that
kernel gives none."""

from fhebench.roofline import ffn

KERNEL = "matmul_k"


def read(run):
    tr = run.trace
    if tr is None or run.sm_clock_hz is None or not tr.requests:
        return None
    busy = sum(s for name, s in tr.device_ops if name.startswith(KERNEL))
    if not busy:
        return None
    c = run.config
    dep = c["deployment"]
    w = ffn.matmuls(c["logN"], c["primes"],
                    len(c["primes"]) - c["num_special_primes"],
                    int(dep["hidden_size"]), int(dep["intermediate_size"]),
                    int(c["scale_bits"]), int(run.mix.get("level", 0)))
    return 100.0 * w.least_s(run.sm_clock_hz) / (busy / tr.requests)
