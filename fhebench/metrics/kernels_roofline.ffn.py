"""A feed-forward forward's least time (roofline/ffn.py: its two modular
matrix products at the int8 tensor-core ceiling, its squares' cc_mult
calls at work.py's) over the device time of all its kernels, per
forward, in %.  The square chunks are the program's: the ``cc_mult``
spans its ``ffn.act`` spans hold."""

from fhebench import layer_spans
from fhebench.roofline import ffn


def read(run):
    tr = run.trace
    per_root = layer_spans.inside(run, "ffn", "cc_mult", "ffn.act")
    if (tr is None or not tr.kernel_s or run.sm_clock_hz is None
            or not per_root or not per_root[0]):
        return None
    c = run.config
    dep = c["deployment"]
    S = c["num_special_primes"]
    w = ffn.forward(c["logN"], c["primes"], len(c["primes"]) - S, S,
                    int(dep["hidden_size"]), int(dep["intermediate_size"]),
                    int(c["scale_bits"]), len(per_root[0]),
                    int(run.mix.get("level", 0)))
    return 100.0 * w.least_s(run.sm_clock_hz) / (tr.kernel_s / tr.requests)
