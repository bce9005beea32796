"""A LayerNorm forward's least time (roofline/layernorm.py: its cc_mults'
products and bytes, and its elementwise passes' bytes) over the device
time of all its kernels, per forward, in %.  The chunks are the
program's: the ``cc_mult`` spans its ``layernorm.square`` span holds."""

from fhebench import layer_spans
from fhebench.roofline import layernorm


def read(run):
    tr = run.trace
    per_root = layer_spans.inside(run, "layernorm", "cc_mult",
                                  "layernorm.square")
    if (tr is None or not tr.kernel_s or run.sm_clock_hz is None
            or not per_root or not per_root[0]):
        return None
    c = run.config
    dep = c["deployment"]
    S = c["num_special_primes"]
    w = layernorm.forward(c["logN"], len(c["primes"]) - S, S,
                          int(dep["hidden_size"]), int(dep["iters"]),
                          len(per_root[0]))
    return 100.0 * w.least_s(run.sm_clock_hz) / (tr.kernel_s / tr.requests)
