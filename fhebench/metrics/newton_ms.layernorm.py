"""The Newton chain of a LayerNorm forward (its reciprocal square root,
on one ciphertext: the part that stacking the features cannot batch):
the mean duration of the program's ``layernorm.rsqrt`` span over the
traced forwards, in ms."""

from fhebench import layer_spans


def read(run):
    xs = [r.t1 - r.t0 for rs in layer_spans.inside(run, "layernorm",
                                                   "layernorm.rsqrt")
          for r in rs]
    return 1e3 * sum(xs) / len(xs) if xs else None
