"""The 95th percentile over every round trip of the window
(encodecrypt_batch, then decryptcode_batch, each synchronised)."""

import numpy as np


def read(run):
    xs = [r.seconds for r in run.requests if r.work.get("roundtrip")]
    return float(np.percentile(xs, 95)) * 1e3 if xs else None
