"""Fold-rate probe: how many modular multiplies a second the card does.

    python -m tiberate_tpu_torch.benchmarks.profiling.fold_microbench

The counterpart of ``benchmarks/profiling/vpu_microbench.py``, which ran
K = 32 chained ``_shoup_mult`` over a resident [64, 256, 512] u32-pair
block on the TPU and took the fold rate from two iteration counts.  Here
the block is the same shape on an NVIDIA card, in three modes
(``ops/fold_probe.py``, kernels in ``csrc/fold_probe.cu``):

* ``fold_shoup``: the TPU kernels' Shoup fold, with the TPU probe's
  constants q = 2^41 - 143, w = q - 12345 and x < 2^60;
* ``fold_redc`` / ``fold_redc_30``: the REDC of the port's own kernels at
  R = 2^62 (int64) and R = 2^30 (int32), with the largest modulus of the
  logN15 and logN15_30 prime chains and w = q - 12345, x in [0, 2q).

Each mode is timed with CUDA events (median of 3 loops of 3 calls after a
warm-up) at two chain lengths, K = 32 and K = 128, and its rate is
elements x (128 - 32) / (time(128) - time(32)): the bytes each call moves,
its launch and the wrapper's range check cancel.  The REDC rates are the
compute term of ``ops/roofline.py``.  Where the CUDA toolkit has
``cuobjdump``, the SASS of one chain step is counted too.

It runs on a CUDA card only: without one it raises, and it never reports
a rate from the CPU.
"""

import json
import re
import statistics
import subprocess
import sys

import torch

from tiberate_tpu_torch.config import CkksConfig, Preset
from tiberate_tpu_torch.ops import cuda_build, fold_probe

SHAPE = (64, 256, 512)
K_SHORT, K_LONG = 32, 128
Q_PROBE = (1 << 41) - 143  # vpu_microbench.py:25-26
W_PROBE = Q_PROBE - 12345
SEED = 0

# mode -> (wrapper, plain version, word type)
MODES = {
    "fold_shoup": (fold_probe.fold_shoup, fold_probe.fold_shoup_plain,
                   torch.int64),
    "fold_redc": (fold_probe.fold_redc, fold_probe.fold_redc_plain,
                  torch.int64),
    "fold_redc_30": (fold_probe.fold_redc, fold_probe.fold_redc_plain,
                     torch.int32),
}
# mode -> the name its kernel has in the SASS (csrc/fold_probe.cu)
_SASS_NAMES = {"fold_shoup": "fold_shoup_kernel",
               "fold_redc": "fold_redc_kernelIxE",
               "fold_redc_30": "fold_redc_kernelIiE"}


def constants(mode):
    """(q, w) of a mode."""
    if mode == "fold_shoup":
        return Q_PROBE, W_PROBE
    preset = Preset.logN15 if mode == "fold_redc" else "logN15_30"
    q = max(CkksConfig.parse(preset).q)
    return q, q - 12345


def make_input(mode, device, seed=SEED):
    """(x, q, w): the [64, 256, 512] block of a mode, drawn on ``device``
    from ``seed``: x < 2^60 for the Shoup fold, x in [0, 2q) for REDC."""
    q, w = constants(mode)
    gen = torch.Generator(device=device).manual_seed(seed)
    hi = 1 << 60 if mode == "fold_shoup" else 2 * q
    x = torch.randint(0, hi, SHAPE, generator=gen, dtype=torch.int64,
                      device=device)
    return x.to(MODES[mode][2]), q, w


def cuda_ms(fn, reps=3, inner=3):
    """Median over ``reps`` loops of ``inner`` calls, in ms per call, after
    one warm-up call (CUDA events around each loop)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def measure(device="cuda", seed=SEED):
    """mode -> its rate on the card: ``ms`` per call at each chain length,
    ``ns_per_fold``, ``fold_per_s``, with the block's shape and constants.
    Raises unless ``device`` is a CUDA card."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the fold-rate probe runs on a CUDA card only; "
                           f"got {device} (cuda available: "
                           f"{torch.cuda.is_available()})")
    out = {}
    for mode, (fn, _, _) in MODES.items():
        x, q, w = make_input(mode, device, seed)
        ms = {K: cuda_ms(lambda K=K: fn(x, w, q, K))
              for K in (K_SHORT, K_LONG)}
        folds = x.numel() * (K_LONG - K_SHORT)
        dt_s = (ms[K_LONG] - ms[K_SHORT]) * 1e-3
        if dt_s <= 0:
            raise RuntimeError(f"{mode}: K={K_LONG} took no longer than "
                               f"K={K_SHORT} ({ms}); no rate")
        out[mode] = dict(shape=list(SHAPE), q=q, w=w, ms=ms,
                         ns_per_fold=dt_s * 1e9 / folds,
                         fold_per_s=folds / dt_s)
    return out


def chain_step(sass_function):
    """(IMAD-class, all) instructions of one chain step in the SASS text of
    one kernel: the body (counter, compare and branch included) of its
    innermost loop that is nested in another loop, the grid-stride loop;
    IMAD-class counts ``IMAD*`` and ``IMUL*``, every instruction issued to
    the integer multiply-add pipe.  The kernel's other loops are not nested
    (nvcc adds unrolled copy loops for K = 0).  None if there is no such
    loop."""
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
        r"([^;]*);", sass_function)]
    loops = []
    for addr, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))

    def within(a, b):
        return a != b and b[0] <= a[0] and a[1] <= b[1]

    chain = [lp for lp in loops
             if any(within(lp, outer) for outer in loops)
             and not any(within(inner, lp) for inner in loops)]
    if len(chain) != 1:
        return None
    lo, hi = chain[0]
    body = [op for a, op, _ in ins if lo <= a <= hi and op != "NOP"]
    return (sum(op.startswith(("IMAD", "IMUL")) for op in body), len(body))


def sass_step_counts():
    """mode -> (IMAD-class, all) SASS instructions of one chain step
    (:func:`chain_step`) in the built library; None where ``cuobjdump`` is
    absent, and a mode is left out where its loop cannot be found."""
    sass = cuda_build.sass(*_SASS_NAMES.values())
    if sass is None:
        return None
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        mode = next((m for m, s in _SASS_NAMES.items() if s in name), None)
        step = None if mode is None else chain_step(block)
        if step is not None:
            counts[mode] = step
    return counts


def card():
    """The card's name, power limit and SM clocks (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    res = measure()
    smi = card()
    sass = sass_step_counts()
    print(f"card (name, power limit, SM clock, max SM clock): {smi}")
    for mode, r in res.items():
        steps = ("not measured (no cuobjdump)" if sass is None else
                 "not measured (loop not found)" if mode not in sass else
                 f"{sass[mode][0]} IMAD-class of {sass[mode][1]} SASS "
                 f"instructions")
        print(f"{mode}: block {r['shape']} {str(MODES[mode][2])[6:]}, "
              f"q={r['q']}: K={K_SHORT} {r['ms'][K_SHORT]:.4f} ms, "
              f"K={K_LONG} {r['ms'][K_LONG]:.4f} ms per call; "
              f"{r['ns_per_fold']:.6f} ns per fold, "
              f"{r['fold_per_s'] / 1e9:.1f} G-fold/s; one chain step: "
              f"{steps}")
    print(json.dumps({"card": smi, "modes": res, "sass_step": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
