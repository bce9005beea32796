#!/usr/bin/env python3
"""Smoke test of tiberate_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``tiberate_tpu_torch/csrc`` (nvcc), and
   print ptxas's register and spill counts;
3. at the logN15 step shapes (batch 8, 16/17/18 channels, N = 32768) hold
   each kernel against its plain torch version on the same card tensors —
   byte for byte, lazy outputs included — and time both;
4. drive the main path at Preset.logN15 on the card: keygen, encodecrypt
   of 8 message pairs, the fused cc_mult step on the batch, decryptcode;
   the step's output for one pair must equal, byte for byte, the same step
   run on CPU tensors through the plain versions, the decrypt error must
   stay below 1e-6, and every kernel's launch count must have risen;
   ``CkksEngine.rescale`` of the batch must equal the CPU's for one pair;
5. time the step (median of 3 loops after a warm-up), and the same step
   with every wrapper swapped for its plain version (torch ops on the
   card); profile one step with torch.profiler: device time by kernel,
   and the device's busy share of that profiled step's wall time (the
   profiler slows the host, so this share is lower than an unprofiled
   step's).

The second-to-last line is a JSON object with one entry per kernel; the
last line is the device record.
"""

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 8
SEED = 1234
DECRYPT_TOL = 1e-6

# kernel -> (source, the TPU kernel it replaces).  K1-K4 are entry points
# of _run_group (:1395), K5 of _run_tensor_group, K6 of _run_parts_group.
_PALLAS = "tiberate_tpu/ops/pallas_mxu.py"
KERNELS = {
    "ntt": ("tiberate_tpu_torch/csrc/ntt.cu", f"{_PALLAS}:1395"),
    "intt": ("tiberate_tpu_torch/csrc/ntt.cu", f"{_PALLAS}:1395"),
    "ntt_keymul": ("tiberate_tpu_torch/csrc/ntt.cu", f"{_PALLAS}:1395"),
    "intt_pdiv": ("tiberate_tpu_torch/csrc/ntt.cu", f"{_PALLAS}:1395"),
    "ntt_tensor": ("tiberate_tpu_torch/csrc/tensor.cu", f"{_PALLAS}:1194"),
    "ntt_keymul_parts": ("tiberate_tpu_torch/csrc/keyswitch.cu",
                         f"{_PALLAS}:868"),
}
# the kernels the fused step itself launches
STEP_KERNELS = ("intt", "intt_pdiv", "ntt_tensor", "ntt_keymul_parts")


def log(msg):
    print(msg, flush=True)


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


@contextlib.contextmanager
def plain_wrappers(kern):
    """Route every kernel wrapper to its plain version (for timing the
    step without the kernels); restored on exit."""
    saved = {name: getattr(kern, name) for name in KERNELS}
    try:
        for name in KERNELS:
            setattr(kern, name, getattr(kern, name + "_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kern, name, fn)


def uniform(gen, q, shape, device):
    """Residues uniform in [0, q_c) per channel; q: [C] tensor."""
    x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64)
    return (x % q.cpu()[:, None]).to(device)


def check_kernels(eng, kern, mod):
    """Phase 3: every kernel against its plain version at step shapes."""
    dev = eng.device
    gen = torch.Generator().manual_seed(SEED)
    N = eng.ckksCfg.N
    lp_ord, lp_sp = eng._lp(1, False), eng._lp(1, True)
    lp0 = eng._lp(0, False)
    C, C_sp, S = lp_ord.num_channels, lp_sp.num_channels, eng.params.S
    q_ord, q_sp, q0 = lp_ord.pack.q, lp_sp.pack.q, lp0.pack.q
    PiRs = eng.params.PiRs[1]
    parts = eng.params.parts[1]
    ec, alphas = eng._parts_consts(1)
    n_parts, amax = ec.shape[0], ec.shape[-1]

    x = uniform(gen, q_ord, (BATCH, C, N), dev)
    x4 = [uniform(gen, q_ord, (BATCH, C, N), dev) for _ in range(4)]
    x17 = uniform(gen, q0, (BATCH, C + 1, N), dev)
    keys17 = (uniform(gen, q0, (C + 1, N), dev),
              uniform(gen, q0, (C + 1, N), dev))
    acc = uniform(gen, q_sp, (BATCH, C_sp, N), dev)
    p0 = uniform(gen, q_sp[C:], (BATCH, S, N), dev)
    a = uniform(gen, q_ord, (BATCH, C, N), dev)
    st = mod._parts_digits(a, parts, lp_ord, amax).contiguous()
    pkeys = tuple(
        torch.stack([uniform(gen, q_sp, (C_sp, N), dev)
                     for _ in range(n_parts)])
        for _ in range(2)
    )
    cases = {
        "ntt": (lambda: kern.ntt(x, lp_ord, enter=True),
                lambda: kern.ntt_plain(x, lp_ord, enter=True)),
        "intt": (lambda: kern.intt(x, lp_ord, "exit_reduce"),
                 lambda: kern.intt_plain(x, lp_ord, "exit_reduce")),
        "ntt_keymul": (lambda: kern.ntt_keymul(x17, lp0, keys17, True),
                       lambda: kern.ntt_keymul_plain(x17, lp0, keys17,
                                                     True)),
        "intt_pdiv": (lambda: kern.intt_pdiv(acc, p0, lp_ord, PiRs),
                      lambda: kern.intt_pdiv_plain(acc, p0, lp_ord, PiRs)),
        "ntt_tensor": (lambda: kern.ntt_tensor(*x4, lp_ord),
                       lambda: kern.ntt_tensor_plain(*x4, lp_ord)),
        "ntt_keymul_parts": (
            lambda: kern.ntt_keymul_parts(st, ec, alphas, pkeys, lp_sp),
            lambda: kern.ntt_keymul_parts_plain(st, ec, alphas, pkeys,
                                                lp_sp)),
    }
    shapes = {
        "ntt": [BATCH, C, N], "intt": [BATCH, C, N],
        "ntt_keymul": [BATCH, C + 1, N], "intt_pdiv": [BATCH, C_sp, N],
        "ntt_tensor": [BATCH, C, N],
        "ntt_keymul_parts": [BATCH, n_parts, amax, N],
    }
    results = {}
    for name, (kfn, pfn) in cases.items():
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms, plain_ms = cuda_ms(kfn), cuda_ms(pfn)
        log(f"kernel {name}: input {shapes[name]} byte-identical={same} "
            f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms")
        if not same:
            raise AssertionError(f"{name} disagrees with its plain version")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


def main_path(kern, CkksEngine, Preset, stack, unstack):
    """Phase 4: the main path on the card, then one pair on the CPU."""
    eng = CkksEngine(Preset.logN15, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED)
    m1 = rng.uniform(-1, 1, (BATCH, eng.num_slots))
    m2 = rng.uniform(-1, 1, (BATCH, eng.num_slots))

    kern.reset_launch_counts()
    t0 = time.perf_counter()
    eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
    torch.cuda.synchronize()
    t_keygen = time.perf_counter() - t0
    A = stack([eng.encodecrypt(m) for m in m1])
    B = stack([eng.encodecrypt(m) for m in m2])
    torch.cuda.synchronize()
    before_step = dict(kern.LAUNCHES)
    t0 = time.perf_counter()
    out = eng.cc_mult(A, B)
    torch.cuda.synchronize()
    t_first_step = time.perf_counter() - t0
    step_launches = {k: kern.LAUNCHES[k] - before_step[k]
                     for k in kern.LAUNCHES}
    decoded = np.stack([eng.decryptcode(ct, is_real=True)
                        for ct in unstack(out)])
    torch.cuda.synchronize()
    launches = dict(kern.LAUNCHES)
    log(f"main path launches {launches}; during the step {step_launches}")
    log(f"keygen {t_keygen:.3f} s, first step {t_first_step:.3f} s")
    missing = [k for k, v in launches.items() if v == 0]
    missing += [k for k in STEP_KERNELS if step_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path: {missing}")

    for d in out.data:
        if tuple(d.shape) != (BATCH, eng._lp(1).num_channels, eng.ckksCfg.N):
            raise AssertionError(f"step output shape {tuple(d.shape)}")
    if not np.all(np.isfinite(decoded)):
        raise AssertionError("non-finite decrypt")
    err = float(np.abs(decoded - m1 * m2).max())
    log(f"logN15 cc_mult decrypt max error vs m1*m2 over {BATCH} pairs: "
        f"{err:.3e} (limit {DECRYPT_TOL})")
    if not err < DECRYPT_TOL:
        raise AssertionError("decrypt error above the limit")

    # the same step on CPU tensors, through the plain versions
    eng_cpu = CkksEngine(Preset.logN15, device="cpu", seed=SEED)
    cpu = torch.device("cpu")
    evk = eng.evk
    eng_cpu.evk = type(evk)(
        data=tuple(tuple(t.to(cpu) for t in part) for part in evk.data),
        flags=evk._flags, level=evk.level,
    )
    t0 = time.perf_counter()
    pair = [type(A)(data=tuple(d[0].to(cpu) for d in X.data), level=0)
            for X in (A, B)]
    out_cpu = eng_cpu.cc_mult(*pair)
    t_cpu = time.perf_counter() - t0
    same = all(torch.equal(c, g[0].cpu())
               for c, g in zip(out_cpu.data, out.data))
    log(f"step on pair 0: GPU == CPU plain path byte for byte: {same} "
        f"(CPU step {t_cpu:.2f} s)")
    if not same:
        raise AssertionError("GPU step differs from the CPU step")

    # CkksEngine.rescale on the card against the CPU, on pair 0
    r_gpu, r_cpu = eng.rescale(A), eng_cpu.rescale(pair[0])
    same = r_gpu.level == r_cpu.level == 1 and all(
        torch.equal(c, g[0].cpu()) for c, g in zip(r_cpu.data, r_gpu.data))
    log(f"rescale of pair 0: GPU == CPU byte for byte: {same}")
    if not same:
        raise AssertionError("GPU rescale differs from the CPU rescale")
    return eng, A, B, launches, err


def profile_step(fn, top=12):
    """Device time by kernel over one step (CUDA kernel events only), and
    the busy share of its wall time (kernel times summed; kernels on one
    stream do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us == 0:
        log("profiler: no device time recorded (not measured)")
        return
    log(f"profile of one step: wall {wall_us:.0f} us under the profiler, "
        f"device busy {busy_us:.0f} us ({100 * busy_us / wall_us:.1f}% of "
        f"that profiled wall), "
        f"{sum(e.count for e in rows)} kernel launches")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:top]:
        log(f"  {e.self_device_time_total:9.1f} us  x{e.count:<4d} "
            f"{e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from tiberate_tpu_torch import Preset
    from tiberate_tpu_torch.engine import (
        CkksEngine,
        stack_ciphertexts,
        unstack_ciphertext,
    )
    from tiberate_tpu_torch.engine import ckks_engine as mod
    from tiberate_tpu_torch.ops import cuda_build
    from tiberate_tpu_torch.ops import ntt_kernels as kern

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    cuda_build.build(verbose=True)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       cuda_build.build_log)]
    spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill",
                                           cuda_build.build_log))
    log(f"built kernels in {time.perf_counter() - t0:.1f} s; ptxas: "
        f"{len(regs)} entry functions, {min(regs)}-{max(regs)} registers, "
        f"{spill} bytes of spill stores and loads")
    cuda_build.lib()

    # 3. kernels against their plain versions
    eng_k = CkksEngine(Preset.logN15, device="cuda", seed=SEED)
    results = check_kernels(eng_k, kern, mod)
    del eng_k

    # 4. the main path
    eng, A, B, launches, err = main_path(kern, CkksEngine, Preset,
                                         stack_ciphertexts,
                                         unstack_ciphertext)

    # 5. step timing and profile
    step_ms = cuda_ms(lambda: eng.cc_mult(A, B))
    with plain_wrappers(kern):
        plain_out = eng.cc_mult(A, B)
        plain_step_ms = cuda_ms(lambda: eng.cc_mult(A, B), inner=1)
    same = all(torch.equal(p, k)
               for p, k in zip(plain_out.data, eng.cc_mult(A, B).data))
    log(f"fused cc_mult step, batch {BATCH}: {step_ms:.3f} ms/step, "
        f"{step_ms / BATCH:.3f} ms/ct; with the plain versions on the card "
        f"{plain_step_ms:.3f} ms/step, {plain_step_ms / BATCH:.3f} ms/ct, "
        f"byte-identical={same} ({smi})")
    if not same:
        raise AssertionError("plain-version step differs on the card")
    profile_step(lambda: eng.cc_mult(A, B))

    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **results[name])
        for name, (src, rep) in KERNELS.items()
    ]
    log(json.dumps({"step_ms": step_ms, "step_ms_per_ct": step_ms / BATCH,
                    "plain_step_ms": plain_step_ms,
                    "batch": BATCH, "decrypt_max_err": err, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
