#!/usr/bin/env python3
"""Smoke test of tiberate_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``tiberate_tpu_torch/csrc`` (one nvcc per
   source, in parallel), and print ptxas's register and spill counts;
2b. the fold-rate probe (``fold_microbench``, the counterpart of the TPU's
   VPU op-rate probe): each of its three kernels (``fold_shoup``,
   ``fold_redc``, ``fold_redc_30``) against its plain version, byte for
   byte, on the [64, 256, 512] block at K = 32; then the probe's entry
   point, with the launch counts set to 0 before and read after, measures
   each mode's rate from two chain lengths; it prints the rates beside the
   card's SM clock, and the SASS instructions of one chain step where
   ``cuobjdump`` is present;
2c. every entry of the register-tiled kernels (K1, K2 with its three
   epilogues, K3 with one and two keys, the chain with and without a skip
   range, K4, K5 and K6) at logN 4, 7 and 10 in both lanes, byte for byte
   against their plain versions, K1 without entry also on the signed
   (negative) words of a rotated and of a conjugated secret key; and the
   SASS of the register-tiled core
   (``cuobjdump``): the instructions per butterfly of the inverse
   contiguous pass and of K5's and K6's contiguous passes;
2d. the ChaCha20 CSPRNG on the card against the same generator on the
   CPU, with the logN15 and the logN17 engine's channel model and one
   (seed, nonce): ``randint`` over the full q chain, ``discrete_gaussian
   (repeats=2)``, ``randround_batch`` and ``encrypt_noise_batch`` of 8,
   three successive calls each, byte for byte, then the states; ms per
   draw on the card (CUDA events);
2e. the pinned digest: ``CkksEngine("logN14", seed=1234, nonce=1)
   .encodecrypt(linspace(-1, 1))`` on the card hashes to
   ``ct_sha256_seed1234_nonce1`` of ``tests/golden/presets.json`` and
   decrypts below 1e-6;
3. at the logN15 step shapes (batch 8, 16/17/18 channels, N = 32768) hold
   each kernel against its plain torch version on the same card tensors —
   byte for byte, lazy outputs included — and time both (the plain
   version by its one comparison call); K1 without entry, K2's "mont" and
   "exit" epilogues and K3 with one key are compared too;
4. drive the main path at Preset.logN15 on the card: keygen,
   ``encodecrypt_batch`` of 8 messages twice, the fused cc_mult step on
   the batch (all keyswitch parts in one kernel), ``decryptcode_batch``;
   the decrypt error must stay below 1e-6 and every kernel of the path
   must have launched.  Then, from the CSPRNG state before the batch
   draws, the same 16 messages through single ``encodecrypt`` calls must
   give the batch ciphertexts byte for byte, and 8 single
   ``decryptcode`` calls the batch decode within 1e-9, and the batch forms
   run again, warm, from the same state (same bytes); the launches of the
   path with the single forms are printed beside the batch path's, and
   the decrypt of the step's 8 ciphertexts, batch and single, is timed
   part by part (``decrypt_parts``).
   A CPU engine of the same preset and seed makes its own keys, which
   must equal the card's byte for byte (sk, pk, every evk part); its
   step on one pair and ``rescale`` must equal the card's;
5. time the logN15 step (median of 3 loops after a warm-up), the same step
   with every wrapper swapped for its plain version (torch ops on the
   card), and the step through the per-part keyswitch chain instead of the
   all-parts kernel (byte-identical); profile one step with
   torch.profiler: device time by kernel, and the device's busy share of
   that profiled step's wall time (the profiler slows the host, so this
   share is lower than an unprofiled step's); a seed-expanded evk
   (``a_seed``) through ``compress_ksk`` and ``expand_ksk`` gives back its
   bytes; then 5b; then the CSPRNG's share of keygen and of
   ``encodecrypt_batch`` (its draws timed, synchronised, in a second
   keygen and batch);
5b. the evaluation path at logN15 on the batch of 8, its launch counts set
   to 0 before it and read after: the Galois keys (14 rotation keys) and
   the conjugation key (time, device memory), ``rotate_offset`` by 1, 5
   and -1, ``conjugate``, ``negate``, ``cc_add``, ``cc_sub``, ``pc_add``,
   ``pc_mult``, ``mult_int_scalar``, ``mult_scalar``, ``add_scalar``,
   ``level_up``, ``cc_mult`` of two levels, ``square(post_relin=False)`` +
   ``relinearize``, ``sum``, ``mean`` and ``var``, each decrypted against
   numpy (1e-6 fresh, 1e-5 rotations and products, ``pc_add`` 100x and
   ``sum`` 200x those: the JAX tests' bounds and ratios); every keyswitch
   one K6 and two K4, ``pc_mult`` two K3; the rotation key for delta 1
   and the conjugation key equal to the CPU engine's from the same CSPRNG
   state; the batch rotation equal to 8 single ones; times of
   ``rotate_single``, ``conjugate``, ``pc_mult``, ``sum``, ``mean`` and
   ``var`` (CUDA events) and of the Galois keys;
6. at Preset.logN17 (N = 2^17, 73 + 6 primes; one engine for the whole
   phase): the kernels at the step's shapes (batch 8, level 1: 72 / 78
   channels) against their plain versions, the chain kernel with no skip
   range and with one part's range, and the all-parts kernel on digits
   [8, 13, 6, 2^17] (median of 3 single calls each);
7. the logN17 main path as in 4 (batch forms, the single forms' bytes and
   launches): the cc_mult step through the per-part chain (13
   ``ntt_keymul_accum`` launches, no all-parts launch), decrypt error
   below 1e-4 (the JAX package's logN17 bound); the step equals the
   plain-version step byte for byte;
8. logN17 ``switch_key``: a ciphertext under a second secret key switched
   to the engine's key decrypts within 1e-6;
8b. logN17 evaluation: the rotation key for delta 1 and the conjugation
   key (a full Galois set, 16 keys of about 2 GiB, is left out), one
   ``rotate_offset(., 1)`` and one ``conjugate`` of the batch, each through
   the per-part chain (one K3 and n_parts - 1 chain launches, no K6),
   within 1e-4;
9. logN17 timing: the step with the kernels and with the plain versions,
   the route A/B (chain against the all-parts kernel, byte-identical, with
   each run's peak device memory), one profiled step, and the CSPRNG's
   share of keygen and of ``encodecrypt_batch``;
10. the 30-bit mode (int32 residues, R = 2^30) at "logN15_30" (19 primes):
    every 30-bit kernel (the ``_30`` lane) against its plain version at the
    step's shapes; the main path as in 4 (the step through the all-parts
    kernel, error below 1e-2, the JAX package's 30-bit bound), which must
    launch only ``_30`` kernels; the keys and the step on one pair equal
    to the CPU's; the evaluation path cut to ``rotate_offset`` by 2,
    ``add_scalar`` and ``sum`` (within 5e-3, the JAX package's 30-bit
    preset bound, and ``sum`` 200x that), ``_30`` kernels only; step
    times with the kernels and
    the plain versions, printed beside phase 5's 62-bit logN15 step; the
    route A/B; one profiled step;
11. "logN17_30" (17 primes): the 30-bit kernels at the step's shapes; the
    main path through the per-part chain (8 ``ntt_keymul_accum_30``
    launches, no all-parts launch; error below 1e-2); the evaluation as in
    8b, within 5e-3; the step equal to the plain-version step; the route
    A/B with peak memory; one profiled step;
12. the extension path at Preset.logN15, its launch counts set to 0
    before it and read after: the operator sugar (``ct1 * ct2 + ct1``,
    ``>> 3``, ``<< 1``, ``** 2``, ``.plain``; the Galois keys made first)
    byte for byte against the explicit engine calls and within 1e-5 of
    numpy; ``save`` / ``load`` of a ciphertext, a triplet, the secret key
    and the evk through files, back onto the card and the CPU with the
    same bytes (the loaded ciphertext decrypts within 1e-6);
    ``batched_inference`` through the benchmark registry (features 8,
    batches 4, iters 3; ``max_err`` below 1e-4) and the launches of one
    ``score_batch`` (two K5, two K6, four K4, no chain);
    ``HELinearFeatureWise`` at dim 16 (79 K6 a forward, exactly; within
    5e-4), its forward times and its rotation keys' memory;
    ``HELayerNormFeatureWise`` (F 4, two Newton steps; within 5e-3); two
    MPC parties (collective encrypt and threshold decrypt, a collective
    rotation; within 5e-4; one share alone garbage; card == CPU); a
    ``trace.profile`` of one rotation holding its ``annotate`` names and
    K6's kernels; the CLI's ``list-benchmarks`` and ``benchmark --name
    single_pmult``.  Each cell ends by clearing the port's default-engine
    registry, which otherwise keeps every engine alive.

Each kernel has two bounds (``tiberate_tpu_torch/ops/roofline.py``): the
time its bytes take at the H100's datasheet HBM rate (every input read
once, the output written once), and the time its REDCs, counted from its
source at the shape of the call, take at the REDC rate of its lane that
phase 2b measured on this card.  ``bound_ms`` is the larger; ``bound_by``
says which ("bytes" or "operations": the REDCs).  Before the JSON lines,
the kernels of each driven path are ranked by launches x (time - bound),
once with the launches of the whole path, once with the step's and once
with the evaluation path's (and the extension path's at logN15).  The
second-to-last line is a JSON object with one entry per kernel and lane,
the probe's three kernels included; the last line is the device record.
"""

import contextlib
import gc
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 8
SEED = 1234
DECRYPT_TOL = 1e-6       # fresh ciphertext; the JAX logN14/15 tests
DECRYPT_TOL_OP = 1e-5    # rotations, products: tests/test_full_presets.py:34
DECRYPT_TOL_17 = 1e-4    # cc_mult at logN17: tests/test_full_presets.py
DECRYPT_TOL_30 = 1e-2    # the 30-bit mode: tests/test_mode30.py
DECRYPT_TOL_30_OP = 5e-3  # 30-bit presets: tests/test_full_presets.py:95
DECODE_SUM_TOL = 1e-9    # batch vs single decode: tests/test_codec.py
HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "presets.json")

# kernel (its launch-count key) -> (source, the TPU kernel it replaces).
# K1-K4 and the K3 chain variant are entry points of _run_group (:1395),
# K5 of _run_tensor_group (:1194), K6 of _run_parts_group (:868); the _30
# lane replaces each runner's single-lane u32 variant (tables.lane ==
# "single": :1542, :1268, :1009).
_PALLAS = "tiberate_tpu/ops/pallas_mxu.py"
_SOURCES = {
    "ntt": ("ntt.cu", 1395, 1542), "intt": ("ntt.cu", 1395, 1542),
    "ntt_keymul": ("ntt.cu", 1395, 1542),
    "ntt_keymul_accum": ("ntt.cu", 1395, 1542),
    "intt_pdiv": ("ntt.cu", 1395, 1542),
    "ntt_tensor": ("tensor.cu", 1194, 1268),
    "ntt_keymul_parts": ("keyswitch.cu", 868, 1009),
}
KERNELS = {
    name + sfx: (f"tiberate_tpu_torch/csrc/{src}",
                 f"{_PALLAS}:{line30 if sfx else line}")
    for sfx in ("", "_30")
    for name, (src, line, line30) in _SOURCES.items()
}
# the fold-rate probe's kernels (no 30-bit Shoup lane)
PROBE = {
    name: ("tiberate_tpu_torch/csrc/fold_probe.cu",
           "benchmarks/profiling/vpu_microbench.py:49")
    for name in ("fold_shoup", "fold_redc", "fold_redc_30")
}
# the kernels each driven path launches (keygen, encrypt, step, decrypt),
# and those the fused step itself launches; the 30-bit paths launch the
# same kernels in their _30 lane
PATH_15 = ("ntt", "intt", "ntt_keymul", "intt_pdiv", "ntt_tensor",
           "ntt_keymul_parts")
STEP_15 = ("intt", "intt_pdiv", "ntt_tensor", "ntt_keymul_parts")
PATH_17 = ("ntt", "intt", "ntt_keymul", "ntt_keymul_accum", "intt_pdiv",
           "ntt_tensor")
STEP_17 = ("intt", "ntt_keymul_accum", "intt_pdiv", "ntt_tensor")
# the kernels the logN15 evaluation path launches (phase 5b): keys (K1, K2),
# pc_mult (K3 and its K1 cache), keyswitches (K6, K4), square (K5)
EVAL_15 = ("ntt", "intt", "ntt_keymul", "intt_pdiv", "ntt_tensor",
           "ntt_keymul_parts")
# the kernels the logN15 extension path launches (phase 12): rotation and
# MPC keys (K1, K2), pc_mult and decrypts (K3), keyswitches (K6, K4),
# cc_mult (K5)
EXT_15 = EVAL_15


def lane(names, sfx):
    return tuple(n + sfx for n in names)


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
    saved = {name: getattr(kern, name) for name in kern.WRAPPERS}
    try:
        for name in kern.WRAPPERS:
            setattr(kern, name, getattr(kern, name + "_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kern, name, fn)


def uniform(gen, q, shape):
    """Residues uniform in [0, q_c) per channel, drawn on the card, in the
    dtype of q (int64 or int32); q: [C] tensor on the card."""
    x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                      device=q.device)
    return (x % q.long()[:, None]).to(q.dtype)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_kernels(eng, kern, mod, roofline, tag, loops, redc_per_s):
    """Every kernel against its plain version at the step shapes of
    ``eng`` (batch 8, work level 1), in the lane of its storage dtype; the
    chain kernel with no skip range and with one part's range.  ``loops``
    = (reps, inner) of cuda_ms for the kernels; each plain version, which
    repeats the kernel's arithmetic in torch ops and is no yardstick of
    speed, is timed by its one comparison call (CUDA events).  Each result
    carries its two bounds: the
    bytes of every input (data, twiddles, keys, constants) read once and
    every output written once, at the datasheet HBM rate, and its REDCs at
    the lane's measured rate ``redc_per_s``."""
    dev = eng.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    N = eng.ckksCfg.N
    lp_ord, lp_sp = eng._lp(1, False), eng._lp(1, True)
    lp0 = eng._lp(0, False)
    C, C_sp, S = lp_ord.num_channels, lp_sp.num_channels, eng.params.S
    q_ord, q_sp, q0 = lp_ord.pack.q, lp_sp.pack.q, lp0.pack.q
    PiRs = eng.params.PiRs[1]
    parts = eng.params.parts[1]
    part = parts[min(1, len(parts) - 1)]
    skip = (part.lo, part.hi)
    skip_key = f"ntt_keymul_accum[skip {part.lo}:{part.hi}]"
    logN = N.bit_length() - 1
    ec, alphas = eng._parts_consts(1)
    n_parts, amax = ec.shape[0], ec.shape[-1]

    x = uniform(gen, q_ord, (BATCH, C, N))
    x4 = [uniform(gen, q_ord, (BATCH, C, N)) for _ in range(4)]
    x0 = uniform(gen, q0, (BATCH, C + 1, N))
    keys0 = (uniform(gen, q0, (C + 1, N)), uniform(gen, q0, (C + 1, N)))
    acc = uniform(gen, q_sp, (BATCH, C_sp, N))
    p0 = uniform(gen, q_sp[C:], (BATCH, S, N))
    ext = uniform(gen, q_sp, (BATCH, C_sp, N))
    keys_sp = (uniform(gen, q_sp, (C_sp, N)), uniform(gen, q_sp, (C_sp, N)))
    st = mod._parts_digits(uniform(gen, q_ord, (BATCH, C, N)), parts, lp_ord,
                           amax).contiguous()
    pkeys = tuple(torch.stack([uniform(gen, q_sp, (C_sp, N))
                               for _ in range(n_parts)]) for _ in range(2))

    def accum_case(skip):
        accs = [tuple(uniform(gen, 2 * q_sp, (BATCH, C_sp, N))
                      for _ in range(2))]
        accs.append(tuple(a.clone() for a in accs[0]))
        return (
            lambda: kern.ntt_keymul_accum(ext, lp_sp, keys_sp, accs[0], skip),
            lambda: kern.ntt_keymul_accum_plain(ext, lp_sp, keys_sp, accs[1],
                                                skip),
        )

    def accum_width(skip):
        # the channels outside the skip range: only they are read, written
        # and transformed
        return C_sp - (0 if skip is None else skip[1] - skip[0])

    def accum_bytes(skip):
        # x, twiddles, both keys, q, k; both accumulators read and written
        return accum_width(skip) / C_sp * (
            nbytes(ext, lp_sp.psi, *keys_sp, lp_sp.pack.q, lp_sp.pack.k)
            + 4 * nbytes(ext))

    cases = {
        "ntt": (lambda: kern.ntt(x, lp_ord, enter=True),
                lambda: kern.ntt_plain(x, lp_ord, enter=True)),
        "intt": (lambda: kern.intt(x, lp_ord, "exit_reduce"),
                 lambda: kern.intt_plain(x, lp_ord, "exit_reduce")),
        "ntt_keymul": (lambda: kern.ntt_keymul(x0, lp0, keys0, True),
                       lambda: kern.ntt_keymul_plain(x0, lp0, keys0, True)),
        "ntt_keymul_accum": accum_case(None),
        skip_key: accum_case(skip),
        "intt_pdiv": (lambda: kern.intt_pdiv(acc, p0, lp_ord, PiRs),
                      lambda: kern.intt_pdiv_plain(acc, p0, lp_ord, PiRs)),
        "ntt_tensor": (lambda: kern.ntt_tensor(*x4, lp_ord),
                       lambda: kern.ntt_tensor_plain(*x4, lp_ord)),
        "ntt_keymul_parts": (
            lambda: kern.ntt_keymul_parts(st, ec, alphas, pkeys, lp_sp),
            lambda: kern.ntt_keymul_parts_plain(st, ec, alphas, pkeys,
                                                lp_sp)),
    }
    consts = (lp_ord.pack.q, lp_ord.pack.k)
    # bytes each call must move: inputs read once, outputs written once
    io = {
        "ntt": nbytes(x, lp_ord.psi, lp_ord.Rs, *consts, x),
        "intt": nbytes(x, lp_ord.ipsi, lp_ord.Ninv, *consts, x),
        "ntt_keymul": nbytes(x0, lp0.psi, lp0.Rs, *keys0, lp0.pack.q,
                             lp0.pack.k, x0, x0),
        "ntt_keymul_accum": accum_bytes(None),
        skip_key: accum_bytes(skip),
        "intt_pdiv": nbytes(acc[..., :C, :], p0, lp_ord.ipsi, lp_ord.Ninv,
                            lp_ord.pdc, *consts, acc[..., :C, :]),
        "ntt_tensor": nbytes(*x4, lp_ord.psi, lp_ord.Rs, *consts,
                             *x4[:3]),
        "ntt_keymul_parts": nbytes(st, ec, alphas, *pkeys, lp_sp.psi,
                                   lp_sp.pack.q, lp_sp.pack.k, ext, ext),
    }
    # REDCs each call's kernel performs (ops/roofline.py)
    redc = {
        "ntt": roofline.ntt(BATCH * C, logN, True),
        "intt": roofline.intt(BATCH * C, logN, "exit_reduce"),
        "ntt_keymul": roofline.ntt_keymul(BATCH * (C + 1), logN, 2, True),
        "ntt_keymul_accum": roofline.ntt_keymul_accum(
            BATCH * accum_width(None), logN),
        skip_key: roofline.ntt_keymul_accum(BATCH * accum_width(skip),
                                            logN),
        "intt_pdiv": roofline.intt_pdiv(BATCH * C, logN, S),
        "ntt_tensor": roofline.ntt_tensor(BATCH * C, logN),
        "ntt_keymul_parts": roofline.ntt_keymul_parts(
            BATCH, alphas.tolist(), C_sp, logN),
    }
    shapes = {"ntt": [BATCH, C, N], "intt": [BATCH, C, N],
              "ntt_keymul": [BATCH, C + 1, N], "intt_pdiv": [BATCH, C_sp, N],
              "ntt_tensor": [BATCH, C, N],
              "ntt_keymul_parts": [BATCH, n_parts, amax, N]}
    results = {}
    for name, (kfn, pfn) in cases.items():
        got = kfn()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        want = pfn()
        stop.record()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms = cuda_ms(kfn, *loops)
        plain_ms = start.elapsed_time(stop)
        shape = shapes.get(name, [BATCH, C_sp, N])
        b = roofline.bound(io[name], redc[name], redc_per_s)
        log(f"{tag} kernel {name}: input {shape} {str(x.dtype)[6:]} "
            f"byte-identical={same} max_abs_err={err} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; HBM bound {b['bytes_bound_ms']:.4f} "
            f"ms ({io[name] / 1e6:.1f} MB), REDC bound "
            f"{b['compute_bound_ms']:.4f} ms ({redc[name] / 1e6:.1f} M "
            f"REDC): bound by {b['bound_by']}, "
            f"{100 * b['bound_ms'] / ms:.1f}% of the bound")
        if not same:
            raise AssertionError(f"{tag} {name} disagrees with its plain "
                                 f"version")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, bytes=io[name], **b)
    # the entries' other variants at the same shapes, compared only
    variants = {
        "ntt (no entry)": (lambda: kern.ntt(x, lp_ord, enter=False),
                           lambda: kern.ntt_plain(x, lp_ord, enter=False)),
        **{f"intt ({e})": (lambda e=e: kern.intt(x, lp_ord, e),
                           lambda e=e: kern.intt_plain(x, lp_ord, e))
           for e in ("mont", "exit")},
        "ntt_keymul (1 key)": (
            lambda: kern.ntt_keymul(x0, lp0, keys0[:1], True),
            lambda: kern.ntt_keymul_plain(x0, lp0, keys0[:1], True)),
    }
    for name, (kfn, pfn) in variants.items():
        if not all(torch.equal(g, w) for g, w in zip(*(
                r if isinstance(r, tuple) else (r,) for r in (kfn(), pfn())))):
            raise AssertionError(f"{tag} {name} disagrees with its plain "
                                 f"version")
    log(f"{tag} also byte-identical at these shapes: {', '.join(variants)}")
    results["ntt_keymul_accum"]["with_skip"] = results.pop(skip_key)
    return results


def signed_key_rows(kern, mod, tp):
    """K1 without entry on what a rotation or a conjugation key transforms
    (``CkksEngine._galois_secret_key``): a secret key's ordinary rows out
    of the NTT domain keeping R, permuted and sign-flipped, so that words
    are negative.  {case: (kernel output, plain output)}."""
    from tiberate_tpu_torch.utils import encoding as codec

    N, P = tp.N, tp.P
    lp = tp.lp(0, False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2 * N)
    ternary = torch.randint(-1, 2, (N,), generator=gen, device="cuda")
    sk = mod._keygen_sk_core(ternary, tp.lp(0, True))
    sk_ord = mod._intt_exit_to_mont(sk[:P].contiguous(), lp)
    cases = {}
    for name, leap in (("rotation", codec.rotate_leap(1, N)),
                       ("conjugation", codec.conjugate_leap(N))):
        src, sign = codec.rotation_perm_tables(N, leap)
        x = mod._perm_core(
            sk_ord, torch.from_numpy(src.astype(np.int64)).cuda(),
            torch.from_numpy(sign).to("cuda", tp.dtype)).contiguous()
        if not bool((x < 0).any()):
            raise AssertionError(f"the {name} key rows hold no negative "
                                 f"word")
        cases[f"ntt on signed {name}-key rows"] = (
            kern.ntt(x, lp, False), kern.ntt_plain(x, lp, False))
    return cases


def check_small(kern, mod, CkksParams, toy_config):
    """Phase 2c: every entry of the two ntt.cu transforms, K5 (tensor.cu)
    and K6 (keyswitch.cu) at logN 4, 7 and 10 (odd and even logN: both
    splits L1 = L2 and L1 + 1 = L2), in both lanes, on a toy parameter set
    at batch 2, against its plain version byte for byte; K1 without entry
    also on the signed rows of a rotated and of a conjugated secret key.
    Returns the number of cases."""
    n = 0
    for logN in (4, 7, 10):
        for lane, opts in ((62, dict(scale_bits=30)),
                           (30, dict(scale_bits=21, buffer_bit_length=30))):
            tp = CkksParams(toy_config(logN=logN, num_scales=4,
                                       num_special_primes=2, **opts), "cuda")
            lp, lp_sp = tp.lp(1, False), tp.lp(1, True)
            gen = torch.Generator(device="cuda").manual_seed(SEED + logN)
            C, C_sp, N = lp.num_channels, lp_sp.num_channels, 1 << logN
            q, q_sp = lp.pack.q, lp_sp.pack.q
            x = uniform(gen, q, (2, C, N))
            x4 = [uniform(gen, q, (2, C, N)) for _ in range(4)]
            keys = (uniform(gen, q, (C, N)), uniform(gen, q, (C, N)))
            acc = uniform(gen, q_sp, (2, C_sp, N))
            p0 = uniform(gen, q_sp[C:], (2, tp.S, N))
            ext = uniform(gen, q_sp, (2, C_sp, N))
            keys_sp = (uniform(gen, q_sp, (C_sp, N)),
                       uniform(gen, q_sp, (C_sp, N)))
            part = tp.parts[1][-1]
            ec, alphas = mod._parts_consts(tp, 1)
            st = mod._parts_digits(x, tp.parts[1], lp,
                                   ec.shape[-1]).contiguous()
            pkeys = tuple(torch.stack([uniform(gen, q_sp, (C_sp, N))
                                       for _ in range(ec.shape[0])])
                          for _ in range(2))

            def accum(skip):
                a = tuple(uniform(gen, 2 * q_sp, (2, C_sp, N))
                          for _ in range(2))
                b = tuple(t.clone() for t in a)
                return (kern.ntt_keymul_accum(ext, lp_sp, keys_sp, a, skip),
                        kern.ntt_keymul_accum_plain(ext, lp_sp, keys_sp, b,
                                                    skip))

            cases = {
                **signed_key_rows(kern, mod, tp),
                "ntt enter": (kern.ntt(x, lp, True),
                              kern.ntt_plain(x, lp, True)),
                "ntt": (kern.ntt(x, lp, False), kern.ntt_plain(x, lp, False)),
                **{f"intt {e}": (kern.intt(x, lp, e),
                                 kern.intt_plain(x, lp, e))
                   for e in ("mont", "exit", "exit_reduce")},
                "ntt_keymul 1 key": (
                    kern.ntt_keymul(x, lp, keys[:1], True),
                    kern.ntt_keymul_plain(x, lp, keys[:1], True)),
                "ntt_keymul 2 keys": (
                    kern.ntt_keymul(x, lp, keys, False),
                    kern.ntt_keymul_plain(x, lp, keys, False)),
                "ntt_keymul_accum": accum(None),
                f"ntt_keymul_accum skip {part.lo}:{part.hi}": accum(
                    (part.lo, part.hi)),
                "intt_pdiv": (kern.intt_pdiv(acc, p0, lp, tp.PiRs[1]),
                              kern.intt_pdiv_plain(acc, p0, lp, tp.PiRs[1])),
                "ntt_tensor": (kern.ntt_tensor(*x4, lp),
                               kern.ntt_tensor_plain(*x4, lp)),
                "ntt_keymul_parts": (
                    kern.ntt_keymul_parts(st, ec, alphas, pkeys, lp_sp),
                    kern.ntt_keymul_parts_plain(st, ec, alphas, pkeys,
                                                lp_sp)),
            }
            torch.cuda.synchronize()
            for name, (got, want) in cases.items():
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"logN{logN} {lane}-bit {name} "
                                         f"disagrees with its plain version")
                n += 1
    return n


# contiguous-pass kernel -> the butterflies one thread runs in the code its
# SASS holds, per stage (4 at R = 8): the inverse pass one line; the K6
# pass its part loop's body once (one part); the K5 pass its four lines
CONTIG_SASS = {"inv_contig_k": 4, "parts_contig_k": 4, "tensor_contig_k": 16}


def contig_sass(cuda_build):
    """{(kernel, lane, logN): (IMAD-class, all, butterflies)} for the
    contiguous passes of CONTIG_SASS at logN 15 and 17: their SASS
    instructions (loads, twiddle table, every butterfly, the exchanges,
    products and stores; NOP left out) and the butterflies one thread runs
    in that code.  None without ``cuobjdump``."""
    sass = cuda_build.sass(*(f"{k}I{w}Li{n}E" for k in CONTIG_SASS
                             for w in "xi" for n in (15, 17)))
    if sass is None:
        return None
    out = {}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*?(" + "|".join(CONTIG_SASS)
                     + r")I([xi])Li(1[57])E", block)
        if not m:
            continue
        ops = [op for op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
            block) if op != "NOP"]
        logN = int(m.group(3))
        out[(m.group(1), 62 if m.group(2) == "x" else 30, logN)] = (
            sum(op.startswith(("IMAD", "IMUL")) for op in ops), len(ops),
            CONTIG_SASS[m.group(1)] * (logN - logN // 2))
    return out


def probe_phase(fm, fp, roofline):
    """Phase 2b.  Each probe kernel against its plain version on the
    [64, 256, 512] block at K = 32, byte for byte; then the probe's entry
    point (``fm.measure``) with the launch counts set to 0 before and read
    after.  Returns (results by kernel, the counts of that run)."""
    results = {}
    for mode, (fn, plain, _) in fm.MODES.items():
        x, q, w = fm.make_input(mode, "cuda", SEED)
        got, want = fn(x, w, q, fm.K_SHORT), plain(x, w, q, fm.K_SHORT)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = float((got - want).abs().max())
        plain_ms = cuda_ms(lambda: plain(x, w, q, fm.K_SHORT), 3, 1)
        log(f"probe {mode}: block {list(x.shape)} {str(x.dtype)[6:]}, "
            f"q={q}, K={fm.K_SHORT}: byte-identical={same} "
            f"max_abs_err={err}, plain {plain_ms:.4f} ms")
        if not same:
            raise AssertionError(f"probe {mode} disagrees with its plain "
                                 f"version")
        results[mode] = dict(max_abs_err=err, plain_ms=plain_ms,
                             bytes=nbytes(x, got), folds=x.numel() * fm.K_SHORT)
    fp.reset_launch_counts()
    rates = fm.measure("cuda", SEED)
    torch.cuda.synchronize()
    counts = dict(fp.LAUNCHES)
    clocks = fm.card()
    sass = fm.sass_step_counts() or {}
    for mode, r in rates.items():
        res = results[mode]
        b = roofline.bound(res.pop("bytes"), res.pop("folds"),
                           r["fold_per_s"])
        step = sass.get(mode)
        res.update(ms=r["ms"][fm.K_SHORT], chain=fm.K_SHORT,
                   ms_by_chain=r["ms"], ns_per_fold=r["ns_per_fold"],
                   fold_per_s=r["fold_per_s"], library_ms=None,
                   sass_step=step, **b)
        log(f"probe {mode}: K={fm.K_SHORT} {r['ms'][fm.K_SHORT]:.4f} ms, "
            f"K={fm.K_LONG} {r['ms'][fm.K_LONG]:.4f} ms per call: "
            f"{r['ns_per_fold']:.6f} ns per fold, "
            f"{r['fold_per_s'] / 1e9:.1f} G-fold/s; one chain step "
            + ("not measured" if step is None else
               f"{step[0]} IMAD-class of {step[1]} SASS instructions")
            + f" ({clocks}: name, power limit, SM clock, max SM clock)")
    return results, counts


def rank(results, launches, sfx, tag):
    """The kernels by launches x (time - bound), largest first; the chain
    kernel with one part's range skipped, as the step runs it."""
    rows = []
    for name, res in results.items():
        n = launches[name + sfx]
        if n:
            res = res.get("with_skip", res)
            # a kernel faster than its bound loses nothing (the bound's
            # dependent-chain rate understates independent butterflies)
            rows.append((n * max(0.0, res["ms"] - res["bound_ms"]),
                         name + sfx, n, res))
    rows.sort(key=lambda r: -r[0])
    log(f"{tag} kernels by launches x (time - bound), a negative gap read "
        f"as 0: " + "; ".join(
            f"{name} {n} x ({r['ms']:.4f} - {r['bound_ms']:.4f}) = "
            f"{loss:.4f} ms" + (" (above its bound)"
                                if r["ms"] < r["bound_ms"] else "")
            for loss, name, n, r in rows))


def count_launches(kern, fn):
    """Run ``fn`` with every launch count set to 0; returns (result, the
    counts it made)."""
    kern.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kern.LAUNCHES)


def require(counts, names, what):
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing}")


def only_30(counts, what):
    """A 30-bit path launches no 62-bit kernel."""
    wrong = [k for k, n in counts.items() if n and not k.endswith("_30")]
    if wrong:
        raise AssertionError(f"62-bit kernels launched on {what}: {wrong}")


def msgs(eng):
    """The main path's two batches of BATCH random messages (m1, m2) of
    ``eng``'s slot count."""
    rng = np.random.default_rng(SEED)
    return tuple(rng.uniform(-1, 1, (BATCH, eng.num_slots))
                 for _ in range(2))


def drive(eng, kern, stack, unstack, tol, tag):
    """keygen, encodecrypt_batch of 8 messages twice, cc_mult on the batch,
    decryptcode_batch, with the launch counts set to 0 before and read
    after; the step's own counts separately.  Then the single forms from
    the same CSPRNG state (:func:`single_forms`).  Returns (A, B, out,
    launches, step counts, err, info)."""
    m1, m2 = msgs(eng)

    kern.reset_launch_counts()
    t0 = time.perf_counter()
    eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
    torch.cuda.synchronize()
    t_keygen = time.perf_counter() - t0
    keygen_counts = dict(kern.LAUNCHES)
    states = eng.rng.states.clone()
    t0 = time.perf_counter()
    A = stack(eng.encodecrypt_batch(m1))
    B = stack(eng.encodecrypt_batch(m2))
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    before = dict(kern.LAUNCHES)
    t0 = time.perf_counter()
    out = eng.cc_mult(A, B)
    torch.cuda.synchronize()
    t_first_step = time.perf_counter() - t0
    step_counts = {k: kern.LAUNCHES[k] - before[k] for k in kern.LAUNCHES}
    t0 = time.perf_counter()
    decoded = eng.decryptcode_batch(unstack(out), is_real=True)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    log(f"{tag} main path launches {launches}; during the step "
        f"{step_counts}")
    log(f"{tag} keygen {t_keygen:.3f} s, encodecrypt_batch of {BATCH} "
        f"twice {t_enc:.3f} s, first step {t_first_step:.3f} s, "
        f"decryptcode_batch of {BATCH} {t_dec:.3f} s")
    for d in out.data:
        if tuple(d.shape) != (BATCH, eng._lp(1).num_channels, eng.ckksCfg.N):
            raise AssertionError(f"{tag} step output shape {tuple(d.shape)}")
    if not np.all(np.isfinite(decoded)):
        raise AssertionError(f"{tag} non-finite decrypt")
    err = float(np.abs(decoded - m1 * m2).max())
    log(f"{tag} cc_mult decrypt max error vs m1*m2 over {BATCH} pairs: "
        f"{err:.3e} (limit {tol})")
    if not err < tol:
        raise AssertionError(f"{tag} decrypt error above the limit")
    single = single_forms(eng, kern, unstack, (m1, m2), states, (A, B), out,
                          decoded, tag)
    parts = decrypt_parts(eng, unstack(out), tag)
    single_path = {k: keygen_counts[k] + step_counts[k] + single["counts"][k]
                   for k in kern.LAUNCHES}
    log(f"{tag} main-path launches by kernel, with the single forms "
        f"({2 * BATCH} encodecrypt, {BATCH} decryptcode) -> with the batch "
        f"forms: " + ", ".join(f"{k} {single_path[k]} -> {launches[k]}"
                               for k in launches if single_path[k]))
    info = dict(keygen_s=t_keygen, encodecrypt_batch_s=t_enc,
                decryptcode_batch_s=t_dec,
                encodecrypt_single_s=single["encodecrypt_s"],
                decryptcode_single_s=single["decryptcode_s"],
                encodecrypt_batch_warm_s=single["encodecrypt_batch_warm_s"],
                decryptcode_batch_warm_s=single["decryptcode_batch_warm_s"],
                launches_single_forms=single_path, decrypt_parts_s=parts)
    return A, B, out, launches, step_counts, err, info


def single_forms(eng, kern, unstack, msgs, states, batches, out, decoded,
                 tag):
    """From the CSPRNG ``states`` the batch draws started from, the same
    messages through single ``encodecrypt`` calls (which must give the
    batch ciphertexts byte for byte) and the step's output through single
    ``decryptcode`` calls (within DECODE_SUM_TOL of the batch decode);
    then the batch forms once more from the same state, warm as the
    single forms are (the main path's first calls also build the codec's
    cached tables).  The engine's CSPRNG state is restored after.
    Returns the single forms' launch counts and the host times."""
    saved, eng.rng.states = eng.rng.states, states.clone()
    try:
        kern.reset_launch_counts()
        t0 = time.perf_counter()
        cts = [[eng.encodecrypt(m) for m in ms] for ms in msgs]
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = np.stack([eng.decryptcode(ct, is_real=True)
                        for ct in unstack(out)])
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        counts = dict(kern.LAUNCHES)
        eng.rng.states = states.clone()
        t0 = time.perf_counter()
        again = [eng.encodecrypt_batch(ms) for ms in msgs]
        torch.cuda.synchronize()
        t_enc_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.decryptcode_batch(unstack(out), is_real=True)
        torch.cuda.synchronize()
        t_dec_b = time.perf_counter() - t0
    finally:
        eng.rng.states = saved
    same = all(torch.equal(c.data[i], X.data[i][b])
               for X, row in zip(batches, cts)
               for b, c in enumerate(row) for i in (0, 1)) and all(
        torch.equal(c.data[i], X.data[i][b])
        for X, row in zip(batches, again)
        for b, c in enumerate(row) for i in (0, 1))
    gap = float(np.abs(dec - decoded).max())
    log(f"{tag} single forms from the same CSPRNG state: {2 * BATCH} "
        f"encodecrypt {t_enc:.3f} s, byte-identical to the batch "
        f"ciphertexts: {same}; {BATCH} decryptcode {t_dec:.3f} s, max "
        f"|single - batch decode| {gap:.3e} (limit {DECODE_SUM_TOL}); "
        f"the batch forms again, warm: encodecrypt_batch of {BATCH} twice "
        f"{t_enc_b:.3f} s, decryptcode_batch of {BATCH} {t_dec_b:.3f} s")
    if not same:
        raise AssertionError(f"{tag} batch ciphertexts differ from the "
                             f"single encodecrypt's")
    if not gap <= DECODE_SUM_TOL:
        raise AssertionError(f"{tag} batch decode differs from the single "
                             f"decryptcode's")
    return dict(counts=counts, encodecrypt_s=t_enc, decryptcode_s=t_dec,
                encodecrypt_batch_warm_s=t_enc_b,
                decryptcode_batch_warm_s=t_dec_b)


def decrypt_parts(eng, cts, tag, reps=3):
    """``decryptcode_batch`` of ``cts`` and as many single ``decryptcode``
    calls, part by part (host clock, synchronised around each part; the
    median of ``reps`` runs): the decrypt core (the batch stacks its
    inputs first), the bias guard's DC fetch and CRT, the DC zeroing and
    final scale, the fetch of the scaled coefficients, and the host
    decode; the batch decode also in its earlier form, a scatter into the
    columns of [B, N] (the same values).  Returns {form: {part: s}}."""
    from tiberate_tpu_torch.engine import ckks_engine as mod
    from tiberate_tpu_torch.utils import encoding as codec

    if not eng.bias_guard:
        raise AssertionError("decrypt_parts times the bias-guard path")
    level = cts[0].level
    lp, base_lp, fs, rh, base_at = eng._decrypt_args(level)
    C = base_at + 1
    sk = eng.sk.data[level : level + C]
    scale, corr = eng.ckksCfg.scale, eng.params.corrections[level]
    slots = eng.num_slots
    _, post_perm = codec.prepost_perms(eng.ckksCfg.N)

    def single_decode(x):
        return np.stack([codec.decode(r, scale=scale, correction=corr,
                                      return_without_scaling=True)[:slots]
                         / scale * corr for r in x])

    def scatter_decode(x):
        mm = codec._ifft(x * codec._skewer(x.shape[-1]), "forward")
        mm = mm / scale * corr
        out = np.zeros_like(mm)
        out[:, post_perm] = mm
        return out[:, :slots]

    def one_run(groups, decode):
        spent = {}

        def lap(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return res

        for g in groups:
            def core():
                if len(g) == 1:
                    x0, x1 = g[0].data[0][:C], g[0].data[1][:C]
                else:
                    x0 = torch.stack([c.data[0][:C] for c in g])
                    x1 = torch.stack([c.data[1][:C] for c in g])
                return mod._decrypt_double_core(x0, x1, sk, lp, base_lp, fs,
                                                rh, base_at,
                                                final_round=False)[1]

            def final():
                z = pt.clone()
                z[..., base_at, 0] = 0
                z[..., 0, 0] = 0
                return mod._final_scale(z, base_lp, fs, rh, base_at,
                                        final_round=True)

            pt = lap("core", core)
            lap("dc_crt", lambda: eng._dc_crt(pt[..., [base_at, 0, 1], 0],
                                              level, base_at))
            scaled = lap("final_scale", final)
            host = lap("fetch", lambda: np.asarray(scaled.cpu()).reshape(
                len(g), -1))
            lap("decode", lambda: decode(host))
        return spent

    forms = {
        "batch": ([cts], lambda x: codec.decode_batch(
            x, scale=scale, correction=corr)[:, :slots]),
        "batch_scatter_decode": ([cts], scatter_decode),
        "single": ([[c] for c in cts], single_decode),
    }
    res = {}
    for form, (groups, decode) in forms.items():
        runs = [one_run(groups, decode) for _ in range(reps)]
        res[form] = {k: statistics.median(r[k] for r in runs)
                     for k in runs[0]}
        res[form]["total"] = sum(res[form].values())
    log(f"{tag} decrypt of {len(cts)} by part (s, host clock, median of "
        f"{reps}): " + "; ".join(
            f"{form} " + ", ".join(f"{k} {v:.4f}" for k, v in r.items())
            for form, r in res.items()))
    return res


def check_against_cpu(eng, CkksEngine, preset, A, B, out, tag):
    """An engine of the same preset and seed on the CPU makes its own keys:
    sk, pk and every evk part must equal the card's byte for byte.  Then
    the step and rescale on pair 0 against CPU tensors (the plain
    versions).  Returns the CPU engine."""
    eng_cpu = CkksEngine(preset, device="cpu", seed=SEED)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    eng_cpu.sk, eng_cpu.pk, eng_cpu.evk  # noqa: B018 — keygen
    t_keygen = time.perf_counter() - t0
    pairs = [(eng_cpu.sk.data, eng.sk.data)] + [
        (c, g) for X in ("pk", "evk")
        for c, g in zip(leaves(getattr(eng_cpu, X)), leaves(getattr(eng, X)))]
    same = all(torch.equal(c, g.cpu()) for c, g in pairs)
    log(f"{tag} keygen on the CPU ({t_keygen:.1f} s) == keygen on the card "
        f"byte for byte (sk, pk, {len(eng.evk.data)} evk parts): {same}")
    if not same:
        raise AssertionError(f"{tag} the card's keys differ from the CPU's")
    t0 = time.perf_counter()
    pair = [type(A)(data=tuple(d[0].to(cpu) for d in X.data), level=0)
            for X in (A, B)]
    out_cpu = eng_cpu.cc_mult(*pair)
    t_cpu = time.perf_counter() - t0
    same = all(torch.equal(c, g[0].cpu())
               for c, g in zip(out_cpu.data, out.data))
    log(f"{tag} step on pair 0: GPU == CPU plain path byte for byte: "
        f"{same} (CPU step {t_cpu:.2f} s)")
    if not same:
        raise AssertionError(f"{tag} GPU step differs from the CPU step")

    r_gpu, r_cpu = eng.rescale(A), eng_cpu.rescale(pair[0])
    same = r_gpu.level == r_cpu.level == 1 and all(
        torch.equal(c, g[0].cpu()) for c, g in zip(r_cpu.data, r_gpu.data))
    log(f"{tag} rescale of pair 0: GPU == CPU byte for byte: {same}")
    if not same:
        raise AssertionError(f"{tag} GPU rescale differs from the CPU "
                             f"rescale")
    return eng_cpu


def leaves(key):
    """The tensors of a key: (pk0, pk1), or every part's (k0, k1)."""
    return [t for d in key.data
            for t in (d if isinstance(d, tuple) else (d,))]


def csprng_phase(Csprng, CkksConfig, presets, smi):
    """Phase 2d.  A generator on the card and one on the CPU with the
    channel model of each preset's engine and one (seed, nonce); each draw
    three times in a row on both, byte for byte, then the states; ms per
    draw on the card (CUDA events: median of 3 loops of 3 draws) beside
    the bytes bound of the block function (the rows' states read once,
    their stepped states and the samples written once).  Returns
    {preset: {draw: result}}."""
    results = {}
    for preset in presets:
        cfg = CkksConfig.parse(preset)
        S = cfg.num_special_primes
        tag = f"logN{cfg.logN}"
        kw = dict(num_coefs=cfg.N, num_channels=[len(cfg.q) - S],
                  num_repeating_channels=max(S, 2), sigma=cfg.sigma,
                  seed=SEED, nonce=7)
        gpu, cpu = Csprng(**kw, device="cuda"), Csprng(**kw, device="cpu")
        coefs = np.random.default_rng(SEED).uniform(-2.0**40, 2.0**40,
                                                    (BATCH, cfg.N))
        L16 = cfg.N // 16
        # draw -> (call, state rows it runs the block function on)
        draws = {
            f"randint over the q chain ({len(cfg.q)} channels)": (
                lambda r: (r.randint(amax=cfg.q, repeats=S),),
                len(cfg.q) * gpu.L),
            "discrete_gaussian(repeats=2)": (
                lambda r: (r.discrete_gaussian(repeats=2),), 2 * gpu.L),
            f"randround_batch({BATCH})": (
                lambda r: (r.randround_batch(coefs),), BATCH * L16),
            f"encrypt_noise_batch({BATCH})": (
                lambda r: r.encrypt_noise_batch(BATCH), 3 * BATCH * gpu.L),
        }
        out_bytes = {}
        for name, (fn, _) in draws.items():
            t0 = time.perf_counter()
            for _ in range(3):
                got, want = fn(gpu), fn(cpu)
                torch.cuda.synchronize()
                if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                    raise AssertionError(f"{tag} CSPRNG {name} on the card "
                                         f"differs from the CPU's")
            out_bytes[name] = nbytes(*got)
            log(f"{tag} CSPRNG {name}: card == CPU over 3 successive calls "
                f"({time.perf_counter() - t0:.1f} s with the CPU's)")
        if not torch.equal(gpu.states.cpu(), cpu.states):
            raise AssertionError(f"{tag} CSPRNG states differ after the "
                                 f"draws")
        res = {}
        for name, (fn, rows) in draws.items():
            ms = cuda_ms(lambda fn=fn: fn(gpu))
            nbytes_ = rows * 16 * 8 + rows * 2 * 8 + out_bytes[name]
            bound_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
            res[name] = dict(ms=ms, rows=rows, bytes=nbytes_,
                             bytes_bound_ms=bound_ms)
            log(f"{tag} CSPRNG {name}: {ms:.4f} ms per draw on the card, "
                f"{rows} block rows, bytes bound {bound_ms:.4f} ms ({smi})")
        results[tag] = res
    return results


def digest_phase(CkksEngine):
    """Phase 2e.  The JAX package's pinned logN14 ciphertext digest from
    the port's keygen, CSPRNG, codec and encrypt on the card."""
    with open(GOLDEN) as f:
        want = json.load(f)["logN14"]["ct_sha256_seed1234_nonce1"]
    eng = CkksEngine("logN14", device="cuda", seed=1234, nonce=1)
    m = np.linspace(-1, 1, eng.num_slots)
    ct = eng.encodecrypt(m)
    h = hashlib.sha256()
    for d in ct.data:
        h.update(np.ascontiguousarray(d.cpu().numpy()).tobytes())
    err = float(np.abs(eng.decryptcode(ct, is_real=True) - m).max())
    log(f"logN14 seed 1234 nonce 1: ciphertext sha256 {h.hexdigest()} == "
        f"the pinned digest: {h.hexdigest() == want}; decrypt max error "
        f"{err:.3e} (limit {DECRYPT_TOL})")
    if h.hexdigest() != want:
        raise AssertionError("the logN14 ciphertext digest differs from "
                             "tests/golden/presets.json")
    if not err < DECRYPT_TOL:
        raise AssertionError("logN14 decrypt error above the limit")
    return err


def compressed_keys(eng, typing, mont):
    """A seed-expanded evk (``a_seed``): ``compress_ksk`` drops the a
    halves, ``expand_ksk`` gives back the key's bytes."""
    sk = eng.sk
    sk2 = typing.SecretKey(
        data=mont.mont_mult(sk.data, sk.data, eng._lp(0, True).pack),
        flags=sk._flags, level=0)
    evk = typing.EvaluationKey.wrap(
        eng.create_key_switching_key(sk2, sk, a_seed=SEED))
    t0 = time.perf_counter()
    ck = eng.compress_ksk(evk)
    back = eng.expand_ksk(ck)
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(leaves(evk), leaves(back)))
    log(f"logN15 a_seed evk: {nbytes(*leaves(evk)) / 2**20:.1f} MiB, "
        f"compressed {nbytes(*leaves(ck)) / 2**20:.1f} MiB; compress + "
        f"expand {t_round:.3f} s, byte-identical to the key: {same}")
    if not same:
        raise AssertionError("expand_ksk(compress_ksk(evk)) differs from "
                             "the evk")


def draw_share(eng, msgs, tag):
    """The CSPRNG's share of keygen and of one ``encodecrypt_batch``: both
    run again with every draw method timed (host clock, synchronised
    before and after each draw).  Replaces the engine's keys."""
    rng = eng.rng
    names = ("randint", "discrete_gaussian", "randround", "randround_batch",
             "encrypt_noise_batch")
    spent = [0.0]

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out
        return run

    def keygen():
        eng.sk = eng._create_secret_key()
        eng.pk, eng.evk  # noqa: B018

    res = {}
    try:
        for name in names:
            setattr(rng, name, timed(getattr(rng, name)))
        for what, fn in (("keygen", keygen),
                         (f"encodecrypt_batch of {BATCH}",
                          lambda: eng.encodecrypt_batch(msgs))):
            spent[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            res[what] = dict(total_s=total, csprng_s=spent[0],
                             share=spent[0] / total)
            log(f"{tag} {what}: {total:.4f} s, of which CSPRNG draws "
                f"{spent[0]:.4f} s ({100 * spent[0] / total:.1f}%)")
    finally:
        for name in names:
            delattr(rng, name)
    return res


def time_step(eng, kern, A, B, tag, smi, loops, plain_reps):
    """The step with the kernels and with the plain versions (byte-
    identical); returns (step_ms, plain_step_ms)."""
    step_ms = cuda_ms(lambda: eng.cc_mult(A, B), *loops)
    with plain_wrappers(kern):
        plain_out = eng.cc_mult(A, B)
        plain_step_ms = cuda_ms(lambda: eng.cc_mult(A, B), reps=plain_reps,
                                inner=1)
    same = all(torch.equal(p, k)
               for p, k in zip(plain_out.data, eng.cc_mult(A, B).data))
    log(f"{tag} fused cc_mult step, batch {BATCH}: {step_ms:.3f} ms/step, "
        f"{step_ms / BATCH:.3f} ms/ct; with the plain versions on the card "
        f"{plain_step_ms:.3f} ms/step, {plain_step_ms / BATCH:.3f} ms/ct, "
        f"byte-identical={same} ({smi})")
    if not same:
        raise AssertionError(f"{tag} plain-version step differs on the card")
    return step_ms, plain_step_ms


def route_ab(eng, kern, sharded, A, B, tag, loops):
    """The same step through the per-part chain and through the all-parts
    kernel: byte-identical outputs, each route's time, launches and peak
    device memory."""
    sfx = kern.LANES[eng.params.dtype]
    step = eng._fused_mult_step(A.level)
    ksk = sharded.prepare_step_ksk(eng, A.level)
    prm = sharded.mult_step_params(eng, A.level)
    routes = {
        "chain": dict(prm, parts_fused=None),
        "parts_kernel": dict(
            prm, parts_fused=eng._ksk_parts_stacked(eng.evk, A.level + 1)),
    }
    outs, res = {}, {}
    for name, p in routes.items():
        def run(p=p):
            return step(A.data[0], A.data[1], B.data[0], B.data[1], ksk, p)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name], counts = count_launches(kern, run)
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_ms(run, *loops)
        res[name] = dict(ms=ms, peak_bytes=peak, resident_bytes=base,
                         accum=counts["ntt_keymul_accum" + sfx],
                         parts=counts["ntt_keymul_parts" + sfx])
        log(f"{tag} route {name}: {ms:.3f} ms/step, peak device memory "
            f"{peak / 2**30:.3f} GiB (resident before the step "
            f"{base / 2**30:.3f} GiB), ntt_keymul_accum{sfx} x"
            f"{res[name]['accum']}, ntt_keymul_parts{sfx} x"
            f"{res[name]['parts']}")
    n_parts = len(eng.params.parts[A.level + 1])
    if (res["chain"]["accum"], res["chain"]["parts"]) != (n_parts, 0) or (
            res["parts_kernel"]["accum"], res["parts_kernel"]["parts"]) != (
            0, 1):
        raise AssertionError(f"{tag} route A/B took the wrong kernels")
    same = all(torch.equal(c, k)
               for c, k in zip(outs["chain"], outs["parts_kernel"]))
    log(f"{tag} route A/B: chain == all-parts kernel byte for byte: {same}")
    if not same:
        raise AssertionError(f"{tag} the two keyswitch routes differ")
    return res


def switch_key_17(eng, kern, stack, unstack):
    """A batch of ciphertexts under a second secret key, switched to the
    engine's key; launches counted from 0.  Returns (err, counts)."""
    rng = np.random.default_rng(SEED + 1)
    m = rng.uniform(-1, 1, (2, eng.num_slots))
    sk2 = eng._create_secret_key()
    pk2 = eng._create_public_key(sk2)
    ct = stack([eng.encodecrypt(mi, pk=pk2) for mi in m])
    ksk = eng.create_key_switching_key(sk2, eng.sk)
    t0 = time.perf_counter()
    out, counts = count_launches(kern, lambda: eng.switch_key(ct, ksk))
    t_sw = time.perf_counter() - t0
    dec = np.stack([eng.decryptcode(c, is_real=True) for c in unstack(out)])
    err = float(np.abs(dec - m).max())
    n_parts = len(eng.params.parts[0])
    log(f"logN17 switch_key of 2 ciphertexts: {t_sw:.3f} s (first call), "
        f"launches {counts}; decrypt max error under the engine's key "
        f"{err:.3e} (limit {DECRYPT_TOL})")
    if counts["ntt_keymul"] != 1 or counts["ntt_keymul_accum"] != (
            n_parts - 1) or counts["ntt_keymul_parts"] != 0:
        raise AssertionError("switch_key did not run the per-part chain")
    if not np.all(np.isfinite(dec)) or not err < DECRYPT_TOL:
        raise AssertionError("switch_key decrypt error above the limit")
    return err, counts


def run_op(eng, kern, fn, unstack, want, tol, name, tag, is_real=True):
    """One evaluation op on the batch: its launches (counted from the
    counts before it), its host time, and the decrypt of its output held
    to ``want`` within ``tol``.  Returns (output, counts, err)."""
    before = dict(kern.LAUNCHES)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    counts = {k: kern.LAUNCHES[k] - before[k] for k in kern.LAUNCHES}
    dec = eng.decryptcode_batch(unstack(out), is_real=is_real)
    if dec.shape != (BATCH, eng.num_slots) or not np.all(np.isfinite(dec)):
        raise AssertionError(f"{tag} {name}: decrypt of shape {dec.shape} "
                             f"or not finite")
    err = float(np.abs(dec - want).max())
    log(f"{tag} {name}: {t_op:.4f} s (first call), launches "
        f"{ {k: n for k, n in counts.items() if n} }; decrypt max error "
        f"{err:.3e} (limit {tol})")
    if not err < tol:
        raise AssertionError(f"{tag} {name}: decrypt error above the limit")
    return out, counts, err


def keyswitch_launches(counts, n, tag, name, sfx="", chain_parts=None):
    """A keyswitched op's launches: ``n`` keyswitches through the all-parts
    kernel (one K6 and two K4 each, no chain), or, with ``chain_parts``,
    through the per-part chain (one K3 and chain_parts - 1 chain launches
    each, no K6)."""
    got = (counts["ntt_keymul_parts" + sfx], counts["intt_pdiv" + sfx],
           counts["ntt_keymul_accum" + sfx], counts["ntt_keymul" + sfx])
    if chain_parts is None:  # K3 may run besides (mean's pc_mult)
        got, want = got[:3], (n, 2 * n, 0)
    else:
        want = (0, 2 * n, n * (chain_parts - 1), n)
    if got != want:
        raise AssertionError(
            f"{tag} {name}: (K6, K4, chain, K3) launches {got}, want {want}")


def make_keys(eng, tag, galois):
    """The rotation keys (the Galois set, or delta 1 alone) and the
    conjugation key, timed (host clock, synchronised), with the device
    memory they add.  Returns (CSPRNG states before each, info)."""
    mem0 = torch.cuda.memory_allocated()
    states = {"rot": eng.rng.states.clone()}
    t0 = time.perf_counter()
    if galois:
        eng.rotk = {k.delta: k for k in eng.gk.data}
    else:
        eng.rotk[1]  # noqa: B018
    torch.cuda.synchronize()
    t_rot = time.perf_counter() - t0
    states["conj"] = eng.rng.states.clone()
    t0 = time.perf_counter()
    eng.conjk  # noqa: B018
    torch.cuda.synchronize()
    t_conj = time.perf_counter() - t0
    mem = torch.cuda.memory_allocated() - mem0
    n = len(eng.rotk)
    key_bytes = nbytes(*(t for k in (*map(eng.get_rotation_key, eng.rotk),
                                     eng.conjk)
                         for t in leaves(k)))
    log(f"{tag} {n} rotation key{'s' if n > 1 else ''} "
        f"{'(the Galois set, deltas 1 .. 2^(logN-2)) ' if galois else ''}"
        f"{t_rot:.3f} s, conjugation key {t_conj:.3f} s (host clock, "
        f"synchronised); the keys' tensors {key_bytes / 2**30:.3f} GiB; "
        f"device memory +{mem / 2**30:.3f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    return states, dict(rotation_keys=n, rotation_keys_s=t_rot,
                        conjugation_key_s=t_conj, key_bytes=key_bytes,
                        memory_added=mem)


def evaluate15(eng, eng_cpu, kern, stack, unstack, A, B, out, smi):
    """Phase 5b: the evaluation path at logN15 on the batch of 8, with the
    launch counts set to 0 before it and read after: the Galois keys and
    the conjugation key, then rotations (by 1, by 5 composed of 1 and 4,
    by -1 composed of all 14), conjugation, negate, add/sub, pc_add,
    pc_mult, the three scalar ops, level_up, cc_mult of two levels,
    square + relinearize, sum, mean and var, each decrypted against
    numpy.  After the counts are read: the rotation key for delta 1 and
    the conjugation key against the CPU engine's from the same CSPRNG
    state, byte for byte; the batch rotation against the 8 single ones;
    the timings, and one profiled rotation, conjugation and sum.  Returns
    (launches, per-op results, timings, key info)."""
    from tiberate_tpu_torch.typing import Plaintext

    tag = "logN15 evaluation"
    m1, m2 = msgs(eng)
    mc = m1 + 1j * m2
    C = stack(eng.encodecrypt_batch(mc))
    p = m2[0]
    L = eng.ckksCfg.logN - 1  # keyswitches of sum / mean, and of -1
    kern.reset_launch_counts()
    states, keys = make_keys(eng, tag, galois=True)
    require(kern.LAUNCHES, ("ntt", "intt"), f"{tag} key creation")

    def row(v):
        return np.broadcast_to(v, m1.shape)

    ops = {
        "rotate_offset 1": (lambda: eng.rotate_offset(A, 1),
                            np.roll(m1, 1, -1), DECRYPT_TOL_OP, 1),
        "rotate_offset 5": (lambda: eng.rotate_offset(A, 5),
                            np.roll(m1, 5, -1), DECRYPT_TOL_OP, 2),
        "rotate_offset -1": (lambda: eng.rotate_offset(A, -1),
                             np.roll(m1, -1, -1), DECRYPT_TOL_OP, L),
        "conjugate": (lambda: eng.conjugate(C), np.conj(mc),
                      DECRYPT_TOL_OP, 1),
        "negate": (lambda: eng.negate(A), -m1, DECRYPT_TOL, 0),
        "cc_add": (lambda: eng.cc_add(A, B), m1 + m2, DECRYPT_TOL, 0),
        "cc_sub": (lambda: eng.cc_sub(A, B), m1 - m2, DECRYPT_TOL, 0),
        "pc_add": (lambda: eng.pc_add(Plaintext(p), A), m1 + p,
                   100 * DECRYPT_TOL, 0),
        "pc_mult": (lambda: eng.pc_mult(Plaintext(p), A), m1 * p,
                    DECRYPT_TOL_OP, 0),
        "mult_int_scalar 3": (lambda: eng.mult_int_scalar(A, 3), 3 * m1,
                              DECRYPT_TOL, 0),
        "mult_scalar -1.5": (lambda: eng.mult_scalar(A, -1.5), -1.5 * m1,
                             DECRYPT_TOL_OP, 0),
        "add_scalar 0.25": (lambda: eng.add_scalar(A, 0.25), m1 + 0.25,
                            DECRYPT_TOL, 0),
        "level_up to 2": (lambda: eng.level_up(A, 2), m1, DECRYPT_TOL_OP, 0),
        "cc_mult of levels 1 and 0": (lambda: eng.cc_mult(out, A),
                                      m1 * m2 * m1, DECRYPT_TOL_OP, 1),
        "square(post_relin=False) + relinearize": (
            lambda: eng.relinearize(eng.square(A, post_relin=False)),
            m1 * m1, DECRYPT_TOL_OP, 1),
        "sum": (lambda: eng.sum(A), row(m1.sum(-1, keepdims=True)),
                200 * DECRYPT_TOL_OP, L),
        "mean": (lambda: eng.mean(A), row(m1.mean(-1, keepdims=True)),
                 DECRYPT_TOL_OP, L),
        "var": (lambda: eng.var(A), row(m1.var(-1, keepdims=True)),
                DECRYPT_TOL_OP, 2 * L + 1),
    }
    res, outs = {}, {}
    for name, (fn, want, tol, n_ks) in ops.items():
        outs[name], counts, err = run_op(eng, kern, fn, unstack, want, tol,
                                         name, tag,
                                         is_real=name != "conjugate")
        if name.startswith(("rotate", "conjugate", "sum", "mean", "var")):
            keyswitch_launches(counts, n_ks, tag, name)
        if name == "pc_mult" and counts["ntt_keymul"] != 2:
            raise AssertionError(f"{tag} pc_mult: {counts['ntt_keymul']} "
                                 f"ntt_keymul launches, want 2")
        if name.startswith("square") and counts["ntt_tensor"] != 1:
            raise AssertionError(f"{tag} square: no ntt_tensor launch")
        res[name] = dict(max_abs_err=err, limit=tol, launches={
            k: v for k, v in counts.items() if v})
    launches = dict(kern.LAUNCHES)
    require(launches, EVAL_15, "the logN15 evaluation path")
    log(f"{tag} path launches {launches}")

    # after the counted path: bytes against the CPU and against singles
    for what, state, make_cpu, card_key in (
            ("rotation key (delta 1)", states["rot"],
             lambda: eng_cpu._create_rotation_key(1), eng.rotk[1]),
            ("conjugation key", states["conj"],
             eng_cpu.create_conjugation_key, eng.conjk)):
        eng_cpu.rng.states = state.cpu()
        t0 = time.perf_counter()
        cpu_key = make_cpu()
        t_cpu = time.perf_counter() - t0
        same = all(torch.equal(c, g.cpu())
                   for c, g in zip(leaves(cpu_key), leaves(card_key)))
        log(f"{tag} {what}: card == CPU byte for byte: {same} "
            f"({len(card_key.data)} parts; CPU {t_cpu:.1f} s)")
        if not same:
            raise AssertionError(f"{tag} the card's {what} differs from "
                                 f"the CPU's")
    singles = [eng.rotate_offset(c, 1) for c in unstack(A)]
    same = all(torch.equal(b, s) for one, batch in zip(
        singles, unstack(outs["rotate_offset 1"]))
        for b, s in zip(batch.data, one.data))
    log(f"{tag} rotate_offset 1 of the batch == the {BATCH} single "
        f"rotations byte for byte: {same}")
    if not same:
        raise AssertionError(f"{tag} batch rotation differs from the "
                             f"single rotations")

    pt = Plaintext(p)
    eng.pc_mult(pt, A)
    timed = {
        "rotate_single (delta 1)": (lambda: eng.rotate_single(
            A, eng.rotk[1]), 3),
        "conjugate": (lambda: eng.conjugate(C), 3),
        "pc_mult (cached plaintext)": (lambda: eng.pc_mult(pt, A), 3),
        "sum": (lambda: eng.sum(A), 1),
        "mean": (lambda: eng.mean(A), 1),
        "var": (lambda: eng.var(A), 1),
    }
    times = {}
    for name, (fn, inner) in timed.items():
        times[name] = cuda_ms(fn, 3, inner)
        log(f"{tag} {name} of the batch of {BATCH}: {times[name]:.3f} ms, "
            f"{times[name] / BATCH:.3f} ms/ct (CUDA events, median of 3 "
            f"after a warm-up; {smi})")
    log(f"{tag} Galois key creation ({keys['rotation_keys']} keys): "
        f"{keys['rotation_keys_s']:.3f} s, "
        f"{keys['rotation_keys_s'] / keys['rotation_keys']:.3f} s a key "
        f"(host clock; {smi})")
    profile_step(lambda: eng.rotate_single(A, eng.rotk[1]),
                 f"{tag} rotate_single")
    profile_step(lambda: eng.conjugate(C), f"{tag} conjugate")
    profile_step(lambda: eng.sum(A), f"{tag} sum", top=8)
    return launches, res, times, keys


def evaluate_light(eng, kern, stack, unstack, A, tol, sfx, tag, chain):
    """The evaluation path cut for the other presets, on the batch of 8
    with the launch counts set to 0 before and read after.  ``chain``
    False (logN15_30): ``rotate_offset`` by 2, ``add_scalar`` and ``sum``
    (its 14 keys made on first use); True (logN17, logN17_30): the
    rotation key for delta 1 and the conjugation key, one
    ``rotate_offset(., 1)`` and one ``conjugate``, each through the
    per-part chain.  Returns (launches, per-op results, key info)."""
    m1, m2 = msgs(eng)
    mc = m1 + 1j * m2
    C = stack(eng.encodecrypt_batch(mc)) if chain else None
    n_parts = len(eng.params.parts[0])
    kern.reset_launch_counts()
    keys = None
    if chain:
        _, keys = make_keys(eng, tag, galois=False)
        log(f"{tag}: no full Galois set here: its {eng.ckksCfg.logN - 1} "
            f"keys would take {eng.ckksCfg.logN - 1} x "
            f"{keys['key_bytes'] / 2 / 2**30:.2f} GiB of key tensors")
        ops = {
            "rotate_offset 1": (lambda: eng.rotate_offset(A, 1),
                                np.roll(m1, 1, -1), 1),
            "conjugate": (lambda: eng.conjugate(C), np.conj(mc), 1),
        }
    else:
        row = np.broadcast_to(m1.sum(-1, keepdims=True), m1.shape)
        ops = {
            "rotate_offset 2": (lambda: eng.rotate_offset(A, 2),
                                np.roll(m1, 2, -1), 1),
            "add_scalar 0.5": (lambda: eng.add_scalar(A, 0.5), m1 + 0.5, 0),
            "sum": (lambda: eng.sum(A), row, eng.ckksCfg.logN - 1),
        }
    res = {}
    for name, (fn, want, n_ks) in ops.items():
        limit = 200 * tol if name == "sum" else tol
        _, counts, err = run_op(eng, kern, fn, unstack, want, limit, name,
                                tag, is_real=name != "conjugate")
        if n_ks:
            keyswitch_launches(counts, n_ks, tag, name, sfx,
                               n_parts if chain else None)
        res[name] = dict(max_abs_err=err, limit=limit, launches={
            k: v for k, v in counts.items() if v})
    launches = dict(kern.LAUNCHES)
    need = ("ntt", "intt", "intt_pdiv") + (
        ("ntt_keymul", "ntt_keymul_accum") if chain
        else ("ntt_keymul_parts",))
    require(launches, lane(need, sfx), f"the {tag} evaluation path")
    if sfx:
        only_30(launches, f"the {tag} evaluation path")
    log(f"{tag} evaluation path launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches, res, keys


# ----------------------------------------------------------------------
# Phase 12: the extension path at logN15.
# ----------------------------------------------------------------------

EXT_TOL_BI = 1e-4     # batched_inference: tests/test_extensions.py:172
EXT_TOL_LINEAR = 5e-4  # HE linear, MPC: tests/test_extensions.py:18
EXT_TOL_LN = 5e-3     # LayerNorm: tests/test_extensions.py:325


def release_engines(typing):
    """End of a cell: drop the port's default-engine registry (it holds
    every engine made so far, as the JAX package's does), collect, and
    return the freed blocks to the card."""
    typing._default_engines.clear()
    typing._engines_by_hash.clear()
    gc.collect()
    torch.cuda.empty_cache()


def diff(kern, before):
    return {k: kern.LAUNCHES[k] - before[k] for k in kern.LAUNCHES
            if kern.LAUNCHES[k] - before[k]}


def flat(data):
    if isinstance(data, (tuple, list)):
        return [t for d in data for t in flat(d)]
    return [data]


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def ext_sugar(eng, kern, typing, tag):
    """12.1: ``ct1 * ct2 + ct1``, ``ct >> 3``, ``ct << 1`` and ``ct ** 2``
    through the operators (the registry finds the engine), each equal byte
    for byte to the explicit engine calls on the same operands, and its
    ``.plain`` to their decrypt; within DECRYPT_TOL_OP of numpy.  The
    Galois keys are made first, so neither path draws."""
    rng = np.random.default_rng(SEED)
    m1, m2 = rng.uniform(-1, 1, (2, eng.num_slots))
    ct1, ct2 = eng.encodecrypt_batch([m1, m2])
    check(ct1._default_engine is eng, f"{tag}: the registry does not "
          f"find the engine that made the ciphertext")
    t0 = time.perf_counter()
    eng.rotk = {k.delta: k for k in eng.gk.data}
    torch.cuda.synchronize()
    log(f"{tag} sugar: {len(eng.rotk)} rotation keys made first "
        f"({time.perf_counter() - t0:.3f} s)")
    exprs = {
        "ct1 * ct2 + ct1": (lambda: ct1 * ct2 + ct1,
                            lambda: eng.cc_add_double(eng.cc_mult(ct1, ct2),
                                                      ct1),
                            m1 * m2 + m1),
        "ct >> 3": (lambda: ct1 >> 3, lambda: eng.rotate_offset(ct1, 3),
                    np.roll(m1, 3)),
        "ct << 1": (lambda: ct1 << 1, lambda: eng.rotate_offset(ct1, -1),
                    np.roll(m1, -1)),
        "ct ** 2": (lambda: ct1 ** 2, lambda: eng.cc_mult(ct1, ct1),
                    m1 ** 2),
    }
    res = {}
    for name, (sugar, explicit, want) in exprs.items():
        before = dict(kern.LAUNCHES)
        out = sugar()
        torch.cuda.synchronize()
        counts = diff(kern, before)
        ref = explicit()
        same = all(torch.equal(a, b) for a, b in zip(out.data, ref.data))
        plain = out.plain
        same_plain = np.array_equal(plain, eng.decryptcode(ref, is_real=True))
        err = float(np.abs(plain - want).max())
        log(f"{tag} sugar {name}: launches {counts}; == the explicit "
            f"engine calls byte for byte: {same}, .plain == their decrypt: "
            f"{same_plain}; max error {err:.3e} (limit {DECRYPT_TOL_OP})")
        check(same and same_plain, f"{tag} sugar {name} differs from the "
              f"explicit engine calls")
        check(err < DECRYPT_TOL_OP, f"{tag} sugar {name}: error above the "
              f"limit")
        res[name] = dict(max_abs_err=err, limit=DECRYPT_TOL_OP,
                         launches=counts)
    return ct1, ct2, m1, res


def ext_save_load(eng, typing, ct1, ct2, m1, tag):
    """12.2: a ciphertext, a triplet, the secret key and the evk saved from
    the card; loaded onto the card and onto the CPU with the same bytes,
    dtype, flags, level and scalar misc; the loaded ciphertext decrypts
    within DECRYPT_TOL."""
    tri = eng.cc_mult(ct1, ct2, post_relin=False)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        for name, obj in (("ciphertext", ct1), ("triplet", tri),
                          ("secret_key", eng.sk), ("evk", eng.evk)):
            path = os.path.join(d, name)
            t0 = time.perf_counter()
            obj.save(path)
            t_save = time.perf_counter() - t0
            want = [t.cpu() for t in flat(obj.data)]
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                back = typing.DataStruct.load(path, device=dev)
                t_load = time.perf_counter() - t0
                got = flat(back.data)
                same = (len(got) == len(want) and all(
                    g.device.type == dev and g.dtype == w.dtype
                    and torch.equal(g.cpu(), w) for g, w in zip(got, want)))
                meta = (type(back) is type(obj) and back.level == obj.level
                        and back._flags == obj._flags and all(
                            back.misc[k] == v for k, v in obj.misc.items()
                            if isinstance(v, (str, int, float, bool))))
                log(f"{tag} save/load {name} -> {dev}: {len(got)} leaves "
                    f"({nbytes(*want) / 2**20:.1f} MiB), same bytes and "
                    f"dtype: {same}, same class, level, flags and misc: "
                    f"{meta} (save {t_save:.3f} s, load {t_load:.3f} s)")
                check(same and meta, f"{tag}: {name} loaded onto {dev} "
                      f"differs from the saved one")
            res[name] = dict(leaves=len(want), bytes=nbytes(*want),
                             save_s=t_save)
        back = typing.Ciphertext.load(os.path.join(d, "ciphertext"),
                                      device="cuda")
    err = float(np.abs(back.plain - m1).max())
    log(f"{tag} loaded ciphertext decrypts: max error {err:.3e} (limit "
        f"{DECRYPT_TOL})")
    check(err < DECRYPT_TOL, f"{tag}: loaded ciphertext decrypt error")
    res["loaded_decrypt_max_abs_err"] = err
    return res


def ext_batched_inference(eng, kern, benchreg, score_batch, tag):
    """12.3: ``batched_inference`` through the registry at logN15 (features
    8, batches 4, iters 3), within EXT_TOL_BI; then the launches of one
    ``score_batch`` on this engine: two cc_mult, so two K5, two K6, four
    K4 and no chain."""
    t0 = time.perf_counter()
    bi = benchreg["batched_inference"]().run(
        preset="logN15", features=8, batches=4, iters=3, device="cuda")
    t_bi = time.perf_counter() - t0
    vals = {m.name: m.value for m in bi.metrics}
    log(f"{tag} batched_inference (features 8, batches 4, iters 3; "
        f"{t_bi:.1f} s in all): " + ", ".join(
            f"{k} {v:.6g}" for k, v in vals.items()))
    check(vals["max_err"] < EXT_TOL_BI, f"{tag} batched_inference max_err "
          f"{vals['max_err']:.3e} above {EXT_TOL_BI}")
    log(f"{tag} batched_inference max_err {vals['max_err']:.3e} (limit "
        f"{EXT_TOL_BI})")
    rng = np.random.default_rng(SEED)
    fcts = eng.encodecrypt_batch(list(rng.uniform(-1, 1,
                                                  (8, eng.num_slots))))
    w = rng.uniform(-1, 1, 8)
    before = dict(kern.LAUNCHES)
    score_batch(eng, fcts, w, 0.25)
    torch.cuda.synchronize()
    counts = diff(kern, before)
    log(f"{tag} one score_batch launches {counts}")
    want = dict(ntt_tensor=2, ntt_keymul_parts=2, intt_pdiv=4)
    got = {k: counts.get(k, 0) for k in want}
    check(got == want and not counts.get("ntt_keymul_accum"),
          f"{tag} score_batch: launches {got}, want {want} and no chain")
    return dict(vals, seconds=t_bi, score_batch_launches=counts)


def ext_linear(CkksEngine, Preset, kern, tag, smi):
    """12.4: ``HELinearFeatureWise`` at dim 16 on a fresh logN15 engine:
    16 x 4 rotate-and-sum rotations and 15 placements, so 79 K6 in a
    forward, exactly; the first forward (which makes the rotation keys)
    and a warm one timed, the keys' device memory; within EXT_TOL_LINEAR
    of ``x @ W.T + b``."""
    from tiberate_tpu_torch.extension import (
        FeatureWiseCTEncoding,
        HELinearFeatureWise,
    )
    from tiberate_tpu_torch.utils.massive import datastruct_size_bytes

    eng = CkksEngine(Preset.logN15, device="cuda", seed=SEED + 1)
    eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
    dim = 16
    rng = np.random.default_rng(SEED)
    W = rng.uniform(-1, 1, (dim, dim))
    b = rng.uniform(-1, 1, dim)
    x = rng.uniform(-1, 1, (1, dim))
    layer = HELinearFeatureWise(W, b, eng)
    ct_in = FeatureWiseCTEncoding.encodecrypt(x, eng)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    before = dict(kern.LAUNCHES)
    t0 = time.perf_counter()
    layer(ct_in)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    first = diff(kern, before)
    mem = torch.cuda.memory_allocated() - mem0
    keys = [eng.get_rotation_key(d) for d in eng.rotk]
    key_bytes = nbytes(*(t for k in keys for t in leaves(k)))
    # what else the first forward keeps: each key's stacked K6 form per
    # level it ran at (cached on the key) and the plaintext rows' caches
    form_bytes = sum(nbytes(*form[:2]) for k in keys
                     for form in (k.misc["_parts_fused"] or {}).values())
    rows = [pt for row in layer.weight_rows for pt in row]
    rows += [layer.mask, *(layer.bias_rows or [])]
    pt_bytes = sum(datastruct_size_bytes(pt) for pt in rows)
    before = dict(kern.LAUNCHES)
    t0 = time.perf_counter()
    out = layer(ct_in)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm = diff(kern, before)
    rotations = dim * int(math.log2(layer.period)) + (dim - 1)
    for name, counts in (("first", first), ("warm", warm)):
        check(counts.get("ntt_keymul_parts", 0) == rotations
              and not counts.get("ntt_keymul_accum"),
              f"{tag} linear {name} forward: {counts} K6 launches, want "
              f"{rotations} (the rotations)")
    got = FeatureWiseCTEncoding.decryptcode(out, eng)
    err = float(np.abs(got - (x @ W.T + b)).max())
    log(f"{tag} HELinearFeatureWise dim {dim}: {rotations} rotations, K6 "
        f"launches first / warm {first['ntt_keymul_parts']} / "
        f"{warm['ntt_keymul_parts']}; first forward (makes {len(keys)} "
        f"rotation keys) {t_first:.3f} s, warm forward {t_warm:.3f} s "
        f"(host clock, synchronised; {smi}); the keys' tensors "
        f"{key_bytes / 2**30:.3f} GiB, their stacked K6 forms "
        f"{form_bytes / 2**30:.3f} GiB, the plaintext rows' caches "
        f"{pt_bytes / 2**30:.3f} GiB; device memory +{mem / 2**30:.3f} "
        f"GiB over the first forward; warm launches {warm}; max error "
        f"{err:.3e} (limit {EXT_TOL_LINEAR})")
    check(err < EXT_TOL_LINEAR, f"{tag} linear error above the limit")
    return dict(dim=dim, rotations=rotations, first_forward_s=t_first,
                warm_forward_s=t_warm, rotation_keys=len(keys),
                key_bytes=key_bytes, key_form_bytes=form_bytes,
                plaintext_cache_bytes=pt_bytes, memory_added=mem,
                max_abs_err=err,
                limit=EXT_TOL_LINEAR, launches_warm=warm)


def ext_layernorm(eng, kern, tag, smi):
    """12.5: ``HELayerNormFeatureWise`` on the data of
    ``tests/test_extensions.py:280-325`` at the full slot width: F = 4,
    eps 1e-2, two Newton steps; within EXT_TOL_LN of numpy."""
    from tiberate_tpu_torch.extension.nn import HELayerNormFeatureWise

    F, eps = 4, 1e-2
    rng = np.random.default_rng(0)
    pattern = np.array([-1.5, -0.5, 0.5, 1.5])
    c = rng.uniform(-0.3, 0.3, eng.num_slots)
    r = rng.uniform(0.5, 0.9, eng.num_slots)
    x = c[None, :] + r[None, :] * pattern[:, None]
    gamma = rng.uniform(0.5, 1.5, F)
    beta = rng.uniform(-0.5, 0.5, F)
    ln = HELayerNormFeatureWise(
        gamma, beta, eng, eps=eps,
        var_range=(1.25 * 0.25 + eps, 1.25 * 0.81 + eps), iters=2)
    cts = eng.encodecrypt_batch(list(x))
    before = dict(kern.LAUNCHES)
    t0 = time.perf_counter()
    out = ln(cts)
    torch.cuda.synchronize()
    t_ln = time.perf_counter() - t0
    counts = diff(kern, before)
    got = eng.decryptcode_batch(out, is_real=True)
    want = (gamma[:, None] * (x - x.mean(0)) / np.sqrt(x.var(0) + eps)
            + beta[:, None])
    err = float(np.abs(got - want).max())
    log(f"{tag} HELayerNormFeatureWise F {F}, iters 2: output level "
        f"{out[0].level}, {t_ln:.3f} s (host clock, synchronised; {smi}), "
        f"launches {counts}; max error {err:.3e} (limit {EXT_TOL_LN})")
    check(err < EXT_TOL_LN, f"{tag} LayerNorm error above the limit")
    return dict(seconds=t_ln, level=out[0].level, max_abs_err=err,
                limit=EXT_TOL_LN, launches=counts)


def mpc_run(mpc, m, rotate):
    """Two parties: keys, the collective key, encrypt, threshold decrypt
    (and with ``rotate`` a collective rotation key and one rotation)."""
    sk1 = mpc._create_secret_key()
    sk2 = mpc._create_secret_key()
    pk1 = mpc.multiparty_create_public_key(sk1)
    crs = mpc.multiparty_public_crs(pk1)
    pk2 = mpc.multiparty_create_public_key(sk2, a=crs)
    cpk = mpc.multiparty_create_collective_public_key([pk1, pk2])
    ct = mpc.encodecrypt(m, pk=cpk)

    def fuse(c, parties=(sk1, sk2)):
        shares = [mpc.multiparty_decrypt_head(c, parties[0])]
        shares += [mpc.multiparty_decrypt_partial(c, sk)
                   for sk in parties[1:]]
        return mpc.multiparty_decrypt_fusion(shares, level=c.level,
                                             is_real=True)

    out = dict(cpk=cpk, ct=ct, fused=fuse(ct), single=fuse(ct, (sk1,)))
    if rotate:
        rotk1 = mpc.multiparty_create_rotation_key(sk1, 1)
        rotk2 = mpc.multiparty_create_rotation_key(
            sk2, 1, a=mpc.generate_rotation_crs(rotk1))
        crotk = mpc.multiparty_generate_rotation_key([rotk1, rotk2])
        out["rotated"] = fuse(mpc.rotate_single(ct, crotk))
    return out


def ext_mpc(Preset, kern, tag):
    """12.6: two parties at logN15, bias guard off: collective encrypt,
    head + partial + fusion within EXT_TOL_LINEAR, one share alone
    garbage (error above 1.0), a collective rotation key and one rotation
    within EXT_TOL_LINEAR; a CPU engine from the same seed runs the same
    steps up to the fusion: the same collective key and ciphertext bytes,
    the same fused floats."""
    from tiberate_tpu_torch.extension import CkksEngineMPCExtension

    mpc = CkksEngineMPCExtension(Preset.logN15, device="cuda", seed=SEED,
                                 bias_guard=False)
    m = np.linspace(-1, 1, mpc.num_slots)
    before = dict(kern.LAUNCHES)
    t0 = time.perf_counter()
    got = mpc_run(mpc, m, rotate=True)
    torch.cuda.synchronize()
    t_mpc = time.perf_counter() - t0
    counts = diff(kern, before)
    errs = {k: float(np.abs(got[k] - w).max()) for k, w in (
        ("fused", m), ("single", m), ("rotated", np.roll(m, 1)))}
    log(f"{tag} MPC two parties: {t_mpc:.3f} s (keys, encrypt, two "
        f"threshold decrypts, a collective rotation key and one rotation); "
        f"launches {counts}; fused max error {errs['fused']:.3e}, rotated "
        f"{errs['rotated']:.3e} (limit {EXT_TOL_LINEAR}); one share alone "
        f"{errs['single']:.3e} (must exceed 1.0)")
    check(errs["fused"] < EXT_TOL_LINEAR and errs["rotated"]
          < EXT_TOL_LINEAR, f"{tag} MPC decrypt error above the limit")
    check(errs["single"] > 1.0, f"{tag} MPC: one share decrypts")
    t0 = time.perf_counter()
    cpu = mpc_run(CkksEngineMPCExtension(Preset.logN15, device="cpu",
                                         seed=SEED, bias_guard=False),
                  m, rotate=False)
    same = (all(torch.equal(a.cpu(), b) for a, b in zip(
        flat(got["cpk"].data) + flat(got["ct"].data),
        flat(cpu["cpk"].data) + flat(cpu["ct"].data)))
        and np.array_equal(got["fused"], cpu["fused"])
        and np.array_equal(got["single"], cpu["single"]))
    log(f"{tag} MPC card == CPU (collective key, ciphertext bytes, fused "
        f"floats): {same} ({time.perf_counter() - t0:.1f} s on the CPU)")
    check(same, f"{tag} MPC on the card differs from the CPU")
    return dict(seconds=t_mpc, launches=counts, limit=EXT_TOL_LINEAR,
                **{f"{k}_max_abs_err": v for k, v in errs.items()})


def ext_trace(eng, trace, ct, tag):
    """12.7: ``trace.profile`` around one ``rotate_single`` with ``annotate``
    ranges: the written trace holds the range names and K6's two kernel
    names."""
    want = ("ext_rotate_single", "ext_decrypt", "parts_strided_k",
            "parts_contig_k")
    with tempfile.TemporaryDirectory() as d:
        with trace.profile(d) as path:
            with trace.annotate("ext_rotate_single"):
                rot = eng.rotate_single(ct, eng.rotk[1])
            with trace.annotate("ext_decrypt"):
                eng.decryptcode(rot)
        with open(path) as f:
            text = f.read()
    found = {w: w in text for w in want}
    log(f"{tag} trace.profile of one rotate_single: {len(text)} bytes of "
        f"chrome trace; holds {found}")
    check(all(found.values()), f"{tag}: the trace lacks {found}")
    return found


def ext_cli(tag):
    """12.8: the CLI in process: ``list-benchmarks``, then ``benchmark
    --name single_pmult --preset logN15 --iters 3 --file F`` on the card;
    F parses and holds the metrics."""
    from tiberate_tpu_torch._cli import main as cli_main

    check(cli_main(["list-benchmarks"]) == 0, f"{tag}: list-benchmarks")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "single_pmult.json")
        t0 = time.perf_counter()
        rc = cli_main(["benchmark", "--name", "single_pmult", "--preset",
                       "logN15", "--iters", "3", "--file", path])
        t_cli = time.perf_counter() - t0
        check(rc == 0, f"{tag}: benchmark exited {rc}")
        with open(path) as f:
            results = json.load(f)
    vals = {m["name"]: m["value"] for m in results[0]["metrics"]}
    log(f"{tag} CLI benchmark single_pmult (logN15, 3 iters, {t_cli:.1f} "
        f"s): {vals}")
    check(set(vals) == {"pc_mult", "decrypt_max_err", "pt_cache_size_mb"}
          and vals["decrypt_max_err"] < DECRYPT_TOL_OP,
          f"{tag}: the CLI's result file {vals}")
    return dict(vals, seconds=t_cli)


def extension_phase(CkksEngine, Preset, kern, typing, smi):
    """Phase 12: the extension path at logN15 (16 levels, 2 special primes,
    9 keyswitch parts), its launch counts set to 0 before it and read
    after.  Returns (launches, results)."""
    from tiberate_tpu_torch.extension.benchmarks import benchreg
    from tiberate_tpu_torch.extension.benchmarks.bench_ops import (
        score_batch,
    )
    from tiberate_tpu_torch.utils import trace

    tag = "logN15 extensions"
    t_phase = time.perf_counter()
    kern.reset_launch_counts()
    eng = CkksEngine(Preset.logN15, device="cuda", seed=SEED)
    eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
    res = {}
    ct1, ct2, m1, res["sugar"] = ext_sugar(eng, kern, typing, tag)
    res["save_load"] = ext_save_load(eng, typing, ct1, ct2, m1, tag)
    res["batched_inference"] = ext_batched_inference(
        eng, kern, benchreg, score_batch, tag)
    res["linear_feature_wise"] = ext_linear(CkksEngine, Preset, kern, tag,
                                            smi)
    res["layernorm"] = ext_layernorm(eng, kern, tag, smi)
    res["mpc"] = ext_mpc(Preset, kern, tag)
    res["trace"] = ext_trace(eng, trace, ct1, tag)
    res["cli"] = ext_cli(tag)
    launches = dict(kern.LAUNCHES)
    require(launches, EXT_15, "the logN15 extension path")
    log(f"{tag} path launches {launches}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"{tag}: phase 12 took {res['seconds']:.1f} s")
    return launches, res


def profile_step(fn, tag, top=12):
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
        log(f"{tag} profiler: no device time recorded (not measured)")
        return
    log(f"{tag} profile of one step: wall {wall_us:.0f} us under the "
        f"profiler, device busy {busy_us:.0f} us "
        f"({100 * busy_us / wall_us:.1f}% of that profiled wall), "
        f"{sum(e.count for e in rows)} kernel launches")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:top]:
        log(f"  {e.self_device_time_total:11.1f} us  x{e.count:<5d} "
            f"{e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from tiberate_tpu_torch import CkksConfig, Preset
    from tiberate_tpu_torch import typing as ttyping
    from tiberate_tpu_torch.engine import (
        CkksEngine,
        stack_ciphertexts,
        unstack_ciphertext,
    )
    from tiberate_tpu_torch.benchmarks.profiling import fold_microbench
    from tiberate_tpu_torch.engine import ckks_engine as mod
    from tiberate_tpu_torch.ops import cuda_build, fold_probe, mont, roofline
    from tiberate_tpu_torch.ops import ntt_kernels as kern
    from tiberate_tpu_torch.parallel import sharded
    from tiberate_tpu_torch.rng.csprng import Csprng

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

    # 2b. the fold-rate probe: its kernels against their plain versions,
    # then its entry point; the REDC rate of each lane bounds the kernels
    probe, probe_counts = probe_phase(fold_microbench, fold_probe, roofline)
    rate, rate30 = (probe[m]["fold_per_s"]
                    for m in ("fold_redc", "fold_redc_30"))

    # 2c. the redesigned transforms at small logN, and their SASS
    from tiberate_tpu_torch.config.toy import toy_config
    from tiberate_tpu_torch.context.ntt_context import CkksParams

    t0 = time.perf_counter()
    n_small = check_small(kern, mod, CkksParams, toy_config)
    log(f"logN 4, 7, 10: {n_small} cases of the ntt.cu entries, K5 and K6, "
        f"both lanes, byte-identical to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    sass = contig_sass(cuda_build)
    if sass is None:
        log("SASS of the contiguous passes: not measured (no cuobjdump)")
    for (name, bits, logN), (imad, total, bfly) in sorted(
            (sass or {}).items()):
        log(f"SASS {name} {bits}-bit logN{logN}: {total} instructions, "
            f"{imad} IMAD-class, for {bfly} butterflies a thread: "
            f"{total / bfly:.1f} ({imad / bfly:.1f} IMAD-class) a butterfly")

    # 2d. the CSPRNG on the card against the CPU; 2e. the pinned digest
    csprng = csprng_phase(Csprng, CkksConfig, (Preset.logN15, Preset.logN17),
                          smi)
    err14 = digest_phase(CkksEngine)
    release_engines(ttyping)

    # 3. logN15 kernels against their plain versions
    eng_k = CkksEngine(Preset.logN15, device="cuda", seed=SEED)
    results15 = check_kernels(eng_k, kern, mod, roofline, "logN15", (3, 3),
                              rate)
    del eng_k
    release_engines(ttyping)

    # 4. the logN15 main path
    eng = CkksEngine(Preset.logN15, device="cuda", seed=SEED)
    A, B, out, launches15, step15, err15, info15 = drive(
        eng, kern, stack_ciphertexts, unstack_ciphertext, DECRYPT_TOL,
        "logN15")
    require(launches15, PATH_15, "the logN15 main path")
    require(step15, STEP_15, "the logN15 step")
    eng_cpu = check_against_cpu(eng, CkksEngine, Preset.logN15, A, B, out,
                                "logN15")

    # 5. logN15 timing, route A/B, profile
    step_ms, plain_step_ms = time_step(eng, kern, A, B, "logN15", smi,
                                       (3, 3), 3)
    ab15 = route_ab(eng, kern, sharded, A, B, "logN15", (3, 3))
    profile_step(lambda: eng.cc_mult(A, B), "logN15")
    compressed_keys(eng, ttyping, mont)

    # 5b. the evaluation path: Galois and conjugation keys, rotations,
    # add/sub, plaintext and scalar ops, levels, sum / mean / var
    eval15, evalres15, evaltimes15, evalkeys15 = evaluate15(
        eng, eng_cpu, kern, stack_ciphertexts, unstack_ciphertext, A, B,
        out, smi)
    del eng_cpu
    share15 = draw_share(eng, msgs(eng)[0], "logN15")
    del eng, A, B, out
    release_engines(ttyping)

    # 6. logN17 kernels (one engine for phases 6-9: its CkksParams build
    # alone takes about 20 s of host time)
    t0 = time.perf_counter()
    eng17 = CkksEngine(Preset.logN17, device="cuda", seed=SEED)
    log(f"logN17 engine built in {time.perf_counter() - t0:.1f} s: "
        f"{len(eng17.params.q)} primes, {len(eng17.params.parts[1])} "
        f"keyswitch parts at level 1")
    results17 = check_kernels(eng17, kern, mod, roofline, "logN17", (3, 1),
                              rate)

    # 7. the logN17 main path
    A, B, out, launches17, step17, err17, info17 = drive(
        eng17, kern, stack_ciphertexts, unstack_ciphertext, DECRYPT_TOL_17,
        "logN17")
    require(launches17, PATH_17, "the logN17 main path")
    require(step17, STEP_17, "the logN17 step")
    n_parts = len(eng17.params.parts[1])
    if step17["ntt_keymul_accum"] != n_parts or step17["ntt_keymul_parts"]:
        raise AssertionError(
            f"logN17 step: {step17['ntt_keymul_accum']} chain launches "
            f"(want {n_parts}), {step17['ntt_keymul_parts']} all-parts")

    # 8. logN17 switch_key
    err_sw, sw_counts = switch_key_17(eng17, kern, stack_ciphertexts,
                                      unstack_ciphertext)

    # 8b. a rotation and a conjugation through the per-part chain
    eval17, evalres17, evalkeys17 = evaluate_light(
        eng17, kern, stack_ciphertexts, unstack_ciphertext, A,
        DECRYPT_TOL_17, "", "logN17", chain=True)

    # 9. logN17 timing (3 single-step loops; one for the plain versions,
    # whose step takes seconds), route A/B, profile
    step17_ms, plain_step17_ms = time_step(eng17, kern, A, B, "logN17", smi,
                                           (3, 1), 1)
    ab17 = route_ab(eng17, kern, sharded, A, B, "logN17", (3, 1))
    profile_step(lambda: eng17.cc_mult(A, B), "logN17", top=16)
    share17 = draw_share(eng17, msgs(eng17)[0], "logN17")

    del eng17, A, B, out
    release_engines(ttyping)

    # 10. the 30-bit mode at logN15_30: kernels, the main path (all parts in
    # one kernel), the CPU comparison, timing, route A/B, profile
    eng_k = CkksEngine("logN15_30", device="cuda", seed=SEED)
    results15_30 = check_kernels(eng_k, kern, mod, roofline, "logN15_30",
                                 (3, 3), rate30)
    del eng_k
    release_engines(ttyping)
    eng = CkksEngine("logN15_30", device="cuda", seed=SEED)
    A, B, out, launches15_30, step15_30, err15_30, info15_30 = drive(
        eng, kern, stack_ciphertexts, unstack_ciphertext, DECRYPT_TOL_30,
        "logN15_30")
    require(launches15_30, lane(PATH_15, "_30"), "the logN15_30 main path")
    require(step15_30, lane(STEP_15, "_30"), "the logN15_30 step")
    only_30(launches15_30, "logN15_30")
    check_against_cpu(eng, CkksEngine, "logN15_30", A, B, out, "logN15_30")
    eval15_30, evalres15_30, _ = evaluate_light(
        eng, kern, stack_ciphertexts, unstack_ciphertext, A,
        DECRYPT_TOL_30_OP, "_30", "logN15_30", chain=False)
    step15_30_ms, plain_step15_30_ms = time_step(
        eng, kern, A, B, "logN15_30", smi, (3, 3), 3)
    log(f"logN15 fused step, batch {BATCH}, same call: 62-bit "
        f"{step_ms:.3f} ms/step, 30-bit (logN15_30) {step15_30_ms:.3f} "
        f"ms/step ({smi})")
    ab15_30 = route_ab(eng, kern, sharded, A, B, "logN15_30", (3, 3))
    profile_step(lambda: eng.cc_mult(A, B), "logN15_30")
    del eng, A, B, out
    release_engines(ttyping)

    # 11. logN17_30: kernels, the main path through the per-part chain,
    # the plain-version step, route A/B with peak memory, profile
    t0 = time.perf_counter()
    eng = CkksEngine("logN17_30", device="cuda", seed=SEED)
    n_parts = len(eng.params.parts[1])
    log(f"logN17_30 engine built in {time.perf_counter() - t0:.1f} s: "
        f"{len(eng.params.q)} primes, {n_parts} keyswitch parts at level 1")
    results17_30 = check_kernels(eng, kern, mod, roofline, "logN17_30",
                                 (3, 1), rate30)
    A, B, out, launches17_30, step17_30, err17_30, info17_30 = drive(
        eng, kern, stack_ciphertexts, unstack_ciphertext, DECRYPT_TOL_30,
        "logN17_30")
    require(launches17_30, lane(PATH_17, "_30"), "the logN17_30 main path")
    require(step17_30, lane(STEP_17, "_30"), "the logN17_30 step")
    only_30(launches17_30, "logN17_30")
    if (step17_30["ntt_keymul_accum_30"] != n_parts
            or step17_30["ntt_keymul_parts_30"]):
        raise AssertionError(
            f"logN17_30 step: {step17_30['ntt_keymul_accum_30']} chain "
            f"launches (want {n_parts}), {step17_30['ntt_keymul_parts_30']} "
            f"all-parts")
    eval17_30, evalres17_30, evalkeys17_30 = evaluate_light(
        eng, kern, stack_ciphertexts, unstack_ciphertext, A,
        DECRYPT_TOL_30_OP, "_30", "logN17_30", chain=True)
    step17_30_ms, plain_step17_30_ms = time_step(
        eng, kern, A, B, "logN17_30", smi, (3, 1), 1)
    ab17_30 = route_ab(eng, kern, sharded, A, B, "logN17_30", (3, 1))
    profile_step(lambda: eng.cc_mult(A, B), "logN17_30", top=16)
    del eng, A, B, out
    release_engines(ttyping)

    # 12. the extension path at logN15: the operator sugar, save/load,
    # batched_inference, the HE linear layer and LayerNorm, two-party
    # MPC, a trace and the CLI
    ext15, extres15 = extension_phase(CkksEngine, Preset, kern, ttyping,
                                      smi)
    release_engines(ttyping)

    counts = {k: launches15[k] + launches17[k] + sw_counts[k]
              + launches15_30[k] + launches17_30[k] + eval15[k] + eval17[k]
              + eval15_30[k] + eval17_30[k] + ext15[k] for k in KERNELS}
    counts.update(probe_counts)
    require(counts, [*KERNELS, *PROBE], "the driven paths")
    for res, launches, step, sfx, tag in (
            (results15, launches15, step15, "", "logN15"),
            (results17, launches17, step17, "", "logN17"),
            (results15_30, launches15_30, step15_30, "_30", "logN15_30"),
            (results17_30, launches17_30, step17_30, "_30", "logN17_30")):
        rank(res, launches, sfx, f"{tag} main path:")
        rank(res, step, sfx, f"{tag} step:")
    for res, launches, sfx, tag in (
            (results15, eval15, "", "logN15"),
            (results17, eval17, "", "logN17"),
            (results15_30, eval15_30, "_30", "logN15_30"),
            (results17_30, eval17_30, "_30", "logN17_30")):
        rank(res, launches, sfx, f"{tag} evaluation path:")
    rank(results15, ext15, "", "logN15 extension path:")
    measured = {"": (results17, results15, "logN17", "logN15"),
                "_30": (results17_30, results15_30, "logN17_30",
                        "logN15_30")}
    kernels = []
    for key, (src, rep) in KERNELS.items():
        sfx = "_30" if key.endswith("_30") else ""
        name = key[: len(key) - len(sfx)]
        big, small, big_tag, small_tag = measured[sfx]
        res = big.get(name, small[name])
        entry = dict(name=key, route="cuda", source=src, replaces=rep,
                     launches=counts[key], **res,
                     shape=big_tag if name in big else small_tag)
        if name in big:
            entry[small_tag] = small[name]
        kernels.append(entry)
    kernels += [dict(name=key, route="cuda", source=src, replaces=rep,
                     launches=counts[key], **probe[key],
                     shape=list(fold_microbench.SHAPE))
                for key, (src, rep) in PROBE.items()]
    log(json.dumps({
        "card": smi, "batch": BATCH,
        "csprng": csprng, "logN14_digest_decrypt_max_err": err14,
        "logN15": {"step_ms": step_ms, "step_ms_per_ct": step_ms / BATCH,
                   "plain_step_ms": plain_step_ms,
                   "decrypt_max_err": err15, "route_ab": ab15,
                   "csprng_share": share15,
                   "evaluation": {"ops": evalres15, "ms": evaltimes15,
                                  "keys": evalkeys15}, **info15},
        "logN17": {"step_ms": step17_ms,
                   "step_ms_per_ct": step17_ms / BATCH,
                   "plain_step_ms": plain_step17_ms,
                   "decrypt_max_err": err17,
                   "switch_key_decrypt_max_err": err_sw,
                   "route_ab": ab17, "csprng_share": share17,
                   "evaluation": {"ops": evalres17, "keys": evalkeys17},
                   **info17},
        "logN15_30": {"step_ms": step15_30_ms,
                      "step_ms_per_ct": step15_30_ms / BATCH,
                      "plain_step_ms": plain_step15_30_ms,
                      "decrypt_max_err": err15_30, "route_ab": ab15_30,
                      "evaluation": {"ops": evalres15_30}, **info15_30},
        "logN17_30": {"step_ms": step17_30_ms,
                      "step_ms_per_ct": step17_30_ms / BATCH,
                      "plain_step_ms": plain_step17_30_ms,
                      "decrypt_max_err": err17_30, "route_ab": ab17_30,
                      "evaluation": {"ops": evalres17_30,
                                     "keys": evalkeys17_30},
                      **info17_30},
        "logN15_extensions": {"launches": {k: n for k, n in ext15.items()
                                           if n}, **extres15},
        "seconds": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
