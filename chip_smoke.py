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
   range, K4, K5 and K6) and the step's glue kernels (G1 ``rescale``, G2
   ``parts_digits``, G3 ``pdiv_p0``) at logN 4, 7 and 10 in both lanes,
   byte for byte against their plain versions (K6's 62-bit lane, whose
   sums are exact and reduced once, residue for residue with its outputs
   in [0, 2q); the same in 3, 6), K1 without entry also on
   the signed (negative) words of a rotated and of a conjugated secret
   key; and the SASS of the register-tiled core
   (``cuobjdump``): the instructions per butterfly of the inverse
   contiguous pass, of K5's and K6's contiguous passes and of the strided
   passes of K1/K3, K5 and K6 at logN 15 and 17, and of one step of the
   fold probe's REDC chain in each lane;
2d. the ChaCha20 CSPRNG on the card against the same generator on the
   CPU, with the logN15 and the logN17 engine's channel model and one
   (seed, nonce): ``randbytes`` and ``randint`` over the full q chain,
   ``discrete_gaussian(repeats=2)``, ``randround_batch`` and
   ``encrypt_noise_batch`` of 8, three successive calls each, byte for
   byte, then the states, the card's launches counted (R1-R4, the
   generator's own entry points); ms per draw on the card (CUDA events);
   then each CSPRNG kernel (R1 ``chacha_words``, R2 ``chacha_randint``,
   R3 ``chacha_dgauss``, R4 ``chacha_randround``, and R2 + R3 as
   ``encrypt_noise``) against its plain version on the card at its
   draw's shape, timed beside its bytes bound and its issue bound (SASS
   instructions a block, ``cuobjdump``, at 132 x 4 warp issues a cycle at
   the card's highest SM clock), and compared on edge counters (low words
   at 2^32 - 1 and 2^32 - 1 - k inc, high words at 2^32 - 1), moduli near
   2^62 and 2^30 and edge coefficients (fractions m / 2^32 and one ulp
   either side, halves, negatives, +-0), single and batch forms;
2e. the pinned digests: ``CkksEngine(preset, seed=1234, nonce=1)
   .encodecrypt(linspace(-1, 1))`` on the card hashes to
   ``ct_sha256_seed1234_nonce1`` of ``tests/golden/presets.json`` and
   decrypts below 1e-6, at logN14, logN15 and logN16;
2f. (run with phase 9's logN17 engine) the native host oracle
   (``utils/native.py``, exact ``__int128`` arithmetic): K1 -> mont_mult
   -> K2 on the card equals its negacyclic product for every prime of the
   logN17 chain, and R1's blocks on the card its ChaCha20 blocks;
3. at the logN15 step shapes (batch 8, 16/17/18 channels, N = 32768) hold
   each kernel against its plain torch version on the same card tensors —
   byte for byte, lazy outputs included (K6: see 2c) — and time both (the
   plain version by its one comparison call); K1 without entry, K2's
   "mont" and "exit" epilogues and K3 with one key are compared too.  The
   glue kernels G1-G3 (the rescale, the keyswitch digits, the P-division's
   special rows) and G4 (the engine's modular product by a column, add
   and subtract) run here too, timed beside their bytes bound, and are
   then compared on adversarial residues read through views: every kept
   row below a rescaler of q - 1, rows at 0 and q - 1, rescalers at
   round_at and either side of it, both roundings, a part's rows of the
   level's and an accumulator's special rows (the same in 6, 10, 11);
3b. the stacked linear op's matrix product (``matmul``, csrc/matmul.cu)
   at the feed-forward layer's shapes, in both lanes (Preset.logN15 and
   logN15_30): 768 inputs to a block of 512 intermediate features at
   level 0 (17 channels) and the down product's 512 to 768 at level 2,
   random residues, weights drawn as BERT-base's and encoded by the
   engine (five bytes in the 62-bit lane).  The kernel's output, and the
   same call adding into an accumulator, against ``matmul_plain`` on the
   CPU byte for byte in three 64-coefficient column tiles of every row
   (every channel and output tile); its time beside ``bound_ms``, the
   least time of ``fhebench/roofline/ffn.py``'s count (int8 tensor-core
   ceiling at the card's highest SM clock, or bytes at the HBM rate); the
   engagement counters' int8 products a modular product
   (``ops/matmul.py``) beside the roofline's count; phase 2 prints
   ptxas's registers and spills of every ``matmul_k`` instantiation, and
   the 62-bit lane's at five bytes a weight (the cell's) must not spill;
4. drive the main path at Preset.logN15 on the card: keygen,
   ``encodecrypt_batch`` of 8 messages twice, the fused cc_mult step on
   the batch (all keyswitch parts in one kernel), ``decryptcode_batch``;
   the decrypt error must stay below 1e-6 and every kernel of the path
   must have launched; keygen must have drawn through R2 and R3 and the
   batch encrypts through R2, R3 and R4, and a draw on the card through
   the plain torch word path fails the phase (the same holds in 7, 10,
   11, key creation and the draw shares).  Then, from the CSPRNG state
   before the batch
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
   with every wrapper (K1-K6, G1-G3) swapped for its plain version (torch
   ops on the card); profile one step with
   torch.profiler: device time by kernel, and the device's busy share of
   that profiled step's wall time (the profiler slows the host, so this
   share is lower than an unprofiled step's); a seed-expanded evk
   (``a_seed``) through ``compress_ksk`` and ``expand_ksk`` gives back its
   bytes; then 5b; then the CSPRNG's share of keygen, of
   ``encodecrypt_batch`` and of the 14 Galois keys (its draws timed,
   synchronised, in a second keygen, batch and Galois set);
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
   launches): the cc_mult step through the all-parts kernel (one
   ``ntt_keymul_parts`` launch, no chain launch: the port keyswitches
   through K6 at every logN, where the JAX package takes its per-part
   chain from logN17 up), decrypt error below 1e-4 (the JAX package's
   logN17 bound); the step equals the plain-version step byte for byte;
8. logN17 ``switch_key``: a ciphertext under a second secret key switched
   to the engine's key (one K6, no chain) decrypts within 1e-6;
8b. logN17 evaluation: the rotation key for delta 1 and the conjugation
   key (a full Galois set, 16 keys of about 2 GiB, is left out), one
   ``rotate_offset(., 1)`` and one ``conjugate`` of the batch, each one K6
   and two K4, within 1e-4; the device memory the keys hold before and
   after their first use (the K6 key form adds only its pointer tables);
9. logN17 timing: the step with the kernels and with the plain versions,
   one profiled step, and the CSPRNG's share of keygen and of
   ``encodecrypt_batch``;
10. the 30-bit mode (int32 residues, R = 2^30) at "logN15_30" (19 primes):
    every 30-bit kernel (the ``_30`` lane) against its plain version at the
    step's shapes; the main path as in 4 (the step through the all-parts
    kernel, error below 1e-2, the JAX package's 30-bit bound), which must
    launch only ``_30`` kernels; the keys and the step on one pair equal
    to the CPU's; the evaluation path cut to ``rotate_offset`` by 2,
    ``add_scalar``, ``cc_sub``, ``mult_scalar`` and ``sum`` (within 5e-3,
    the JAX package's 30-bit
    preset bound, and ``sum`` 200x that), ``_30`` kernels only; step
    times with the kernels and
    the plain versions, printed beside phase 5's 62-bit logN15 step; one
    profiled step; the CSPRNG's share of keygen and of
    ``encodecrypt_batch``;
11. "logN17_30" (17 primes): the 30-bit kernels at the step's shapes; the
    main path through the all-parts kernel (one ``ntt_keymul_parts_30``
    launch, no chain launch; error below 1e-2); the evaluation as in 8b,
    within 5e-3; the step equal to the plain-version step; one profiled
    step; the CSPRNG's share as in 10;
11b. Preset.logN16 (4 special primes): keygen, ``encodecrypt_batch`` of
    8 twice, the fused step through the all-parts kernel (launches
    counted from 0), its decrypt error below 1e-6, its time and peak
    device memory, and its bytes equal to the plain-version step's;
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
    5e-4), its forward times, its rotation keys' memory, and what their
    K6 key forms hold after first use (pointer tables only);
    ``HELayerNormFeatureWise`` (F 4, two Newton steps; within 5e-3);
    ``HEFeedForwardFeatureWise`` through ``CkksEngine.feed_forward`` at
    64 hidden and 1024 intermediate features (two blocks) and, on a
    logN15_30 engine, 16 and 64, its launches counted from that run
    alone (the matrix products exactly 2 a block, in the engine's lane;
    within 1e-6 and 5e-3 of the float forward); two
    MPC parties (collective encrypt and threshold decrypt, a collective
    rotation; within 5e-4; one share alone garbage; card == CPU); a
    ``trace.profile`` of one rotation holding its ``annotate`` names and
    K6's kernels; the CLI's ``list-benchmarks`` and ``benchmark --name
    single_pmult``.  Each cell ends by clearing the port's default-engine
    registry, which otherwise keeps every engine alive;
13. the mesh at Preset.logN15, batch 8, every shard on this one card
    (``make_mesh(devices=["cuda:0"] * D)``): rns 2, rns 4, rns 2 x coef 2
    and batch 2 x rns 2, keys laid out from the single-device engine's.
    The step at level 0 (its work level's 16 channels divide 2 and 4) runs
    per shard and equals the single-device step byte for byte; its kernel
    launches are counted and required (K5, K2, K3 and its chain form, K4
    where no coef axis), its collectives counted, its time (CUDA events,
    median of 3 loops of 3) and peak memory printed, labelled as shards
    sharing one card, not a scaling figure.  switch_key, relinearize and
    rotate_single at level 1 equal the single-device ops with the special
    rows replicated and scattered (``TIBERATE_SCATTER_SPECIAL``);
    switch_key at level 0 (17 channels) takes the gathered route, counted.
    Then the coefficient-sharded NTT and iNTT at logN15 over coef 2 and 4
    (K1 and K2 on the local stages) against K1 and K2 unsharded;
14. two processes (this script with ``--multihost-child``) share cuda:0
    over gloo: ``init_multihost``, same-seed keys equal across them,
    ``broadcast_key`` of an evk only rank 0 holds, ``scatter_batch`` of
    four pairs each, one mesh step (batch 2 x rns 2) with the broadcast
    key; rank 0 holds every process's step bytes to a single-process
    engine.  A failing child fails the phase.

Each kernel has two bounds (``tiberate_tpu_torch/ops/roofline.py``): the
time its bytes take at the H100's datasheet HBM rate (every input read
once, the output written once), and the time its REDCs, counted from its
source at the shape of the call, take at the REDC rate of its lane that
phase 2b measured on this card (the CSPRNG's kernels: their SASS
instructions at the card's warp-issue rate, phase 2d).  ``bound_ms`` is
the larger; ``bound_by`` says which ("bytes" or "operations").  Before
the JSON lines, the kernels of each driven path are ranked by launches x
(time - bound) (the CSPRNG's at the logN15 and logN17 draws, on the
62-bit main paths), once with the launches of the whole path, once with
the step's and once
with the evaluation path's (and the extension path's and the mesh
paths' at logN15).  The
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
# The step's glue kernels (G1-G3, csrc/glue.cu) have no Pallas
# counterpart: XLA fuses that glue inside the JAX package's jitted step.
# Each replaces the JAX function named here, in both lanes.
_GLUE = {"rescale": 527, "parts_digits": 236, "pdiv_p0": 279}
GLUE = tuple(_GLUE)
# G4 (csrc/glue.cu) replaces the JAX engine's elementwise cores, which the
# step does not run (the evaluation and extension paths do)
_MODEW = {"mont_scalar": 602, "mod_add": 544, "mod_sub": 549}
KERNELS = {
    **{name + sfx: (f"tiberate_tpu_torch/csrc/{src}",
                    f"{_PALLAS}:{line30 if sfx else line}")
       for sfx in ("", "_30")
       for name, (src, line, line30) in _SOURCES.items()},
    **{name + sfx: ("tiberate_tpu_torch/csrc/glue.cu",
                    f"tiberate_tpu/engine/ckks_engine.py:{line}")
       for sfx in ("", "_30")
       for name, line in (_GLUE | _MODEW).items()},
}
# The CSPRNG's kernels (R1-R4, csrc/csprng.cu; one lane) have no Pallas
# counterpart either: XLA fuses the JAX package's jitted block function
# and samplers.  Each replaces the JAX function named here.
_CSPRNG = {"chacha_words": 196, "chacha_randint": 80, "chacha_dgauss": 107,
           "chacha_randround": 202}
CSPRNG = tuple(_CSPRNG)
KERNELS.update({name: ("tiberate_tpu_torch/csrc/csprng.cu",
                       f"tiberate_tpu/rng/csprng.py:{line}")
                for name, line in _CSPRNG.items()})
# The stacked linear op's matrix product (csrc/matmul.cu) replaces no TPU
# kernel: the JAX package has no stacked linear op.
KERNELS.update({"matmul" + sfx: ("tiberate_tpu_torch/csrc/matmul.cu",
                                 "none (no JAX counterpart)")
                for sfx in ("", "_30")})
# the kernels keygen draws with (sk, pk, evk: R2, R3), and those
# encodecrypt_batch draws with (R4, and R2 + R3 for the noise)
KEYGEN_DRAWS = ("chacha_randint", "chacha_dgauss")
ENCRYPT_DRAWS = ("chacha_randint", "chacha_dgauss", "chacha_randround")
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
           "ntt_keymul_parts", *GLUE)
STEP_15 = ("intt", "intt_pdiv", "ntt_tensor", "ntt_keymul_parts", *GLUE)
# every preset keyswitches through K6; the per-part chain runs only on the
# mesh paths (phase 13)
PATH_17 = PATH_15
STEP_17 = STEP_15
# the kernels the logN15 evaluation path launches (phase 5b): keys (K1, K2),
# pc_mult (K3 and its K1 cache), keyswitches (K6, K4, the digits G2 and
# the special rows G3), square (K5), the rescales (G1)
EVAL_15 = ("ntt", "intt", "ntt_keymul", "intt_pdiv", "ntt_tensor",
           "ntt_keymul_parts", *GLUE)
# the kernels the logN15 extension path launches (phase 12): rotation and
# MPC keys (K1, K2), pc_mult and decrypts (K3), keyswitches (K6, K4),
# cc_mult (K5), the feed-forward layer's matrix products in both lanes
EXT_15 = (*EVAL_15, "matmul", "matmul_30")


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
    """Route every kernel wrapper (K1-K6 and the glue's G1-G3) to its
    plain version (for timing the step without the kernels); restored on
    exit."""
    from tiberate_tpu_torch.ops import glue_kernels as glue

    saved = [(mod, name, getattr(mod, name)) for mod in (kern, glue)
             for name in mod.WRAPPERS]
    try:
        for mod, name, _ in saved:
            setattr(mod, name, getattr(mod, name + "_plain"))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def uniform(gen, q, shape):
    """Residues uniform in [0, q_c) per channel, drawn on the card, in the
    dtype of q (int64 or int32); q: [C] tensor on the card."""
    x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                      device=q.device)
    return (x % q.long()[:, None]).to(q.dtype)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def part_keys(kern, gen, q0, n_parts, N, level=1):
    """K6's key operand as the engine hands it over: per part, (k0, k1)
    views of the ``level``'s rows of a level-0 key [len(q0), N] (read in
    place, not stacked), and their pointer tables."""
    keys = tuple(tuple(uniform(gen, q0, (len(q0), N))[level:]
                       for _ in range(2))
                 for _ in range(n_parts))
    return keys, kern.key_tables(keys)


def glue_adversarial(eng, glue, gen):
    """{case: (kernel output, plain output)} of G1-G4 at the step's
    shapes on adversarial residues: every kept row below a rescaler of
    q - 1, rows at 0 and q - 1, rescalers at round_at and either side of
    it, both roundings; digits and special rows at 0 and q - 1.  Each
    operand is a view, as the engine passes it: the rescaler and rows of
    one tensor, a part's rows of the level's, an accumulator's special
    rows."""
    dev = eng.device
    lp0, lp1, lp_sp = eng._lp(0, False), eng._lp(1, False), eng._lp(1, True)
    C, S, N = lp1.num_channels, eng.params.S, eng.ckksCfg.N
    q0, q1, q_sp = lp0.pack.q, lp1.pack.q, lp_sp.pack.q
    round_at = eng.params.q[0] // 2
    d = uniform(gen, q0, (BATCH, C + 1, N))
    d[:, 0, : N // 2] = q0[0] - 1
    d[:, 1:, : N // 4] = 0
    d[:, 1:, N // 4 : N // 2] = torch.minimum(q1 - 1, q0[0] - 2)[:, None]
    d[:, 0, N // 2 :] = torch.tensor(
        [round_at - 1, round_at, round_at + 1, int(q0[0]) - 1],
        dtype=d.dtype, device=dev).repeat(N // 8)
    a = uniform(gen, q1, (BATCH, C, N))
    a[..., ::2] = (q1 - 1)[:, None]
    a[..., 1::4] = 0
    acc = uniform(gen, q_sp, (BATCH, C + S, N))
    acc[:, C:, ::2] = (q_sp[C:] - 1)[:, None]
    acc[:, C:, 1::4] = 0
    parts = eng.params.parts[1]
    amax = max(p.alpha for p in parts)
    rs = eng.params.rescale_scales[0]
    cases = {}
    for exact in (True, False):
        args = (d[:, 0:1], d[:, 1:], rs, lp1, round_at, exact)
        cases[f"rescale exact={exact}"] = (glue.rescale(*args),
                                           glue.rescale_plain(*args))
    cases["parts_digits"] = (glue.parts_digits(a, parts, lp1, amax),
                             glue.parts_digits_plain(a, parts, lp1, amax))
    for part in (parts[0], parts[-2], parts[-1]):
        args = (a[:, part.lo : part.hi], (part,), lp1[part.lo : part.hi],
                part.alpha, part.lo)
        cases[f"one part {part.lo}:{part.hi}"] = (
            glue.parts_digits(*args), glue.parts_digits_plain(*args))
    args = (acc[:, C:], lp_sp[C:], eng.params.PiRs[1], C, S)
    cases["pdiv_p0"] = (glue.pdiv_p0(*args), glue.pdiv_p0_plain(*args))
    # G4: every pair of the add and subtract operands 0, q - 1, q, 2q - 1
    # (one ciphertext against the batch too), and level_up's view of kept
    # rows by a column a ciphertext holding 0 and q - 1
    edges = torch.stack([torch.zeros_like(q1), q1 - 1, q1, 2 * q1 - 1], -1)
    e1, e2 = (uniform(gen, 2 * q1, (BATCH, C, N)) for _ in range(2))
    e1[..., :16] = edges.repeat(1, 4)
    e2[..., :16] = edges.repeat_interleave(4, -1)
    cases["mod_add edges"] = (glue.mod_add(e1, e2, lp1),
                              glue.mod_add_plain(e1, e2, lp1))
    cases["mod_sub edges, one against the batch"] = (
        glue.mod_sub(e1, e2[0], lp1), glue.mod_sub_plain(e1, e2[0], lp1))
    col = uniform(gen, q1, (BATCH, C, 1))
    col[0, :, 0] = q1 - 1
    col[1, :, 0] = 0
    cases["mont_scalar rows view, a column a ciphertext"] = (
        glue.mont_scalar(d[:, 1:], col, lp1),
        glue.mont_scalar_plain(d[:, 1:], col, lp1))
    return cases


def check_kernels(eng, kern, mod, roofline, tag, loops, redc_per_s):
    """Every kernel against its plain version at the step shapes of
    ``eng`` (batch 8, work level 1), in the lane of its storage dtype; the
    chain kernel with no skip range and with one part's range; the glue
    kernels G1-G4 on random residues, then on adversarial ones
    (:func:`glue_adversarial`), compared only.  ``loops``
    = (reps, inner) of cuda_ms for the kernels; each plain version, which
    repeats the kernel's arithmetic in torch ops and is no yardstick of
    speed, is timed by its one comparison call (CUDA events).  Each result
    carries its two bounds: the
    bytes of every input (data, twiddles, keys, constants) read once and
    every output written once, at the datasheet HBM rate, and its REDCs at
    the lane's measured rate ``redc_per_s``."""
    from tiberate_tpu_torch.ops import glue_kernels as glue

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
    pkeys, tables = part_keys(kern, gen, eng._lp(0, True).pack.q, n_parts,
                              N)
    d0 = uniform(gen, q0, (BATCH, C + 1, N))
    rs, round_at = eng.params.rescale_scales[0], eng.params.q[0] // 2
    cur = uniform(gen, q_sp[C:], (BATCH, S, N))
    col = uniform(gen, q_ord, (C, 1))
    lp_spec = lp_sp[C:]
    part_list = [p.alpha for p in parts]
    word = x.element_size()

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
            lambda: kern.ntt_keymul_parts(st, ec, alphas, pkeys, lp_sp,
                                          tables),
            lambda: kern.ntt_keymul_parts_plain(st, ec, alphas, pkeys,
                                                lp_sp)),
        "rescale": (
            lambda: glue.rescale(d0[:, :1], d0[:, 1:], rs, lp_ord, round_at),
            lambda: glue.rescale_plain(d0[:, :1], d0[:, 1:], rs, lp_ord,
                                       round_at)),
        "parts_digits": (
            lambda: glue.parts_digits(x, parts, lp_ord, amax),
            lambda: glue.parts_digits_plain(x, parts, lp_ord, amax)),
        "pdiv_p0": (
            lambda: glue.pdiv_p0(cur, lp_spec, PiRs, C, S),
            lambda: glue.pdiv_p0_plain(cur, lp_spec, PiRs, C, S)),
        "mont_scalar": (lambda: glue.mont_scalar(x, col, lp_ord),
                        lambda: glue.mont_scalar_plain(x, col, lp_ord)),
        "mod_add": (lambda: glue.mod_add(x, x4[0], lp_ord),
                    lambda: glue.mod_add_plain(x, x4[0], lp_ord)),
        "mod_sub": (lambda: glue.mod_sub(x, x4[1][0], lp_ord),
                    lambda: glue.mod_sub_plain(x, x4[1][0], lp_ord)),
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
        "ntt_keymul_parts": nbytes(st, ec, alphas, *sum(pkeys, ()),
                                   tables.k0p, tables.k1p, lp_sp.psi,
                                   lp_sp.pack.q, lp_sp.pack.k, lp_sp.fold,
                                   ext, ext),
        "rescale": roofline.rescale_bytes(BATCH, C, N, word),
        "parts_digits": roofline.parts_digits_bytes(
            BATCH, part_list, amax, N, word,
            glue.digits_table(parts, lp_ord).numel()),
        "pdiv_p0": roofline.pdiv_p0_bytes(BATCH, S, N, word),
        "mont_scalar": roofline.mont_scalar_bytes(BATCH, C, N, word),
        "mod_add": roofline.mod_add_bytes(BATCH, C, N, word),
        # one ciphertext against the batch: batch stride 0
        "mod_sub": roofline.mod_add_bytes(BATCH, C, N, word, b_batch=1),
    }
    # REDCs each call's kernel performs (ops/roofline.py); K6's 62-bit
    # lane makes one a sum
    runs = lp_sp.sum_runs if x.dtype == torch.int64 else None
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
            BATCH, alphas.tolist(), C_sp, logN, runs),
        "rescale": roofline.rescale(BATCH * C, N),
        "parts_digits": roofline.parts_digits(BATCH, part_list, N),
        "pdiv_p0": roofline.pdiv_p0(BATCH, S, N),
        "mont_scalar": roofline.mont_scalar(BATCH * C, N),
        "mod_add": 0, "mod_sub": 0,
    }
    shapes = {"ntt": [BATCH, C, N], "intt": [BATCH, C, N],
              "ntt_keymul": [BATCH, C + 1, N], "intt_pdiv": [BATCH, C_sp, N],
              "ntt_tensor": [BATCH, C, N],
              "ntt_keymul_parts": [BATCH, n_parts, amax, N],
              "rescale": [BATCH, C + 1, N], "parts_digits": [BATCH, C, N],
              "pdiv_p0": [BATCH, S, N], "mont_scalar": [BATCH, C, N],
              "mod_add": [BATCH, C, N], "mod_sub": [BATCH, C, N]}
    results = {}
    for name, (kfn, pfn) in cases.items():
        got = kfn()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        want = pfn()
        stop.record()
        torch.cuda.synchronize()
        same = agrees(name, got, want, lp_sp)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if name == "ntt_keymul_parts" and got[0].dtype == torch.int64:
            # residues: the kernel's words differ from the plain chain's
            got, want = ((t % lp_sp.pack.q.long()[:, None] for t in u)
                         for u in (got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms = cuda_ms(kfn, *loops)
        plain_ms = start.elapsed_time(stop)
        shape = shapes.get(name, [BATCH, C_sp, N])
        b = roofline.bound(io[name], redc[name], redc_per_s)
        log(f"{tag} kernel {name}: input {shape} {str(x.dtype)[6:]} "
            f"agrees={same} max_abs_err={err} kernel {ms:.4f} ms, "
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
    adversarial = glue_adversarial(eng, glue, gen)
    torch.cuda.synchronize()
    for name, (got, want) in adversarial.items():
        if not torch.equal(got, want):
            raise AssertionError(f"{tag} {name} on adversarial residues "
                                 f"disagrees with its plain version")
    log(f"{tag} also byte-identical at these shapes: {', '.join(variants)}; "
        f"on adversarial residues and views: "
        f"{', '.join(adversarial)}")
    # K6's sums at these shapes: products added per reduction
    prods, reds = roofline.keymul_parts_sums(BATCH, alphas.tolist(), C_sp,
                                             N, runs)
    log(f"{tag} K6 sums: {prods} products in {reds} reductions "
        f"({prods / reds:.3f} a reduction; alphas {alphas.tolist()}, "
        f"C_sp {C_sp}, runs {runs})")
    results["ntt_keymul_parts"]["sums"] = dict(products=prods,
                                               reductions=reds)
    results["ntt_keymul_accum"]["with_skip"] = results.pop(skip_key)
    return results


# Phase 3b: the stacked linear op's matrix product at the feed-forward
# layer's shapes: (level, F_in, F_out) of BERT-base's up product (768 to a
# block of 512 intermediate features) and down product (512 to 768)
MATMUL_SHAPES = ((0, 768, 512), (2, 512, 768))
MATMUL_TILE = 64       # coefficients a block of the kernel owns
FFN_STD = 0.02         # BERT-base's initializer_range


def matmul_tiles(t, N):
    """Coefficient tiles 0, N / 2 and the last of every row of ``t`` [F,
    C, N], contiguous on the CPU."""
    cols = [slice(a, a + MATMUL_TILE)
            for a in (0, N // 2, N - MATMUL_TILE)]
    return torch.cat([t[..., c] for c in cols], dim=-1).cpu().contiguous()


def matmul_ptxas(build_log):
    """ptxas's account of each ``matmul_k`` instantiation in a verbose
    build's log: {(lane bits, L): registers, spill stores and loads,
    static shared memory}, from the chunk of the log that each entry
    function's "Compiling entry function" line opens."""
    out = {}
    for chunk in build_log.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'_Z\d+matmul_kI([xi])Li(\d)EE", chunk)
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        out[62 if name.group(1) == "x" else 30, int(name.group(2))] = dict(
            registers=int(regs.group(1)) if regs else None,
            spill_stores=int(spill.group(1)) if spill else None,
            spill_loads=int(spill.group(2)) if spill else None,
            smem=int(smem.group(1)) if smem else 0)
    return out


def matmul_phase(CkksEngine, preset, tag, smi, clock_hz):
    """3b: ``ops/matmul.matmul`` at MATMUL_SHAPES in one lane: random
    canonical residues, weights of N(0, FFN_STD^2) (the up product's times
    sqrt(0.125), as the layer folds the Quad's 0.125) encoded by the
    engine at the product's level; the output, and the same call into an
    accumulator holding it (twice it, mod q), against ``matmul_plain`` on
    the CPU byte for byte in three column tiles of every row; canonical.
    Timed (CUDA events) beside ``bound_ms`` from
    ``fhebench/roofline/ffn.py``.  Returns the last shape's result, with
    every shape's under ``shapes``."""
    from fhebench.roofline import ffn as ffn_roofline
    from tiberate_tpu_torch.ops import matmul as mm
    from tiberate_tpu_torch.ops import ntt_kernels as kern

    eng = CkksEngine(preset, device="cuda", seed=SEED)
    cfg = eng.ckksCfg
    primes = [int(q) for q in eng.params.q]
    P = len(primes) - cfg.num_special_primes
    sfx = "" if cfg.numpy_dtype == np.int64 else "_30"
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    shapes = {}
    for level, F_in, F_out in MATMUL_SHAPES:
        lp = eng._lp(level, False)
        q = lp.pack.q.long()[:, None]
        C, N = len(q), cfg.N
        x0, x1 = ((torch.randint(0, 1 << 62, (F_in, C, N), device="cuda",
                                 generator=gen) % q).to(lp.pack.dtype)
                  for _ in range(2))
        w = rng.normal(0.0, FFN_STD, (F_in, F_out))
        if level == 0:
            w *= math.sqrt(0.125)
        wl = eng.encode_matrix(w, level).limbs
        before = dict(kern.LAUNCHES)
        got = mm.matmul(x0, x1, wl, lp)
        acc = tuple(g.clone() for g in got)
        again = mm.matmul(x0, x1, wl, lp, acc=acc)
        torch.cuda.synchronize()
        counts = diff(kern, before)
        check(counts == {"matmul" + sfx: 2},
              f"{tag} matmul launches {counts}")
        t0 = time.perf_counter()
        lp_cpu = eng._lp(level, False).to("cpu")
        want = mm.matmul_plain(matmul_tiles(x0, N), matmul_tiles(x1, N),
                               wl.cpu(), lp_cpu)
        plain_s = time.perf_counter() - t0
        qc = q.cpu()
        same = all(torch.equal(matmul_tiles(g, N), w_)
                   and torch.equal(matmul_tiles(a, N),
                                   (2 * w_.long() % qc).to(w_.dtype))
                   for g, a, w_ in zip(got, again, want))
        canonical = all(bool(((g >= 0) & (g.long() < q)).all())
                        for g in got)
        del got, again, acc, want
        key = "matmul" + sfx
        i8, mod = mm.INT8_PRODUCTS[key], mm.MOD_PRODUCTS[key]
        mm.matmul(x0, x1, wl, lp)
        ratio = ((mm.INT8_PRODUCTS[key] - i8)
                 / (mm.MOD_PRODUCTS[key] - mod))
        ms = cuda_ms(lambda: mm.matmul(x0, x1, wl, lp))
        work = ffn_roofline.matmul(cfg.logN, primes, level, P, F_in, F_out,
                                   cfg.scale_bits)
        counted = work.int8 / (F_in * F_out * 2 * N * C)
        bound_ms = work.least_s(clock_hz) * 1e3
        res = dict(ms=ms, bound_ms=bound_ms, bound_by="int8 tensor cores"
                   if work.int8 / ffn_roofline.int8_ceiling(clock_hz)
                   >= work.nbytes / HBM_BYTES_PER_S else "bytes",
                   limbs=int(wl.shape[0]), same_bytes=same,
                   canonical=canonical, plain_s=plain_s,
                   int8_per_product=ratio, roofline_int8_per_product=counted,
                   dims=[level, F_in, F_out, C, N])
        shapes[f"level{level}_{F_in}x{F_out}"] = res
        log(f"{tag} matmul{sfx} level {level}, {F_in} -> {F_out} "
            f"ciphertexts ({C} channels, N {N}, {res['limbs']} limbs a "
            f"weight): same bytes as matmul_plain in 3 column tiles of "
            f"every row, with and without an accumulator: {same} (plain "
            f"{plain_s:.1f} s on the CPU); canonical {canonical}; "
            f"{ms:.3f} ms a call; bound {bound_ms:.3f} ms "
            f"({res['bound_by']}, roofline/ffn.py at "
            f"{clock_hz / 1e6:.0f} MHz), {100 * bound_ms / ms:.1f}% of the "
            f"bound ({smi}); int8 products a modular product "
            f"{ratio:.4f} issued (ops/matmul.py's counters), "
            f"{counted:.4f} counted (roofline/ffn.py at {cfg.scale_bits}-bit "
            f"weights)")
        check(same and canonical, f"{tag} matmul differs from its plain "
              f"version at level {level}, {F_in} x {F_out}")
        del x0, x1
    del eng
    return dict(res, shapes=shapes)


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


def agrees(name, got, want, lp_sp):
    """A kernel's outputs against its plain version's: byte for byte; K6
    (``ntt_keymul_parts``) in the 62-bit lane, whose sums are exact and
    reduced once, residue for residue with every word in [0, 2q) of the
    with-special channels of ``lp_sp``."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name != "ntt_keymul_parts" or got[0].dtype != torch.int64:
        return all(torch.equal(g, w) for g, w in zip(got, want))
    q = lp_sp.pack.q.long()[:, None]
    return all(bool(((g >= 0) & (g < 2 * q)).all())
               and torch.equal(g % q, w % q) for g, w in zip(got, want))


def check_small(kern, mod, CkksParams, toy_config):
    """Phase 2c: every entry of the two ntt.cu transforms, K5 (tensor.cu),
    K6 (keyswitch.cu) and the glue's G1-G4 (glue.cu) at logN 4, 7 and 10
    (odd and even logN: both splits L1 = L2 and L1 + 1 = L2), in both
    lanes, on a toy parameter set at batch 2, against its plain version
    byte for byte; K1 without entry also on the signed rows of a rotated
    and of a conjugated secret key.  Returns the number of cases."""
    from tiberate_tpu_torch.ops import glue_kernels as glue

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
            pkeys, tables = part_keys(kern, gen, tp.lp(0, True).pack.q,
                                      ec.shape[0], N)
            d0 = uniform(gen, tp.lp(0, False).pack.q, (2, C + 1, N))
            resc = (d0[:, :1], d0[:, 1:], tp.rescale_scales[0], lp,
                    tp.q[0] // 2)
            digits = (x, tp.parts[1], lp, ec.shape[-1])
            spec = (p0, lp_sp[C:], tp.PiRs[1], C, tp.S)
            col = uniform(gen, q, (2, C, 1))
            flat = torch.empty(2 * C * N + 1, dtype=x.dtype, device="cuda")
            shifted = flat[1:].view(2, C, N)    # G4's one-word path
            shifted.copy_(x)

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
                    kern.ntt_keymul_parts(st, ec, alphas, pkeys, lp_sp,
                                          tables),
                    kern.ntt_keymul_parts_plain(st, ec, alphas, pkeys,
                                                lp_sp)),
                "rescale": (glue.rescale(*resc), glue.rescale_plain(*resc)),
                "parts_digits": (glue.parts_digits(*digits),
                                 glue.parts_digits_plain(*digits)),
                "pdiv_p0": (glue.pdiv_p0(*spec), glue.pdiv_p0_plain(*spec)),
                "mont_scalar": (glue.mont_scalar(x, col, lp),
                                glue.mont_scalar_plain(x, col, lp)),
                "mod_add": (glue.mod_add(x, x4[0], lp),
                            glue.mod_add_plain(x, x4[0], lp)),
                "mod_sub against one": (glue.mod_sub(x, x4[1][0], lp),
                                        glue.mod_sub_plain(x, x4[1][0], lp)),
                "mod_sub misaligned": (glue.mod_sub(shifted, x4[2], lp),
                                       glue.mod_sub_plain(shifted, x4[2],
                                                          lp)),
            }
            torch.cuda.synchronize()
            for name, (got, want) in cases.items():
                if not agrees(name, got, want, lp_sp):
                    raise AssertionError(f"logN{logN} {lane}-bit {name} "
                                         f"disagrees with its plain version")
                n += 1
    return n


# pass kernel -> the lines one thread runs in the code its SASS holds: the
# contiguous passes (R = 8, 4 butterflies a stage) the inverse pass one
# line, the K6 pass its part loop's body once (one part), the K5 pass its
# four lines; the strided passes (R = 2^strided_rlog) one line, with the x
# R entry (K1, K5) or the extension's first digit and one iteration of its
# digit loop (K6) in the same code
PASS_SASS = {"inv_contig_k": (False, 1), "parts_contig_k": (False, 1),
             "tensor_contig_k": (False, 4), "fwd_strided_k": (True, 1),
             "parts_strided_k": (True, 1), "tensor_strided_k": (True, 1)}


def strided_rlog(L1, TC):
    """csrc/ntt.cuh's strided_rlog: TT_RLOG (3), or more where a block
    of TC columns would exceed TT_MAX_THREADS (512)."""
    r = min(3, L1)
    while (TC << (L1 - r)) > 512:
        r += 1
    return r


def pass_butterflies(name, lane, logN):
    """The butterflies one thread runs in a pass kernel's SASS
    (PASS_SASS)."""
    strided, lines = PASS_SASS[name]
    L1 = logN // 2
    if not strided:
        return lines * 4 * (logN - L1)
    TC = min(1 << (logN - L1), 128 // (8 if lane == 62 else 4))
    return lines * (1 << (strided_rlog(L1, TC) - 1)) * L1


def pass_sass(cuda_build):
    """{(kernel, lane, logN): (IMAD-class, all, butterflies)} for the
    passes of PASS_SASS at logN 15 and 17: their SASS instructions (loads,
    twiddle table, every butterfly, the exchanges, products and stores; NOP
    left out) and the butterflies one thread runs in that code.  None
    without ``cuobjdump``."""
    sass = cuda_build.sass(*(f"{k}I{w}Li{n}E" for k in PASS_SASS
                             for w in "xi" for n in (15, 17)))
    if sass is None:
        return None
    out = {}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*?(" + "|".join(PASS_SASS)
                     + r")I([xi])Li(1[57])E", block)
        if not m:
            continue
        ops = [op for op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
            block) if op != "NOP"]
        lane, logN = (62 if m.group(2) == "x" else 30), int(m.group(3))
        out[(m.group(1), lane, logN)] = (
            sum(op.startswith(("IMAD", "IMUL")) for op in ops), len(ops),
            pass_butterflies(m.group(1), lane, logN))
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
        name = name if name in CSPRNG else name + sfx
        n = launches[name]
        if n:
            res = res.get("with_skip", res)
            # a kernel faster than its bound loses nothing (the bound's
            # dependent-chain rate understates independent butterflies)
            rows.append((n * max(0.0, res["ms"] - res["bound_ms"]),
                         name, n, res))
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


@contextlib.contextmanager
def card_draws_only():
    """While active, a draw on a card generator that ran the plain torch
    word path (the block function of the CSPRNG's plain versions) raises;
    also a decorator."""
    from tiberate_tpu_torch.ops import csprng_kernels as ck
    from tiberate_tpu_torch.rng import csprng as rc

    plain = ck.chacha20_block

    def guarded(state):
        if state.device.type == "cuda":
            raise AssertionError("a draw on the card ran the plain torch "
                                 "word path")
        return plain(state)

    try:
        ck.chacha20_block = rc.chacha20_block = guarded
        yield
    finally:
        ck.chacha20_block = rc.chacha20_block = plain


def require(counts, names, what):
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing}")


def only_30(counts, what):
    """A 30-bit path launches no 62-bit kernel (the CSPRNG's kernels have
    one lane)."""
    wrong = [k for k, n in counts.items()
             if n and not k.endswith("_30") and k not in CSPRNG]
    if wrong:
        raise AssertionError(f"62-bit kernels launched on {what}: {wrong}")


def msgs(eng):
    """The main path's two batches of BATCH random messages (m1, m2) of
    ``eng``'s slot count."""
    rng = np.random.default_rng(SEED)
    return tuple(rng.uniform(-1, 1, (BATCH, eng.num_slots))
                 for _ in range(2))


@card_draws_only()
def drive(eng, kern, stack, unstack, tol, tag):
    """keygen, encodecrypt_batch of 8 messages twice, cc_mult on the batch,
    decryptcode_batch, with the launch counts set to 0 before and read
    after; the step's own counts separately; keygen must have drawn
    through R2 and R3, the batch encrypts through R2, R3 and R4, and no
    draw through the plain word path.  Then the single forms from the
    same CSPRNG state (:func:`single_forms`).  Returns (A, B, out,
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
    enc_counts = {k: before[k] - keygen_counts[k] for k in before}
    require(keygen_counts, KEYGEN_DRAWS, f"{tag} keygen")
    require(enc_counts, ENCRYPT_DRAWS, f"{tag} encodecrypt_batch")
    log(f"{tag} CSPRNG launches: keygen "
        f"{ {k: keygen_counts[k] for k in CSPRNG} }, encodecrypt_batch of "
        f"{BATCH} twice { {k: enc_counts[k] for k in CSPRNG} }")
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
                keygen_draw_launches={k: keygen_counts[k] for k in CSPRNG},
                encrypt_draw_launches={k: enc_counts[k] for k in CSPRNG},
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


def edge_states(states, inc, kmax):
    """``states`` with every second row's low counter at 2^32 - 1 or at
    2^32 - 1 - k inc or 2^32 - k inc (k <= kmax: each carries into word 13
    at a replica advance) and every seventh high counter at 2^32 - 1
    (word 13 wraps)."""
    m32 = 0xFFFFFFFF
    lows = [m32, *((m32 - k * inc) & m32 for k in range(kmax + 1)),
            *((m32 + 1 - k * inc) & m32 for k in range(1, kmax + 1))]
    s = states.clone()
    rows = torch.arange(0, s.shape[0], 2, device=s.device)
    s[rows, 12] = torch.tensor(lows, device=s.device)[rows % len(lows)]
    s[::7, 13] = m32
    return s


def edge_coefs(rng, shape):
    """f64 coefficients with fractions of exactly m / 2^32, one ulp either
    side and (2m + 1) / 2^33 (a half after the x 2^32), negatives, +-0."""
    c = rng.uniform(-2.0**40, 2.0**40, shape)
    whole = np.floor(rng.uniform(0, 2.0**20, shape))
    exact = whole + rng.integers(0, 1 << 32, shape) / 2.0**32
    c[:, 0::6] = exact[:, 0::6]
    c[:, 1::6] = np.nextafter(exact, np.inf)[:, 1::6]
    c[:, 2::6] = np.nextafter(exact, -np.inf)[:, 2::6]
    c[:, 3::6] = (whole + (2 * rng.integers(0, 1 << 32, shape) + 1)
                  / 2.0**33)[:, 3::6]
    c[:, 1::4] *= -1
    c[:, 5::24] = 0.0
    c[:, 11::24] = -0.0
    return c


def csprng_sass(cuda_build, depth):
    """{kernel: SASS instructions (NOP left out)} of R1-R4, R3 at the
    tree's ``depth``: one row's block function and samples (the replica
    loop's body, with the row's loads and counter store); None without
    ``cuobjdump``."""
    names = {"words_k": "chacha_words", "randint_k": "chacha_randint",
             f"dgauss_kILi{depth}E": "chacha_dgauss",
             "randround_k": "chacha_randround"}
    sass = cuda_build.sass(*names)
    if sass is None:
        return None
    out = {}
    for block in sass.split("Function : ")[1:]:
        for part, name in names.items():
            if part in block.split()[0]:
                out[name] = len([op for op in re.findall(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)", block) if op != "NOP"])
    return out


def max_sm_clock_hz():
    """The card's highest SM clock (nvidia-smi), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def csprng_kernels(gen, ck, roofline, q, coefs, sass, clock_hz, tag):
    """R1-R4 (and R2 + R3 of ``encrypt_noise``) against their plain
    versions on the card, each at its draw's shape in ``gen``'s channel
    model: R1 and R2 over the q chain's rows (pk / evk), R3 over one
    repeating channel (keygen's e), R2 + R3 for BATCH messages
    (``encrypt_noise_batch``), R4 over BATCH messages (``randround_batch``).
    Each is timed (CUDA events, median of 3 loops of 3 after a warm-up;
    the plain version 3 single calls) beside its bytes and issue bounds.
    Then each is compared, not timed, on edge counters (``edge_states``),
    moduli of both lanes near their tops and edge coefficients, in its
    single and its batch form."""
    L, inc, N = gen.L, gen.inc, gen.num_coefs
    rows_q, r_rep = len(q) * L, gen.repeating_start
    lo, hi, depth = gen._btree_lo, gen._btree_hi, gen.tree_depth
    qt = torch.tensor(q, device=gen.device)
    tree = nbytes(lo, hi)
    # name -> (wrapper, args, blocks = rows x replicas, base rows read,
    # rows stepped, sample bytes, other input bytes)
    cases = {
        "chacha_words": (ck.chacha_words, (0, rows_q, inc), rows_q, rows_q,
                         rows_q, rows_q * 128, 0),
        "chacha_randint": (ck.chacha_randint, (0, rows_q, qt, 0, inc),
                           rows_q, rows_q, rows_q, rows_q * 32,
                           nbytes(qt)),
        "chacha_dgauss": (ck.chacha_dgauss, (r_rep, r_rep + L, lo, hi,
                                             depth, inc), L, L, L, L * 32,
                          tree),
        "encrypt_noise": (ck.encrypt_noise, (r_rep, L, lo, hi, depth, 2,
                                             BATCH, inc), 3 * BATCH * L,
                          2 * L, 2 * L, 3 * BATCH * L * 32, tree + 8),
        "chacha_randround": (ck.chacha_randround, (0, coefs, inc),
                             BATCH * N // 16, N // 16, N // 16,
                             BATCH * N * 8, nbytes(coefs)),
    }
    res = {}
    for name, (fn, args, blocks, rows, stepped, out_b, in_b) in cases.items():
        plain = getattr(ck, name + "_plain")
        a, b = gen.states.clone(), gen.states.clone()
        got, want = fn(a, *args), plain(b, *args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(g, w) for g, w in zip(got, want)) and (
            torch.equal(a, b))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not same:
            raise AssertionError(f"{tag} {name} disagrees with its plain "
                                 f"version")
        ms = cuda_ms(lambda: fn(a, *args))
        plain_ms = cuda_ms(lambda: plain(b, *args), 3, 1)
        if name == "encrypt_noise":
            # R2 over L rows, R3 over 2 L, each for BATCH messages
            per = sum(sass[k] for k in ("chacha_randint", "chacha_dgauss")
                      ) / 2 if sass else None
        else:
            per = sass.get(name) if sass else None
        b_ = roofline.issue_bound(
            roofline.csprng_bytes(rows, stepped, out_b, in_b), blocks, per,
            clock_hz)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, rows=rows, blocks=blocks,
                         sass_per_block=per, **b_)
        log(f"{tag} {name}: byte-identical to its plain version, "
            f"{ms:.4f} ms (plain {plain_ms:.4f}); {blocks} blocks; bounds: "
            f"bytes {b_['bytes_bound_ms']:.4f} ms, issue "
            + ("not measured" if per is None else
               f"{b_['compute_bound_ms']:.4f} ms ({per:.0f} SASS a block)")
            + f"; share {b_['bound_ms'] / ms:.1%}")
    # the same kernels on edge counters, moduli and coefficients, both
    # batch forms: compared only
    m62, m30 = (1 << 62) - 57, (1 << 30) - 35
    edge_q = torch.tensor([m62, m30, (1 << 62) - 1, (1 << 30) - 1, 3, 2],
                          device=gen.device)
    rng = np.random.default_rng(SEED)
    checked = []
    for B in (1, BATCH):
        st = edge_states(gen.states, inc, 2 * B + 1)
        ec = torch.from_numpy(edge_coefs(rng, (B, N))).to(gen.device)
        edge = {
            "chacha_words": (ck.chacha_words, (0, 6 * L, inc)),
            "chacha_randint": (ck.chacha_randint, (0, 6 * L, edge_q, -1,
                                                   inc)),
            "chacha_dgauss": (ck.chacha_dgauss, (r_rep, r_rep + 2 * L, lo,
                                                 hi, depth, inc)),
            "encrypt_noise": (ck.encrypt_noise, (r_rep, L, lo, hi, depth, 2,
                                                 B, inc)),
            "chacha_randround": (ck.chacha_randround, (0, ec, inc)),
        }
        for name, (fn, args) in edge.items():
            a, b = st.clone(), st.clone()
            got, want = fn(a, *args), getattr(ck, name + "_plain")(b, *args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if not (all(torch.equal(g, w) for g, w in zip(got, want))
                    and torch.equal(a, b)):
                raise AssertionError(f"{tag} {name} on edge counters "
                                     f"(B = {B}) disagrees with its plain "
                                     f"version")
            checked.append(f"{name} (B = {B})")
    log(f"{tag} on edge counters, moduli near 2^62 and 2^30 and edge "
        f"coefficients, byte-identical to the plain versions: "
        f"{', '.join(checked)}")
    return res


def csprng_phase(Csprng, CkksConfig, presets, smi, kern, roofline,
                 cuda_build):
    """Phase 2d.  A generator on the card and one on the CPU with the
    channel model of each preset's engine and one (seed, nonce): each draw
    (``randbytes``, ``randint`` over the q chain, ``discrete_gaussian``,
    ``randround_batch``, ``encrypt_noise_batch``) three times in a row on
    both, byte for byte, then the states, the card's launches counted from
    0 (a path of the generator's own entry points); ms per draw on the
    card (CUDA events: median of 3 loops of 3 draws) beside its bytes
    bound (the base rows' states read once, their stepped counters and the
    samples written once); then the kernels against their plain versions
    (:func:`csprng_kernels`).  Returns ({preset: {draw: result}}, {preset:
    {kernel: result}}, the draws' launch counts)."""
    from tiberate_tpu_torch.ops import csprng_kernels as ck

    sass = None
    clock_hz = max_sm_clock_hz()
    results, kernels = {}, {}
    counts = dict.fromkeys(kern.LAUNCHES, 0)
    for preset in presets:
        cfg = CkksConfig.parse(preset)
        S = cfg.num_special_primes
        tag = f"logN{cfg.logN}"
        kw = dict(num_coefs=cfg.N, num_channels=[len(cfg.q) - S],
                  num_repeating_channels=max(S, 2), sigma=cfg.sigma,
                  seed=SEED, nonce=7)
        gpu, cpu = Csprng(**kw, device="cuda"), Csprng(**kw, device="cpu")
        if sass is None:
            sass = csprng_sass(cuda_build, gpu.tree_depth) or {}
            log("CSPRNG kernels' SASS instructions a block (cuobjdump): "
                + (", ".join(f"{k} {n}" for k, n in sass.items())
                   or "not measured") + f"; max SM clock "
                f"{clock_hz / 1e6:.0f} MHz ({smi})")
        coefs = np.random.default_rng(SEED).uniform(-2.0**40, 2.0**40,
                                                    (BATCH, cfg.N))
        L, L16 = gpu.L, cfg.N // 16
        # draw -> (call, base rows read, rows stepped, sample words[,
        # other input bytes])
        draws = {
            f"randbytes over the q chain ({len(cfg.q)} channels)": (
                lambda r: (r.randbytes(shares=len(cfg.q) - S, repeats=S),),
                len(cfg.q) * L, len(cfg.q) * L, len(cfg.q) * L * 16),
            f"randint over the q chain ({len(cfg.q)} channels)": (
                lambda r: (r.randint(amax=cfg.q, repeats=S),),
                len(cfg.q) * L, len(cfg.q) * L, len(cfg.q) * cfg.N),
            "discrete_gaussian(repeats=2)": (
                lambda r: (r.discrete_gaussian(repeats=2),), 2 * L, 2 * L,
                2 * cfg.N),
            f"randround_batch({BATCH})": (
                lambda r: (r.randround_batch(coefs),), L16, L16,
                BATCH * cfg.N, coefs.nbytes),
            f"encrypt_noise_batch({BATCH})": (
                lambda r: r.encrypt_noise_batch(BATCH), 2 * L, 2 * L,
                3 * BATCH * cfg.N),
        }
        for name, (fn, *_) in draws.items():
            t0 = time.perf_counter()
            for _ in range(3):
                kern.reset_launch_counts()
                got = fn(gpu)
                torch.cuda.synchronize()
                for k, n in kern.LAUNCHES.items():
                    counts[k] += n
                want = fn(cpu)
                if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                    raise AssertionError(f"{tag} CSPRNG {name} on the card "
                                         f"differs from the CPU's")
            log(f"{tag} CSPRNG {name}: card == CPU over 3 successive calls "
                f"({time.perf_counter() - t0:.1f} s with the CPU's)")
        if not torch.equal(gpu.states.cpu(), cpu.states):
            raise AssertionError(f"{tag} CSPRNG states differ after the "
                                 f"draws")
        res = {}
        for name, (fn, rows, stepped, words, *in_b) in draws.items():
            ms = cuda_ms(lambda fn=fn: fn(gpu))
            nbytes_ = roofline.csprng_bytes(rows, stepped, words * 8, *in_b)
            bound_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
            res[name] = dict(ms=ms, rows=rows, bytes=nbytes_,
                             bytes_bound_ms=bound_ms)
            log(f"{tag} CSPRNG {name}: {ms:.4f} ms per draw on the card, "
                f"{rows} base rows, bytes bound {bound_ms:.4f} ms ({smi})")
        results[tag] = res
        kernels[tag] = csprng_kernels(gpu, ck, roofline, cfg.q,
                                      torch.from_numpy(coefs).cuda(), sass,
                                      clock_hz, tag)
    return results, kernels, counts


def digest_phase(CkksEngine, typing):
    """Phase 2e.  The JAX package's pinned ciphertext digests (logN14,
    logN15, logN16) from the port's keygen, CSPRNG, codec and encrypt on
    the card.  Returns {preset: decrypt max error}."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    errs = {}
    for preset in ("logN14", "logN15", "logN16"):
        want = golden[preset]["ct_sha256_seed1234_nonce1"]
        t0 = time.perf_counter()
        eng = CkksEngine(preset, device="cuda", seed=1234, nonce=1)
        m = np.linspace(-1, 1, eng.num_slots)
        ct = eng.encodecrypt(m)
        h = hashlib.sha256()
        for d in ct.data:
            h.update(np.ascontiguousarray(d.cpu().numpy()).tobytes())
        err = float(np.abs(eng.decryptcode(ct, is_real=True) - m).max())
        log(f"{preset} seed 1234 nonce 1: ciphertext sha256 "
            f"{h.hexdigest()} == the pinned digest: {h.hexdigest() == want}; "
            f"decrypt max error {err:.3e} (limit {DECRYPT_TOL}); "
            f"{time.perf_counter() - t0:.1f} s with the engine's build")
        if h.hexdigest() != want:
            raise AssertionError(f"the {preset} ciphertext digest differs "
                                 f"from tests/golden/presets.json")
        if not err < DECRYPT_TOL:
            raise AssertionError(f"{preset} decrypt error above the limit")
        errs[preset] = err
        del eng, ct
        release_engines(typing)
    return errs


def oracle_phase(eng, kern, mont, native, ck):
    """Phase 2f.  The native host oracle (exact ``__int128`` arithmetic,
    no code shared with the kernels or their plain versions) against the
    card at the logN17 chain: for every prime, K1 (enter) of a and b,
    ``mont_mult``, K2 (exit_reduce) equals the oracle's negacyclic
    product; and R1's blocks on the card (``chacha_words``) equal the
    oracle's ChaCha20 blocks."""
    t0 = time.perf_counter()
    lp = eng._lp(0, True)
    rng = np.random.default_rng(SEED)
    a, b = (np.stack([rng.integers(0, q, eng.params.N) for q in eng.params.q])
            .astype(np.int64) for _ in range(2))
    ta, tb = (torch.from_numpy(x).cuda() for x in (a, b))
    got = kern.intt(mont.mont_mult(kern.ntt(ta, lp, enter=True),
                                   kern.ntt(tb, lp, enter=True), lp.pack),
                    lp, "exit_reduce").cpu().numpy()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    bad = [c for c, q in enumerate(eng.params.q)
           if not np.array_equal(got[c], native.negacyclic_mul(a[c], b[c], q))]
    t_oracle = time.perf_counter() - t0
    log(f"logN17 chain ({len(eng.params.q)} primes, N = {eng.params.N}): "
        f"K1 -> mont_mult -> K2 on the card == the native oracle's "
        f"negacyclic product for every prime: {not bad} (card path with "
        f"transfers {t_card:.1f} s, oracle {t_oracle:.1f} s on the host)")
    if bad:
        raise AssertionError(f"the card's NTT product differs from the "
                             f"oracle at primes {bad}")
    states = rng.integers(0, 2**32, (1 << 16, 16), dtype=np.uint32)
    states[::7, 12] = 0xFFFFFFFF
    rows = torch.from_numpy(states.astype(np.int64)).cuda()
    card = ck.chacha_words(rows, 0, rows.shape[0], 1).cpu().numpy()
    same = np.array_equal(card, native.chacha20_blocks(states)
                          .astype(np.int64))
    log(f"R1 (chacha_words) on the card == the native oracle's ChaCha20 "
        f"blocks on {states.shape[0]} states: {same}")
    if not same:
        raise AssertionError("the card's ChaCha20 blocks differ from the "
                             "oracle's")
    return dict(primes=len(eng.params.q), card_s=t_card, oracle_s=t_oracle,
                chacha_states=states.shape[0])


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


@card_draws_only()
def draw_share(eng, msgs, tag, galois=False):
    """The CSPRNG's share of keygen, of one ``encodecrypt_batch`` and
    (``galois``) of the Galois keys: each run again with every draw method
    timed (host clock, synchronised before and after each draw).
    Replaces the engine's keys."""
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

    runs = [("keygen", keygen), (f"encodecrypt_batch of {BATCH}",
                                  lambda: eng.encodecrypt_batch(msgs))]
    if galois:
        runs.append((f"{eng.ckksCfg.logN - 1} Galois keys",
                     lambda: eng._create_galois_key(eng.sk)))
    res = {}
    try:
        for name in names:
            setattr(rng, name, timed(getattr(rng, name)))
        for what, fn in runs:
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
    log(f"logN17 switch_key of 2 ciphertexts ({n_parts} parts): {t_sw:.3f} "
        f"s (first call), launches {counts}; decrypt max error under the "
        f"engine's key {err:.3e} (limit {DECRYPT_TOL})")
    keyswitch_launches(counts, 1, "logN17", "switch_key")
    if counts["ntt_keymul"]:
        raise AssertionError("switch_key launched K3")
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


def keyswitch_launches(counts, n, tag, name, sfx=""):
    """A keyswitched op's launches: ``n`` keyswitches through the all-parts
    kernel (one K6 and two K4 each, no chain; K3 may run besides, as
    mean's pc_mult)."""
    got = (counts["ntt_keymul_parts" + sfx], counts["intt_pdiv" + sfx],
           counts["ntt_keymul_accum" + sfx])
    want = (n, 2 * n, 0)
    if got != want:
        raise AssertionError(
            f"{tag} {name}: (K6, K4, chain) launches {got}, want {want}")


@card_draws_only()
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


def key_form_bytes(keys):
    """The bytes the all-parts key forms cached on ``keys`` hold beyond
    the keys themselves: their pointer tables (the forms' per-part views
    are the keys' own rows)."""
    return sum(nbytes(tables.k0p, tables.k1p) for k in keys
               for _, tables in (k.misc.get("_parts_tables") or {}).values())


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
    require(kern.LAUNCHES, ("ntt", "intt", *KEYGEN_DRAWS),
            f"{tag} key creation")

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


def evaluate_light(eng, kern, stack, unstack, A, tol, sfx, tag, large):
    """The evaluation path cut for the other presets, on the batch of 8
    with the launch counts set to 0 before and read after.  ``large``
    False (logN15_30): ``rotate_offset`` by 2, ``add_scalar``, ``cc_sub``,
    ``mult_scalar`` and ``sum`` (its 14 keys made on first use); True (logN17, logN17_30): the
    rotation key for delta 1 and the conjugation key, one
    ``rotate_offset(., 1)`` and one ``conjugate``, each one K6 and two K4,
    and the device memory the keys hold before and after that first use.
    Returns (launches, per-op results, key info)."""
    m1, m2 = msgs(eng)
    mc = m1 + 1j * m2
    C = stack(eng.encodecrypt_batch(mc)) if large else None
    kern.reset_launch_counts()
    keys = None
    if large:
        keys = make_keys(eng, tag, galois=False)[1]
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
            "cc_sub": (lambda: eng.cc_sub(A, A), 0 * m1, 0),
            "mult_scalar -1.5": (lambda: eng.mult_scalar(A, -1.5),
                                 -1.5 * m1, 0),
            "sum": (lambda: eng.sum(A), row, eng.ckksCfg.logN - 1),
        }
    res = {}
    gc.collect()
    torch.cuda.synchronize()
    mem_keys = torch.cuda.memory_allocated()
    for name, (fn, want, n_ks) in ops.items():
        limit = 200 * tol if name == "sum" else tol
        counts, err = run_op(eng, kern, fn, unstack, want, limit, name, tag,
                             is_real=name != "conjugate")[1:]
        if n_ks:
            keyswitch_launches(counts, n_ks, tag, name, sfx)
        res[name] = dict(max_abs_err=err, limit=limit, launches={
            k: v for k, v in counts.items() if v})
    if large:  # the ops' outputs are gone: what stays is what use kept
        gc.collect()
        torch.cuda.synchronize()
        used = torch.cuda.memory_allocated() - mem_keys
        kf = key_form_bytes([*map(eng.get_rotation_key, eng.rotk),
                             eng.conjk])
        keys.update(memory_after_first_use=used, key_form_bytes=kf)
        log(f"{tag} key memory: the keys' tensors "
            f"{keys['key_bytes'] / 2**30:.3f} GiB; device memory "
            f"{mem_keys / 2**30:.3f} GiB before their first use, "
            f"{(mem_keys + used) / 2**30:.3f} GiB after it ({used:+d} B; "
            f"the K6 key forms' pointer tables {kf} B)")
    launches = dict(kern.LAUNCHES)
    need = ("ntt", "intt", "intt_pdiv", "ntt_keymul_parts")
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
    # what else the first forward keeps: each key's K6 form per level it
    # ran at (cached on the key: views of the key's rows and their pointer
    # tables, which alone take memory) and the plaintext rows' caches.
    # Dropping the forms measures what they hold; the warm forward makes
    # them again.
    form_bytes = key_form_bytes(keys)
    torch.cuda.synchronize()
    mem_used = torch.cuda.memory_allocated()
    for k in keys:
        k.misc.pop("_parts_tables")
    torch.cuda.synchronize()
    form_mem = mem_used - torch.cuda.memory_allocated()
    log(f"{tag} key memory of the {len(keys)} rotation keys: "
        f"{(mem_used - form_mem) / 2**30:.4f} GiB allocated without their "
        f"K6 key forms, {mem_used / 2**30:.4f} GiB after their first use "
        f"(the forms hold {form_mem} B on the card, their pointer tables "
        f"{form_bytes} B)")
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
        f"{key_bytes / 2**30:.3f} GiB, their K6 key forms "
        f"{form_bytes} B (pointer tables), the plaintext rows' caches "
        f"{pt_bytes / 2**30:.3f} GiB; device memory +{mem / 2**30:.3f} "
        f"GiB over the first forward; warm launches {warm}; max error "
        f"{err:.3e} (limit {EXT_TOL_LINEAR})")
    check(err < EXT_TOL_LINEAR, f"{tag} linear error above the limit")
    return dict(dim=dim, rotations=rotations, first_forward_s=t_first,
                warm_forward_s=t_warm, rotation_keys=len(keys),
                key_bytes=key_bytes, key_form_bytes=form_bytes,
                key_form_memory=form_mem,
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


EXT_TOL_FFN = 1e-6    # a fresh ciphertext's; the cell reads ~1e-7


def ext_ffn(eng, kern, tag, smi, H, I, tol, sfx):
    """12.5b: ``HEFeedForwardFeatureWise`` through
    ``CkksEngine.feed_forward`` at H hidden and I intermediate features,
    drawn as BERT-base's (weights N(0, FFN_STD^2), biases U(-0.1, 0.1))
    over LayerNorm outputs: a first forward encodes the weights, then the
    launches of the second alone are counted (the matrix products exactly
    2 a block of ``layer.blocks``, in the lane ``sfx`` only), its time
    taken and its output decrypted within ``tol`` of the float forward,
    three levels down."""
    from tiberate_tpu_torch.engine import (
        stack_ciphertexts,
        unstack_ciphertext,
    )

    rng = np.random.default_rng(SEED)
    w1 = rng.normal(0.0, FFN_STD, (H, I))
    w2 = rng.normal(0.0, FFN_STD, (I, H))
    b1, b2 = rng.uniform(-0.1, 0.1, I), rng.uniform(-0.1, 0.1, H)
    z = rng.standard_normal((H, eng.num_slots))
    z = (z - z.mean(axis=0)) / z.std(axis=0)
    x = (rng.uniform(0.5, 1.5, H)[:, None] * z
         + rng.uniform(-0.5, 0.5, H)[:, None])
    X = stack_ciphertexts(eng.encodecrypt_batch(list(x)))
    layer = eng.feed_forward(w1, b1, w2, b2)
    layer(X)
    torch.cuda.synchronize()
    before = dict(kern.LAUNCHES)
    t0 = time.perf_counter()
    out = layer(X)
    torch.cuda.synchronize()
    t_ffn = time.perf_counter() - t0
    counts = diff(kern, before)
    blocks = layer.blocks(X.level)
    mm = {k: v for k, v in counts.items() if k.startswith("matmul")}
    got = np.stack([eng.decryptcode(c, is_real=True)
                    for c in unstack_ciphertext(out)])
    h = w1.T @ x + b1[:, None]
    want = x + w2.T @ (0.125 * h * h + 0.25 * h + 0.5) + b2[:, None]
    err = float(np.abs(got - want).max())
    log(f"{tag} HEFeedForwardFeatureWise H {H}, I {I} ({len(blocks)} "
        f"blocks): output level {out.level}, {t_ffn:.3f} s (host clock, "
        f"synchronised; {smi}), matrix products {mm}, launches {counts}; "
        f"max error {err:.3e} (limit {tol})")
    check(mm == {"matmul" + sfx: 2 * len(blocks)},
          f"{tag} feed-forward matrix products {mm}, want "
          f"{2 * len(blocks)} of matmul{sfx}")
    check(out.level == X.level + 3, f"{tag} feed-forward level {out.level}")
    check(err < tol, f"{tag} feed-forward error above the limit")
    return dict(seconds=t_ffn, hidden=H, intermediate=I,
                blocks=len(blocks), level=out.level, max_abs_err=err,
                limit=tol, launches=counts)


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
    res["ffn"] = ext_ffn(eng, kern, tag, smi, 64, 1024, EXT_TOL_FFN, "")
    eng30 = CkksEngine("logN15_30", device="cuda", seed=SEED)
    res["ffn_30"] = ext_ffn(eng30, kern, "logN15_30 extensions", smi, 16,
                            64, DECRYPT_TOL_30_OP, "_30")
    del eng30
    res["mpc"] = ext_mpc(Preset, kern, tag)
    res["trace"] = ext_trace(eng, trace, ct1, tag)
    res["cli"] = ext_cli(tag)
    launches = dict(kern.LAUNCHES)
    require(launches, EXT_15, "the logN15 extension path")
    log(f"{tag} path launches {launches}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"{tag}: phase 12 took {res['seconds']:.1f} s")
    return launches, res


# ----------------------------------------------------------------------
# Phase 13: the mesh at logN15 on the one card; phase 14: two processes.
# ----------------------------------------------------------------------

MESHES = (("rns2", dict(rns=2)), ("rns4", dict(rns=4)),
          ("rns2_coef2", dict(rns=2, coef=2)),
          ("batch2_rns2", dict(batch=2, rns=2)))
# the kernels the mesh step launches on each shard's rows: G1 (the
# shard's rows of the rescale), K5, K2, G2 (the digits, replicated), K3
# (the first part two-key, the chain's accumulate form after it), G3 and
# K4 (its ordinary rows); with a coef axis the local stages run on K5, K3
# and K2 and the P-division's ordinary rows as torch ops (no K4)
MESH_STEP = ("ntt_tensor", "intt", "ntt_keymul", "ntt_keymul_accum",
             "intt_pdiv", *GLUE)
MESH_STEP_COEF = ("ntt_tensor", "intt", "ntt_keymul", "ntt_keymul_accum",
                  *GLUE)
SHARED = "shards sharing one card, not a scaling figure"


def same_bytes(got, want):
    from tiberate_tpu_torch.parallel.mesh import ShardedArray

    return all(torch.equal(g.gather() if isinstance(g, ShardedArray) else g,
                           w) for g, w in zip(got.data, want.data))


def mesh_config(CkksEngine, Preset, kern, meshlib, ref, refs, name, axes,
                smi):
    """One mesh of phase 13: the step at level 0 (launches and collectives
    counted, bytes against the single-device engine, ms per step, peak
    memory), then switch_key, relinearize and a rotation at level 1 with
    the special rows replicated and scattered, and switch_key at level 0
    (17 channels: the gathered route)."""
    A, B, want, trip, rotk = (refs[k] for k in ("A", "B", "out", "trip",
                                                "rotk"))
    D = math.prod(axes.values())
    tag = f"logN15 mesh {name} ({D} {SHARED})"
    mesh = meshlib.make_mesh(devices=["cuda:0"] * D, **axes)
    eng = CkksEngine(Preset.logN15, seed=SEED, mesh=mesh)
    eng.sk = eng.to_mesh(ref.sk)
    eng.evk = eng.to_mesh(ref.evk)
    eng.rotk = {1: eng.to_mesh(rotk)}
    Am, Bm = eng.to_mesh(A), eng.to_mesh(B)

    mesh.reset_counts()
    out, counts = count_launches(kern, lambda: eng.cc_mult(Am, Bm))
    coll = dict(mesh.counts)
    require(counts, MESH_STEP_COEF if "coef" in axes else MESH_STEP,
            f"the {name} mesh step")
    check("cc_mult" not in eng.gathered_ops and out.data[0].spec[-2] ==
          "rns", f"{tag}: the step did not run per shard")
    check(same_bytes(out, want), f"{tag}: step differs from one device")
    ms = cuda_ms(lambda: eng.cc_mult(Am, Bm), reps=3, inner=3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng.cc_mult(Am, Bm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: step at level 0 == the single-device step byte for byte; "
        f"launches {({k: n for k, n in counts.items() if n})}; collectives "
        f"{coll}; {ms:.3f} ms/step (CUDA events, median of 3 loops of 3), "
        f"peak device memory {peak / 2**30:.3f} GiB (resident before "
        f"{base / 2**30:.3f} GiB) ({smi})")
    profile_step(lambda: eng.cc_mult(Am, Bm), tag, top=8)

    ops = {}
    for scatter in ("0", "1"):
        os.environ["TIBERATE_SCATTER_SPECIAL"] = scatter
        try:
            mesh.reset_counts()
            got, op_counts = count_launches(kern, lambda: (
                eng.switch_key(out, eng.evk),
                eng.relinearize(eng.to_mesh(trip)),
                eng.rotate_single(out, eng.rotk[1])))
        finally:
            del os.environ["TIBERATE_SCATTER_SPECIAL"]
        for g, k in zip(got, ("switch_key", "relinearize", "rotate")):
            check(same_bytes(g, refs[k]), f"{tag} scatter={scatter}: {k} "
                  f"differs from one device")
        check(not {"switch_key", "relinearize"} & set(eng.gathered_ops),
              f"{tag}: a level-1 keyswitch took the gathered route")
        ops["scatter" if scatter == "1" else "replicated"] = dict(
            collectives=dict(mesh.counts),
            launches={k: n for k, n in op_counts.items() if n})
        log(f"{tag} level 1, special rows "
            f"{'scattered' if scatter == '1' and 'coef' not in axes else 'replicated'}"
            f": switch_key, relinearize, rotate_single byte-identical; "
            f"collectives {dict(mesh.counts)}; launches "
            f"{({k: n for k, n in op_counts.items() if n})}")
    got0 = eng.switch_key(Am, eng.evk)
    check(same_bytes(got0, refs["switch_key0"])
          and eng.gathered_ops.get("switch_key") == 1,
          f"{tag}: level-0 switch_key (17 channels) did not take the "
          f"gathered route or differs")
    log(f"{tag} level 0 (17 channels): switch_key took the gathered route "
        f"({eng.gathered_ops}), byte-identical")
    return counts, dict(step_ms=ms, step_ms_per_ct=ms / BATCH,
                        peak_bytes=peak, resident_bytes=base,
                        collectives=coll,
                        launches={k: n for k, n in counts.items() if n},
                        level1=ops, gathered=dict(eng.gathered_ops),
                        shards=D, note=f"{D} {SHARED}")


def mesh_phase(CkksEngine, Preset, kern, typing, stack, smi):
    """Phase 13: the mesh at Preset.logN15, batch 8, every shard on
    cuda:0 (rns 2, rns 4, rns 2 x coef 2, batch 2 x rns 2), each held byte
    for byte to the single-device engine; then the coefficient-sharded
    NTT (K1 on the local stages) at logN15 against K1 unsharded.  Returns
    (launches of the mesh paths, results)."""
    from tiberate_tpu_torch.parallel import coef_sharded
    from tiberate_tpu_torch.parallel import mesh as meshlib

    t_phase = time.perf_counter()
    ref = CkksEngine(Preset.logN15, device="cuda", seed=SEED)
    ref.sk, ref.pk, ref.evk  # noqa: B018 — keygen
    m1, m2 = msgs(ref)
    refs = dict(A=stack(ref.encodecrypt_batch(m1)),
                B=stack(ref.encodecrypt_batch(m2)), rotk=ref.rotk[1])
    refs["out"] = ref.cc_mult(refs["A"], refs["B"])
    refs["trip"] = ref.cc_mult(refs["out"], refs["out"], pre_rescale=False,
                               post_relin=False)
    refs["switch_key"] = ref.switch_key(refs["out"], ref.evk)
    refs["relinearize"] = ref.relinearize(refs["trip"])
    refs["rotate"] = ref.rotate_single(refs["out"], refs["rotk"])
    refs["switch_key0"] = ref.switch_key(refs["A"], ref.evk)
    ref_ms = cuda_ms(lambda: ref.cc_mult(refs["A"], refs["B"]), reps=3,
                     inner=3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref.cc_mult(refs["A"], refs["B"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"logN15 single-device step for the mesh comparison: {ref_ms:.3f} "
        f"ms/step, peak device memory {peak / 2**30:.3f} GiB (resident "
        f"before {base / 2**30:.3f} GiB) ({smi})")
    profile_step(lambda: ref.cc_mult(refs["A"], refs["B"]),
                 "logN15 single-device step (mesh comparison)", top=8)
    launches = dict.fromkeys(kern.LAUNCHES, 0)
    res = dict(single_device_step_ms=ref_ms, single_device_peak_bytes=peak,
               single_device_resident_bytes=base)
    for name, axes in MESHES:
        counts, res[name] = mesh_config(CkksEngine, Preset, kern, meshlib,
                                        ref, refs, name, axes, smi)
        for k in launches:
            launches[k] += counts[k]
        release_engines(typing)
        gc.collect()

    lp = ref._lp(0, True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = uniform(gen, lp.pack.q, (BATCH, lp.num_channels, ref.params.N))
    want_f = kern.ntt(x, lp, enter=False)
    want_rt = kern.intt(want_f, lp, "mont")
    for D in (2, 4):
        mesh = meshlib.make_mesh(devices=["cuda:0"] * D, rns=1, coef=D)
        ntt_fn, intt_fn = coef_sharded.make_coef_sharded_ntt(lp, 15, mesh)
        xs = meshlib.ShardedArray.from_tensor(x, mesh, (None, None, "coef"))
        (got, rt), counts = count_launches(
            kern, lambda: (lambda f: (f, intt_fn(f)))(ntt_fn(xs)))
        require(counts, ("ntt", "intt"), f"the coef-sharded NTT at D={D}")
        check(torch.equal(got.gather(), want_f)
              and torch.equal(rt.gather(), want_rt),
              f"coef-sharded NTT at D={D} differs from K1 / K2 unsharded")
        for k in launches:
            launches[k] += counts[k]
        log(f"logN15 coef-sharded NTT and iNTT, [{BATCH}, "
            f"{lp.num_channels}, 2^15] over coef {D} ({D} {SHARED}): "
            f"byte-identical to K1 / K2 unsharded, local stages on K1 x"
            f"{counts['ntt']} and K2 x{counts['intt']}, "
            f"collectives {mesh.counts}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"logN15 mesh: phase 13 took {res['seconds']:.1f} s")
    del ref, refs
    return launches, res


def multihost_child(rank, world, port, outdir):
    """One process of phase 14 (``chip_smoke.py --multihost-child``)."""
    import torch.distributed as dist

    from tiberate_tpu_torch import Preset
    from tiberate_tpu_torch.engine import CkksEngine
    from tiberate_tpu_torch.ops import ntt_kernels as kern
    from tiberate_tpu_torch.parallel import multihost as mh
    from tiberate_tpu_torch.parallel import sharded
    from tiberate_tpu_torch.typing import EvaluationKey

    tag = f"multihost rank {rank}/{world}"
    check(mh.init_multihost(f"localhost:{port}", world, rank,
                            backend="gloo") == (rank, world), tag)
    mesh = mh.global_mesh(rns=2, devices=["cuda:0"] * 2)
    eng = CkksEngine(Preset.logN15, seed=SEED, mesh=mesh)
    sk, pk, evk = eng.sk, eng.pk, eng.evk
    pk0 = pk.data[0].gather().cpu()
    every = [torch.empty_like(pk0) for _ in range(world)]
    dist.all_gather(every, pk0)
    check(all(torch.equal(p, pk0) for p in every),
          f"{tag}: same-seed keys differ across processes")
    real = [tuple(k.gather() for k in part) for part in evk.data]
    held = real if rank == 0 else [tuple(torch.zeros_like(k) for k in part)
                                   for part in real]
    t0 = time.perf_counter()
    bcast = mh.broadcast_key(held, from_process=0, device="cuda:0")
    t_bcast = time.perf_counter() - t0
    check(all(torch.equal(x, y) for p, r in zip(bcast, real)
              for x, y in zip(p, r)), f"{tag}: broadcast_key")
    bkey = EvaluationKey(data=tuple(bcast), flags=evk._flags, level=0,
                         **evk.misc)
    rng = np.random.default_rng(SEED + rank)
    cts = eng.encodecrypt_batch(list(rng.uniform(-1, 1, (BATCH,
                                                         eng.num_slots))))
    rows = [tuple(d.gather() for d in ct.data) for ct in cts]
    half = BATCH // 2
    a0, a1 = mh.scatter_batch(rows[:half], mesh)
    b0, b1 = mh.scatter_batch(rows[half:], mesh)
    step = sharded.make_mult_step(eng, 0)
    ksk = sharded.prepare_step_ksk(eng, 0, ksk=bkey)
    prm = sharded.mult_step_params(eng, 0, ksk=bkey)
    mesh.reset_counts()
    (o0, o1), counts = count_launches(
        kern, lambda: step(a0, a1, b0, b1, ksk, prm))
    coll = dict(mesh.counts)
    require(counts, MESH_STEP, f"{tag} mesh step")
    ms = cuda_ms(lambda: step(a0, a1, b0, b1, ksk, prm), reps=3, inner=1)
    mine = [torch.stack([r[i] for r in rows[:half]]).cpu() for i in (0, 1)]
    mine += [torch.stack([r[i] for r in rows[half:]]).cpu() for i in (0, 1)]
    mine += [mh.local_batch(o).cpu() for o in (o0, o1)]
    # rank 0 holds every process's step against a single-process engine
    gathered = [[torch.empty_like(t) for _ in range(world)] if rank == 0
                else None for t in mine]
    for t, g in zip(mine, gathered):
        dist.gather(t, g, dst=0)
    if rank == 0:
        ref = CkksEngine(Preset.logN15, device="cuda:0", seed=SEED)
        ref.sk, ref.pk, ref.evk  # noqa: B018 — the same draws
        step_u = sharded.make_mult_step(ref, 0, rns_shard=False)
        ksk_u = sharded.prepare_step_ksk(ref, 0, rns_shard=False)
        prm_u = sharded.mult_step_params(ref, 0, rns_shard=False)
        for r in range(world):
            ins = [g[r].cuda() for g in gathered[:4]]
            want = step_u(*ins, ksk_u, prm_u)
            check(all(torch.equal(w.cpu(), g[r])
                      for w, g in zip(want, gathered[4:])),
                  f"{tag}: rank {r}'s mesh step differs from the "
                  f"single-process step")
    dist.barrier()
    log(f"{tag}: same-seed keys equal, broadcast_key of an evk "
        f"({sum(nbytes(*p) for p in real) / 2**20:.1f} MiB) in "
        f"{t_bcast:.3f} s, scatter_batch of {half} pairs, mesh step "
        f"(batch {world} x rns 2, both processes' shards sharing cuda:0) "
        f"{ms:.3f} ms, launches {({k: n for k, n in counts.items() if n})},"
        f" collectives {coll}" + ("; every process's step bytes == "
                                        "the single-process step"
                                        if rank == 0 else ""))
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(step_ms=ms, broadcast_s=t_bcast,
                       launches={k: n for k, n in counts.items() if n},
                       collectives=coll), f)
    dist.destroy_process_group()
    return 0


def multihost_phase():
    """Phase 14: two processes on cuda:0 over gloo, each running
    :func:`multihost_child`; a failing child fails the phase."""
    import socket

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-child",
             str(rank), "2", str(port), outdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for rank, (p, out) in enumerate(zip(procs, outs)):
            log("\n".join(f"  [rank {rank}] {line}"
                          for line in out.strip().splitlines()[-6:]))
            if p.returncode != 0:
                raise AssertionError(f"multihost rank {rank} exited "
                                     f"{p.returncode}")
        res = {}
        for rank in range(2):
            with open(os.path.join(outdir, f"rank{rank}.json")) as f:
                res[f"rank{rank}"] = json.load(f)
    res["seconds"] = time.perf_counter() - t0
    log(f"multihost: phase 14 took {res['seconds']:.1f} s")
    return res


def step_phase16(CkksEngine, Preset, kern, stack, unstack, smi):
    """Phase 11b: Preset.logN16 on the card.  keygen, ``encodecrypt_batch``
    of 8 twice, the fused step through the all-parts kernel with the
    launch counts set to 0 before it and read after, its peak device
    memory, its decrypt error (below 1e-6), its time and its bytes against
    the plain-version step.  Returns (the step's launches, results)."""
    t0 = time.perf_counter()
    eng = CkksEngine(Preset.logN16, device="cuda", seed=SEED)
    eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    m1, m2 = msgs(eng)
    A = stack(eng.encodecrypt_batch(m1))
    B = stack(eng.encodecrypt_batch(m2))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, counts = count_launches(kern, lambda: eng.cc_mult(A, B))
    peak = torch.cuda.max_memory_allocated()
    require(counts, STEP_15, "the logN16 step")
    keyswitch_launches(counts, 1, "logN16", "step")
    C = eng._lp(1).num_channels
    for d in out.data:
        if tuple(d.shape) != (BATCH, C, eng.ckksCfg.N):
            raise AssertionError(f"logN16 step output shape "
                                 f"{tuple(d.shape)}")
    dec = eng.decryptcode_batch(unstack(out), is_real=True)
    if not np.all(np.isfinite(dec)):
        raise AssertionError("logN16 non-finite decrypt")
    err = float(np.abs(dec - m1 * m2).max())
    log(f"logN16 ({len(eng.params.q)} primes, "
        f"{len(eng.params.parts[1])} keyswitch parts at level 1; engine and "
        f"keys {t_build:.1f} s): step launches "
        f"{ {k: n for k, n in counts.items() if n} }; peak device memory "
        f"{peak / 2**30:.3f} GiB (resident before the step "
        f"{base / 2**30:.3f} GiB); decrypt max error vs m1*m2 over {BATCH} "
        f"pairs {err:.3e} (limit {DECRYPT_TOL})")
    if not err < DECRYPT_TOL:
        raise AssertionError("logN16 decrypt error above the limit")
    step_ms, plain_ms = time_step(eng, kern, A, B, "logN16", smi, (3, 1), 1)
    return counts, dict(step_ms=step_ms, step_ms_per_ct=step_ms / BATCH,
                        plain_step_ms=plain_ms, decrypt_max_err=err,
                        peak_bytes=peak, resident_bytes=base,
                        launches={k: n for k, n in counts.items() if n})


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
    mm_ptxas = matmul_ptxas(cuda_build.build_log)
    for (lane_bits, L), info in sorted(mm_ptxas.items()):
        log(f"ptxas matmul_k, {lane_bits}-bit lane, {L} bytes a weight: "
            f"{info['registers']} registers, {info['spill_stores']} / "
            f"{info['spill_loads']} bytes of spill stores / loads, "
            f"{info['smem']} bytes of static shared memory")
    check((62, 5) in mm_ptxas and mm_ptxas[62, 5]["spill_stores"]
          + mm_ptxas[62, 5]["spill_loads"] == 0,
          f"matmul_k at five bytes a weight (62-bit) spills or is missing: "
          f"{mm_ptxas.get((62, 5))}")
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
    log(f"logN 4, 7, 10: {n_small} cases of the ntt.cu entries, K5, K6 "
        f"and G1-G4, both lanes, equal to their plain versions (K6's "
        f"62-bit lane residue for residue, in [0, 2q); all else byte for "
        f"byte) "
        f"({time.perf_counter() - t0:.1f} s)")
    sass = pass_sass(cuda_build)
    if sass is None:
        log("SASS of the NTT passes: not measured (no cuobjdump)")
    for (name, bits, logN), (imad, total, bfly) in sorted(
            (sass or {}).items()):
        log(f"SASS {name} {bits}-bit logN{logN}: {total} instructions, "
            f"{imad} IMAD-class, for {bfly} butterflies a thread: "
            f"{total / bfly:.1f} ({imad / bfly:.1f} IMAD-class) a butterfly")
    for mode in ("fold_redc", "fold_redc_30"):
        step = probe[mode]["sass_step"]
        log(f"SASS {mode}: one chain step (a REDC, the loop's counter, "
            f"compare and branch) " + ("not measured" if step is None else
                                       f"{step[1]} instructions, {step[0]} "
                                       f"IMAD-class"))

    # 2d. the CSPRNG on the card against the CPU, and its kernels against
    # their plain versions; 2e. the pinned digests
    csprng, csprng_k, draws = csprng_phase(
        Csprng, CkksConfig, (Preset.logN15, Preset.logN17), smi, kern,
        roofline, cuda_build)
    digest_errs = digest_phase(CkksEngine, ttyping)

    # 3. logN15 kernels against their plain versions
    eng_k = CkksEngine(Preset.logN15, device="cuda", seed=SEED)
    results15 = check_kernels(eng_k, kern, mod, roofline, "logN15", (3, 3),
                              rate)
    del eng_k
    release_engines(ttyping)

    # 3b. the stacked linear op's matrix product at the feed-forward
    # layer's shapes, both lanes (the 30-bit result joins phase 10's)
    clock_hz = max_sm_clock_hz()
    results15["matmul"] = matmul_phase(CkksEngine, Preset.logN15, "logN15",
                                       smi, clock_hz)
    matmul15_30 = matmul_phase(CkksEngine, "logN15_30", "logN15_30", smi,
                               clock_hz)
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

    # 5. logN15 timing, profile
    step_ms, plain_step_ms = time_step(eng, kern, A, B, "logN15", smi,
                                       (3, 3), 3)
    profile_step(lambda: eng.cc_mult(A, B), "logN15")
    compressed_keys(eng, ttyping, mont)

    # 5b. the evaluation path: Galois and conjugation keys, rotations,
    # add/sub, plaintext and scalar ops, levels, sum / mean / var
    eval15, evalres15, evaltimes15, evalkeys15 = evaluate15(
        eng, eng_cpu, kern, stack_ciphertexts, unstack_ciphertext, A, B,
        out, smi)
    del eng_cpu
    share15 = draw_share(eng, msgs(eng)[0], "logN15", galois=True)
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
    keyswitch_launches(step17, 1, "logN17", "step")

    # 8. logN17 switch_key
    err_sw, sw_counts = switch_key_17(eng17, kern, stack_ciphertexts,
                                      unstack_ciphertext)

    # 8b. a rotation and a conjugation, each through the all-parts kernel
    eval17, evalres17, evalkeys17 = evaluate_light(
        eng17, kern, stack_ciphertexts, unstack_ciphertext, A,
        DECRYPT_TOL_17, "", "logN17", large=True)

    # 9. logN17 timing (3 single-step loops; one for the plain versions,
    # whose step takes seconds), profile
    step17_ms, plain_step17_ms = time_step(eng17, kern, A, B, "logN17", smi,
                                           (3, 1), 1)
    profile_step(lambda: eng17.cc_mult(A, B), "logN17", top=16)
    share17 = draw_share(eng17, msgs(eng17)[0], "logN17")

    # 2f. the native oracle at the logN17 chain (phase 9's engine)
    from tiberate_tpu_torch.ops import csprng_kernels
    from tiberate_tpu_torch.utils import native

    oracle = oracle_phase(eng17, kern, mont, native, csprng_kernels)

    del eng17, A, B, out
    release_engines(ttyping)

    # 10. the 30-bit mode at logN15_30: kernels, the main path (all parts in
    # one kernel), the CPU comparison, timing, profile
    eng_k = CkksEngine("logN15_30", device="cuda", seed=SEED)
    results15_30 = check_kernels(eng_k, kern, mod, roofline, "logN15_30",
                                 (3, 3), rate30)
    results15_30["matmul"] = matmul15_30
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
        DECRYPT_TOL_30_OP, "_30", "logN15_30", large=False)
    step15_30_ms, plain_step15_30_ms = time_step(
        eng, kern, A, B, "logN15_30", smi, (3, 3), 3)
    log(f"logN15 fused step, batch {BATCH}, same call: 62-bit "
        f"{step_ms:.3f} ms/step, 30-bit (logN15_30) {step15_30_ms:.3f} "
        f"ms/step ({smi})")
    profile_step(lambda: eng.cc_mult(A, B), "logN15_30")
    share15_30 = draw_share(eng, msgs(eng)[0], "logN15_30")
    del eng, A, B, out
    release_engines(ttyping)

    # 11. logN17_30: kernels, the main path through the all-parts kernel,
    # the plain-version step, profile
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
    keyswitch_launches(step17_30, 1, "logN17_30", "step", "_30")
    eval17_30, evalres17_30, evalkeys17_30 = evaluate_light(
        eng, kern, stack_ciphertexts, unstack_ciphertext, A,
        DECRYPT_TOL_30_OP, "_30", "logN17_30", large=True)
    step17_30_ms, plain_step17_30_ms = time_step(
        eng, kern, A, B, "logN17_30", smi, (3, 1), 1)
    profile_step(lambda: eng.cc_mult(A, B), "logN17_30", top=16)
    share17_30 = draw_share(eng, msgs(eng)[0], "logN17_30")
    del eng, A, B, out
    release_engines(ttyping)

    # 11b. a step at Preset.logN16
    step16, res16 = step_phase16(CkksEngine, Preset, kern, stack_ciphertexts,
                                 unstack_ciphertext, smi)
    release_engines(ttyping)

    # 12. the extension path at logN15: the operator sugar, save/load,
    # batched_inference, the HE linear layer and LayerNorm, two-party
    # MPC, a trace and the CLI
    ext15, extres15 = extension_phase(CkksEngine, Preset, kern, ttyping,
                                      smi)
    release_engines(ttyping)

    # 13. the mesh at logN15 on this one card; 14. two processes over gloo
    mesh15, meshres15 = mesh_phase(CkksEngine, Preset, kern, ttyping,
                                   stack_ciphertexts, smi)
    release_engines(ttyping)
    multihost = multihost_phase()

    # the driven paths: the main paths, switch_key, the evaluation,
    # extension and mesh paths, the logN16 step.  K3 accum runs only in the
    # mesh switcher, which phase 13 drives in the 62-bit lane; phases 2c
    # and 3 hold it to its plain version in both lanes
    paths = (launches15, launches17, sw_counts, launches15_30,
             launches17_30, eval15, eval17, eval15_30, eval17_30, ext15,
             mesh15, step16, draws)
    counts = {k: sum(p[k] for p in paths) for k in KERNELS}
    counts.update(probe_counts)
    require(counts, [*(k for k in KERNELS if k != "ntt_keymul_accum_30"),
                     *PROBE], "the driven paths")
    # the CSPRNG's kernels join the 62-bit main paths' ranking at their
    # logN15 and logN17 draws
    kernels15, kernels17 = ({k: csprng_k[t][k] for k in CSPRNG}
                            for t in ("logN15", "logN17"))
    for res, launches, step, sfx, tag in (
            (results15 | kernels15, launches15, step15, "", "logN15"),
            (results17 | kernels17, launches17, step17, "", "logN17"),
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
    rank(results15, mesh15, "", "logN15 mesh paths (every shard on one "
         "card):")
    measured = {"": (results17, results15, "logN17", "logN15"),
                "_30": (results17_30, results15_30, "logN17_30",
                        "logN15_30")}
    kernels = []
    for key, (src, rep) in KERNELS.items():
        if key in CSPRNG:
            kernels.append(dict(name=key, route="cuda", source=src,
                                replaces=rep, launches=counts[key],
                                **csprng_k["logN17"][key], shape="logN17",
                                logN15=csprng_k["logN15"][key]))
            continue
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
        "csprng": csprng, "csprng_kernels": csprng_k,
        "csprng_draw_launches": {k: draws[k] for k in CSPRNG},
        "digest_decrypt_max_err": digest_errs,
        "native_oracle": oracle,
        "logN15": {"step_ms": step_ms, "step_ms_per_ct": step_ms / BATCH,
                   "plain_step_ms": plain_step_ms,
                   "decrypt_max_err": err15,
                   "csprng_share": share15,
                   "evaluation": {"ops": evalres15, "ms": evaltimes15,
                                  "keys": evalkeys15}, **info15},
        "logN17": {"step_ms": step17_ms,
                   "step_ms_per_ct": step17_ms / BATCH,
                   "plain_step_ms": plain_step17_ms,
                   "decrypt_max_err": err17,
                   "switch_key_decrypt_max_err": err_sw,
                   "csprng_share": share17,
                   "evaluation": {"ops": evalres17, "keys": evalkeys17},
                   **info17},
        "logN15_30": {"step_ms": step15_30_ms,
                      "step_ms_per_ct": step15_30_ms / BATCH,
                      "plain_step_ms": plain_step15_30_ms,
                      "decrypt_max_err": err15_30,
                      "csprng_share": share15_30,
                      "evaluation": {"ops": evalres15_30}, **info15_30},
        "logN17_30": {"step_ms": step17_30_ms,
                      "step_ms_per_ct": step17_30_ms / BATCH,
                      "plain_step_ms": plain_step17_30_ms,
                      "decrypt_max_err": err17_30,
                      "csprng_share": share17_30,
                      "evaluation": {"ops": evalres17_30,
                                     "keys": evalkeys17_30},
                      **info17_30},
        "logN16": res16,
        "logN15_extensions": {"launches": {k: n for k, n in ext15.items()
                                           if n}, **extres15},
        "logN15_mesh": {"launches": {k: n for k, n in mesh15.items() if n},
                        **meshres15},
        "multihost": multihost,
        "seconds": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-child"]:
        rank, world, port = (int(v) for v in sys.argv[2:5])
        sys.exit(multihost_child(rank, world, port, sys.argv[5]))
    sys.exit(main())
