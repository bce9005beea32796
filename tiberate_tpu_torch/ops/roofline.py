"""The least time a kernel call could take on the card: its roofline.

Two terms, the larger of which bounds the call:

* **bytes**: every input (data, twiddles, keys, constants) read once and
  every output written once, at the H100's datasheet HBM rate;
* **REDC**: the Montgomery reductions the call's CUDA kernel performs,
  counted below from its source, at the REDC rate of its lane that the
  fold-rate probe measured on the card
  (``tiberate_tpu_torch.benchmarks.profiling.fold_microbench``), never a
  datasheet figure: a 62-bit REDC is about twenty 32-bit integer
  multiply-adds, which no published peak states.

This is the counterpart of the VPU term of the JAX package's
compute-aware roofline (``bench.py::_roofline_ct_per_s``), whose rate the
TPU probe measured in the same way.

The counts are those of the kernels (``csrc/ntt.cuh``, ``ntt.cu``,
``tensor.cu``, ``keyswitch.cu``), per polynomial row of N coefficients: a
forward or inverse transform runs N/2 butterflies, one REDC each, in each
of its logN stages; prologues and epilogues add one REDC per coefficient
for each multiply.  A skipped channel costs nothing.
"""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet, at the 700 W power limit


def _transform(logN: int) -> int:
    """REDCs of one row's butterflies: N/2 per stage, logN stages."""
    return (1 << logN) // 2 * logN


def ntt(rows: int, logN: int, enter: bool) -> int:
    """K1: fwd_pass1 (x R entry: one REDC per coefficient, ntt.cuh:179)
    and the forward stages (ntt.cuh:69, :91)."""
    return rows * (_transform(logN) + (1 << logN) * int(enter))


def ntt_keymul(rows: int, logN: int, nkeys: int, enter: bool) -> int:
    """K3: K1, then one REDC per coefficient and key (ntt.cu:84-88)."""
    return ntt(rows, logN, enter) + rows * nkeys * (1 << logN)


def ntt_keymul_accum(rows: int, logN: int) -> int:
    """K3 accum: ``rows`` = the rows outside the skip range; no entry, two
    key products each (the ACC epilogue of ntt.cu:84-90)."""
    return rows * (_transform(logN) + 2 * (1 << logN))


def intt(rows: int, logN: int, epilogue: str) -> int:
    """K2: the inverse stages (ntt.cuh:115, :139), x N^-1 R (ntt.cu:157),
    and the exit REDC of "exit" / "exit_reduce" (ntt.cu:158)."""
    exits = {"mont": 0, "exit": 1, "exit_reduce": 1}[epilogue]
    return rows * (_transform(logN) + (1 + exits) * (1 << logN))


def intt_pdiv(rows: int, logN: int, S: int) -> int:
    """K4 over ``rows`` = B x C ordinary rows: the inverse stages, x N^-1 R,
    x c_x, and one REDC per special prime (ntt.cu:157-165)."""
    return rows * (_transform(logN) + (2 + S) * (1 << logN))


def ntt_tensor(rows: int, logN: int) -> int:
    """K5: four enter-NTTs, then four products per coefficient
    (tensor.cu:53-55)."""
    return 4 * ntt(rows, logN, True) + 4 * rows * (1 << logN)


def ntt_keymul_parts(batch: int, alphas, C_sp: int, logN: int) -> int:
    """K6: per part p and with-special row, alpha_p extension REDCs per
    coefficient (keyswitch.cu:62-65), the forward stages (:69, :101) and
    the two key products (:104-105)."""
    N = 1 << logN
    return batch * C_sp * sum(a * N + _transform(logN) + 2 * N
                              for a in alphas)


def bound(nbytes: float, redc: int, redc_per_s: float) -> dict:
    """The call's two bounds in ms and the larger of them: ``bound_by``
    "bytes" or "operations" (the REDCs)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    compute_ms = redc / redc_per_s * 1e3
    return dict(redc=redc, bytes_bound_ms=bytes_ms,
                compute_bound_ms=compute_ms,
                bound_ms=max(bytes_ms, compute_ms),
                bound_by="bytes" if bytes_ms >= compute_ms else "operations")
