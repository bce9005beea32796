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

The CSPRNG's kernels (R1-R4, ``csprng.cu``) do no REDC: their second
term is instruction issue, the SASS instructions of one row's work (the
block function and its samples, counted in the built kernel by
``cuobjdump``) for every row and replica, one thread each, at the card's
warp-issue rate (132 SMs x 4 schedulers, one warp instruction a cycle
each, at the SM clock).

This is the counterpart of the VPU term of the JAX package's
compute-aware roofline (``bench.py::_roofline_ct_per_s``), whose rate the
TPU probe measured in the same way.

The counts are those of the kernels (``csrc/ntt.cuh``, ``ntt.cu``,
``tensor.cu``, ``keyswitch.cu``, ``glue.cu``; each formula names the code
it counts),
per polynomial row of N coefficients: a forward or inverse transform runs
N/2 butterflies, one REDC each, in each of its logN stages; prologues and
epilogues add one REDC per coefficient for each multiply.  A skipped
channel costs nothing.
"""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet, at the 700 W power limit
H100_SMS = 132             # H100 SXM datasheet
SCHEDULERS_PER_SM = 4      # warp schedulers an SM, one issue a cycle each
WARP = 32


def _transform(logN: int) -> int:
    """REDCs of one row's butterflies: N/2 per stage, logN stages."""
    return (1 << logN) // 2 * logN


def ntt(rows: int, logN: int, enter: bool) -> int:
    """K1: the x R entry, one REDC per coefficient in ``fwd_strided_k``'s
    load (ntt.cuh), and the forward stages (``butterflies`` in ntt.cuh,
    run by ``fwd_strided_k`` and ``fwd_contig_k``)."""
    return rows * (_transform(logN) + (1 << logN) * int(enter))


def ntt_keymul(rows: int, logN: int, nkeys: int, enter: bool) -> int:
    """K3: K1, then one REDC per coefficient and key (``fwd_contig_k``'s
    key epilogue, ntt.cu)."""
    return ntt(rows, logN, enter) + rows * nkeys * (1 << logN)


def ntt_keymul_accum(rows: int, logN: int) -> int:
    """K3 accum: ``rows`` = the rows outside the skip range; no entry, two
    key products each (``fwd_contig_k``'s epilogue with ``acc``, ntt.cu)."""
    return rows * (_transform(logN) + 2 * (1 << logN))


def intt(rows: int, logN: int, epilogue: str) -> int:
    """K2: the inverse stages (``butterflies``, run by ``inv_contig_k`` and
    ``inv_strided_k``), x N^-1 R and the exit REDC of "exit" /
    "exit_reduce" (``inv_strided_k``'s epilogue, ntt.cu)."""
    exits = {"mont": 0, "exit": 1, "exit_reduce": 1}[epilogue]
    return rows * (_transform(logN) + (1 + exits) * (1 << logN))


def intt_pdiv(rows: int, logN: int, S: int) -> int:
    """K4 over ``rows`` = B x C ordinary rows: the inverse stages, x N^-1 R,
    x c_x, and one REDC per special prime (``inv_strided_k``'s
    ``EPI_PDIV`` epilogue, ntt.cu)."""
    return rows * (_transform(logN) + (2 + S) * (1 << logN))


def ntt_tensor(rows: int, logN: int) -> int:
    """K5: four enter-NTTs (``tensor_strided_k``, ``tensor_contig_k``),
    then four products per coefficient (``tensor_contig_k``, tensor.cu)."""
    return 4 * ntt(rows, logN, True) + 4 * rows * (1 << logN)


def keymul_parts_sums(batch: int, alphas, C_sp: int, N: int,
                      runs=None) -> tuple:
    """K6's sums (``parts_strided_k``'s extension, ``parts_contig_k``'s
    key products; keyswitch.cu): (products, reductions) of ``batch`` x
    ``C_sp`` rows.  Per part p, row and coefficient, alpha_p extension
    products and two key products.  The 30-bit lane (``runs`` None)
    reduces each.  The 62-bit lane takes them as 128-bit products and
    reduces each sum once: ceil(alpha_p / digits) extension sums a part
    (one REDC for alpha 1 too) and the two key sums, whose folds, one
    64-bit product each, after every ``parts`` parts where parts follow,
    count as products.  ``runs`` = (digits, parts): ``LevelPack.sum_runs``
    (``ntt_kernels.sum_runs``)."""
    words = batch * C_sp * N
    products = words * (sum(alphas) + 2 * len(alphas))
    if runs is None:
        return products, products
    digits, parts = runs
    folds = 2 * ((len(alphas) - 1) // parts)
    return (products + words * folds,
            words * (sum(-(-a // digits) for a in alphas) + 2))


def ntt_keymul_parts(batch: int, alphas, C_sp: int, logN: int,
                     runs=None) -> int:
    """K6: per part and with-special row the forward stages
    (``parts_strided_k``, ``parts_contig_k``), and the REDCs of its sums
    (:func:`keymul_parts_sums`): with ``runs`` None those of the 30-bit
    lane, one a product, which is also the number of the 62-bit lane's
    modular products; with ``runs`` the 62-bit lane's, one a sum.  The
    ``tmp`` intermediate, written by pass 1 and read by pass 2, is no
    input or output: the bytes bound leaves it out."""
    return (batch * C_sp * len(alphas) * _transform(logN)
            + keymul_parts_sums(batch, alphas, C_sp, 1 << logN, runs)[1])


def rescale(rows: int, N: int) -> int:
    """G1 over ``rows`` = B x c kept rows: one REDC per coefficient
    (``rescale_k``, glue.cu)."""
    return rows * N


def parts_digits(batch: int, alphas, N: int) -> int:
    """G2: per part and coefficient, alpha - 1 digits, digit i + 1's REDC
    followed by one REDC into each of the alpha - i - 2 rows above it
    (``digits_k``, glue.cu): alpha (alpha - 1) / 2."""
    return batch * N * sum(a * (a - 1) // 2 for a in alphas)


def pdiv_p0(batch: int, S: int, N: int) -> int:
    """G3: division i updates the S - 1 - i rows it leaves to later
    divisions, one REDC each (``pdiv_p0_k``, glue.cu): S (S - 1) / 2 per
    coefficient."""
    return batch * N * S * (S - 1) // 2


def mont_scalar(rows: int, N: int) -> int:
    """G4's product by a column over ``rows`` = B x C rows: one REDC per
    coefficient (``modew_k``, glue.cu).  Its add and subtract do none."""
    return rows * N


# The glue's bytes, in words of ``word`` bytes: every input read once and
# every output written once (G1-G4 are bound by these).


def rescale_bytes(batch: int, c: int, N: int, word: int) -> int:
    """G1: c kept rows and the rescaler read, c rows written; the scale,
    q and k of each kept row."""
    return word * (batch * N * (2 * c + 1) + 3 * c)


def parts_digits_bytes(batch: int, alphas, amax: int, N: int, word: int,
                       table_words: int) -> int:
    """G2: each part's alpha rows read, its amax rows of the digit
    operand written; the constants table."""
    return word * (batch * N * (sum(alphas) + len(alphas) * amax)
                   + table_words)


def pdiv_p0_bytes(batch: int, S: int, N: int, word: int) -> int:
    """G3: S special rows read and S written; the S - 1 division columns
    and each row's q and k."""
    return word * (2 * batch * S * N + (S - 1) * S + 2 * S)


def mont_scalar_bytes(batch: int, C: int, N: int, word: int,
                      col_batch: int = 1) -> int:
    """G4's product: B x C rows read and written; each row's q and k, and
    the column's ``col_batch`` x C words (1 for [C, 1], B for [B, C,
    1])."""
    return word * (2 * batch * C * N + (2 + col_batch) * C)


def mod_add_bytes(batch: int, C: int, N: int, word: int,
                  b_batch: int | None = None) -> int:
    """G4's add or subtract: B x C rows of the first operand read and of
    the output written; the second operand's ``b_batch`` x C rows read
    once (B, the default, or 1 for one ciphertext against a stack, batch
    stride 0); each row's q."""
    b_batch = batch if b_batch is None else b_batch
    return word * ((2 * batch + b_batch) * C * N + C)


def bound(nbytes: float, redc: int, redc_per_s: float) -> dict:
    """The call's two bounds in ms and the larger of them: ``bound_by``
    "bytes" or "operations" (the REDCs)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    compute_ms = redc / redc_per_s * 1e3
    return dict(redc=redc, bytes_bound_ms=bytes_ms,
                compute_bound_ms=compute_ms,
                bound_ms=max(bytes_ms, compute_ms),
                bound_by="bytes" if bytes_ms >= compute_ms else "operations")


# The CSPRNG (R1-R4): bytes and instruction issue.


def csprng_bytes(rows: int, stepped: int, out_bytes: int,
                 in_bytes: int = 0) -> int:
    """R1-R4: ``rows`` base state rows read once (16 int64 words), the
    counters of ``stepped`` rows written (words 12 and 13), the samples
    written once and any other input (coefficients, moduli, the CDT tree)
    read once."""
    return 128 * rows + 16 * stepped + out_bytes + in_bytes


def warp_issue_per_s(sm_clock_hz: float) -> float:
    """Warp instructions the card issues a second at ``sm_clock_hz``."""
    return H100_SMS * SCHEDULERS_PER_SM * sm_clock_hz


def issue_bound(nbytes: float, blocks: int, sass_per_block,
                sm_clock_hz: float) -> dict:
    """A CSPRNG call's two bounds in ms: its bytes, and ``blocks`` (rows x
    replicas, one thread each) times ``sass_per_block`` SASS instructions
    over 32 threads a warp at the warp-issue rate; ``sass_per_block`` None
    (not measured) leaves the bytes alone."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if sass_per_block is None:
        return dict(warp_instructions=None, bytes_bound_ms=bytes_ms,
                    compute_bound_ms=None, bound_ms=bytes_ms,
                    bound_by="bytes")
    warps = blocks * sass_per_block / WARP
    compute_ms = warps / warp_issue_per_s(sm_clock_hz) * 1e3
    return dict(warp_instructions=warps, bytes_bound_ms=bytes_ms,
                compute_bound_ms=compute_ms,
                bound_ms=max(bytes_ms, compute_ms),
                bound_by="bytes" if bytes_ms >= compute_ms else "operations")
