"""``tiberate_tpu_torch.ops.roofline``'s REDC counts against the plain
versions of the kernels.

Each kernel's plain version (``ops/ntt_kernels.py``) runs the same
butterflies, prologues and epilogues as its CUDA kernel, one REDC
(``mont.mont_mult_raw`` or ``mont.mont_reduce_raw``) per output element of
each Montgomery multiply.  Here both are wrapped to count the elements they
compute, each plain version runs at toy_config(logN=7, num_scales=4,
num_special_primes=2) in both lanes (three parts at level 1: alpha 1, 2,
1), and the count must equal the formula — exactly.

The step's glue (G1-G3, ``ops/glue_kernels.py``) and G4's product by a
column are counted the same way: their plain versions run the kernels'
REDCs one for one; G4's add and subtract run none.

K4 is the exception: its plain version runs the successive P-division
chain (``intt_pdiv_plain``: exit, enter, S x (enter P0, multiply), exit),
while the kernel evaluates the division's affine form (``csrc/ntt.cu``,
``inv_strided_k``'s ``EPI_PDIV`` epilogue: x N^-1 R, then x c_x and one
REDC per special prime), so the two do different numbers of REDCs for the
same result.  ``roofline.intt_pdiv`` is checked against that source by reading
it, not by this test.
"""

import pytest
import torch

from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.context.ntt_context import CkksParams
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.ops import glue_kernels as G
from tiberate_tpu_torch.ops import mont, roofline
from tiberate_tpu_torch.ops import ntt_kernels as K

torch.set_num_threads(1)

LOGN = 7
LEVEL = 1
BATCH = 2
LANES = {62: dict(scale_bits=30),
         30: dict(scale_bits=21, buffer_bit_length=30)}


@pytest.fixture(scope="module", params=sorted(LANES))
def tp(request):
    return CkksParams(toy_config(logN=LOGN, num_scales=4,
                                 num_special_primes=2, **LANES[request.param]),
                      "cpu")


@pytest.fixture
def redc_count(monkeypatch):
    """Wrap both REDC functions so they add the number of elements they
    compute to ``count[0]``."""
    count = [0]

    def counting(fn):
        def wrapped(*args):
            out = fn(*args)
            count[0] += out.numel()
            return out
        return wrapped

    monkeypatch.setattr(mont, "mont_mult_raw", counting(mont.mont_mult_raw))
    monkeypatch.setattr(mont, "mont_reduce_raw",
                        counting(mont.mont_reduce_raw))
    return count


def _uniform(gen, q, shape):
    x = torch.randint(0, 1 << 62, shape, generator=gen)
    return (x % q.long()[:, None]).to(q.dtype)


def _case(tp, name):
    """(plain-version call, the REDCs roofline counts for it)."""
    lp, lp_sp = tp.lp(LEVEL, False), tp.lp(LEVEL, True)
    C, C_sp = lp.num_channels, lp_sp.num_channels
    N = 1 << LOGN
    gen = torch.Generator().manual_seed(7)
    x = _uniform(gen, lp.pack.q, (BATCH, C, N))
    keys = tuple(_uniform(gen, lp.pack.q, (C, N)) for _ in range(2))
    ext = _uniform(gen, lp_sp.pack.q, (BATCH, C_sp, N))
    keys_sp = tuple(_uniform(gen, lp_sp.pack.q, (C_sp, N)) for _ in range(2))
    rows = BATCH * C
    if name.startswith("ntt_keymul_accum"):
        part = name.rsplit(":", 1)[1]
        parts = tp.parts[LEVEL]
        skip = (None if part == "none" else
                (parts[int(part)].lo, parts[int(part)].hi))
        acc = tuple(_uniform(gen, 2 * lp_sp.pack.q, (BATCH, C_sp, N))
                    for _ in range(2))
        outside = C_sp - (0 if skip is None else skip[1] - skip[0])
        return (lambda: K.ntt_keymul_accum_plain(ext, lp_sp, keys_sp, acc,
                                                 skip),
                roofline.ntt_keymul_accum(BATCH * outside, LOGN))
    if name == "ntt_keymul_parts":
        ec, alphas = teng._parts_consts(tp, LEVEL)
        st = teng._parts_digits(x, tp.parts[LEVEL], lp, ec.shape[-1])
        pkeys = tuple(tuple(_uniform(gen, lp_sp.pack.q, (C_sp, N))
                            for _ in range(2))
                      for _ in range(ec.shape[0]))
        return (lambda: K.ntt_keymul_parts_plain(st, ec, alphas, pkeys,
                                                 lp_sp),
                roofline.ntt_keymul_parts(BATCH, alphas.tolist(), C_sp, LOGN))
    C0 = tp.lp(LEVEL - 1, False).num_channels
    d = _uniform(gen, tp.lp(LEVEL - 1, False).pack.q, (BATCH, C0, N))
    cur = _uniform(gen, lp_sp.pack.q[C:], (BATCH, tp.S, N))
    parts = tp.parts[LEVEL]
    glue = {
        "rescale": (lambda: G.rescale_plain(
            d[..., :1, :], d[..., 1:, :], tp.rescale_scales[LEVEL - 1], lp,
            tp.q[LEVEL - 1] // 2), roofline.rescale(BATCH * C, N)),
        "parts_digits": (lambda: G.parts_digits_plain(
            x, parts, lp, max(p.alpha for p in parts)),
            roofline.parts_digits(BATCH, [p.alpha for p in parts], N)),
        "pdiv_p0": (lambda: G.pdiv_p0_plain(cur, lp_sp[C:], tp.PiRs[LEVEL],
                                            C, tp.S),
                    roofline.pdiv_p0(BATCH, tp.S, N)),
        "mont_scalar": (lambda: G.mont_scalar_plain(
            x, _uniform(gen, lp.pack.q, (BATCH, C, 1)), lp),
            roofline.mont_scalar(BATCH * C, N)),
    }
    cases = {
        **glue,
        "ntt[enter]": (lambda: K.ntt_plain(x, lp, True),
                       roofline.ntt(rows, LOGN, True)),
        "ntt": (lambda: K.ntt_plain(x, lp, False),
                roofline.ntt(rows, LOGN, False)),
        **{f"intt[{epi}]": (lambda epi=epi: K.intt_plain(x, lp, epi),
                            roofline.intt(rows, LOGN, epi))
           for epi in ("mont", "exit", "exit_reduce")},
        "ntt_keymul[1 key, enter]": (
            lambda: K.ntt_keymul_plain(x, lp, keys[:1], True),
            roofline.ntt_keymul(rows, LOGN, 1, True)),
        "ntt_keymul[2 keys]": (
            lambda: K.ntt_keymul_plain(x, lp, keys, False),
            roofline.ntt_keymul(rows, LOGN, 2, False)),
        "ntt_tensor": (
            lambda: K.ntt_tensor_plain(*(_uniform(gen, lp.pack.q,
                                                  (BATCH, C, N))
                                         for _ in range(4)), lp),
            roofline.ntt_tensor(rows, LOGN)),
    }
    return cases[name]


@pytest.mark.parametrize("name", [
    "ntt[enter]", "ntt", "intt[mont]", "intt[exit]", "intt[exit_reduce]",
    "ntt_keymul[1 key, enter]", "ntt_keymul[2 keys]",
    "ntt_keymul_accum:none", "ntt_keymul_accum:0", "ntt_keymul_accum:1",
    "ntt_keymul_accum:2", "ntt_tensor", "ntt_keymul_parts", "rescale",
    "parts_digits", "pdiv_p0", "mont_scalar",
])
def test_redc_count_equals_plain_version(tp, redc_count, name):
    run, formula = _case(tp, name)
    redc_count[0] = 0  # the digits of K6's inputs take REDCs of their own
    run()
    assert redc_count[0] == formula > 0


def test_kernel_shapes_counts():
    """The formulas at logN15 sizes, reckoned by hand: K1 over [8, 16, 2^15]
    with the entry is 128 rows x (2^14 x 15 + 2^15); K6 over 9 parts whose
    alphas sum to 17, onto 18 with-special channels, in each lane; K4
    with S = 2."""
    assert roofline.ntt(128, 15, True) == 128 * (16384 * 15 + 32768)
    alphas = [1, 2, 2, 2, 2, 2, 2, 2, 2]
    assert roofline.ntt_keymul_parts(8, alphas, 18, 15) == 8 * 18 * (
        17 * 32768 + 9 * (16384 * 15 + 2 * 32768))
    # the 62-bit lane: one REDC an extension sum of each part, one a key
    # sum
    assert roofline.ntt_keymul_parts(8, alphas, 18, 15, (8, 24)) == \
        8 * 18 * (9 * 16384 * 15 + (9 + 2) * 32768)
    assert roofline.intt_pdiv(10, 15, 2) == 10 * (16384 * 15 + 4 * 32768)


def test_glue_shapes_counts():
    """The glue's formulas at the logN17 step, reckoned by hand: G1 over
    [8, 72, 2^17] (73 ordinary channels at level 0), G2 over the 13 parts
    of level 1 (alpha 5, eleven of 6, the base prime alone) with a 90-word
    table row each, G3 with S = 6.  At the 62-bit REDC rate the probe
    measured (510-535 G/s, PERF.md) G1 and G2 are bound by bytes; G3's 15
    REDCs to 12 words a coefficient sit at the crossing there, and it is
    bound by bytes at logN15's S = 2."""
    N = 1 << 17
    alphas = [5] + [6] * 11 + [1]
    cases = {
        "rescale": (roofline.rescale_bytes(8, 72, N, 8),
                    roofline.rescale(8 * 72, N),
                    8 * (8 * N * 145 + 216), 8 * 72 * N),
        "parts_digits": (roofline.parts_digits_bytes(8, alphas, 6, N, 8,
                                                     13 * G._PART),
                         roofline.parts_digits(8, alphas, N),
                         8 * (8 * N * (72 + 13 * 6) + 13 * 90),
                         8 * N * (10 + 11 * 15)),
        "pdiv_p0": (roofline.pdiv_p0_bytes(8, 6, N, 8),
                    roofline.pdiv_p0(8, 6, N),
                    8 * (96 * N + 30 + 12), 8 * N * 15),
    }
    cases["pdiv_p0 at S = 2"] = (roofline.pdiv_p0_bytes(8, 2, N // 4, 8),
                                 roofline.pdiv_p0(8, 2, N // 4),
                                 8 * (32 * N // 4 + 2 + 4), 8 * N // 4)
    for name, (nbytes, redc, want_bytes, want_redc) in cases.items():
        assert (nbytes, redc) == (want_bytes, want_redc), name
        b = roofline.bound(nbytes, redc, 510e9)
        assert b["bound_by"] == ("operations" if name == "pdiv_p0"
                                 else "bytes"), name


@pytest.mark.parametrize("op", ["mod_add", "mod_sub"])
def test_modew_add_and_sub_do_no_redc(tp, redc_count, op):
    """G4's add and subtract reduce by selects alone: their plain versions
    run no REDC, and ``roofline`` counts none (only their bytes)."""
    lp = tp.lp(LEVEL, False)
    gen = torch.Generator().manual_seed(8)
    a, b = (_uniform(gen, 2 * lp.pack.q, (BATCH, lp.num_channels, 1 << LOGN))
            for _ in range(2))
    redc_count[0] = 0
    getattr(G, op + "_plain")(a, b, lp)
    assert redc_count[0] == 0


def test_modew_shapes_counts():
    """G4's formulas at logN15's shapes, reckoned by hand: the LayerNorm's
    centring (a chunk of 93 level-1 ciphertexts, 16 rows, less one
    unstacked mean: 187 row sets; its product by a [C, 1] column), the
    outputs' level_up (4 rows, a [B, C, 1] column) and a rotsum add on [8,
    17, N].  At the 62-bit REDC rate the probe measured (510-535 G/s,
    PERF.md) each is bound by bytes."""
    N = 1 << 15
    cases = {
        "centring sub": (roofline.mod_add_bytes(93, 16, N, 8, b_batch=1), 0,
                         8 * (187 * 16 * N + 16), 0),
        "centring scalar": (roofline.mont_scalar_bytes(93, 16, N, 8),
                            roofline.mont_scalar(93 * 16, N),
                            8 * (186 * 16 * N + 48), 93 * 16 * N),
        "level_up per row": (roofline.mont_scalar_bytes(93, 4, N, 8,
                                                        col_batch=93),
                             roofline.mont_scalar(93 * 4, N),
                             8 * (186 * 4 * N + 95 * 4), 93 * 4 * N),
        "rotsum add": (roofline.mod_add_bytes(8, 17, N, 8), 0,
                       8 * (24 * 17 * N + 17), 0),
    }
    for name, (nbytes, redc, want_bytes, want_redc) in cases.items():
        assert (nbytes, redc) == (want_bytes, want_redc), name
        assert roofline.bound(nbytes, redc, 510e9)["bound_by"] == "bytes"


def test_bound_takes_the_larger_term():
    b = roofline.bound(3.35e9, 10**9, 1e12)  # 1 ms of bytes, 1 ms of REDCs
    assert b["bytes_bound_ms"] == pytest.approx(1.0)
    assert b["compute_bound_ms"] == pytest.approx(1.0)
    assert b["bound_by"] == "bytes"
    b = roofline.bound(3.35e9, 2 * 10**9, 1e12)
    assert b["bound_ms"] == pytest.approx(2.0)
    assert b["bound_by"] == "operations" and b["redc"] == 2 * 10**9


def test_csprng_bounds():
    """R1-R4: 128 bytes a base row read, 16 a stepped row written, the
    samples and other inputs once; the issue term is rows x replicas x
    SASS instructions over 32 lanes at 132 x 4 warp issues a cycle."""
    assert roofline.csprng_bytes(10, 4, 320, 64) == 1280 + 64 + 320 + 64
    assert roofline.warp_issue_per_s(1e9) == 528e9
    b = roofline.issue_bound(3.35e9, 528 * 32 * 10**6, 2000, 1e9)
    assert b["bytes_bound_ms"] == pytest.approx(1.0)
    assert b["compute_bound_ms"] == pytest.approx(2000.0)
    assert b["bound_by"] == "operations" and b["bound_ms"] == b[
        "compute_bound_ms"]
    b = roofline.issue_bound(3.35e12, 10, None, 1e9)
    assert b["bound_ms"] == pytest.approx(1000.0)
    assert b["bound_by"] == "bytes" and b["compute_bound_ms"] is None
