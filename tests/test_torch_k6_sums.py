"""K6's deferred sums (``csrc/keyswitch.cu``, ``mont.cuh``: "Sums of
products"), on the CPU.

K6's 62-bit lane sums the basis extension's digit products (pass 1) and
the keys' part products (pass 2) as exact 128-bit integers and reduces
each output word once; a sum longer than its run (``ntt_kernels.sum_runs``,
held by the ``LevelPack``) is reduced a run of digits at a time (pass 1)
or folded between runs of parts (pass 2).  Here:

* an exact integer model of both sums, their runs and their reduction,
  step for step as the kernel computes them (the biased digits and fold
  words, the 64-bit wraps), against the plain chain of reductions mod q
  and against the exact residue, on random and extreme inputs over the
  prime chains of ``Preset.logN15`` and ``Preset.logN17``, at the runs of
  the chain and at short ones: equal residues, and the kernel's word in
  [0, 2q);
* the runs: every level of every 62-bit preset the port's config defines
  sums whole (no second run, no fold), the runs are the longest the bound
  admits, and every view of a ``CkksParams`` holds them and 2^64 mod q;
* K6's lazy accumulators in other representatives of the same residues
  give the keyswitch's canonical outputs byte for byte (the P-division
  reads residues only);
* the count of K6's products and reductions (``ops/roofline.py``);
* ``csrc/keyswitch.cu`` itself, built for the host by ``g++``
  (``_cuda_host``: a launch's blocks in turn, a block's threads as
  threads, ``__syncthreads`` a barrier), through the wrapper on CPU
  tensors against ``ntt_keymul_parts_plain``: residues equal and outputs
  in [0, 2q) in the 62-bit lane, bytes equal in the 30-bit lane, on
  random digits and on adversarial ones (+-(2^62 - 1), the plain REDC's
  extremes, and +-(q - 1) / 2, keys at q - 1, every part at its largest
  alpha), over a chain of 31 parts (a fold) and at short runs (several
  runs of digits, several folds).

The card's build: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
Tolerance: none.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from tiberate_tpu_torch.config.ckks_config import CkksConfig
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.context.ntt_context import CkksParams
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.ops import cuda_build, mont, roofline
from tiberate_tpu_torch.ops import ntt_kernels as K
from tiberate_tpu_torch.utils.primes import find_the_next_prime

import _cuda_host

torch.set_num_threads(1)

R_BITS = 62
M64 = (1 << 64) - 1
BIAS = 1 << 63


def _k(q):
    return ((1 << R_BITS) * pow(1 << R_BITS, -1, q) - 1) // q


def _u64(x):
    return x & M64


def _s64(x):
    x &= M64
    return x - (1 << 64) if x >> 63 else x


# ----------------------------------------------------------------------
# The kernel's arithmetic in Python integers.
# ----------------------------------------------------------------------


def redc_wide(p, q, k):
    """mont.cuh's ``redc_wide`` on the 128-bit word p: floor(p / 2^62) +
    floor(m q / 2^62) + [m != 0], mod 2^64 (as the kernel's u64)."""
    p &= (1 << 128) - 1
    m4 = _u64(_u64(p) * _u64(k << 2))
    t = (m4 * q) >> 64
    return _u64((p >> 62) + t + (m4 != 0))


def redc_by(x, c, q, k):
    """mont.cuh's ``redc_by``: the biased word x + 2^63 times c."""
    return _s64(redc_wide((_u64(x) ^ BIAS) * c, q, k) - (c << 1))


def ext_word(digits, consts, q, k, f, run):
    """Pass 1's extension of one word, as ``parts_strided_k`` forms it:
    alpha = 1, one ``redc_by`` into [0, 2q); else, for each run of at
    most ``run`` digits, the sum of the biased digits' products from
    -2^63 sum c, then ``redc_sum_signed`` and +q where negative, the
    runs' results added lazily (``tile_add``)."""
    if len(digits) == 1:
        x = redc_by(digits[0], consts[0], q, k)
        return x + 2 * q if x < 0 else (x if x < 2 * q else x - 2 * q)
    out = None
    for a0 in range(0, len(digits), run):
        ds, cs = digits[a0:a0 + run], consts[a0:a0 + run]
        acc = -(sum(cs) << 63)
        for d, c in zip(ds, cs):
            acc += (_u64(d) ^ BIAS) * c
        assert -(1 << 127) <= acc < 1 << 127
        acc &= (1 << 128) - 1
        hi, lo = acc >> 64, acc & M64
        x = _s64(redc_wide((hi ^ BIAS) * f + lo, q, k) - (f << 1))
        x = x + q if x < 0 else x
        assert 0 <= x < 2 * q
        out = x if out is None else (out + x if out + x < 2 * q
                                     else out + x - 2 * q)
    return out


def key_word(vs, keys, q, k, f, run):
    """Pass 2's accumulator word, as ``parts_contig_k`` forms it: the sum
    of v key over the parts, folded (``fold_sum``) after every ``run``
    parts where parts follow, then ``redc_sum``."""
    acc = 0
    for p, (v, key) in enumerate(zip(vs, keys)):
        acc += v * key
        assert acc < 1 << 128
        if (p + 1) % run == 0 and p + 1 < len(vs):
            acc = (acc >> 64) * f + (acc & M64)
    return redc_wide((acc >> 64) * f + (acc & M64), q, k)


def exact_redc(s, q, k):
    """(s + m q) / 2^62 with m = (s k) mod 2^62, in unbounded integers."""
    m = (s * k) % (1 << R_BITS)
    assert (s + m * q) % (1 << R_BITS) == 0
    return (s + m * q) >> R_BITS


def _chain(pairs, q, pack, add):
    """The plain version's chain over (x, c) pairs: mont_mult each, then
    ``add`` (mont_add), as torch int64 of one channel."""
    xs = torch.tensor([[x for x, _ in pairs]], dtype=torch.int64)
    cs = torch.tensor([[c for _, c in pairs]], dtype=torch.int64)
    prods = mont.mont_mult(xs, cs, pack)[0].tolist()
    out = prods[0]
    for y in prods[1:]:
        out = add(out, y)
    return out


def _preset_chain(name):
    cfg = CkksConfig.parse(name)
    return cfg, [int(q) for q in cfg.q]


def _above_2_59(n=8):
    """NTT-friendly primes just above 2^59: 2^64 mod q is near q there."""
    out, q = [], (1 << 59) + 1
    for _ in range(n):
        q = find_the_next_prime(q, 1 << 18, up=True)
        out.append(q)
        q += 2
    return out


def _chains(name):
    """(alpha at most, primes) of a preset's chain, or of primes just
    above 2^59 with logN17's six."""
    if name == "above2^59":
        return 6, _above_2_59()
    cfg, chain = _preset_chain(name)
    return cfg.num_special_primes, chain


def _cases(rng, q_digits, q, n, alpha):
    """n digit vectors of length alpha and their constants: random int64
    digits, random digits of the primes' size, and the extremes (int64's,
    +-(q_i - 1) / 2, 0) with constants at q - 1 and 0."""
    extremes = [-(1 << 63), (1 << 63) - 1, 0]
    for qi in q_digits:
        extremes += [(qi - 1) // 2, -((qi - 1) // 2), qi - 1]
    out = []
    for j in range(n):
        if j % 3 == 0:
            d = [rng.randrange(-(1 << 63), 1 << 63) for _ in range(alpha)]
        elif j % 3 == 1:
            d = [rng.randrange(-2 * qi, 2 * qi)
                 for qi in rng.sample(q_digits, alpha)]
        else:
            d = [rng.choice(extremes) for _ in range(alpha)]
        c = [rng.choice([q - 1, 0, rng.randrange(q)]) if j % 3 == 2
             else rng.randrange(q) for _ in range(alpha)]
        out.append((d, c))
    out.append(([-(1 << 63)] * alpha, [q - 1] * alpha))
    out.append(([(1 << 63) - 1] * alpha, [q - 1] * alpha))
    return out




@pytest.mark.parametrize("preset", ["logN15", "logN17", "above2^59"])
def test_extension_sum_model_equals_the_chain(preset):
    """Pass 1: the kernel's reduction of the exact sums equals the exact
    residue sum d c R^-1 mod q for every int64 digit, and the plain chain
    (mont_mult + mont_add per digit) below 2^62, the plain REDC's domain,
    and lies in [0, 2q), for alpha 1 up to the chain's run of digits (at
    most the chain's length) and
    in runs of two digits up to alpha 7 (a run's remainder of one digit
    too), over every prime of the chain; above 2^59 the fold's +q branch
    runs on sums of int64's most negative digits."""
    S, chain = _chains(preset)
    digits = K.sum_runs(chain)[0]
    assert digits >= S
    rng = random.Random(f"ext-{preset}")
    negative = 0
    for q in chain:
        k, f = _k(q), (1 << 64) % q
        pack = mont.ModPack.from_q([q])
        Rinv = pow(1 << R_BITS, -1, q)
        for run, top in ((digits, min(digits, len(chain))), (2, 7)):
            for alpha in range(1, top + 1):
                for d, c in _cases(rng, chain, q, 12 if run == digits else 3,
                                   alpha):
                    got = ext_word(d, c, q, k, f, run)
                    assert 0 <= got < 2 * q, (q, d, c)
                    want = sum(x * y for x, y in zip(d, c)) * Rinv % q
                    assert got % q == want
                    if max(abs(x) for x in d) < 1 << 62 and run == digits:
                        # the plain REDC's domain (ops/mont.py)
                        plain = _chain(list(zip(d, c)), q, pack,
                                       lambda a, b: mont.mont_add(
                                           torch.tensor([[a]]),
                                           torch.tensor([[b]]), pack).item())
                        assert plain % q == want
                    if 1 < alpha <= run:
                        s = sum(x * y for x, y in zip(d, c))
                        hi, lo = s >> 64, s & M64
                        r = exact_redc(hi * f + lo, q, k)
                        assert got == (r + q if r < 0 else r)
                        negative += r < 0
    if preset == "above2^59":
        for q in chain:
            for _ in range(200):
                d = [-(1 << 63)] * S
                c = [rng.randrange(q) for _ in range(S)]
                s = sum(x * y for x, y in zip(d, c))
                r = exact_redc((s >> 64) * ((1 << 64) % q) + (s & M64), q,
                               _k(q))
                negative += r < 0
                got = ext_word(d, c, q, _k(q), (1 << 64) % q, digits)
                assert 0 <= got < 2 * q
                assert got % q == s * pow(1 << R_BITS, -1, q) % q
        assert negative > 0


@pytest.mark.parametrize("preset", ["logN15", "logN17", "above2^59"])
def test_part_sum_model_equals_the_chain(preset):
    """Pass 2: the kernel's reduction of sum_p v_p key_p (v in [0, 2q),
    keys in [0, q)) over the preset's number of parts at level 0, and
    over twice the chain's run of parts and one more (two folds), equals
    the plain chain of mont_mult and mont_add over the parts and the
    exact residue, and lies in [0, 2q); at the largest words the sums
    reach the bound's edge."""
    _, chain = _chains(preset)
    run = K.sum_runs(chain)[1]
    n_preset = 13 if preset == "above2^59" else _layouts(
        _preset_chain(preset)[0])[0][1]
    assert n_preset <= run
    rng = random.Random(f"key-{preset}")
    for q in chain:
        k, f = _k(q), (1 << 64) % q
        pack = mont.ModPack.from_q([q])
        Rinv = pow(1 << R_BITS, -1, q)
        for n_parts in (n_preset, 2 * run + 1):
            for j in range(10 if n_parts == n_preset else 4):
                if j == 0:
                    vs, keys = [2 * q - 1] * n_parts, [q - 1] * n_parts
                elif j == 1:
                    vs, keys = [0] * n_parts, [q - 1] * n_parts
                else:
                    vs = [rng.randrange(2 * q) for _ in range(n_parts)]
                    keys = [rng.randrange(q) for _ in range(n_parts)]
                got = key_word(vs, keys, q, k, f, run)
                assert 0 <= got < 2 * q
                want = sum(v * y for v, y in zip(vs, keys)) * Rinv % q
                assert got % q == want
                plain = _chain(list(zip(vs, keys)), q, pack,
                               lambda a, b: mont.mont_add(
                                   torch.tensor([[a]]), torch.tensor([[b]]),
                                   pack).item())
                assert plain % q == want


# ----------------------------------------------------------------------
# The runs.
# ----------------------------------------------------------------------


def _layouts(cfg):
    """(amax, n_parts) of the keyswitch parts at every level of ``cfg``
    (``CkksParams._build_parts``: groups of S over the ordinary primes
    but the base, aligned to level 0, the base prime its own part)."""
    S = cfg.num_special_primes
    P = len(cfg.q) - S
    out = []
    for lvl in range(P):
        sizes = []
        gi = lvl // S
        while gi * S < P - 1:
            lo, hi = max(gi * S, lvl), min((gi + 1) * S, P - 1)
            if hi > lo:
                sizes.append(hi - lo)
            gi += 1
        sizes.append(1)
        out.append((max(sizes), len(sizes)))
    return out


@pytest.mark.parametrize("preset", ["logN14", "logN15", "logN16", "logN17"])
def test_every_preset_fits_the_sums(preset):
    """Every level of every 62-bit preset sums whole: its largest alpha
    fits one run of digits and its parts one run of parts, so the
    kernel makes one reduction a sum and no fold (the runs cost the
    presets nothing); the sums stay inside 128 bits."""
    cfg, chain = _preset_chain(preset)
    S = cfg.num_special_primes
    digits, parts = K.sum_runs(chain)
    for lvl, (amax, n_parts) in enumerate(_layouts(cfg)):
        assert amax <= digits and n_parts <= parts, (lvl, amax, n_parts)
        q_sp = chain[lvl:]
        s1 = amax * (1 << 63) * max(q_sp)
        s2 = n_parts * (2 * max(q_sp)) * max(q_sp)
        assert s1 < 1 << 127 and s2 < 1 << 128
    assert _layouts(cfg)[0][0] == S


def _high_word_fits(h, q):
    return h * (q - 1) + (1 << 64) <= q << 62


def test_bound_refuses_long_sums():
    """``sum_runs`` gives the longest runs the bound admits: at 2^60 - 1,
    7 digits and 23 parts; at the largest words one digit or one part
    more breaks it (a high word past the bound), the runs' own keep it;
    moduli of 62 bits leave no run and are refused."""
    for q in ((1 << 60) - 1, (1 << 60) - 262143, _above_2_59()[0],
              (1 << 61) - 1):
        digits, parts = K.sum_runs([q])
        if q == (1 << 60) - 1:
            assert (digits, parts) == (7, 23)
        for run, fits in ((digits, True), (digits + 1, False)):
            h = -(-run * (q - 1) // 2)  # |H| of run 2^63 (q - 1)
            assert _high_word_fits(h, q) == fits
        top = ((1 << 64) - 1) * q  # a folded sum at its largest
        for run, fits in ((parts, True), (parts + 1, False)):
            h = (top + run * (2 * q - 1) * (q - 1)) >> 64
            assert _high_word_fits(h, q) == fits
    assert K.sum_runs([(1 << 59) + 1, (1 << 60) - 1]) == (7, 23)
    with pytest.raises(ValueError, match="no room"):
        K.sum_runs([(1 << 62) - 57])


@pytest.fixture(scope="module")
def toy6():
    """logN 7, 14 scales, six special primes of 60 bits: parts of alpha up
    to 6, as logN17's.  The scale primes lie either side of 2^59: those
    just above it have 2^64 mod q near q, so the signed fold of pass 1
    lands below 0 for about one sum of one sign in 16 (the +q branch);
    the presets' primes, just below 2^60 or of 40 bits, seldom reach it."""
    return CkksParams(toy_config(logN=7, num_scales=14, num_special_primes=6,
                                 scale_bits=59), "cpu")


def _key_parts(gen, tp, level, n_parts, hi_key=False):
    lp0 = tp.lp(0, True)
    q = lp0.pack.q.long()[:, None]
    out = []
    for _ in range(n_parts):
        pair = []
        for _ in range(2):
            x = torch.randint(0, 1 << 62, (lp0.num_channels, tp.N),
                              generator=gen) % q
            if hi_key:
                x[...] = q - 1
            pair.append(x.to(tp.dtype)[level:])
        out.append(tuple(pair))
    return tuple(out)


def test_level_packs_hold_the_runs(toy6):
    """``CkksParams`` works the runs out once, from the whole basis, and
    every level view holds them and 2^64 mod q of its own rows (a slice
    and a shard's list of rows, on ``to``); the 30-bit lane sums nothing
    and holds no runs."""
    want = K.sum_runs([int(q) for q in toy6.q])
    for lvl in range(3):
        for special in (False, True):
            lp = toy6.lp(lvl, special)
            assert lp.sum_runs == want
            assert lp.fold.tolist() == [(1 << 64) % q
                                        for q in lp.pack.q.tolist()]
    rows = toy6.lp(1, True)[[0, 3, 5]].to("cpu")
    assert rows.sum_runs == want
    assert rows.fold.tolist() == [(1 << 64) % q
                                  for q in rows.pack.q.tolist()]
    tp30 = CkksParams(toy_config(logN=7, num_scales=3, scale_bits=21,
                                 buffer_bit_length=30), "cpu")
    assert tp30.lp(0, True).sum_runs == (0, 0)


def test_lazy_representatives_give_the_same_keyswitch(toy6):
    """The P-division after K6 (``_pdiv_fused``: iNTT-exit of the special
    rows, G3, K4) gives the same canonical bytes for any representative
    in [0, 2q) of K6's residues: the plain accumulators against the same
    with q added to a seeded half of the words below q."""
    lvl = 1
    lp_sp, lp_ord = toy6.lp(lvl, True), toy6.lp(lvl, False)
    gen = torch.Generator().manual_seed(11)
    ec, alphas = teng._parts_consts(toy6, lvl)
    x = torch.randint(0, 1 << 62, (2, lp_ord.num_channels, toy6.N),
                      generator=gen) % lp_ord.pack.q.long()[:, None]
    st = teng._parts_digits(x, toy6.parts[lvl], lp_ord, ec.shape[-1])
    keys = _key_parts(gen, toy6, lvl, ec.shape[0])
    q = lp_sp.pack.q.long()[:, None]
    for acc in K.ntt_keymul_parts(st, ec, alphas, keys, lp_sp):
        assert bool(((acc >= 0) & (acc < 2 * q)).all())
        canon = acc % q
        flip = torch.randint(0, 2, acc.shape, generator=gen).bool()
        other = torch.where(flip, canon + q, canon)
        assert not torch.equal(other, acc)
        args = (lp_sp, lp_ord, toy6.PiRs[lvl], toy6.S)
        assert torch.equal(teng._pdiv_fused(acc, *args),
                           teng._pdiv_fused(other, *args))


def test_sums_counter():
    """``roofline.keymul_parts_sums``: at logN17's level 1 (13 parts of
    [5, 6 x 11, 1], 78 with-special channels, batch 8) a launch sums
    8.0e9 products in 1.23e9 reductions; the 30-bit lane (no runs)
    reduces every product; short runs reduce a run of digits at a time
    and fold between runs of parts.  ``ntt_keymul_parts`` counts the
    butterflies' REDCs beside them."""
    alphas = [5] + [6] * 11 + [1]
    B, C_sp, N, logN = 8, 78, 1 << 17, 17
    words = B * C_sp * N
    prods, reds = roofline.keymul_parts_sums(B, alphas, C_sp, N, (8, 24))
    assert prods == words * (72 + 26) == 8_015_314_944
    assert reds == words * 15 == 1_226_833_920
    assert roofline.keymul_parts_sums(B, alphas, C_sp, N) == (prods, prods)
    assert roofline.keymul_parts_sums(B, alphas, C_sp, N, (2, 3)) == (
        prods + words * 2 * 4, words * (3 + 11 * 3 + 1 + 2))
    bfly = B * C_sp * 13 * (N // 2 * logN)
    assert roofline.ntt_keymul_parts(B, alphas, C_sp, logN) == bfly + prods
    assert roofline.ntt_keymul_parts(B, alphas, C_sp, logN, (8, 24)) == \
        bfly + reds


# ----------------------------------------------------------------------
# csrc/keyswitch.cu built for the host.
# ----------------------------------------------------------------------

# the logN cases the host build instantiates (the card's: 4..17)
_HOST_LOGN = (7, 8)


@pytest.fixture(scope="module")
def host_k6(tmp_path_factory):
    """``csrc/keyswitch.cu`` as a host library (``_cuda_host``), a block's
    threads as threads: its passes exchange words through shared
    memory."""
    lib = _cuda_host.build(
        tmp_path_factory.mktemp("k6_host"), "keyswitch.cu",
        {"tt_ntt_keymul_parts" + sfx: cuda_build._LANED["tt_ntt_keymul_parts"]
         for sfx in ("", "_30")}, logn=_HOST_LOGN, threads=True)
    if lib is None:
        pytest.skip("needs g++ to build csrc/keyswitch.cu on the host")
    return lib


@pytest.fixture
def host_launch(host_k6, monkeypatch):
    """The wrapper launches the host build on CPU tensors."""
    monkeypatch.setattr(cuda_build, "lib", lambda: host_k6)
    monkeypatch.setattr(K, "_on_cpu", lambda x, kernels=1: False)
    monkeypatch.setattr(K, "_stream", lambda device: None)
    K.reset_launch_counts()


def _k6_inputs(tp, level, seed, adversarial):
    lp_ord, lp_sp = tp.lp(level, False), tp.lp(level, True)
    gen = torch.Generator().manual_seed(seed)
    ec, alphas = teng._parts_consts(tp, level)
    x = torch.randint(0, 1 << 62, (2, lp_ord.num_channels, tp.N),
                      generator=gen) % lp_ord.pack.q.long()[:, None]
    st = teng._parts_digits(x.to(tp.dtype), tp.parts[level], lp_ord,
                            ec.shape[-1]).contiguous()
    keys = _key_parts(gen, tp, level, ec.shape[0], hi_key=adversarial)
    if adversarial:
        # the plain REDC's extremes +-(2^62 - 1) (its domain) and +-(q_i
        # - 1) / 2 of the part's primes, in every digit row a part has;
        # zero rows past alpha stay zero
        top = (1 << 62) - 1 if st.dtype == torch.int64 else (1 << 29) - 1
        for p, part in enumerate(tp.parts[level]):
            qs = lp_ord.pack.q[part.lo:part.hi].long()
            half = (qs - 1) // 2
            for a in range(part.alpha):
                vals = torch.tensor([-top, top, int(half[a]),
                                     -int(half[a]), int(qs[a]) - 1, 0],
                                    dtype=st.dtype)
                pick = torch.randint(0, len(vals), (2, tp.N), generator=gen)
                # a quarter of the strided pass's [N1, N2] grid columns
                # at -top in every row, a quarter at +top: sums of one
                # sign, as long as they get
                col = torch.arange(tp.N) % (1 << (tp.logN - tp.logN // 2))
                pick[:, col % 4 == 0] = 0
                pick[:, col % 4 == 1] = 1
                st[:, p, a] = vals[pick]
    return st, ec, alphas, keys, lp_sp


def _check_k6(got, want, lp_sp, lane):
    q = lp_sp.pack.q.long()[:, None]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if lane == 30:
            assert torch.equal(g, w)
            continue
        g, w = g.long(), w.long()
        assert bool(((g >= 0) & (g < 2 * q)).all())
        assert torch.equal(g % q, w % q)


@pytest.mark.parametrize("adversarial", [False, True],
                         ids=["random", "adversarial"])
@pytest.mark.parametrize("level", [0, 1])
def test_kernel_source_matches_plain(toy6, host_launch, level, adversarial):
    """K6's CUDA source through the wrapper, 62-bit lane, logN 7, parts
    of alpha up to 6: residues equal to the plain version's, outputs in
    [0, 2q); one launch."""
    st, ec, alphas, keys, lp_sp = _k6_inputs(toy6, level, 20 + level,
                                             adversarial)
    got = K.ntt_keymul_parts(st, ec, alphas, keys, lp_sp)
    want = K.ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp)
    _check_k6(got, want, lp_sp, 62)
    assert K.LAUNCHES["ntt_keymul_parts"] == 1


@pytest.mark.parametrize("runs", [(2, 3), (1, 1), (5, 2)],
                         ids=["2-3", "1-1", "5-2"])
def test_kernel_source_at_short_runs(toy6, host_launch, runs):
    """The level pack's runs cut short, so that parts of alpha 6 sum in
    runs of digits (of two, of one, of five and a remainder of one) and
    level 0's four parts fold between runs of parts (once, after every
    part, twice): adversarial digits and keys, residues equal to the
    plain version's, outputs in [0, 2q)."""
    st, ec, alphas, keys, lp_sp = _k6_inputs(toy6, 0, 50 + runs[0], True)
    assert alphas.tolist() == [6, 6, 2, 1]
    lp_sp = dataclasses.replace(lp_sp, sum_runs=runs)
    got = K.ntt_keymul_parts(st, ec, alphas, keys, lp_sp)
    _check_k6(got, K.ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp),
              lp_sp, 62)


@pytest.mark.parametrize("level", [0, 1])
def test_kernel_source_long_chain(host_launch, level):
    """One special prime and 30 scale primes of 59 bits beside a base
    just below 2^60: 31 parts of alpha 1 at level 0 and 30 at level 1,
    more than the basis's run of 23 parts, so pass 2 folds its sums once
    (a configuration the runs make work: the presets have 13 or fewer);
    adversarial digits and keys, residues equal to the plain version's,
    outputs in [0, 2q)."""
    tp = CkksParams(toy_config(logN=7, num_scales=30, num_special_primes=1,
                               scale_bits=59), "cpu")
    assert tp.lp(0, True).sum_runs[1] < len(tp.parts[level])
    st, ec, alphas, keys, lp_sp = _k6_inputs(tp, level, 60 + level, True)
    got = K.ntt_keymul_parts(st, ec, alphas, keys, lp_sp)
    _check_k6(got, K.ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp),
              lp_sp, 62)


@pytest.mark.parametrize("logN", _HOST_LOGN)
def test_kernel_source_30bit_lane_unchanged(host_launch, logN):
    """The 30-bit lane keeps its per-product reductions: byte for byte
    the plain version, at both host-built sizes."""
    tp = CkksParams(toy_config(logN=logN, num_scales=4, num_special_primes=2,
                               scale_bits=21, buffer_bit_length=30), "cpu")
    st, ec, alphas, keys, lp_sp = _k6_inputs(tp, 1, 30 + logN, False)
    got = K.ntt_keymul_parts(st, ec, alphas, keys, lp_sp)
    want = K.ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp)
    _check_k6(got, want, lp_sp, 30)
    assert K.LAUNCHES["ntt_keymul_parts_30"] == 1


def test_kernel_source_at_two_chunks(host_launch):
    """logN 8 (L1 = 4, L2 = 4: pass 2 of two rounds, one exchange buffer)
    in the 62-bit lane, two special primes, level 0's parts of [2, 2,
    1], adversarial digits and keys."""
    tp = CkksParams(toy_config(logN=8, num_scales=4, num_special_primes=2,
                               scale_bits=30), "cpu")
    st, ec, alphas, keys, lp_sp = _k6_inputs(tp, 0, 8, True)
    assert np.array_equal(np.asarray(alphas), [2, 2, 1])
    got = K.ntt_keymul_parts(st, ec, alphas, keys, lp_sp)
    _check_k6(got, K.ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp),
              lp_sp, 62)


@pytest.mark.parametrize("level", [0, 1])
def test_kernel_source_intermediate_in_range(toy6, host_k6, level):
    """Pass 1's output ``tmp`` (the extension after the strided stages),
    read through the entry point itself: every word in [0, 2q) on the
    adversarial digits, whose signed sums reach the fold's +q branch at
    the scale primes above 2^59 (the model above holds that branch to
    the exact residue); the outputs as in the test above."""
    st, ec, alphas, keys, lp_sp = _k6_inputs(toy6, level, 40 + level, True)
    B, (n_parts, amax, N) = st.shape[0], st.shape[1:]
    C_sp = lp_sp.num_channels
    tables = K.key_tables(keys)
    tmp = torch.empty((B, n_parts, C_sp, N), dtype=torch.int64)
    acc = [torch.empty((B, C_sp, N), dtype=torch.int64) for _ in range(2)]
    ptr = K._ptr
    rc = host_k6.tt_ntt_keymul_parts(
        ptr(st), ptr(ec), ptr(alphas), ptr(tmp), ptr(tables.k0p),
        ptr(tables.k1p), ptr(acc[0]), ptr(acc[1]), B, n_parts, amax, C_sp,
        7, ptr(lp_sp.pack.q), ptr(lp_sp.pack.k), ptr(lp_sp.psi),
        ptr(lp_sp.fold), *lp_sp.sum_runs, None)
    assert rc == 0
    q = lp_sp.pack.q.long()[:, None]
    assert bool(((tmp >= 0) & (tmp < 2 * q)).all())
    _check_k6(acc, K.ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp),
              lp_sp, 62)
