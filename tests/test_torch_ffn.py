"""The stacked linear op (``CkksEngine.mult_matrix``), its modular matrix
product (``ops/matmul.py``: wrapper, plain version; ``csrc/matmul.cu``)
and ``HEFeedForwardFeatureWise``, on the CPU, in both lanes (62-bit
int64, 30-bit int32) where the lane matters.

* ``mult_matrix`` against the port's own composition (per weight
  ``mult_int_scalar`` by the integer ``mult_scalar`` would take, the
  ``cc_add`` sum, ``rescale``, ``add_scalar``), against the same
  composition on the JAX engine (keys and ciphertexts carried over), and
  the unrescaled sums against exact residues in Python integers.
* The plain version at residues q - 1 with the largest and least
  weights five and eight bytes hold, over a run of ``matmul_run``
  features and past it, against the exact residue; the run's int32
  bound; the weights' balanced bytes; an integer model of the kernel's
  class sums and their one reduction, in ``redc_sum_signed``'s domain
  and exact, for every residue and weight width.
* ``csrc/matmul.cu`` built for the host by g++ (``_cuda_host``, a block's
  threads as threads of their own: the kernel stages its operands in
  shared memory, and its MMA's host model exchanges a warp's fragments
  there), launched through the wrapper on CPU tensors against the plain
  version byte for byte, with ``LAUNCHES`` and the engagement counters
  counted: 40-, 41- and 60-bit channels of logN15's chain (5, 6 and 8
  bytes a residue), the 30-bit chain, one to eight bytes a weight, a
  ragged output tile, weights read 16 bytes at a time and byte by byte,
  an accumulator updated in place, two runs at the bound.
* The wrappers refuse what the kernel does not read, on every device.
* ``HEFeedForwardFeatureWise`` at 8 hidden and 32 intermediate features:
  in blocks of 12 the residues of one block; every residue
  ``fhebench/reference/ffn.py``'s circuit's; decrypted within
  ``CIRCUIT_TOL`` of its float64 circuit, which lies within
  ``FORWARD_TOL`` of the float forward; its spans and their launches.

Tolerance: none for residues.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from fhebench.reference import ckks as rref
from fhebench.reference import ffn as rffn
from tiberate_tpu.config.toy import toy_config as jtoy_config
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.config import CkksConfig
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.engine import stack_ciphertexts, unstack_ciphertext
from tiberate_tpu_torch.extension import nn as tnn
from tiberate_tpu_torch.ops import cuda_build
from tiberate_tpu_torch.ops import matmul as mm
from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt_kernels as K
from tiberate_tpu_torch.utils import trace

import _cuda_host

torch.set_num_threads(1)

# lane -> (toy config options, launch-count suffix)
LANES = {62: (dict(scale_bits=30), ""),
         30: (dict(scale_bits=21, buffer_bit_length=30), "_30")}
F_IN, F_OUT = 5, 3
H, I = 8, 32
CIRCUIT_TOL = 1e-6    # the toy's 2^30 scale over 3 levels: ~1e-7 read
FORWARD_TOL = 1e-6    # weights rounded to 2^-30: ~1e-9 read


def _cfg(lane, make=toy_config, **kw):
    opts = dict(logN=7, num_scales=6, num_special_primes=2,
                **LANES[lane][0])
    opts.update(kw)
    return make(**opts)


@pytest.fixture(scope="module", params=sorted(LANES))
def lane(request):
    return request.param


def _weights(rng):
    """[F_IN, F_OUT] weights: one beyond one limb at the toy scales."""
    w = rng.normal(0.0, 0.3, (F_IN, F_OUT))
    w[0, 0] = 1.7
    return w


@pytest.fixture(scope="module")
def pair(lane):
    """The JAX and the port engine on one configuration object, the
    port's keys and ciphertexts carried from the JAX engine: (jax engine,
    port engine, JAX ciphertexts, the port's stack, weights, bias)."""
    cfg = _cfg(lane, jtoy_config)
    j = jeng.CkksEngine(cfg, seed=7, nonce=2)
    t = teng.CkksEngine(cfg, device="cpu", seed=7, nonce=2)
    rng = np.random.default_rng(lane)
    x = rng.uniform(-1, 1, (F_IN, t.num_slots))
    jcts = [j.encodecrypt(x[f]) for f in range(F_IN)]
    t.sk = interop.from_jax(j.sk, device="cpu")
    X = stack_ciphertexts([interop.from_jax(c, device="cpu") for c in jcts])
    return j, t, jcts, X, x, _weights(rng), rng.uniform(-0.2, 0.2, F_OUT)


def _ints(eng, w, level):
    """The integers ``mult_scalar`` takes for the weights at ``level``."""
    root = np.sqrt(eng.params.deviations[level + 1])
    return np.array([[int(v * eng.ckksCfg.scale * root + 0.5) for v in row]
                     for row in w], dtype=object)


def _composition(eng, cts, ints, bias):
    """Output j: sum_i mult_int_scalar(ct_i, W[i, j]) by cc_add, rescaled,
    plus bias[j] (``eng`` either package's engine)."""
    out = []
    for j in range(ints.shape[1]):
        acc = None
        for i, ct in enumerate(cts):
            term = eng.mult_int_scalar(ct, int(ints[i, j]))
            acc = term if acc is None else eng.cc_add(acc, term)
        out.append(eng.add_scalar(eng.rescale(acc), float(bias[j])))
    return out


def _same(stack, cts):
    for j, ct in enumerate(cts):
        assert ct.level == stack.level
        for a, b in zip(stack.data, ct.data):
            b = torch.from_numpy(np.array(b))
            assert b.dtype == a.dtype and torch.equal(a[j], b), j


def test_mult_matrix_is_the_composition(pair):
    """The port's ``mult_matrix`` gives the residues of its own
    composition, each weight's limbs those of the integer ``mult_scalar``
    takes."""
    _, t, _, X, _, w, b = pair
    enc = t.encode_matrix(w, X.level)
    ints = _ints(t, w, X.level)
    L = min(L for L in range(1, 9) if all(
        mm.limb_min(L) <= int(v) <= mm.limb_max(L) for v in ints.flat))
    assert enc.limbs.dtype == torch.int8
    assert enc.limbs.shape == (L, F_IN, F_OUT)
    assert enc.limbs.transpose(1, 2).is_contiguous()
    limbs = enc.limbs.long()
    back = sum(limbs[i] << (8 * i) for i in range(L))
    assert back.tolist() == ints.tolist()
    want = _composition(t, unstack_ciphertext(X), ints, b)
    got = t.mult_matrix(X, enc, b)
    assert got.level == X.level + 1
    _same(got, want)
    with pytest.raises(ValueError, match="level"):
        t.mult_matrix(t.rescale(X), enc)


def test_mult_matrix_is_the_jax_composition(pair, lane):
    """The JAX engine's composition on the same ciphertexts gives the
    port's ``mult_matrix`` bytes; the unrescaled sums are the exact
    residues in Python integers."""
    j, t, jcts, X, _, w, b = pair
    enc = t.encode_matrix(w, X.level)
    ints = _ints(t, w, X.level)
    _same(t.mult_matrix(X, enc, b), _composition(j, jcts, ints, b))
    sums = t._matrix_sum(X, enc)
    q = [int(v) for v in t.params.q]
    for p in range(2):
        x = X.data[p].long().numpy()
        got = sums.data[p].long().numpy()
        for jj in range(F_OUT):
            want = sum(int(ints[i, jj]) * x[i].astype(object)
                       for i in range(F_IN))
            for c in range(x.shape[1]):
                assert [int(v) % q[c] for v in want[c]] == \
                    got[jj, c].tolist()


def _edge_lp(lane, channels):
    """A level pack of ``channels`` of the logN15 (or logN15_30) preset's
    chain, as the wrapper reads it."""
    name = "logN15" if lane == 62 else "logN15_30"
    q = [int(v) for v in CkksConfig.parse(name).q]
    q = [q[c] for c in channels]
    bits = 62 if lane == 62 else 30
    pack = mont.ModPack.from_q(q, bits)
    return types.SimpleNamespace(
        pack=pack, fold=torch.tensor([(1 << 64) % p for p in q],
                                     dtype=pack.dtype),
        Rs=torch.tensor([(1 << 2 * bits) % p for p in q],
                        dtype=pack.dtype)[:, None]), q


def _exact(x, W, q):
    """sum_i W[i, j] x[i] mod q in Python integers, [F_out, C, N] of
    object."""
    x = x.long().numpy().astype(object)
    out = np.tensordot(W.numpy().astype(object), x, axes=([0], [0]))
    return np.array([[[int(v) % q[c] for v in row] for c, row in
                      enumerate(plane)] for plane in out], dtype=object)


@pytest.mark.parametrize("L", [5, 8])
@pytest.mark.parametrize("runs", [1, 2])
def test_plain_at_the_edges(lane, runs, L):
    """Residues q - 1 and weights of the largest and least L bytes hold,
    over one whole run of ``matmul_run(L)`` features and past it, on the
    40-, 41- and 60-bit channels (5, 6 and 8 bytes): the exact
    residues."""
    lp, q = _edge_lp(lane, [14, 15, 16] if lane == 62 else [0, 1, 16])
    F = mm.matmul_run(L) * runs - (runs - 1) * 7
    C, N = len(q), 32
    qt = torch.tensor(q)[:, None]
    x = (qt - 1).expand(F, C, N).clone()
    x[:, :, 1::2] = torch.randint(0, 1 << 62, (F, C, N // 2)) % qt
    x = x.to(lp.pack.dtype)
    top, least = mm.limb_max(L), max(mm.limb_min(L), -2**63)
    W = torch.full((F, 4), top)
    W[:, 1] = least
    W[::3, 2] = least
    W[:, 3] = torch.randint(-(1 << 37), 1 << 37, (F,))
    wl = mm.weight_limbs(W)
    assert wl.shape == (L, F, 4)
    assert int(wl.max()) == 127 and int(wl.min()) == -128
    out = mm.matmul_plain(x, x.flip(0), wl, lp)
    assert np.array_equal(out[0].long().numpy(), _exact(x, W, q))
    assert np.array_equal(out[1].long().numpy(), _exact(x.flip(0), W, q))


def test_the_run_bound():
    """A run's class sums of up to L byte products a feature, each at most
    255 x 128 in magnitude, stay below 2^31 for every L; one feature more
    does not."""
    for L in range(1, 9):
        run = mm.matmul_run(L)
        term = L * 255 * 128
        assert run * term < 2**31 <= (run + 1) * term, L
    assert [mm.matmul_run(L) for L in (1, 5, 8)] == [65793, 13158, 8224]


def _back(wl):
    """The weights [F_in, F_out] that balanced bytes [L, F_in, F_out]
    hold."""
    return sum(wl[b].long() << (8 * b) for b in range(wl.shape[0]))


def test_weight_limbs():
    """Balanced bytes [L, F_in, F_out], stored F_in fastest, sum back to
    the weights [F_in, F_out]: L bytes hold ``limb_min(L)`` to ``limb_max(L)``, one past
    either takes L + 1; eight hold ``MAX_WEIGHT`` (above 2^62) and -2^63;
    past ``MAX_WEIGHT`` raises."""
    assert (mm.limb_min(1), mm.limb_max(1)) == (-128, 127)
    assert mm.limb_max(5) == 127 * (2**40 - 1) // 255
    assert mm.MAX_WEIGHT == mm.limb_max(8) and 2**62 < mm.MAX_WEIGHT < 2**63
    for L in range(1, 9):
        top, least = mm.limb_max(L), max(mm.limb_min(L), -2**63)
        W = torch.tensor([[top, least, 0], [1, -1, top - 1]])
        wl = mm.weight_limbs(W)
        assert wl.dtype == torch.int8 and wl.shape == (L, 2, 3), L
        assert wl.transpose(1, 2).is_contiguous(), L
        assert torch.equal(_back(wl), W), L
        if L < 8:
            for v in (top + 1, least - 1):
                wl = mm.weight_limbs(torch.tensor([[v]]))
                assert wl.shape[0] == L + 1 and int(_back(wl)) == v, (L, v)
    gen = torch.Generator().manual_seed(3)
    W = torch.randint(-(1 << 45), 1 << 45, (7, 9), generator=gen)
    wl = mm.weight_limbs(W)
    assert wl.shape == (6, 7, 9) and torch.equal(_back(wl), W)
    assert wl[0, 2, 4] == ((int(W[2, 4]) + 128) & 255) - 128
    wl = mm.weight_limbs(torch.tensor([[-2**63, mm.MAX_WEIGHT]]))
    assert wl.shape[0] == 8
    assert _back(wl).tolist() == [[-2**63, mm.MAX_WEIGHT]]
    for bad in (mm.MAX_WEIGHT + 1, 2**63 - 1):
        with pytest.raises(ValueError, match="exceeds"):
            mm.weight_limbs(torch.tensor([[bad]]))
    with pytest.raises(ValueError, match="int64"):
        mm.weight_limbs(W.double())


# mont.cuh's REDC in Python integers, as the kernel's 64-bit words wrap
M64 = (1 << 64) - 1


def _s64(x):
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def _redc_wide(p, q, k):
    p &= (1 << 128) - 1
    m4 = (p & M64) * ((k << 2) & M64) & M64
    return ((p >> 62) + ((m4 * q) >> 64) + (m4 != 0)) & M64


def _redc_sum_signed(x, f, q, k):
    x &= (1 << 128) - 1
    return _s64(_redc_wide(((x >> 64) ^ (1 << 63)) * f + (x & M64), q, k)
                - (f << 1))


def _redc_by(x, c, q, k):
    return _s64(_redc_wide(((x & M64) ^ (1 << 63)) * c, q, k) - (c << 1))


def _canon(a, q):
    a = a + q if a < 0 else a
    return a if a < q else a - q


def _main_classes():
    with open(os.path.join(_cuda_host.CSRC, "matmul.cu")) as f:
        return int(re.search(r"#define TT_MM_MAIN (\d+)", f.read()).group(1))


def test_class_sums_stay_in_the_reduction_domain():
    """The kernel's epilogue (``MmReduce``, 62-bit lane) as an integer
    model, for XL = 3..8 residue bytes and L = 1..8 weight bytes over a
    run of ``matmul_run(L)`` features: every class sum's bound fits an
    int32; the classes below ``TT_MM_MAIN``, shifted and added with an
    accumulator word, keep ``redc_sum_signed``'s high word inside its
    domain (|hi| <= H, H (q - 1) + 2^64 <= q 2^62) for the largest and
    least modulus of XL bytes below 2^60; the classes above fit the 64-bit
    word; and the model on the class sums at their extremes (and random)
    gives the exact residue."""
    main = _main_classes()
    rng = np.random.default_rng(9)
    for XL in range(3, 9):
        qs = [(1 << (8 * XL - 8)) + 1, min((1 << (8 * XL)) - 1, 2**60 - 1)]
        for L in range(1, 9):
            run = mm.matmul_run(L)
            NS = XL + L - 1
            count = [sum(1 for a in range(XL) if 0 <= s - a < L)
                     for s in range(NS)]
            bound = [c * 255 * 128 * run for c in count]
            assert max(bound) < 2**31, (XL, L)
            top = sum(b << (8 * s) for s, b in enumerate(bound[:main]))
            hi = (top + 2**62) >> 64
            h = sum(b << (8 * (s - main)) for s, b in enumerate(bound)
                    if s >= main)
            assert h < 2**63, (XL, L)
            for q in qs:
                q |= 1
                assert hi * (q - 1) + 2**64 <= q * 2**62, (XL, L, q)
                k = ((1 << 62) * pow(1 << 62, -1, q) - 1) // q
                f, r2 = (1 << 64) % q, (1 << 124) % q
                c96 = _canon(_redc_by(1 << 34, r2, q, k), q)
                cases = [[b for b in bound], [-b for b in bound],
                         [b if s % 2 else -b for s, b in enumerate(bound)],
                         [int(rng.integers(-b, b + 1)) for b in bound]]
                for T in cases:
                    acc = q - 1
                    t = sum(v << (8 * s) for s, v in enumerate(T[:main]))
                    v = _redc_sum_signed(t + acc, f, q, k)
                    if NS > main:
                        v += _redc_by(sum(x << (8 * (s - main)) for s, x
                                          in enumerate(T) if s >= main),
                                      c96, q, k)
                    got = _canon(_redc_by(v, r2, q, k), q)
                    want = (acc + sum(x << (8 * s) for s, x in
                                      enumerate(T))) % q
                    assert got == want, (XL, L, q)


def test_wrappers_refuse_what_the_kernel_does_not_take(lane):
    lp, q = _edge_lp(lane, [14, 15, 16])
    dt = lp.pack.dtype
    x = torch.zeros((4, 3, 64), dtype=dt)
    wl = mm.weight_limbs(torch.ones((4, 2), dtype=torch.int64))
    other = torch.int32 if dt == torch.int64 else torch.int64
    acc = tuple(torch.zeros((2, 3, 64), dtype=dt) for _ in range(2))
    bad = [
        (TypeError, lambda: mm.matmul(x.to(other), x.to(other), wl, lp)),
        (ValueError, lambda: mm.matmul(x[:, :2], x[:, :2], wl, lp)),
        (ValueError, lambda: mm.matmul(x[..., :16], x[..., :16], wl, lp)),
        (ValueError, lambda: mm.matmul(x[..., :48].contiguous(),
                                       x[..., :48].contiguous(), wl, lp)),
        (ValueError, lambda: mm.matmul(x.transpose(1, 2).contiguous()
                                       .transpose(1, 2), x, wl, lp)),
        (ValueError, lambda: mm.matmul(x, x[:3], wl, lp)),
        (ValueError, lambda: mm.matmul(x, x, wl[:, :3], lp)),
        (ValueError, lambda: mm.matmul(x, x, wl.long(), lp)),
        (ValueError, lambda: mm.matmul(x, x, wl.transpose(1, 2), lp)),
        (ValueError, lambda: mm.matmul(x, x, torch.zeros(
            (9, 4, 2), dtype=torch.int8), lp)),
        (ValueError, lambda: mm.matmul(x, x, wl, lp,
                                       acc=(acc[0][:1], acc[1][:1]))),
        (TypeError, lambda: mm.matmul(x, x, wl, lp,
                                      acc=tuple(a.to(other) for a in acc))),
        (ValueError, lambda: mm.matmul(x.to("meta"), x.to("meta"),
                                       wl.to("meta"), lp)),
    ]
    for err, call in bad:
        with pytest.raises(err):
            call()


# ----------------------------------------------------------------------
# csrc/matmul.cu built for the host.
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_matmul(tmp_path_factory):
    lib = _cuda_host.build(
        tmp_path_factory.mktemp("matmul_host"), "matmul.cu",
        {"tt_matmul" + sfx: cuda_build._LANED["tt_matmul"]
         for sfx in ("", "_30")}, logn=(), threads=True)
    if lib is None:
        pytest.skip("needs g++ to build csrc/matmul.cu on the host")
    return lib


@pytest.fixture
def host_launch(host_matmul, monkeypatch):
    """The wrapper launches the host build on CPU tensors."""
    monkeypatch.setattr(cuda_build, "lib", lambda: host_matmul)
    monkeypatch.setattr(mm, "_on_cpu", lambda x, kernels=1: False)
    monkeypatch.setattr(mm, "_stream", lambda device: None)
    K.reset_launch_counts()


def test_kernel_source_matches_plain(lane, host_launch):
    """The kernel through the wrapper, byte for byte the plain version:
    40-, 41- and 60-bit channels (or the 30-bit chain's), one to eight
    bytes a weight (the largest and least five and eight hold), 70
    outputs (a ragged second tile), weights read 16 bytes at a time (F_in
    a multiple of 16) and byte by byte, two stages, residues q - 1, an
    accumulator updated in place; weights laid out F_out fastest and cut
    along F_in; then a sum of two runs at the bound of
    eight bytes (the second launch starting mid-row, byte by byte); the
    engagement counters at every launch."""
    lp, q = _edge_lp(lane, [14, 15, 16] if lane == 62 else [0, 1, 16])
    dt = lp.pack.dtype
    qt = torch.tensor(q)[:, None]
    sfx = LANES[lane][1]
    key = "matmul" + sfx
    start = mm.INT8_PRODUCTS[key], mm.MOD_PRODUCTS[key]
    gen = torch.Generator().manual_seed(5)

    def residues(q, F, N=32):
        qt = torch.tensor(q)[:, None]
        x = torch.randint(0, 1 << 62, (F, len(q), N), generator=gen) % qt
        x[0] = qt - 1
        return x.to(dt)

    def counted(x, W, q, launches):
        """The products the launches issue: a stage of 64 features, a
        block of 64 outputs, every channel's residue bytes."""
        F_in, F_out = W.shape
        L = mm.weight_limbs(W).shape[0]
        per = -(-F_out // 64) * 64 * 2 * x.shape[2]
        xl = sum(mm.residue_bytes(v) for v in q)
        runs = [min(mm.matmul_run(L), F_in - k0)
                for k0 in range(0, F_in, mm.matmul_run(L))]
        return (sum(-(-k // 64) * 64 for k in runs) * xl * L * per
                * launches, F_in * F_out * 2 * x.shape[2] * len(q)
                * launches)

    cases = {
        "five bytes": (residues(q, 9), torch.randint(
            -(1 << 38), 1 << 38, (9, 70), generator=gen)),
        "one byte": (residues(q, 12, 128), torch.randint(
            -128, 128, (12, 5), generator=gen)),
        "largest five, 16 at a time": (residues(q, 16), torch.tensor(
            [[mm.limb_max(5), mm.limb_min(5)]] * 16)),
        "three bytes, 16 at a time": (residues(q, 64), torch.randint(
            -(1 << 23), 1 << 23, (64, 33), generator=gen)),
        "eight bytes": (residues(q, 10), torch.randint(
            -(1 << 62), 1 << 62, (10, 66), generator=gen)),
        "largest eight, two stages": (residues(q, 80), torch.tensor(
            [[mm.MAX_WEIGHT, -2**63, 1]] * 80)),
    }
    launches = 0
    int8, mod = 0, 0
    for name, (x, W) in cases.items():
        wl = mm.weight_limbs(W)
        y = x.flip(0).clone()
        got = mm.matmul(x, y, wl, lp)
        want = mm.matmul_plain(x, y, wl, lp)
        assert all(g.is_contiguous() and g.dtype == dt for g in got), name
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        acc = tuple(w.clone() for w in want)
        again = mm.matmul(x, y, wl, lp, acc=acc)
        assert again[0] is acc[0] and again[1] is acc[1]
        twice = mm.matmul_plain(x, y, wl, lp, acc=tuple(w.clone()
                                                         for w in want))
        assert all(torch.equal(g, w) for g, w in zip(again, twice)), name
        launches += 2
        i8, md = counted(x, W, q, 2)
        int8, mod = int8 + i8, mod + md
        assert (mm.INT8_PRODUCTS[key] - start[0],
                mm.MOD_PRODUCTS[key] - start[1]) == (int8, mod), name
    # weights laid out F_out fastest and cut to the first 7 input
    # features, as a caller may slice them: read F_in fastest all the same
    x, W = cases["five bytes"][0][:7], cases["five bytes"][1][:7]
    wl = mm.weight_limbs(cases["five bytes"][1]).contiguous()[:, :7]
    got = mm.matmul(x, x, wl, lp)
    assert all(torch.equal(g, w) for g, w in
               zip(got, mm.matmul_plain(x, x, wl, lp)))
    launches += 1
    i8, md = counted(x, W, q, 1)
    int8, mod = int8 + i8, mod + md
    # two runs of eight-byte weights at the bound, residues q - 1 and the
    # largest weights: the second launch adds into the first's output
    lp1 = types.SimpleNamespace(pack=lp.pack[:1], fold=lp.fold[:1],
                                Rs=lp.Rs[:1])
    F = mm.matmul_run(8) + 3
    x = (qt[:1] - 1).expand(F, 1, 32).clone().to(dt)
    W = torch.full((F, 2), mm.MAX_WEIGHT)
    W[:, 1] = -2**63
    wl = mm.weight_limbs(W)
    got = mm.matmul(x, x, wl, lp1)
    assert all(torch.equal(g, w) for g, w in
               zip(got, mm.matmul_plain(x, x, wl, lp1)))
    launches += 2
    i8, md = counted(x, W, q[:1], 1)
    assert (mm.INT8_PRODUCTS[key] - start[0],
            mm.MOD_PRODUCTS[key] - start[1]) == (int8 + i8, mod + md)
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "matmul" + sfx: launches}


# ----------------------------------------------------------------------
# The feed-forward layer.
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ffn():
    """An engine of the cell's depth and more at logN 7, a layer of H
    hidden and I intermediate features, its inputs (LayerNorm outputs) and
    their stack."""
    eng = teng.CkksEngine(_cfg(62), device="cpu", seed=11)
    rng = np.random.default_rng(3)
    w1, w2 = rng.normal(0, 0.2, (H, I)), rng.normal(0, 0.2, (I, H))
    b1, b2 = rng.uniform(-0.1, 0.1, I), rng.uniform(-0.1, 0.1, H)
    x = rfn_messages(rng)
    X = stack_ciphertexts(eng.encodecrypt_batch(list(x)))
    return eng, (w1, b1, w2, b2), x, X


def rfn_messages(rng):
    return rffn.messages(rng, H, 64)


def test_ffn_against_the_reference(ffn, monkeypatch):
    """In blocks of 12 the residues of one block; every residue the
    reference circuit's (in blocks of 12, squares 5 at a time); decrypted
    within CIRCUIT_TOL of its float64 circuit, which lies within
    FORWARD_TOL of the float forward."""
    eng, (w1, b1, w2, b2), x, X = ffn
    whole = eng.feed_forward(w1, b1, w2, b2)
    assert whole.blocks(0) == [(0, I)]
    one = whole(X)
    monkeypatch.setattr(tnn, "ffn_block", lambda engine, level: 12)
    layer = eng.feed_forward(w1, b1, w2, b2)
    assert layer.blocks(0) == [(0, 12), (12, 24), (24, I)]
    out = layer(X)
    assert out.level == 3
    for a, b in zip(out.data, one.data):
        assert torch.equal(a, b)
    cfg = eng.ckksCfg
    pr = rref.Params([int(q) for q in eng.params.q], cfg.logN,
                     cfg.num_special_primes, "cpu", cfg.scale_bits)
    evk = [tuple(part) for part in eng.evk.data]
    z = rffn.Circuit(pr, evk).forward(X.data[0], X.data[1], w1, b1, w2, b2,
                                      12, 5)
    assert torch.equal(z.c0, out.data[0]) and torch.equal(z.c1, out.data[1])
    got = np.stack([eng.decryptcode(c, is_real=True)
                    for c in unstack_ciphertext(out)])
    circuit = rffn.float_circuit(pr, x, w1, b1, w2, b2)
    assert np.abs(got - circuit).max() < CIRCUIT_TOL
    assert np.abs(circuit - rffn.float_forward(x, w1, b1, w2, b2)).max() \
        < FORWARD_TOL


def test_ffn_at_another_level(ffn):
    """An input at level 1: every residue the reference circuit's at that
    level, its output at level 4; decrypted within CIRCUIT_TOL of the
    float64 circuit at level 1."""
    eng, (w1, b1, w2, b2), x, X = ffn
    X1 = eng.level_up(X, 1)
    out = eng.feed_forward(w1, b1, w2, b2)(X1)
    assert out.level == rffn.output_level(1) == 4
    cfg = eng.ckksCfg
    pr = rref.Params([int(q) for q in eng.params.q], cfg.logN,
                     cfg.num_special_primes, "cpu", cfg.scale_bits)
    evk = [tuple(part) for part in eng.evk.data]
    z = rffn.Circuit(pr, evk).forward(X1.data[0], X1.data[1], w1, b1, w2,
                                      b2, I, 7, level=1)
    assert z.level == 4
    assert torch.equal(z.c0, out.data[0]) and torch.equal(z.c1, out.data[1])
    got = np.stack([eng.decryptcode(c, is_real=True)
                    for c in unstack_ciphertext(out)])
    circuit = rffn.float_circuit(pr, x, w1, b1, w2, b2, level=1)
    assert np.abs(got - circuit).max() < CIRCUIT_TOL


def test_ffn_blocks():
    """The blocks a layer streams: ffn_block's 4 ciphertexts a feature
    into 16 GiB, 512 at logN15's level 1 (and stack_chunk's 93 inside)."""
    fake = types.SimpleNamespace(
        ckksCfg=types.SimpleNamespace(numpy_dtype=np.int64, N=1 << 15),
        params=types.SimpleNamespace(P=17))
    assert tnn.ffn_block(fake, 1) == 512
    assert tnn.stack_chunk(fake, 1) == 93


def test_ffn_spans(ffn, monkeypatch):
    """The ``ffn`` root holds, a block at a time, ``ffn.up`` (one
    ``mult_matrix``: the product, its rescale), ``ffn.act`` (a ``cc_mult``
    a chunk, then ``mult_scalar`` and ``cc_add``) and ``ffn.down`` (the
    product alone), then the last ``ffn.down`` (the rescale) and
    ``ffn.residual``; every launch is counted in a phase, the matrix
    products one kernel each."""
    eng, (w1, b1, w2, b2), _, X = ffn
    monkeypatch.setattr(tnn, "ffn_block", lambda engine, level: 12)
    monkeypatch.setattr(tnn, "stack_chunk", lambda engine, level: 5)
    layer = eng.feed_forward(w1, b1, w2, b2)
    layer(X)                      # the weights' encoding, before the trace
    trace.clear()
    with trace.profile():
        layer(X)
    recs = trace.spans()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["ffn"]

    def kids(r):
        return [c for c in recs if c.parent == r.index]

    phases = kids(roots[0])
    blocks = [12, 12, 8]
    assert [p.name for p in phases] == [
        *(["ffn.up", "ffn.act", "ffn.down"] * len(blocks)),
        "ffn.down", "ffn.residual"]
    assert roots[0].launches == sum(p.launches for p in phases) > 0
    step = None
    for k, n in enumerate(blocks):
        up, act, down = phases[3 * k:3 * k + 3]
        assert [c.name for c in kids(up)] == ["mult_matrix"]
        assert up.launches == kids(up)[0].launches == 1 + 2   # product, G1
        chunks = kids(act)
        assert [c.name for c in chunks] == ["cc_mult"] * -(-n // 5)
        step = chunks[0].launches
        # mult_scalar (G4, G1 on both polynomials), cc_add (G4)
        assert act.launches == len(chunks) * step + 4 + 2
        assert down.launches == 1
    assert step > 0
    assert phases[-2].launches == 2              # the rescale
    assert phases[-1].launches == 4 + 2          # level_up, cc_add
    trace.clear()
