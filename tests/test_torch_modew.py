"""G4 (``ops/glue_kernels.py``: ``mont_scalar``, ``mod_add``, ``mod_sub``),
the engine's modular product by a column, add and subtract, on the CPU.

* The plain versions against the torch composition they replace
  (``reduce_2q`` of ``mont_mult`` / ``mont_add`` / ``mont_sub``), the JAX
  package's cores of the same name and the exact residues in Python
  integers, in both lanes (62-bit int64, 30-bit int32), on edge operands
  (0, q - 1, q and 2q - 1 for an add or subtract, 0 and q - 1 for a
  product and its column) and random residues.
* The wrappers check their operands on every device and refuse what the
  kernel does not read: another dtype or device, strides that do not
  fold into [B, C, N] with one batch stride, a column neither [C, 1] nor
  [B, C, 1].
* ``_mont_scalar_core``, ``_cc_add_core`` and ``_cc_sub_core``, and the
  engine's ``cc_add``, ``cc_sub``, ``level_up``, ``align_level``,
  ``mult_scalar`` and ``mult_int_scalar`` go through the wrappers.
* ``csrc/glue.cu`` itself, built for the host by ``g++`` (``_cuda_host``:
  a shim defines the CUDA qualifiers away and runs each launch's blocks
  and threads in turn), launched through the wrappers on CPU tensors as
  the card's build is, against the plain versions byte for byte, with
  ``LAUNCHES`` counted: the 16-byte path, the one-word path of a
  misaligned view, a second operand of batch stride 0, views of a row
  range and a column a stacked ciphertext.

The card's build against the plain versions: ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.  Tolerance: none.
"""

import types

import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config as jtoy_config
from tiberate_tpu.context.ntt_context import CkksParams as JParams
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.context.ntt_context import CkksParams
from tiberate_tpu_torch.engine import CkksEngine
from tiberate_tpu_torch.engine.ckks_engine import stack_ciphertexts
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.ops import cuda_build
from tiberate_tpu_torch.ops import glue_kernels as G
from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt_kernels as K

import _cuda_host

torch.set_num_threads(1)

LOGN = 7
BATCH = 3
# lane -> (toy config options, launch-count suffix)
LANES = {62: (dict(scale_bits=30), ""),
         30: (dict(scale_bits=21, buffer_bit_length=30), "_30")}
OPS = ("mont_scalar", "mod_add", "mod_sub")


def _cfg(lane, make=toy_config):
    return make(logN=LOGN, num_scales=6, num_special_primes=2,
                **LANES[lane][0])


@pytest.fixture(scope="module", params=sorted(LANES))
def lane(request):
    return request.param


@pytest.fixture(scope="module")
def tp(lane):
    return CkksParams(_cfg(lane), "cpu")


def _uniform(gen, q, shape, hi=1):
    """Residues uniform in [0, hi q_c) per channel (axis -2), in q's
    dtype."""
    x = torch.randint(0, 1 << 62, shape, generator=gen)
    return (x % (hi * q.long()[:, None])).to(q.dtype)


def _operands(tp, level=2, seed=0):
    """(lp, a, b in [0, 2q), d in [0, q), col [C, 1], colB [B, C, 1] in
    [0, q)) at ``level``: batch row 0 of a and b runs every pair of the
    edge operands 0, q - 1, q and 2q - 1; d and the columns hold 0 and q -
    1."""
    lp = tp.lp(level, False)
    q = lp.pack.q
    C, N = lp.num_channels, tp.N
    gen = torch.Generator().manual_seed(seed)
    a, b = (_uniform(gen, q, (BATCH, C, N), 2) for _ in range(2))
    edges = torch.stack([torch.zeros_like(q), q - 1, q, 2 * q - 1], -1)
    a[0, :, :16] = edges.repeat(1, 4)
    b[0, :, :16] = edges.repeat_interleave(4, -1)
    d = _uniform(gen, q, (BATCH, C, N))
    d[0, :, :2] = torch.stack([torch.zeros_like(q), q - 1], -1)
    col = _uniform(gen, q, (C, 1))
    col[0, 0], col[1, 0] = 0, q[1] - 1
    colB = _uniform(gen, q, (BATCH, C, 1))
    colB[0, 0, 0], colB[1, 1, 0] = q[0] - 1, 0
    return lp, a, b, d, col, colB


def _exact(op, x, y, q, R_bits):
    """The residue in Python integers: (x y R^-1), (x + y) or (x - y) mod
    q, per channel (axis -2) of broadcast numpy operands."""
    x, y = np.broadcast_arrays(np.asarray(x), np.asarray(y))
    out = np.empty(x.shape, dtype=x.dtype)
    for idx in np.ndindex(x.shape):
        qi = int(q[idx[-2]])
        xi, yi = int(x[idx]), int(y[idx])
        if op == "mont_scalar":
            v = xi * yi * pow(1 << R_bits, -1, qi)
        else:
            v = xi + yi if op == "mod_add" else xi - yi
        out[idx] = v % qi
    return out


def _former(op, x, y, pk):
    """The torch composition G4 replaces, as the engine's cores ran it."""
    if op == "mont_scalar":
        return mont.reduce_2q(mont.mont_mult(x, y, pk), pk)
    fn = mont.mont_add if op == "mod_add" else mont.mont_sub
    return mont.reduce_2q(fn(x, y, pk), pk)


@pytest.mark.parametrize("op", OPS)
def test_plain_versions_equal_the_former_composition(lane, tp, op):
    """Each plain version gives the torch composition's bytes, the JAX
    package core's and the exact residue, on edge operands and random
    residues, against a stack and against one ciphertext repeated."""
    lp, a, b, d, col, colB = _operands(tp)
    jp = JParams(_cfg(lane, jtoy_config))
    jlp = jp.lp(2, False)
    q = lp.pack.q.numpy()
    R_bits = 62 if lane == 62 else 30
    if op == "mont_scalar":
        cases = [(d, col), (d, colB), (d[1], col)]
        jcore = jeng._mont_scalar_core
    else:
        cases = [(a, b), (a, b[2]), (a[1], b)]
        jcore = (jeng._cc_add_core if op == "mod_add"
                 else jeng._cc_sub_core)
    plain = getattr(G, op + "_plain")
    for x, y in cases:
        got = plain(x, y, lp)
        assert got.dtype == x.dtype
        assert torch.equal(got, _former(op, x, y, lp.pack))
        want = np.asarray(jcore(x.numpy(), y.numpy(), jlp))
        assert want.dtype == got.numpy().dtype
        assert np.array_equal(want, got.numpy())
        assert np.array_equal(_exact(op, x.numpy(), y.numpy(), q, R_bits),
                              got.numpy())


def _lp_on(lp, device):
    """``lp`` with its pack (the q and k the kernel reads) on ``device``."""
    return types.SimpleNamespace(pack=lp.pack.to(device))


def _refusals(tp):
    """{case: (exception, call)} of operands the kernel does not read."""
    lp, a, b, d, col, colB = _operands(tp)
    C, N = lp.num_channels, tp.N
    other = torch.int32 if tp.dtype == torch.int64 else torch.int64
    wide = torch.zeros((BATCH, C, 2 * N), dtype=tp.dtype)
    stack4 = torch.zeros((2, BATCH, C, N), dtype=tp.dtype)
    return {
        "a of another dtype": (TypeError, lambda: G.mod_add(a.to(other), b,
                                                            lp)),
        "b of another dtype": (TypeError, lambda: G.mod_sub(a, b.to(other),
                                                            lp)),
        "col of another dtype": (TypeError, lambda: G.mont_scalar(
            d, col.to(other), lp)),
        "b on another device": (ValueError, lambda: G.mod_add(
            a, b.to("meta"), lp)),
        "col on another device": (ValueError, lambda: G.mont_scalar(
            d, col.to("meta"), lp)),
        "a device of no kernel": (ValueError, lambda: G.mod_sub(
            a.to("meta"), b.to("meta"), _lp_on(lp, "meta"))),
        "coefficients not contiguous": (ValueError, lambda: G.mod_add(
            wide[..., ::2], b, lp)),
        "rows not N apart": (ValueError, lambda: G.mont_scalar(
            wide[..., :N], col, lp)),
        "transposed rows": (ValueError, lambda: G.mod_sub(
            a.transpose(-1, -2).contiguous().transpose(-1, -2), b, lp)),
        "leading dims of two strides": (ValueError, lambda: G.mod_add(
            stack4.transpose(0, 1), b, lp)),
        "a repeat that does not fold": (ValueError, lambda: G.mod_add(
            a[None].expand(2, -1, -1, -1), stack4, lp)),
        "rows broadcast": (ValueError, lambda: G.mod_add(a, b[:, :1], lp)),
        "another channel count": (ValueError, lambda: G.mod_sub(
            a[:, 1:], b[:, 1:], lp)),
        "shapes that do not broadcast": (ValueError, lambda: G.mod_add(
            a, b[:2], lp)),
        "col [C]": (ValueError, lambda: G.mont_scalar(d, col[:, 0], lp)),
        "col [C, 2]": (ValueError, lambda: G.mont_scalar(
            d, col.repeat(1, 2), lp)),
        "col [C - 1, 1]": (ValueError, lambda: G.mont_scalar(d, col[1:],
                                                             lp)),
        "col [B + 1, C, 1]": (ValueError, lambda: G.mont_scalar(
            d, torch.cat([colB, colB[:1]]), lp)),
        "col [1, C, 1]": (ValueError, lambda: G.mont_scalar(d, colB[:1],
                                                            lp)),
        "col [B, C, 1] for a 4-D d": (ValueError, lambda: G.mont_scalar(
            stack4, colB, lp)),
    }


REFUSALS = ("a of another dtype", "b of another dtype",
            "col of another dtype", "b on another device",
            "col on another device", "a device of no kernel",
            "coefficients not contiguous", "rows not N apart",
            "transposed rows", "leading dims of two strides",
            "a repeat that does not fold", "rows broadcast",
            "another channel count", "shapes that do not broadcast",
            "col [C]", "col [C, 2]", "col [C - 1, 1]", "col [B + 1, C, 1]",
            "col [1, C, 1]", "col [B, C, 1] for a 4-D d")


@pytest.mark.parametrize("case", REFUSALS)
def test_wrappers_refuse_what_the_kernel_does_not_take(tp, case):
    exc, call = _refusals(tp)[case]
    with pytest.raises(exc):
        call()


def test_refusal_cases_are_listed(tp):
    assert set(_refusals(tp)) == set(REFUSALS)


def test_views_the_kernel_reads(tp):
    """What the engine hands over folds, with the batch strides the kernel
    takes: ``level_up``'s row range, a stack's halves, one ciphertext
    against a stack (batch stride 0), a column a stacked ciphertext."""
    lp, a, b, d, col, colB = _operands(tp)
    C, N = lp.num_channels, tp.N
    full = torch.zeros((BATCH, C + 3, N), dtype=tp.dtype)
    assert G._modew_geometry(lp.pack, full[..., 3:, :], col=col) == (
        (BATCH, C, N), BATCH, (C + 3) * N, 0, 0)
    assert G._modew_geometry(lp.pack, full[..., 3:, :], col=colB) == (
        (BATCH, C, N), BATCH, (C + 3) * N, 0, C)
    assert G._modew_geometry(lp.pack, a[:1], a[1:2]) == (
        (1, C, N), 1, C * N, C * N, 0)
    assert G._modew_geometry(lp.pack, a, b[0]) == (
        (BATCH, C, N), BATCH, C * N, 0, 0)
    assert G._modew_geometry(lp.pack, b[0], a) == (
        (BATCH, C, N), BATCH, 0, C * N, 0)
    assert G._modew_geometry(lp.pack, a[0], b[0]) == (
        (C, N), 1, C * N, C * N, 0)


def _engine(lane):
    return CkksEngine(_cfg(lane), device="cpu", seed=3)


def test_engine_goes_through_the_wrappers(lane, monkeypatch):
    """The three cores call their wrapper once a polynomial, and so do
    ``cc_add``, ``cc_sub``, ``level_up`` (after its rescale), an add across
    levels (``align_level``'s ``level_up``), ``mult_int_scalar`` and
    ``mult_scalar`` (before its rescale), a stack's per-row
    ``mult_scalar`` and its ``cc_sub`` of one ciphertext."""
    calls = []
    for name in OPS:
        def counted(*args, _fn=getattr(G, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(G, name, counted)
    eng = _engine(lane)
    lp = eng._lp(0, False)
    d = torch.ones((2, lp.num_channels, eng.ckksCfg.N),
                   dtype=eng.params.dtype)
    col = torch.ones((lp.num_channels, 1), dtype=eng.params.dtype)
    teng._mont_scalar_core(d, col, lp)
    teng._cc_add_core(d, d, lp)
    teng._cc_sub_core(d, d, lp)
    assert calls == ["mont_scalar", "mod_add", "mod_sub"]
    m = np.random.default_rng(4).uniform(-1, 1, eng.num_slots)
    x, y = eng.encodecrypt(m), eng.encodecrypt(m)
    calls.clear()
    eng.cc_add(x, y)
    eng.cc_sub(x, y)
    assert calls == ["mod_add"] * 2 + ["mod_sub"] * 2
    calls.clear()
    eng.level_up(x, 2)
    assert calls == ["mont_scalar"] * 2
    calls.clear()
    z = eng.cc_add(eng.level_up(x, 1), y)   # then y to level 1
    assert z.level == 1
    assert calls == ["mont_scalar"] * 4 + ["mod_add"] * 2
    calls.clear()
    eng.mult_int_scalar(x, 3)
    eng.mult_scalar(x, 0.5)
    assert calls == ["mont_scalar"] * 4
    stack = stack_ciphertexts(eng.encodecrypt_batch([m, m[::-1]]))
    calls.clear()
    eng.mult_scalar(stack, [0.5, 0.25])
    eng.cc_sub(stack, x)
    assert calls == ["mont_scalar"] * 2 + ["mod_sub"] * 2


# ----------------------------------------------------------------------
# csrc/glue.cu built for the host.
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_glue(tmp_path_factory):
    """``csrc/glue.cu`` as a host library (``_cuda_host``): a block's
    threads in turn, the glue's kernels sharing nothing between them."""
    lib = _cuda_host.build(
        tmp_path_factory.mktemp("glue_host"), "glue.cu",
        {"tt_modew" + sfx: cuda_build._LANED["tt_modew"]
         for sfx in ("", "_30")}, logn=())
    if lib is None:
        pytest.skip("needs g++ to build csrc/glue.cu on the host")
    return lib


@pytest.fixture
def host_launch(host_glue, monkeypatch):
    """The wrappers launch the host build on CPU tensors."""
    monkeypatch.setattr(cuda_build, "lib", lambda: host_glue)
    monkeypatch.setattr(G, "_on_cpu", lambda x, kernels=1: False)
    monkeypatch.setattr(G, "_stream", lambda device: None)
    K.reset_launch_counts()


def test_kernel_source_matches_plain(lane, tp, host_launch):
    """G4's three ops through the wrappers on the host build: aligned
    operands (16-byte accesses), a misaligned view (one word at a time),
    a second operand of batch stride 0 either side, ``level_up``'s row
    range with a [C, 1] and a [B, C, 1] column, an unstacked pair."""
    lp, a, b, d, col, colB = _operands(tp, seed=1)
    C, N = lp.num_channels, tp.N
    full = _uniform(torch.Generator().manual_seed(2),
                    tp.lp(0, False).pack.q, (BATCH, C + 2, N))
    full[..., 2:, :] %= lp.pack.q[:, None]
    rows = full[..., 2:, :]
    flat = torch.empty(BATCH * C * N + 1, dtype=tp.dtype)
    shifted = flat[1:].view(BATCH, C, N)
    shifted.copy_(d)
    cases = {
        "add": ("mod_add", a, b), "sub": ("mod_sub", a, b),
        "add against one": ("mod_add", a, b[1]),
        "sub against one": ("mod_sub", a, b[2]),
        "one less a stack": ("mod_sub", b[0], a),
        "sub misaligned": ("mod_sub", shifted, a),
        "add unstacked": ("mod_add", a[0], b[0]),
        "scalar": ("mont_scalar", d, col),
        "scalar per row": ("mont_scalar", d, colB),
        "scalar row range": ("mont_scalar", rows, col),
        "scalar row range per row": ("mont_scalar", rows, colB),
        "scalar misaligned": ("mont_scalar", shifted, colB),
    }
    for name, (op, x, y) in cases.items():
        got = getattr(G, op)(x, y, lp)
        want = getattr(G, op + "_plain")(x, y, lp)
        assert got.is_contiguous() and got.dtype == want.dtype, name
        assert torch.equal(got, want), name
    sfx = LANES[lane][1]
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "mod_add" + sfx: 3, "mod_sub" + sfx: 4, "mont_scalar" + sfx: 5}


def test_engine_cores_launch_on_the_host_build(lane, tp, host_launch):
    """The engine's three cores launch G4 once each, counted in
    ``LAUNCHES`` under the wrappers' names."""
    lp, a, b, d, col, colB = _operands(tp, seed=3)
    got = (teng._cc_add_core(a, b, lp), teng._cc_sub_core(a, b[0], lp),
           teng._mont_scalar_core(d, colB, lp))
    want = (G.mod_add_plain(a, b, lp), G.mod_sub_plain(a, b[0], lp),
            G.mont_scalar_plain(d, colB, lp))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sfx = LANES[lane][1]
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "mod_add" + sfx: 1, "mod_sub" + sfx: 1, "mont_scalar" + sfx: 1}
