"""Each Hopper kernel's plain version against the JAX function it replaces.

On the CPU the JAX engine runs its jnp path (Pallas is off there), so the
reference for each kernel is the jnp chain the engine uses on CPU:

* K1/K2/K3: ``ops/ntt.py`` + ``mont_mult``; K3's accumulating chain:
  ``ntt`` -> ``mont_mult`` -> ``mont_add`` with a part's channels passed
  through;
* K4: the successive P-division of ``_switcher_body`` (restricted to the
  ordinary rows, as ``_pdiv_fused`` does);
* K5: ``_ccmult_tensor_core``;
* K6: per part ``_extend`` + ``_ntt_plain`` + ``mont_mult``, summed with
  ``mont_add``.

Inputs are drawn with numpy at toy_config(logN=7, num_scales=4,
num_special_primes=2), where the parts at level 1 have alpha 1 and 2, in
both lanes: the 62-bit mode (int64, scale_bits 30) and the 30-bit mode
(int32, R = 2^30, scale_bits 21, as the JAX package's own 30-bit toys).
Tolerance: none — outputs must be byte-identical and of the lane's dtype
(lazy outputs included, which is stronger than matching after reduce_2q).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.context.ntt_context import CkksParams as JParams
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu.ops import mont as jmont
from tiberate_tpu.ops import ntt as jntt
from tiberate_tpu_torch.context.ntt_context import CkksParams as TParams
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.ops import ntt_kernels as K

torch.set_num_threads(1)

LEVEL = 1
BATCH = 2


# lane -> toy options
LANES = {62: dict(scale_bits=30),
         30: dict(scale_bits=21, buffer_bit_length=30)}


@pytest.fixture(scope="module", params=sorted(LANES))
def params(request):
    cfg = toy_config(logN=7, num_scales=4, num_special_primes=2,
                     **LANES[request.param])
    return JParams(cfg), TParams(cfg, "cpu")


def _uniform(rng, q, shape):
    """numpy residues uniform in [0, q_c) per channel (axis -2), in the
    lane's dtype (that of ``q``)."""
    dt = np.asarray(q).dtype
    q = np.asarray(q, dtype=np.int64)[:, None]
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.int64) % q
            ).astype(dt)


def _eq(j, t):
    j = np.asarray(j)
    return j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


def _lps(params, special):
    jp, tp = params
    return jp.lp(LEVEL, special), tp.lp(LEVEL, special)


def test_ntt_plain_matches_jnp(params):
    """K1: forward NTT, plain and with the x R entry."""
    jlp, tlp = _lps(params, False)
    x = _uniform(np.random.default_rng(0), jlp.pack._2q[:, 0] // 2,
                 (BATCH, jlp.num_channels, params[0].N))
    assert _eq(jntt.ntt(x, jlp.psi, jlp.pack),
               K.ntt_plain(torch.from_numpy(x), tlp, enter=False))
    assert _eq(jntt.enter_ntt(x, jlp.Rs, jlp.psi, jlp.pack),
               K.ntt_plain(torch.from_numpy(x), tlp, enter=True))


@pytest.mark.parametrize("epilogue", ["mont", "exit", "exit_reduce"])
def test_intt_plain_matches_jnp(params, epilogue):
    """K2: inverse NTT with each epilogue."""
    jlp, tlp = _lps(params, True)
    x = _uniform(np.random.default_rng(1), jlp.pack._2q[:, 0],
                 (BATCH, jlp.num_channels, params[0].N))
    fn = {"mont": jntt.intt, "exit": jntt.intt_exit,
          "exit_reduce": jntt.intt_exit_reduce}[epilogue]
    assert _eq(fn(x, jlp.ipsi, jlp.Ninv, jlp.pack),
               K.intt_plain(torch.from_numpy(x), tlp, epilogue))


def test_ntt_keymul_plain_matches_jnp(params):
    """K3 (encrypt's v*pk and decrypt's a*s): enter-NTT, key products."""
    jlp, tlp = _lps(params, False)
    rng = np.random.default_rng(2)
    C, N = jlp.num_channels, params[0].N
    q = jlp.pack._2q[:, 0] // 2
    x = _uniform(rng, q, (C, N))
    keys = [_uniform(rng, q, (C, N)) for _ in range(2)]
    X = jntt.enter_ntt(x, jlp.Rs, jlp.psi, jlp.pack)
    got = K.ntt_keymul_plain(torch.from_numpy(x), tlp,
                             tuple(torch.from_numpy(k) for k in keys),
                             enter=True)
    for key, t in zip(keys, got):
        assert _eq(jmont.mont_mult(X, key, jlp.pack), t)


@pytest.mark.parametrize("part", [None, 0, 1, 2])
def test_ntt_keymul_accum_plain_matches_jnp(params, part):
    """K3's accumulating chain with no skip range and with each part's own
    channel range (alpha 1, 2, 1 at level 1) passed through, in place."""
    jp, tp = params
    jlp, tlp = _lps(params, True)
    skip = None if part is None else (tp.parts[LEVEL][part].lo,
                                      tp.parts[LEVEL][part].hi)
    C, N = jlp.num_channels, jp.N
    rng = np.random.default_rng(6)
    q = jlp.pack._2q[:, 0] // 2
    x = _uniform(rng, q, (BATCH, C, N))
    keys = [_uniform(rng, q, (C, N)) for _ in range(2)]
    acc = [_uniform(rng, 2 * q, (BATCH, C, N)) for _ in range(2)]
    X = jntt.ntt(x, jlp.psi, jlp.pack)
    tacc = tuple(torch.from_numpy(a.copy()) for a in acc)
    got = K.ntt_keymul_accum_plain(
        torch.from_numpy(x), tlp, tuple(torch.from_numpy(k) for k in keys),
        tacc, skip)
    for a, k, g, ta in zip(acc, keys, got, tacc):
        w = np.array(jmont.mont_add(a, jmont.mont_mult(X, k, jlp.pack),
                                    jlp.pack))
        if skip is not None:
            w[..., skip[0] : skip[1], :] = a[..., skip[0] : skip[1], :]
        assert g is ta
        assert _eq(w, g)


def _jax_pdiv_chain(acc, jlp_sp, jlp_ord, PiRs, S):
    """``_switcher_body``'s jnp P-division (ckks_engine.py:433-461) on one
    accumulator: every row, then the ordinary rows' canonical result."""
    C, C_sp = jlp_ord.num_channels, jlp_sp.num_channels
    N = acc.shape[-1]
    d = jntt.intt_exit_reduce(acc, jlp_sp.ipsi, jlp_sp.Ninv, jlp_sp.pack)
    d = d.at[:C].set(jmont.mont_enter(d[:C], jlp_ord.Rs, jlp_ord.pack))
    for P_ind in range(S):
        P0 = jnp.broadcast_to(d[C_sp - 1 - P_ind], (C_sp, N))
        P0 = P0.at[:C].set(jmont.mont_enter(P0[:C], jlp_ord.Rs,
                                            jlp_ord.pack))
        d = jmont.mont_sub(d, P0, jlp_sp.pack)
        d = jmont.mont_mult(d, PiRs[P_ind], jlp_sp.pack)
    return jmont.reduce_2q(jmont.mont_reduce(d[:C], jlp_ord.pack),
                           jlp_ord.pack)


def test_intt_pdiv_plain_matches_jnp(params):
    """K4: the port's _pdiv_fused (special-row phase + intt_pdiv plain)
    equals the jnp successive division, byte for byte (canonical)."""
    jp, tp = params
    jlp_sp, tlp_sp = _lps(params, True)
    jlp_ord, tlp_ord = _lps(params, False)
    S = jp.S
    acc = _uniform(np.random.default_rng(3), jlp_sp.pack._2q[:, 0],
                   (jlp_sp.num_channels, jp.N))
    want = _jax_pdiv_chain(acc, jlp_sp, jlp_ord, jp.PiRs[LEVEL], S)
    got = teng._pdiv_fused(torch.from_numpy(acc), tlp_sp, tlp_ord,
                           tp.PiRs[LEVEL], S)
    assert _eq(want, got)


def test_ntt_tensor_plain_matches_jnp(params):
    """K5: four enter-NTTs and the tensor product."""
    jlp, tlp = _lps(params, False)
    rng = np.random.default_rng(4)
    q = jlp.pack._2q[:, 0] // 2
    xs = [_uniform(rng, q, (jlp.num_channels, params[0].N))
          for _ in range(4)]
    want = jeng._ccmult_tensor_core(*xs, jlp)
    got = K.ntt_tensor_plain(*(torch.from_numpy(x) for x in xs), tlp)
    for j, t in zip(want, got):
        assert _eq(j, t)


def test_ntt_keymul_parts_plain_matches_jnp(params):
    """K6: digits from the JAX _pre_extend, then the port's all-parts
    plain version against the jnp per-part chain."""
    jp, tp = params
    jlp_sp, tlp_sp = _lps(params, True)
    jlp_ord, tlp_ord = _lps(params, False)
    rng = np.random.default_rng(5)
    N = jp.N
    a = _uniform(rng, jlp_ord.pack._2q[:, 0] // 2,
                 (jlp_ord.num_channels, N))
    keys = [[_uniform(rng, jlp_sp.pack._2q[:, 0] // 2,
                      (jlp_sp.num_channels, N)) for _ in range(2)]
            for _ in jp.parts[LEVEL]]

    d0 = d1 = None
    sts = []
    for part, (k0, k1) in zip(jp.parts[LEVEL], keys):
        state = jeng._pre_extend(a[part.lo : part.hi], part,
                                 jlp_ord[part.lo : part.hi])
        sts.append(np.asarray(state))
        ext = jeng._extend(state, part, jlp_sp, LEVEL)
        ext = jeng._ntt_plain(ext, jlp_sp)
        t0 = jmont.mont_mult(ext, k0, jlp_sp.pack)
        t1 = jmont.mont_mult(ext, k1, jlp_sp.pack)
        d0 = t0 if d0 is None else jmont.mont_add(d0, t0, jlp_sp.pack)
        d1 = t1 if d1 is None else jmont.mont_add(d1, t1, jlp_sp.pack)

    st = teng._parts_digits(torch.from_numpy(a), tp.parts[LEVEL], tlp_ord,
                            max(p.alpha for p in tp.parts[LEVEL]))
    for p, s in enumerate(sts):
        assert _eq(s, st[p, : s.shape[0]])
    ec, alphas = teng._parts_consts(tp, LEVEL)
    tkeys = tuple(tuple(torch.from_numpy(k) for k in pair) for pair in keys)
    acc0, acc1 = K.ntt_keymul_parts_plain(st, ec, alphas, tkeys, tlp_sp)
    assert _eq(d0, acc0) and _eq(d1, acc1)


def test_wrappers_dispatch_cpu_to_plain(params):
    """On CPU tensors every wrapper is its plain version and launches
    nothing; an unsupported device raises."""
    _, tlp = _lps(params, False)
    x = torch.zeros((tlp.num_channels, params[0].N), dtype=params[1].dtype)
    K.reset_launch_counts()
    assert torch.equal(K.ntt(x, tlp, enter=True), K.ntt_plain(x, tlp, True))
    assert torch.equal(K.intt(x, tlp, "exit"), K.intt_plain(x, tlp, "exit"))
    assert all(v == 0 for v in K.LAUNCHES.values())
    with pytest.raises(ValueError):
        K.ntt(x.to("meta"), tlp, enter=True)
