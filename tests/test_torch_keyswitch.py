"""The keyswitch of tiberate_tpu_torch against the JAX package.

At ``toy_config(logN=7, num_scales=14, num_special_primes=6)`` the parts at
level 1 are (lo, hi) = (0, 5), (5, 11), (11, 13), (13, 14): the logN17
pattern (alpha 5, then 6, then short tail parts) in small.

* ``ntt_keymul_accum_plain`` (K3 accum, one part of the mesh switcher's
  per-part chain) against the jnp chain ``ntt`` -> ``mont_mult`` ->
  ``mont_add``, with the skipped channels passed through;
* the port's ``_extend`` (the mesh switcher's basis extension) against the
  JAX ``_extend``;
* the port's ``_switcher_body`` (the all-parts kernel, the one route on one
  device) against the JAX ``_switcher_body``, which on the CPU runs its
  jnp branch;
* ``create_switcher`` on an NTT-domain input against the same;
* ``switch_key`` on a JAX ciphertext and key-switching key carried across
  with ``interop.from_jax``;
* ``CkksParams.part_lp`` at each part against the JAX package's;
* the all-parts key form reads the key's rows in place (no stacked copy,
  pointer tables beside the views), and ``switch_key`` / ``relinearize``
  go through ``ntt_keymul_parts`` alone and equal the JAX package's bytes
  at the toy, the 30-bit toy and this logN17-pattern toy.

Inputs are numpy draws from a seed.  Tolerance: none — byte-identical
(lazy accumulators included where the reference is the same lazy chain).
"""

import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config as jax_toy_config
from tiberate_tpu.context.ntt_context import CkksParams as JParams
from tiberate_tpu.engine import CkksEngine as JaxEngine
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu.ops import mont as jmont
from tiberate_tpu.ops import ntt as jntt
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import CkksEngine as TorchEngine
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.ops import ntt_kernels as K
from tiberate_tpu_torch.typing import FLAGS, KeySwitchKey

torch.set_num_threads(1)

LEVEL = 1
BATCH = 2
CFG = dict(logN=7, num_scales=14, num_special_primes=6, scale_bits=30)


def _uniform(rng, q, shape):
    """numpy residues uniform in [0, q_c) per channel (axis -2)."""
    q = np.asarray(q, dtype=np.int64)[:, None]
    return rng.integers(0, 1 << 62, size=shape, dtype=np.int64) % q


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


def _q(lp):
    return np.asarray(lp.pack._2q)[:, 0] // 2


@pytest.fixture(scope="module")
def params():
    return JParams(jax_toy_config(**CFG)), TorchEngine(toy_config(**CFG),
                                                       device="cpu", seed=0)


def test_parts_follow_the_logN17_pattern(params):
    jp, eng = params
    spans = [(p.lo, p.hi) for p in eng.params.parts[LEVEL]]
    assert spans == [(0, 5), (5, 11), (11, 13), (13, 14)]
    assert spans == [(p.lo, p.hi) for p in jp.parts[LEVEL]]


# (a) the kernel's plain version ----------------------------------------

SKIPS = {"none": None, "head": (0, 2), "interior": (5, 11),
         "to_the_end": (11, 20)}


@pytest.mark.parametrize("skip", sorted(SKIPS))
def test_ntt_keymul_accum_plain_matches_jnp(params, skip):
    jp, eng = params
    skip = SKIPS[skip]
    jlp, tlp = jp.lp(LEVEL, True), eng._lp(LEVEL, True)
    C, N = jlp.num_channels, jp.N
    assert C == 20
    rng = np.random.default_rng(40)
    q = _q(jlp)
    x = _uniform(rng, q, (BATCH, C, N))
    keys = [_uniform(rng, q, (C, N)) for _ in range(2)]
    acc = [_uniform(rng, 2 * q, (BATCH, C, N)) for _ in range(2)]

    X = jntt.ntt(x, jlp.psi, jlp.pack)
    want = []
    for a, k in zip(acc, keys):
        w = np.array(jmont.mont_add(a, jmont.mont_mult(X, k, jlp.pack),
                                    jlp.pack))
        if skip is not None:
            w[..., skip[0] : skip[1], :] = a[..., skip[0] : skip[1], :]
        want.append(w)

    tacc = tuple(torch.from_numpy(a.copy()) for a in acc)
    got = K.ntt_keymul_accum_plain(
        torch.from_numpy(x), tlp, tuple(torch.from_numpy(k) for k in keys),
        tacc, skip)
    for w, g, t in zip(want, got, tacc):
        assert g is t  # updated in place
        assert _eq(w, g)


def test_ntt_keymul_accum_rejects_bad_skip(params):
    _, eng = params
    lp = eng._lp(LEVEL, True)
    x = torch.zeros((lp.num_channels, 128), dtype=torch.int64)
    acc = (torch.zeros_like(x), torch.zeros_like(x))
    for skip in ((3, 3), (5, 2), (-1, 2), (0, lp.num_channels + 1)):
        with pytest.raises(ValueError):
            K.ntt_keymul_accum(x, lp, (x[0:lp.num_channels],) * 2, acc, skip)


# (b) the basis extension ----------------------------------------------


@pytest.mark.parametrize("part_id", range(4))
def test_extend_matches_jax(params, part_id):
    jp, eng = params
    jpart, tpart = jp.parts[LEVEL][part_id], eng.params.parts[LEVEL][part_id]
    jlp_ord = jp.lp(LEVEL, False)
    rng = np.random.default_rng(41 + part_id)
    a = _uniform(rng, _q(jlp_ord), (BATCH, jlp_ord.num_channels, jp.N))
    sl = slice(jpart.lo, jpart.hi)
    states = [jeng._pre_extend(a[b, sl], jpart, jlp_ord[sl])
              for b in range(BATCH)]
    got = teng._extend(torch.from_numpy(np.stack(states)), tpart,
                       eng._lp(LEVEL, True), LEVEL)
    for b, st in enumerate(states):
        want = jeng._extend(st, jpart, jp.lp(LEVEL, True), LEVEL)
        assert _eq(want, got[b])


# (c) the switcher body ------------------------------------------------


@pytest.fixture(scope="module")
def switch_case(params):
    """A random ksk, a batch of NTT-domain inputs and their coefficient
    form, and the JAX jnp _switcher_body on each batch entry."""
    jp, eng = params
    rng = np.random.default_rng(42)
    q_all = np.asarray(jp.q, dtype=np.int64)
    data = tuple(tuple(_uniform(rng, q_all, (len(q_all), jp.N))
                       for _ in range(2))
                 for _ in jp.parts[0])
    jlp_ord, jlp_sp = jp.lp(LEVEL, False), jp.lp(LEVEL, True)
    a_ntt = _uniform(rng, _q(jlp_ord), (BATCH, jlp_ord.num_channels, jp.N))
    a = np.array(jntt.intt_exit_reduce(a_ntt, jlp_ord.ipsi, jlp_ord.Ninv,
                                       jlp_ord.pack))
    alloc = jp.parts_alloc[LEVEL]
    want = [
        jeng._switcher_body(a[b], tuple(data[g] for g in alloc),
                            tuple(jp.parts[LEVEL]), jlp_sp, jlp_ord,
                            tuple(jp.PiRs[LEVEL]), LEVEL, jp.S, False)
        for b in range(BATCH)
    ]
    ksk = KeySwitchKey(
        data=tuple(tuple(torch.from_numpy(k) for k in pair) for pair in data),
        flags=FLAGS.INCLUDE_SPECIAL | FLAGS.MONTGOMERY_STATE
        | FLAGS.NTT_STATE,
        level=0,
    )
    return ksk, torch.from_numpy(a), torch.from_numpy(a_ntt), want


def test_switcher_body_matches_jax(params, switch_case):
    _, eng = params
    ksk, a, _, want = switch_case
    K.reset_launch_counts()
    got = teng._switcher_body(
        a, eng._ksk_parts_fused(ksk, LEVEL), tuple(eng.params.parts[LEVEL]),
        eng._lp(LEVEL, True), eng._lp(LEVEL, False),
        tuple(eng.params.PiRs[LEVEL]), eng.params.S, False)
    assert all(v == 0 for v in K.LAUNCHES.values())  # CPU: plain versions
    for b, (w0, w1) in enumerate(want):
        assert _eq(w0, got[0][b]) and _eq(w1, got[1][b])


# (d) switch_key on JAX objects -----------------------------------------


@pytest.fixture(scope="module")
def jax_switch():
    """A JAX engine, a ciphertext under a second secret key, the ksk from
    that key to the engine's, and the JAX switch_key result."""
    jeng_ = JaxEngine(jax_toy_config(**CFG), seed=31, nonce=2)
    sk2 = jeng_._create_secret_key()
    pk2 = jeng_._create_public_key(sk2)
    m = np.random.default_rng(43).uniform(-1, 1, jeng_.num_slots)
    ct = jeng_.encodecrypt(m, pk=pk2)
    ksk = jeng_.create_key_switching_key(sk2, jeng_.sk)
    return jeng_, ct, ksk, jeng_.switch_key(ct, ksk), m


def test_switch_key_matches_jax(jax_switch):
    jeng_, jct, jksk, want, m = jax_switch
    eng = TorchEngine(jeng_.ckksCfg, device="cpu", seed=0)
    eng.sk = interop.from_jax(jeng_.sk, device="cpu")
    ct, ksk = interop.from_jax(jct, device="cpu"), interop.from_jax(jksk, device="cpu")
    got = eng.switch_key(ct, ksk)
    assert got.level == want.level and got._flags == ct._flags
    for w, g in zip(want.data, got.data):
        assert _eq(w, g)
    out = eng.decryptcode(got, is_real=True)
    assert np.abs(out - m).max() < 5e-5


def test_create_switcher_matches_jax(params, switch_case):
    """``create_switcher`` at level 1 on the NTT-domain input
    (``exit_ntt``): the JAX _switcher_body's result on its coefficient
    form."""
    _, eng = params
    ksk, _, a_ntt, want = switch_case
    got = eng.create_switcher(a_ntt, ksk, LEVEL, exit_ntt=True)
    for b, (w0, w1) in enumerate(want):
        assert _eq(w0, got[0][b]) and _eq(w1, got[1][b])


# (e) the per-part level packs -----------------------------------------


@pytest.mark.parametrize("part_id", range(4))
def test_part_lp_matches_jax(params, part_id):
    """``part_lp`` of each level-1 part: the part's own global primes."""
    jp, eng = params
    jpart, tpart = jp.parts[LEVEL][part_id], eng.params.parts[LEVEL][part_id]
    jlp, tlp = jp.part_lp(jpart, LEVEL), eng.params.part_lp(tpart, LEVEL)
    assert tlp.num_channels == jlp.num_channels == tpart.alpha
    assert _eq(jlp.pack._2q, tlp.pack._2q)
    assert _eq(jlp.psi, tlp.psi) and _eq(jlp.Rs, tlp.Rs)


# (f) the all-parts route: keys in place, every keyswitch through K6 ----


def _storage(t):
    return t.untyped_storage().data_ptr()


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


@pytest.mark.parametrize("level", [0, LEVEL])
def test_parts_key_form_reads_the_key_in_place(params, switch_case, level):
    """Each part's (k0, k1) in the key form is a view of the key's own
    tensor at the level's rows; the pointer tables hold those views'
    addresses; nothing cached on the key holds a copy of key rows."""
    _, eng = params
    ksk = switch_case[0]
    keys, tables, ec, alphas = eng._ksk_parts_fused(ksk, level)
    alloc = eng.params.parts_alloc[level]
    assert len(keys) == len(alloc) == ec.shape[0] == alphas.shape[0]
    for (k0, k1), g in zip(keys, alloc):
        for view, key in zip((k0, k1), ksk.data[g]):
            assert _storage(view) == _storage(key)
            assert view.data_ptr() == key[level].data_ptr()
            assert view.shape == key[level:].shape and view.is_contiguous()
    ptrs = tuple((k0.data_ptr(), k1.data_ptr()) for k0, k1 in keys)
    assert tables.ptrs == ptrs
    assert tables.k0p.tolist() == [p[0] for p in ptrs]
    assert tables.k1p.tolist() == [p[1] for p in ptrs]
    assert eng._ksk_parts_fused(ksk, level)[1] is tables  # cached
    assert "_parts_fused" not in ksk.misc  # the stacked copies' cache
    own = {_storage(k) for pair in ksk.data for k in pair}
    row_bytes = ksk.data[0][0][0].nbytes
    cached = [t for form in ksk.misc["_parts_tables"].values()
              for t in _tensors(form)]
    assert len(cached) >= 2 * len(keys) + 2
    for t in cached:
        assert _storage(t) in own or t.nbytes < row_bytes


ROUTE_CFGS = {"toy": dict(logN=7, num_scales=4, num_special_primes=2,
                          scale_bits=30),
              "toy30": dict(logN=7, num_scales=4, num_special_primes=2,
                            scale_bits=21, buffer_bit_length=30),
              "logN17_pattern": CFG}


@pytest.fixture(scope="module", params=sorted(ROUTE_CFGS))
def jax_pair(request):
    """A JAX engine of the config, a ciphertext under a second secret key
    with its ksk to the engine's key, and a triplet; the port engine with
    the JAX keys carried across."""
    j = JaxEngine(jax_toy_config(**ROUTE_CFGS[request.param]), seed=33,
                  nonce=3)
    rng = np.random.default_rng(44)
    m1, m2 = (rng.uniform(-1, 1, j.num_slots) for _ in range(2))
    sk2 = j._create_secret_key()
    ct2 = j.encodecrypt(m1, pk=j._create_public_key(sk2))
    ksk = j.create_key_switching_key(sk2, j.sk)
    trip = j.cc_mult(j.encodecrypt(m1), j.encodecrypt(m2), post_relin=False)
    t = TorchEngine(j.ckksCfg, device="cpu", seed=0)
    t.sk = interop.from_jax(j.sk, device="cpu")
    t.evk = interop.from_jax(j.evk, device="cpu")
    return request.param, j, t, (ct2, ksk, trip)


@pytest.mark.parametrize("op", ["switch_key", "relinearize"])
def test_keyswitch_runs_the_parts_kernel_and_matches_jax(jax_pair, op,
                                                        monkeypatch):
    """``switch_key`` and ``relinearize`` on JAX objects: one
    ``ntt_keymul_parts`` call each (its plain version on the CPU, fed the
    key's rows in place), no chain kernel, the JAX package's bytes."""
    _, j, t, (ct2, ksk, trip) = jax_pair
    calls = {"parts": 0, "chain": 0}
    parts_plain, accum_plain = (K.ntt_keymul_parts_plain,
                                K.ntt_keymul_accum_plain)

    def parts(*a, **kw):
        calls["parts"] += 1
        return parts_plain(*a, **kw)

    def accum(*a, **kw):
        calls["chain"] += 1
        return accum_plain(*a, **kw)

    monkeypatch.setattr(K, "ntt_keymul_parts_plain", parts)
    monkeypatch.setattr(K, "ntt_keymul_accum_plain", accum)
    if op == "switch_key":
        want = j.switch_key(ct2, ksk)
        tksk = interop.from_jax(ksk, device="cpu")
        got = t.switch_key(interop.from_jax(ct2, device="cpu"), tksk)
    else:
        want = j.relinearize(trip, j.evk)
        tksk = t.evk
        got = t.relinearize(interop.from_jax(trip, device="cpu"))
    assert calls == {"parts": 1, "chain": 0}
    assert "_parts_tables" in tksk.misc
    assert got.level == want.level
    for w, g in zip(want.data, got.data):
        assert g.dtype == t.params.dtype
        assert _eq(w, g)
