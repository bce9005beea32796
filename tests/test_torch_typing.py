"""The typed front door of tiberate_tpu_torch against the JAX package on the
CPU: the class hierarchy, the operator sugar, the default-engine registry,
the flag methods and ``clone``, and ``save`` / ``load`` across packages.

The pairs of engines come from one toy configuration object (the JAX
package's ``toy_config(logN=7, num_scales=4, num_special_primes=2)`` and
its 30-bit twin) and the same (seed, nonce), so both engines have the same
``hash``: a ciphertext carried over with ``interop.from_jax`` keeps its
``creator_hash`` and dispatches to the port engine of the pair.  A test
that draws (an encode, a rotation key) first carries the JAX engine's
CSPRNG state and rotation-key store over.

Every sugar result is byte-identical to the JAX package's sugar on the
same operands and decrypts within its tests' bounds
(``tests/test_engine.py:17``: 5e-5, 200x for ``sum``; the 30-bit toy
``tests/test_mode30.py:21``: 1e-2).  Files written by either package's
``save`` load in the other with equal leaves, dtypes, flags, level and
scalar ``misc``.
"""

import json

import numpy as np
import pytest
import torch

from tiberate_tpu import typing as jtyping
from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu_torch import interop
from tiberate_tpu_torch import typing as ttyping
from tiberate_tpu_torch.config.toy import toy_config as ttoy_config
from tiberate_tpu_torch.engine import ckks_engine as teng

torch.set_num_threads(1)

CASES = {
    "toy": (dict(scale_bits=30), 5e-5),
    "toy30": (dict(scale_bits=21, buffer_bit_length=30), 1e-2),
}
_PAIRS = {}


def _pair(case):
    """(JAX engine, port engine) of one configuration object, from seed 41,
    nonce 3, keyed sk, pk, evk; built once per case."""
    if case not in _PAIRS:
        cfg = toy_config(logN=7, num_scales=4, num_special_primes=2,
                         **CASES[case][0])
        j = jeng.CkksEngine(cfg, seed=41, nonce=3)
        t = teng.CkksEngine(cfg, device="cpu", seed=41, nonce=3)
        for eng in (j, t):
            eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
        _PAIRS[case] = (j, t)
    return _PAIRS[case]


def _synced(case):
    """The pair with the port's CSPRNG and rotation-key store set to the
    JAX engine's."""
    j, t = _pair(case)
    t.rng = interop.csprng_from_jax(j.rng, device="cpu")
    t.rotk = {d: interop.from_jax(j.rotk[d], device="cpu")
              for d in j.rotk.keys()}
    return j, t


def _eq(j, t):
    j = np.asarray(j)
    return j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


def _same(j_data, t_data):
    j_data, t_data = list(j_data), list(t_data)
    return len(j_data) == len(t_data) and all(
        _eq(a, b) for a, b in zip(j_data, t_data))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param


def test_class_hierarchy_matches_jax():
    """Every class of the port's typing module has the JAX package's MRO
    names (``EvaluationKey`` derives from ``SecretKey`` in both), and
    ``_CLASS_REGISTRY`` names the same classes."""
    assert sorted(ttyping._CLASS_REGISTRY) == sorted(jtyping._CLASS_REGISTRY)
    for name in (*jtyping._CLASS_REGISTRY, "Plaintext"):
        jmro = [c.__name__ for c in getattr(jtyping, name).__mro__]
        tmro = [c.__name__ for c in getattr(ttyping, name).__mro__]
        assert tmro == jmro, name
    evk = ttyping.EvaluationKey(data=(), level=0)
    assert isinstance(evk, ttyping.SecretKey)
    assert not isinstance(evk, ttyping.KeySwitchKey)
    assert [f.name for f in ttyping.FLAGS] == [f.name for f in jtyping.FLAGS]
    import tiberate_tpu_torch as tpkg

    for name in tpkg._TYPED:
        assert getattr(tpkg, name) is getattr(ttyping, name)


# the 30-bit toy runs the sugar's dispatch through its other lane; these
# cases reach every engine core the full set reaches at the toy
_SUGAR_30 = ("ct1 * ct2 + ct1", "ct >> 3", "ct << 1", "1 - ct",
             "ct * vector", "triplet + triplet", "triplet * ct")


def _sugar_ops(mvec):
    """name -> (the expression, the expected message from (m1, m2), or
    None where only the bytes are held: a rescale of a fresh ciphertext
    divides the message by a prime)."""
    return {
        "ct1 * ct2 + ct1": (lambda a, b, t: a * b + a,
                            lambda m1, m2: m1 * m2 + m1),
        "ct >> 3": (lambda a, b, t: a >> 3, lambda m1, m2: np.roll(m1, 3)),
        "ct << 1": (lambda a, b, t: a << 1, lambda m1, m2: np.roll(m1, -1)),
        "ct ** 3": (lambda a, b, t: a ** 3, lambda m1, m2: m1 ** 3),
        "-ct": (lambda a, b, t: -a, lambda m1, m2: -m1),
        "ct1 - ct2": (lambda a, b, t: a - b, lambda m1, m2: m1 - m2),
        "0.5 + ct": (lambda a, b, t: 0.5 + a, lambda m1, m2: m1 + 0.5),
        "2.5 * ct": (lambda a, b, t: 2.5 * a, lambda m1, m2: 2.5 * m1),
        "1 - ct": (lambda a, b, t: 1 - a, lambda m1, m2: 1 - m1),
        "ct * vector": (lambda a, b, t: a * mvec,
                        lambda m1, m2: m1 * mvec),
        "ct - vector": (lambda a, b, t: a - list(mvec),
                        lambda m1, m2: m1 - mvec),
        "triplet + triplet": (lambda a, b, t: t + t,
                              lambda m1, m2: 2 * m1 * m2),
        "ct + triplet": (lambda a, b, t: a + t, lambda m1, m2: m1 + m1 * m2),
        "triplet * ct": (lambda a, b, t: t * a,
                         lambda m1, m2: m1 * m2 * m1),
        "triplet >> 1": (lambda a, b, t: t >> 1,
                         lambda m1, m2: np.roll(m1 * m2, 1)),
        "ct.rescale()": (lambda a, b, t: a.rescale(), None),
        "ct.level_up(2)": (lambda a, b, t: a.level_up(2),
                           lambda m1, m2: m1),
        "ct.sum()": (lambda a, b, t: a.sum(),
                     lambda m1, m2: np.full_like(m1, m1.sum())),
        "ct.mean()": (lambda a, b, t: a.mean(),
                      lambda m1, m2: np.full_like(m1, m1.mean())),
    }


def test_sugar_matches_jax(case):
    """Each operator, reflected form and method of the sugar on
    carried-over operands gives the JAX package's sugar's bytes, through
    the port engine the registry finds by ``creator_hash``; ``.plain`` and
    ``decryptcode`` agree with numpy."""
    j, t = _pair(case)
    assert t.hash == j.hash
    rng = np.random.default_rng(5)
    m1, m2, mvec = (rng.uniform(-1, 1, t.num_slots) for _ in range(3))
    ja, jb = j.encodecrypt(m1), j.encodecrypt(m2)
    jt = j.cc_mult(ja, jb, post_relin=False)
    ta, tb, tt_ = (interop.from_jax(x, device="cpu") for x in (ja, jb, jt))
    assert ta._default_engine is t and tt_._default_engine is t
    tol = CASES[case][1]
    for name, (expr, want) in _sugar_ops(mvec).items():
        if case == "toy30" and name not in _SUGAR_30:
            continue
        j, t = _synced(case)
        jout = expr(ja, jb, jt)
        tout = expr(ta, tb, tt_)
        assert type(tout).__name__ == type(jout).__name__, name
        assert tout.level == jout.level and _same(jout.data, tout.data), name
        assert np.array_equal(np.asarray(j.rng.states),
                              t.rng.states.numpy()), name
        bound = 200 * tol if name == "ct.sum()" else tol
        if want is None:
            continue
        if isinstance(tout, ttyping.Ciphertext):
            err = np.abs(tout.plain - want(m1, m2)).max()
        else:
            err = np.abs(tout.decryptcode(is_real=True)
                         - want(m1, m2)).max()
        assert err < bound, (name, err)
    with pytest.raises(TypeError, match="rotation offset must be int"):
        ta >> 1.5  # noqa: B018
    for bad in (ta.__add__, ta.__sub__, ta.__mul__):
        with pytest.raises(TypeError, match="Unsupported type"):
            bad(object())


def test_registry_dispatch_by_creator_hash(monkeypatch):
    """Both packages' registries: the first engine of a logN is its
    default, every engine is found by its hash, a structure dispatches to
    the engine that made it even when two engines share a logN, and an
    unknown logN raises the same error.  Two toy configurations of the
    same parameters hash differently in both packages (their repr holds a
    lambda's address)."""
    for mod in (jtyping, ttyping):
        monkeypatch.setattr(mod, "_default_engines", {})
        monkeypatch.setattr(mod, "_engines_by_hash", {})
    engines = {}
    for pkg, make_cfg, make in (
            ("jax", toy_config, lambda c: jeng.CkksEngine(c, seed=1)),
            ("port", ttoy_config,
             lambda c: teng.CkksEngine(c, device="cpu", seed=1))):
        cfgs = [make_cfg(logN=6, num_scales=3, num_special_primes=1)
                for _ in range(2)]
        engines[pkg] = [make(c) for c in cfgs]
    for (mod, (e1, e2)) in ((jtyping, engines["jax"]),
                            (ttyping, engines["port"])):
        assert e1.hash != e2.hash
        assert mod.get_default_engine(6) is e1
        assert mod.get_default_engine(6, e2.hash) is e2
        ct = mod.Ciphertext(data=(), level=0, **e2._meta())
        assert ct._default_engine is e2
        assert mod.Ciphertext(data=(), level=0, logN=6,
                              creator_hash="unknown")._default_engine is e1
        mod.register_default_engine(6, e2, overwrite=True)
        assert mod.get_default_engine(6) is e2
    with pytest.raises(RuntimeError) as jexc:
        jtyping.get_default_engine(5)
    with pytest.raises(RuntimeError) as texc:
        ttyping.get_default_engine(5)
    assert str(texc.value) == str(jexc.value)


def test_flags_and_clone_match_jax(case):
    """``set_flag`` / ``rm_flag`` / ``toggle_flag`` and the ``flags``
    property and setter move both packages' flags alike; ``clone`` copies
    the tensors (new storage, equal bytes, same device) and keeps flags,
    level and ``misc``."""
    j, t = _pair(case)
    jct = j.encodecrypt([0.5])
    tct = interop.from_jax(jct, device="cpu")
    F, JF = ttyping.FLAGS, jtyping.FLAGS
    steps = [("set_flag", "NTT_STATE"), ("set_flag", "NEED_RESCALE"),
             ("toggle_flag", "NTT_STATE"), ("toggle_flag", "INCLUDE_SPECIAL"),
             ("rm_flag", "NEED_RESCALE"), ("rm_flag", "MONTGOMERY_STATE")]
    for method, flag in steps:
        getattr(jct, method)(JF[flag])
        getattr(tct, method)(F[flag])
        assert [f.name for f in tct.flags] == [f.name for f in jct.flags]
        assert tct._flags.dumps() == jct._flags.dumps()
    tct.flags = [F.NEED_RELINERIZE, F.MONTGOMERY_STATE]
    jct.flags = [JF.NEED_RELINERIZE, JF.MONTGOMERY_STATE]
    assert tct._flags.dumps() == jct._flags.dumps()

    for obj in (tct, t.evk, t.sk):
        c = obj.clone()
        assert type(c) is type(obj) and c.level == obj.level
        assert c._flags == obj._flags and dict(c.misc) == dict(obj.misc)
        src = obj.data if isinstance(obj.data, tuple) else (obj.data,)
        dst = c.data if isinstance(c.data, tuple) else (c.data,)
        flat = [(a, b) for x, y in zip(src, dst)
                for a, b in (zip(x, y) if isinstance(x, tuple)
                             else [(x, y)])]
        for a, b in flat:
            assert torch.equal(a, b) and a.device == b.device
            assert a.data_ptr() != b.data_ptr()


def _saved(tmp_path, obj, name):
    path = str(tmp_path / name)
    obj.save(path)
    return path + ".npz"


def _header(path):
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__header__"]))


def _flat(data):
    if isinstance(data, (tuple, list)):
        return [x for d in data for x in _flat(d)]
    return [data]


def test_save_load_across_packages(case, tmp_path):
    """A ciphertext, a triplet, sk, pk and the evk written by either
    package's ``save`` load in the other (and in itself) with equal
    leaves and dtypes (int32 in the 30-bit mode), flags, level and scalar
    ``misc``; the headers are equal, the tree structure string included.
    As in the JAX package, ``load`` returns a flat tuple of leaves for
    any structure of more than one leaf (the evk's part pairs are
    flattened), and a loaded ciphertext decrypts."""
    j, t = _pair(case)
    m = np.linspace(-1, 1, t.num_slots)
    jct = j.encodecrypt(m)
    jtri = j.cc_mult(jct, jct, post_relin=False)
    objs = {"ct": jct, "triplet": jtri, "sk": j.sk, "pk": j.pk,
            "evk": j.evk}
    for name, jobj in objs.items():
        tobj = interop.from_jax(jobj, device="cpu")
        jpath = _saved(tmp_path, jobj, f"jax_{name}")
        tpath = _saved(tmp_path, tobj, f"port_{name}")
        assert _header(tpath) == _header(jpath), name
        n = len(_flat(tobj.data))
        assert _header(tpath)["num_leaves"] == n
        for path in (jpath, tpath):
            jl = jtyping.DataStruct.load(path)
            tl = ttyping.DataStruct.load(path, device="cpu")
            assert type(tl).__name__ == type(jl).__name__ == \
                type(jobj).__name__
            assert (tl.level, tl._flags.dumps()) == \
                (jl.level, jl._flags.dumps())
            assert dict(tl.misc) == dict(jl.misc)
            assert len(_flat(tl.data)) == len(_flat(jl.data)) == n
            assert isinstance(tl.data, tuple) == (n > 1)
            assert all(_eq(a, b) for a, b in zip(_flat(jl.data),
                                                 _flat(tl.data)))
            assert all(_eq(a, b) for a, b in zip(_flat(jobj.data),
                                                 _flat(tl.data)))
        assert tl.data[0].dtype == t.params.dtype
    ct = ttyping.Ciphertext.load(str(tmp_path / "jax_ct"), device="cpu")
    assert np.abs(ct.plain - m).max() < CASES[case][1]


def test_save_load_header_in_full_at_a_preset(tmp_path):
    """At a preset both packages' engines have one hash (and the same
    ``deviations``, ``corrections`` and ``base_prime``), so the headers
    match in full, ``creator_hash`` included: a port ciphertext of
    ``logN14`` written by the port loads in the JAX package with the JAX
    engine's hash, and a JAX-package structure (made from arrays, no
    engine call) loads in the port with its header unchanged."""
    j = jeng.CkksEngine("logN14", seed=1, nonce=1)
    t = teng.CkksEngine("logN14", device="cpu", seed=1, nonce=1)
    assert t.hash == j.hash
    assert (list(t.deviations), list(t.corrections), t.base_prime) == \
        (list(j.deviations), list(j.corrections), j.base_prime)
    tct = t.encodecrypt(np.linspace(-1, 1, t.num_slots))
    tpath = _saved(tmp_path, tct, "port_ct14")
    jct = jtyping.Ciphertext.load(tpath)
    assert dict(jct.misc) == {"logN": 14, "creator_hash": j.hash}
    assert all(_eq(a, b) for a, b in zip(jct.data, tct.data))

    arrays = tuple(np.asarray(d) for d in tct.data)
    jobj = jtyping.CiphertextTriplet(
        data=(*arrays, arrays[0]), flags=jtyping.FLAGS.NTT_STATE, level=2,
        **j._meta(), note="x", ratio=0.5)
    jpath = _saved(tmp_path, jobj, "jax_tri14")
    tobj = ttyping.DataStruct.load(jpath, device="cpu")
    back = _saved(tmp_path, tobj, "port_tri14")
    assert _header(back) == _header(jpath)
    assert type(tobj) is ttyping.CiphertextTriplet
    assert dict(tobj.misc) == {**j._meta(), "note": "x", "ratio": 0.5}
