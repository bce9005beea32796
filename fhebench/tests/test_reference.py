"""The reference against the program's CPU path at a toy ring: byte for
byte where the output is canonical (every residue of cc_mult, a rotation
and sum; the evaluation domain of the keys), and the decryption of
fresh ciphertexts against their messages."""

import numpy as np
import pytest
import torch
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import CkksEngine, stack_ciphertexts
from tiberate_tpu_torch.ops import ntt_kernels as kern

from fhebench.reference import ckks as ref
from fhebench.reference import modarith as ma
from fhebench.tests.toy import TOY

B = 3


@pytest.fixture(scope="module")
def setup():
    cfg = toy_config(**TOY)
    eng = CkksEngine(cfg, device="cpu", seed=2**33 + 17)
    pr = ref.Params(cfg.q, cfg.logN, cfg.num_special_primes, "cpu",
                    cfg.scale_bits)
    rng = np.random.default_rng(4)
    m1, m2 = (rng.uniform(-1, 1, (B, eng.num_slots)) for _ in range(2))
    A = stack_ciphertexts(eng.encodecrypt_batch(list(m1)))
    Bc = stack_ciphertexts(eng.encodecrypt_batch(list(m2)))
    return eng, pr, m1, m2, A, Bc


def keys(k):
    return [tuple(p) for p in k.data]


def test_redc_is_the_definition():
    rng = np.random.default_rng(0)
    q = (1 << 61) - 1 - 2 * 12345
    q = next(p for p in range(q, q - 10**6, -2) if pow(2, p - 1, p) == 1)
    a = [int(x) for x in rng.integers(-(1 << 61), 1 << 61, 200)]
    b = [int(x) for x in rng.integers(0, q, 200)]
    a += [0, 1, -1, (1 << 62) - 1, -(1 << 62) + 1]
    b += [q - 1, 0, q - 1, q - 1, q - 1]
    got = ma.redc(torch.tensor(a), torch.tensor(b), q, ma.k_of(q)).tolist()
    R = 1 << 62
    for x, y, g in zip(a, b, got):
        T = x * y
        assert g == (T + (T * ma.k_of(q)) % R * q) // R


def test_transform_is_the_programs_domain(setup):
    eng, pr, *_ = setup
    x = torch.randint(0, 1 << 40, (len(pr.primes), pr.N)) % pr.mod.q
    theirs = kern.ntt(x.clone(), eng._lp(0, True), enter=True)
    plain = pr.mod.mul(pr.mod.mod(theirs), torch.ones_like(pr.mod.q))
    assert torch.equal(pr.ntt.forward(x), plain)
    assert torch.equal(pr.ntt.inverse(pr.ntt.forward(x)), x)


def test_cc_mult_residues(setup):
    eng, pr, m1, m2, A, Bc = setup
    out = eng.cc_mult(A, Bc)
    r0, r1 = ref.cc_mult(pr, *A.data, *Bc.data, keys(eng.evk), 0)
    assert torch.equal(r0, out.data[0])
    assert torch.equal(r1, out.data[1])
    s, bad = ref.secret(pr, eng.sk.data)
    assert bad == 0 and set(s.unique().tolist()) <= {-1, 0, 1}
    y, bad = ref.decrypt(pr, *out.data, s, 1, ref.mult_scale(pr, 0))
    assert bad == 0
    assert np.abs(ref.decode(y) - m1 * m2).max() < 1e-5


def test_rotation_and_sum_residues(setup):
    eng, pr, m1, _, A, _ = setup
    rot = eng.rotate_single(A, eng.get_rotation_key(4))
    r0, r1 = ref.rotate(pr, *A.data, keys(eng.get_rotation_key(4)), 4, 0)
    assert torch.equal(r0, rot.data[0]) and torch.equal(r1, rot.data[1])
    out = eng.sum(A)
    rk = [keys(eng.get_rotation_key(1 << i)) for i in range(pr.logN - 1)]
    r0, r1 = ref.rot_sum(pr, *A.data, rk, 0)
    assert torch.equal(r0, out.data[0]) and torch.equal(r1, out.data[1])


def test_fresh_decryption_and_keys(setup):
    eng, pr, m1, _, A, _ = setup
    s, _ = ref.secret(pr, eng.sk.data)
    y, bad = ref.decrypt(pr, *A.data, s, 0, ref.fresh_scale(pr))
    assert bad == 0
    assert np.abs(ref.decode(y) - m1).max() < 1e-6
    S = pr.ntt.forward(pr.mod.mod(s.expand(len(pr.primes), -1)))
    every = list(range(len(pr.primes)))
    assert ref.key_noise(pr, keys(eng.evk), pr.mod.mul(S, pr.mod.mont(S)),
                         s, every) <= 31
    # the key of another secret is no key of this one
    assert ref.key_noise(pr, keys(eng.evk), S, s, every) > 1 << 20
    # one residue altered: the primes disagree
    bad_ct = A.data[0].clone()
    bad_ct[0, 2, 5] = (bad_ct[0, 2, 5] + 1) % pr.primes[2]
    assert ref.decrypt(pr, bad_ct, A.data[1], s, 0, 1.0)[1] == 1
