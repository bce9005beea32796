"""The one traffic generator: a mix file (``traffic/<mix>.json``) names an
operation and its parameters; this module builds the cell's engine and
inputs from the seed, drives one closed-loop request at a time, keeps the
answers the check compares, and holds them to the reference.

Operations built in (the mix's ``"op"``; any other is the ``OP`` of
``ops/<op>.py``, an :class:`Op` subclass that may use this module's
helpers, found by ``harness.Bench.op``):

* ``cc_mult``: ``CkksEngine.cc_mult(A, B)`` on two stacked batches of
  ``batch`` fresh ciphertexts at ``level``; the inputs are not consumed,
  so every request is the same product.  Work: ``hmult`` = batch.
* ``sum``: ``CkksEngine.sum(A)`` on a stacked batch: logN - 1 rotations,
  each a keyswitch with its own key (made in set-up), and the additions.
  Work: ``hrot`` = batch (logN - 1).
* ``client``: ``encodecrypt_batch`` of ``batch`` fresh messages (a pool
  of ``pool`` batches drawn from the seed, in turn), then
  ``decryptcode_batch`` of ``batch`` ciphertexts at level 1 made once in
  set-up by one ``cc_mult``.  Work: ``roundtrip`` = 1.

Every request ends in ``torch.cuda.synchronize()`` with its results on
hand, as a caller that waits for each batch pays for it.
"""

import gc

import numpy as np
import torch
from tiberate_tpu_torch import typing as ttyping
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import (
    CkksEngine,
    stack_ciphertexts,
    unstack_ciphertext,
)

from fhebench.reference import ckks as ref


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_engine(config: dict, device, seed: int):
    """The program's engine for a configuration file, keyed by the seed;
    its prime chain must be the file's."""
    conf = (config["preset"] if "preset" in config
            else toy_config(**config["toy"]))
    eng = CkksEngine(conf, device=str(device), seed=seed)
    if [int(q) for q in eng.params.q] != [int(q) for q in config["primes"]]:
        raise ValueError(f"{config['name']}: the program's prime chain is "
                         "not the configuration file's")
    return eng


def release_engines():
    """Drop the program's registry of engines (it keeps each alive)."""
    ttyping._default_engines.clear()
    ttyping._engines_by_hash.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def key_rows(key):
    """A keyswitch key's residues: [(k0, k1)] over its parts."""
    return [tuple(part) for part in key.data]


def messages(rng, batch, slots):
    return rng.uniform(-1.0, 1.0, (batch, slots))


class Op:
    """One operation of a cell: set-up, a request, the answers kept."""

    def __init__(self, config, mix, seed, device):
        self.config = config
        self.mix = mix
        self.seed = seed
        self.device = torch.device(device)
        self.batch = int(mix["batch"])
        self.level = int(mix.get("level", 0))
        # the benchmark's own stream, apart from the program's CSPRNG
        self.rng = np.random.default_rng([seed, 1])
        self.eng = None

    def setup(self):
        self.eng = make_engine(self.config, self.device, self.seed)
        self.slots = self.eng.num_slots

    def keygen(self, evk=True):
        eng = self.eng
        eng.sk, eng.pk  # noqa: B018 — keygen, in the program's order
        if evk:
            eng.evk  # noqa: B018

    def encrypt(self, ms):
        return stack_ciphertexts(
            self.eng.encodecrypt_batch(list(ms), level=self.level))

    def sk_rows(self):
        return self.eng.sk.data

    def start_window(self):
        """Called once the warm-up is over, before the window opens."""

    def release(self):
        self.eng = None
        release_engines()


class CcMult(Op):
    def setup(self):
        super().setup()
        self.keygen()
        self.m1 = messages(self.rng, self.batch, self.slots)
        self.m2 = messages(self.rng, self.batch, self.slots)
        self.A = self.encrypt(self.m1)
        self.B = self.encrypt(self.m2)
        self.out = None

    def request(self, spans):
        with spans.span("cc_mult"):
            out = self.eng.cc_mult(self.A, self.B)
        with spans.span("sync"):
            sync(self.device)
        self.out = out
        return {"hmult": self.batch}

    def answers(self):
        return dict(A=self.A.data, B=self.B.data, out=self.out.data,
                    sk=self.sk_rows(), evk=key_rows(self.eng.evk))

    def check(self, pr, raw, limits):
        lvl = self.level
        s, sk_bad = ref.secret(pr, raw["sk"])
        out = compare(raw["out"], ref.cc_mult(pr, *raw["A"], *raw["B"],
                                              raw["evk"], lvl))
        got = ref.decode(ref.decrypt(pr, *raw["out"], s, lvl + 1,
                                     ref.mult_scale(pr, lvl))[0])
        ins = [ref.decode(ref.decrypt(pr, *raw[x], s, lvl,
                                      ref.fresh_scale(pr))[0])
               for x in ("A", "B")]
        S = secret_eval(pr, s)
        noise = ref.key_noise(pr, raw["evk"], pr.mod.mul(S, pr.mod.mont(S)),
                              s, sample_channels(pr, self.seed))
        return [
            ("residue_mismatch", out, limits["residues"]),
            ("decrypt_err", err(got, self.m1 * self.m2), limits["mult"]),
            ("input_err", max(err(ins[0], self.m1), err(ins[1], self.m2)),
             limits["fresh"]),
            ("sk_mismatch", sk_bad, limits["residues"]),
            ("evk_noise", noise, limits["key_noise"]),
        ]


class RotSum(Op):
    def setup(self):
        super().setup()
        self.keygen(evk=False)
        self.deltas = [1 << i for i in range(self.eng.ckksCfg.logN - 1)]
        for d in self.deltas:
            self.eng.get_rotation_key(d)
        self.m1 = messages(self.rng, self.batch, self.slots)
        self.A = self.encrypt(self.m1)
        self.out = None

    def request(self, spans):
        with spans.span("sum"):
            out = self.eng.sum(self.A)
        with spans.span("sync"):
            sync(self.device)
        self.out = out
        return {"hrot": self.batch * len(self.deltas)}

    def answers(self):
        return dict(A=self.A.data, out=self.out.data, sk=self.sk_rows(),
                    rotk=[key_rows(self.eng.get_rotation_key(d))
                          for d in self.deltas])

    def check(self, pr, raw, limits):
        lvl = self.level
        s, sk_bad = ref.secret(pr, raw["sk"])
        out = compare(raw["out"], ref.rot_sum(pr, *raw["A"], raw["rotk"],
                                              lvl))
        got = ref.decode(ref.decrypt(pr, *raw["out"], s, lvl,
                                     ref.fresh_scale(pr))[0])
        want = np.broadcast_to(self.m1.sum(-1, keepdims=True), got.shape)
        ins = ref.decode(ref.decrypt(pr, *raw["A"], s, lvl,
                                     ref.fresh_scale(pr))[0])
        channels = sample_channels(pr, self.seed)
        noise = 0
        for d, key in zip(self.deltas, raw["rotk"]):
            src, neg = ref.galois(pr.N, pow(3, d, 2 * pr.N), pr.device)
            noise = max(noise, ref.key_noise(
                pr, key, secret_eval(pr, torch.where(neg, -s[src], s[src])),
                s, channels))
        return [
            ("residue_mismatch", out, limits["residues"]),
            ("decrypt_err", err(got, want), limits["sum"]),
            ("input_err", err(ins, self.m1), limits["fresh"]),
            ("sk_mismatch", sk_bad, limits["residues"]),
            ("rotk_noise", noise, limits["key_noise"]),
        ]


class Client(Op):
    def setup(self):
        super().setup()
        self.keygen()
        self.m1 = messages(self.rng, self.batch, self.slots)
        self.m2 = messages(self.rng, self.batch, self.slots)
        prod = self.eng.cc_mult(self.encrypt(self.m1), self.encrypt(self.m2))
        self.results = unstack_ciphertext(prod)
        self.pool = [messages(self.rng, self.batch, self.slots)
                     for _ in range(int(self.mix["pool"]))]
        self.n = 0
        # a uniform sample of the window's requests (reservoir), drawn
        # from the seed: (request index, ciphertexts, decoded)
        self.keep = int(self.mix["sample"])
        self.kept = []
        self.pick = np.random.default_rng([self.seed, 2])

    def request(self, spans):
        i = self.n
        self.n += 1
        ms = self.pool[i % len(self.pool)]
        with spans.span("encodecrypt_batch"):
            cts = self.eng.encodecrypt_batch(list(ms))
            with spans.span("sync"):
                sync(self.device)
        with spans.span("decryptcode_batch"):
            dec = self.eng.decryptcode_batch(self.results, is_real=True)
            with spans.span("sync"):
                sync(self.device)
        if len(self.kept) < self.keep:
            slot = len(self.kept)
            self.kept.append(None)
        else:
            slot = int(self.pick.integers(0, i + 1))
            slot = slot if slot < self.keep else None
        if slot is not None:
            self.kept[slot] = (i, stack_ciphertexts(cts).data, dec)
        return {"roundtrip": 1}

    def start_window(self):
        """The sample holds the window's requests only."""
        self.n = 0
        self.kept = []

    def answers(self):
        return dict(kept=self.kept, sk=self.sk_rows())

    def check(self, pr, raw, limits):
        s, sk_bad = ref.secret(pr, raw["sk"])
        enc = dec = 0.0
        bad = 0
        for i, data, got in raw["kept"]:
            ms = self.pool[i % len(self.pool)]
            y, b = ref.decrypt(pr, *data, s, 0, ref.fresh_scale(pr))
            enc = max(enc, err(ref.decode(y), ms))
            bad += b
            dec = max(dec, err(got, self.m1 * self.m2))
        if not raw["kept"]:
            enc = dec = float("inf")
        return [
            ("encrypt_err", enc, limits["fresh"]),
            ("encrypt_channels", bad, limits["residues"]),
            ("decrypt_err", dec, limits["mult"]),
            ("sk_mismatch", sk_bad, limits["residues"]),
        ]


OPS = {"cc_mult": CcMult, "sum": RotSum, "client": Client}


def err(got, want):
    """Largest slot error; a non-finite slot reads inf."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    return float(d.max()) if np.all(np.isfinite(d)) else float("inf")


def compare(got, want):
    """Residues of the program's output that differ from the reference's,
    both polynomials; a wrong shape counts every residue."""
    bad = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return sum(int(x.numel()) for x in want)
        bad += int((g != w).sum())
    return bad


def to64(obj):
    """The program's residues as int64 (the 30-bit lane stores int32)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(torch.int64) if obj.dtype == torch.int32 else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(to64(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to64(v) for k, v in obj.items()}
    return obj


def secret_eval(pr, s):
    """A small polynomial [N] in the evaluation domain of every prime."""
    return pr.ntt.forward(pr.mod.mod(s.expand(len(pr.primes), -1)))


def sample_channels(pr, seed):
    """The primes a key check reads, drawn from the seed: each key part's
    first prime, two more ordinary ones and one special."""
    rng = np.random.default_rng([seed, 3])
    own = [lo for lo, _, _ in pr.parts(0)]
    more = rng.choice(pr.P, size=min(2, pr.P), replace=False).tolist()
    spec = [pr.P + int(rng.integers(0, pr.S))]
    return sorted(set(own + more + spec))
