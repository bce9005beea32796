"""The LayerNorm of an encrypted BERT-base encoder, features as
ciphertexts and tokens in the slots: one request is one forward of the
program's feature-wise LayerNorm (``CkksEngine.layer_norm``) over the
configuration's ``hidden_size`` feature ciphertexts, stacked into one.

Set-up: the layer (gamma and beta per feature, drawn from the seed), the
keys, the messages (every token's variance over the features inside
``var_range``) and their ciphertexts at level 0, encrypted a block at a
time and stacked.  Work: ``hmult`` = 2 F + 3 iters a forward: the F
squares, the F products with the reciprocal root and the Newton chain's
three a step.  The inputs are not consumed, so every request is the same
forward.

The check recomputes the window's last output from the same inputs and
the evk's residues (``reference/layernorm.py``), a block of features at a
time: every residue of every feature's output (``residues``), the
decrypted outputs against the same circuit in float64 on the messages
(``layernorm``) and against exact LayerNorm (``approx``), the inputs
(``fresh``), the secret key and the evk's noise, as ``cc_mult`` does.
"""

import numpy as np
import torch

from fhebench import generator
from fhebench.reference import ckks as ref
from fhebench.reference import layernorm as lnref

ENCRYPT_BLOCK = 96   # messages an encodecrypt_batch call in set-up
CHECK_BLOCK = 128    # features a block of the reference


class LayerNorm(generator.Op):
    def setup(self):
        if not hasattr(generator.CkksEngine, "layer_norm"):
            raise RuntimeError(
                "the program has no CkksEngine.layer_norm: no LayerNorm "
                "over a stack of feature ciphertexts to run")
        if self.batch != 1:
            raise ValueError("a layernorm request is one forward: batch 1")
        dep = self.config["deployment"]
        self.F = int(dep["hidden_size"])
        self.eps = float(dep["layer_norm_eps"])
        self.iters = int(dep["iters"])
        self.var_range = tuple(float(v) for v in dep["var_range"])
        super().setup()
        self.gamma = self.rng.uniform(0.5, 1.5, self.F)
        self.beta = self.rng.uniform(-0.5, 0.5, self.F)
        self.layer = self.eng.layer_norm(self.gamma, self.beta, eps=self.eps,
                                         var_range=self.var_range,
                                         iters=self.iters)
        self.keygen()
        self.m = lnref.messages(self.rng, self.F, self.slots, self.var_range)
        parts = [self.encrypt(self.m[i:i + ENCRYPT_BLOCK])
                 for i in range(0, self.F, ENCRYPT_BLOCK)]
        self.X = type(parts[0])(
            data=tuple(torch.cat([p.data[i] for p in parts]) for i in (0, 1)),
            level=self.level, **parts[0].misc)
        del parts
        self.out = None

    def request(self, spans):
        with spans.span("layernorm"):
            out = self.layer(self.X)
        with spans.span("sync"):
            generator.sync(self.device)
        self.out = out
        return {"hmult": 2 * self.F + 3 * self.iters}

    def answers(self):
        return dict(X=self.X.data, out=self.out.data, sk=self.sk_rows(),
                    evk=generator.key_rows(self.eng.evk))

    def check(self, pr, raw, limits):
        s, sk_bad = ref.secret(pr, raw["sk"])
        x0, x1 = raw["X"]
        o0, o1 = raw["out"]
        level = lnref.output_level(self.iters)
        readable = tuple(o0.shape) == (self.F, pr.P - level, pr.N)
        circuit = lnref.Circuit(pr, raw["evk"], self.eps, self.var_range,
                                self.iters)
        block = min(CHECK_BLOCK, self.F)
        bad = 0
        got = np.full((self.F, self.slots), np.inf, dtype=np.complex128)
        for i, z in circuit.forward(x0, x1, self.gamma, self.beta, block):
            bad += generator.compare((o0[i:i + block], o1[i:i + block]),
                                     (z.c0, z.c1))
            if readable:
                y, _ = lnref.decrypt(pr, o0[i:i + block], o1[i:i + block],
                                     s, level, lnref.scale_at(pr, level))
                got[i:i + block] = ref.decode(y)
        want = lnref.float_circuit(self.m, self.gamma, self.beta, self.eps,
                                   self.var_range, self.iters)
        exact = lnref.exact(self.m, self.gamma, self.beta, self.eps)
        fresh = 0.0
        for i in range(0, self.F, block):
            y, _ = ref.decrypt(pr, x0[i:i + block], x1[i:i + block], s,
                               self.level, ref.fresh_scale(pr))
            fresh = max(fresh, generator.err(ref.decode(y),
                                             self.m[i:i + block]))
        S = generator.secret_eval(pr, s)
        noise = ref.key_noise(pr, raw["evk"], pr.mod.mul(S, pr.mod.mont(S)),
                              s, generator.sample_channels(pr, self.seed))
        return [
            ("residue_mismatch", bad, limits["residues"]),
            ("layernorm_err", generator.err(got, want), limits["layernorm"]),
            ("approx_err", generator.err(got, exact), limits["approx"]),
            ("input_err", fresh, limits["fresh"]),
            ("sk_mismatch", sk_bad, limits["residues"]),
            ("evk_noise", noise, limits["key_noise"]),
        ]


OP = LayerNorm
