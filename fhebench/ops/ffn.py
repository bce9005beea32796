"""The feed-forward sub-layer of an encrypted BERT-base encoder, features
as ciphertexts and tokens in the slots: one request is one forward of the
program's feature-wise feed-forward layer (``CkksEngine.feed_forward``)
over the configuration's ``hidden_size`` feature ciphertexts, stacked
into one, through ``intermediate_size`` features and MPCFormer's Quad.

Set-up: the layer (w1, w2 ~ N(0, 0.02^2), b1, b2 ~ U(-0.1, 0.1), drawn
from the seed), the keys, the messages (LayerNorm outputs: every token's
features of mean 0 and variance 1, times gamma, plus beta) and their
ciphertexts at level 0, encrypted a block at a time and stacked.  Work:
``hmult`` = intermediate_size a forward, the Quad's squares.  The inputs
are not consumed, so every request is the same forward.

The check recomputes the window's last output from the same inputs and
the evk's residues (``reference/ffn.py``), a block of intermediate
features at a time: every residue of every feature's output
(``residues``), the decrypted outputs against the same circuit in float64
on the messages (``ffn``), the inputs (``fresh``), the secret key and the
evk's noise, as ``cc_mult`` does.
"""

import numpy as np
import torch

from fhebench import generator
from fhebench.reference import ckks as ref
from fhebench.reference import ffn as ffnref
from fhebench.reference import layernorm as lnref

ENCRYPT_BLOCK = 96   # messages an encodecrypt_batch call in set-up
CHECK_BLOCK = 512    # intermediate features a block of the reference
CHECK_CHUNK = 128    # of which squared at once
DECRYPT_BLOCK = 128  # outputs decrypted at once


class FeedForward(generator.Op):
    def setup(self):
        if not hasattr(generator.CkksEngine, "feed_forward"):
            raise RuntimeError(
                "the program has no CkksEngine.feed_forward: no feed-forward "
                "layer over a stack of feature ciphertexts to run")
        if self.batch != 1:
            raise ValueError("an ffn request is one forward: batch 1")
        dep = self.config["deployment"]
        self.H = int(dep["hidden_size"])
        self.I = int(dep["intermediate_size"])
        std = float(dep["initializer_range"])
        super().setup()
        rng = self.rng
        self.w1 = rng.normal(0.0, std, (self.H, self.I))
        self.b1 = rng.uniform(-0.1, 0.1, self.I)
        self.w2 = rng.normal(0.0, std, (self.I, self.H))
        self.b2 = rng.uniform(-0.1, 0.1, self.H)
        self.layer = self.eng.feed_forward(self.w1, self.b1, self.w2,
                                           self.b2)
        self.keygen()
        self.m = ffnref.messages(rng, self.H, self.slots)
        parts = [self.encrypt(self.m[i:i + ENCRYPT_BLOCK])
                 for i in range(0, self.H, ENCRYPT_BLOCK)]
        self.X = type(parts[0])(
            data=tuple(torch.cat([p.data[i] for p in parts]) for i in (0, 1)),
            level=self.level, **parts[0].misc)
        del parts
        self.out = None

    def request(self, spans):
        with spans.span("ffn"):
            out = self.layer(self.X)
        with spans.span("sync"):
            generator.sync(self.device)
        self.out = out
        return {"hmult": self.I}

    def answers(self):
        return dict(X=self.X.data, out=self.out.data, sk=self.sk_rows(),
                    evk=generator.key_rows(self.eng.evk))

    def check(self, pr, raw, limits):
        s, sk_bad = ref.secret(pr, raw["sk"])
        x0, x1 = raw["X"]
        o0, o1 = raw["out"]
        level = ffnref.output_level(self.level)
        want_shape = (self.H, pr.P - level, pr.N)
        circuit = ffnref.Circuit(pr, raw["evk"])
        with torch.no_grad():
            z = circuit.forward(x0, x1, self.w1, self.b1, self.w2, self.b2,
                                CHECK_BLOCK, CHECK_CHUNK, self.level)
        bad = generator.compare((o0, o1), (z.c0, z.c1))
        del z
        got = np.full((self.H, self.slots), np.inf, dtype=np.complex128)
        if tuple(o0.shape) == want_shape:
            for i in range(0, self.H, DECRYPT_BLOCK):
                y, _ = lnref.decrypt(pr, o0[i:i + DECRYPT_BLOCK],
                                     o1[i:i + DECRYPT_BLOCK], s, level,
                                     lnref.scale_at(pr, level))
                got[i:i + DECRYPT_BLOCK] = ref.decode(y)
        want = ffnref.float_circuit(pr, self.m, self.w1, self.b1, self.w2,
                                    self.b2, self.level)
        fresh = 0.0
        for i in range(0, self.H, DECRYPT_BLOCK):
            y, _ = ref.decrypt(pr, x0[i:i + DECRYPT_BLOCK],
                               x1[i:i + DECRYPT_BLOCK], s, self.level,
                               ref.fresh_scale(pr))
            fresh = max(fresh, generator.err(ref.decode(y),
                                             self.m[i:i + DECRYPT_BLOCK]))
        S = generator.secret_eval(pr, s)
        noise = ref.key_noise(pr, raw["evk"], pr.mod.mul(S, pr.mod.mont(S)),
                              s, generator.sample_channels(pr, self.seed))
        return [
            ("residue_mismatch", bad, limits["residues"]),
            ("ffn_err", generator.err(got, want), limits["ffn"]),
            ("input_err", fresh, limits["fresh"]),
            ("sk_mismatch", sk_bad, limits["residues"]),
            ("evk_noise", noise, limits["key_noise"]),
        ]


OP = FeedForward
