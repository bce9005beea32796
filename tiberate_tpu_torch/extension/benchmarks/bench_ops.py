"""Op-level benchmarks: single cc_mult / pc_mult, the per-level sweep, the
HE linear layer and batched encrypted inference.

The torch counterparts of ``tiberate_tpu/extension/benchmarks/
bench_ops.py``, with the same names, presets and metrics: the latency of
each engine op, with ciphertext sizes and the decrypt-vs-plain error
always reported beside it.  Every ``run`` takes ``device`` ("cuda" unless
the caller asks for "cpu").
"""

import time

import numpy as np

from tiberate_tpu_torch.extension.benchmarks.interface import (
    BenchmarkBase,
    BenchmarkResult,
    benchreg,
    sync,
)
from tiberate_tpu_torch.typing import Plaintext
from tiberate_tpu_torch.utils.massive import datastruct_size_bytes


def _make_engine(preset, device="cuda", num_scales=4):
    """The engine of ``preset`` from seed 7; "toy" is the JAX package's toy
    ring (logN 8, 30-bit scale, two special primes) with ``num_scales``
    levels."""
    from tiberate_tpu_torch.engine import CkksEngine

    if preset == "toy":
        from tiberate_tpu_torch.config.toy import toy_config

        return CkksEngine(
            toy_config(logN=8, num_scales=num_scales, num_special_primes=2,
                       scale_bits=30),
            device=device, seed=7,
        )
    return CkksEngine(preset, device=device, seed=7)


@benchreg.register
class SingleCMult(BenchmarkBase):
    name = "single_cmult"
    description = "cc_mult latency + error, with and without relinearize"

    def run(self, preset="logN15", iters=10, device="cuda",
            **kwargs) -> BenchmarkResult:
        eng = _make_engine(preset, device)
        res = BenchmarkResult(name=f"{self.name}[{preset}]")
        m1 = np.random.default_rng(0).uniform(-1, 1, eng.num_slots)
        m2 = np.random.default_rng(1).uniform(-1, 1, eng.num_slots)
        ct1, ct2 = eng.encodecrypt(m1), eng.encodecrypt(m2)
        _ = eng.evk  # build outside the timed region

        dt = self.timeit(lambda: eng.cc_mult(ct1, ct2), iters=iters)
        res.add_scalar("cc_mult_with_relin", dt * 1e3, "ms")
        dt = self.timeit(lambda: eng.cc_mult(ct1, ct2, post_relin=False),
                         iters=iters)
        res.add_scalar("cc_mult_no_relin", dt * 1e3, "ms")

        out = eng.decryptcode(eng.cc_mult(ct1, ct2), is_real=True)
        err = np.abs(out - m1 * m2)
        res.add_scalar("decrypt_max_err", float(err.max()))
        res.add_scalar("decrypt_mean_err", float(err.mean()))
        res.add_scalar("ct_size_mb",
                       datastruct_size_bytes(ct1) / 2**20, "MB")
        return res


@benchreg.register
class SinglePMult(BenchmarkBase):
    name = "single_pmult"
    description = "pc_mult latency + error"

    def run(self, preset="logN15", iters=10, device="cuda",
            **kwargs) -> BenchmarkResult:
        eng = _make_engine(preset, device)
        res = BenchmarkResult(name=f"{self.name}[{preset}]")
        m1 = np.random.default_rng(0).uniform(-1, 1, eng.num_slots)
        m2 = np.random.default_rng(1).uniform(-1, 1, eng.num_slots)
        ct = eng.encodecrypt(m1)
        pt = Plaintext(m2)
        _ = eng.pc_mult(pt, ct)  # warm the per-level encode cache

        dt = self.timeit(lambda: eng.pc_mult(pt, ct), iters=iters)
        res.add_scalar("pc_mult", dt * 1e3, "ms")

        out = eng.decryptcode(eng.pc_mult(pt, ct), is_real=True)
        err = np.abs(out - m1 * m2)
        res.add_scalar("decrypt_max_err", float(err.max()))
        res.add_scalar("pt_cache_size_mb",
                       datastruct_size_bytes(pt.cache[0]["pc_mult"]) / 2**20,
                       "MB")
        return res


@benchreg.register
class LatOfEachLevel(BenchmarkBase):
    name = "lat_of_each_level"
    description = (
        "per-level latency of every op + ct size + error until the level "
        "budget is exhausted"
    )

    def run(self, preset="logN15", iters=5, max_levels=None, device="cuda",
            **kwargs) -> BenchmarkResult:
        eng = _make_engine(preset, device)
        res = BenchmarkResult(name=f"{self.name}[{preset}]")
        rng = np.random.default_rng(0)
        m1 = rng.uniform(-1, 1, eng.num_slots)
        m2 = rng.uniform(-1, 1, eng.num_slots)
        _ = eng.evk
        rotk1 = eng.get_rotation_key(1)

        levels = range(
            0, min(max_levels or eng.num_levels - 1, eng.num_levels - 1)
        )
        cols = [
            "level", "cc_add_ms", "cc_add_triplet_ms",
            "cc_mult_norelin_ms", "relin_ms", "pc_add_ms", "pc_mult_ms",
            "rescale_ms", "rotate_ks_ms", "ct_mb", "decrypt_max_err",
        ]
        rows = []
        for lvl in levels:
            ct1 = eng.encodecrypt(m1, level=lvl)
            ct2 = eng.encodecrypt(m2, level=lvl)
            pt = Plaintext(m2)
            tri = eng.cc_mult(ct1, ct2, post_relin=False)
            ops = [
                lambda: eng.cc_add(ct1, ct2),
                lambda: eng.cc_add(tri, tri),
                lambda: eng.cc_mult(ct1, ct2, post_relin=False),
                lambda: eng.relinearize(tri),
                lambda: eng.pc_add(pt, ct1),
                lambda: eng.pc_mult(pt, ct1, post_rescale=False),
                lambda: eng.rescale(ct1),
                lambda: eng.rotate_single(ct1, rotk1),
            ]
            times = [self.timeit(op, iters=iters) for op in ops]

            out = eng.decryptcode(eng.cc_mult(ct1, ct2), is_real=True)
            err = float(np.abs(out - m1 * m2).max())
            rows.append([
                lvl,
                *(round(t * 1e3, 3) for t in times),
                round(datastruct_size_bytes(ct1) / 2**20, 3),
                err,
            ])
        res.add_table("per_level", cols, rows)
        return res


@benchreg.register
class LinearFeatureWise(BenchmarkBase):
    name = "linear_feature_wise"
    description = "HE linear layer (feature-wise packed) forward"

    def run(self, preset="toy", dim=None, device="cuda",
            **kwargs) -> BenchmarkResult:
        from tiberate_tpu_torch.extension.nn import HELinearFeatureWise
        from tiberate_tpu_torch.extension.packing import (
            FeatureWiseCTEncoding,
        )

        eng = _make_engine(preset, device)
        res = BenchmarkResult(name=f"{self.name}[{preset}]")
        dim = dim or min(16, eng.num_slots)
        rng = np.random.default_rng(0)
        W = rng.uniform(-1, 1, (dim, dim))
        b = rng.uniform(-1, 1, dim)
        x = rng.uniform(-1, 1, (1, dim))

        layer = HELinearFeatureWise(W, b, eng)
        ct_in = FeatureWiseCTEncoding.encodecrypt(x, eng)
        t0 = time.perf_counter()
        ct_out = layer(ct_in)
        sync()
        dt = time.perf_counter() - t0
        out = FeatureWiseCTEncoding.decryptcode(ct_out, eng)
        expect = x @ W.T + b
        err = np.abs(out - expect)
        res.add_scalar("forward_s", dt, "s")
        res.add_scalar("max_err", float(err.max()))
        res.add_scalar("dim", dim)
        return res


def score_batch(eng, fcts, w, bias):
    """Encrypted logistic-regression scores of one batch: ``fcts`` one
    ciphertext per feature (samples in the slots); the dot product with
    ``w`` plus ``bias`` by scalar products and adds, then the degree-3
    sigmoid 0.5 + 0.25 z - z^3 / 48 (two cc_mult levels)."""
    z = eng.mult_scalar(fcts[0], float(w[0]))
    for f in range(1, len(fcts)):
        z = eng.cc_add(z, eng.mult_scalar(fcts[f], float(w[f])))
    z = eng.add_scalar(z, bias)
    # sigmoid(z) ~ 0.5 + 0.25 z - z^3 / 48 on [-4, 4]
    z2 = eng.cc_mult(z, z)
    z3 = eng.cc_mult(z2, eng.level_up(z, z2.level))
    out = eng.cc_add(
        eng.mult_scalar(eng.level_up(z, z3.level), 0.25),
        eng.mult_scalar(z3, -1.0 / 48.0),
    )
    return eng.add_scalar(out, 0.5)


@benchreg.register
class BatchedInference(BenchmarkBase):
    name = "batched_inference"
    description = ("encrypted logistic-regression scoring over batches of "
                   "feature-wise packed ciphertexts (samples in slots)")

    def run(self, preset="toy", features=8, batches=4, iters=3,
            device="cuda", **kwargs) -> BenchmarkResult:
        """Samples fill the slot axis, features are separate ciphertexts
        (the packing extension's feature-wise layout), so the dot product
        needs no rotation (:func:`score_batch`).  ``codec_share`` is the
        encode and decode time's share of the whole pipeline."""
        # the scoring chain needs 4 multiplicative levels
        eng = _make_engine(preset, device, num_scales=6)
        res = BenchmarkResult(name=f"{self.name}[{preset}]")
        rng = np.random.default_rng(0)
        w = rng.uniform(-1, 1, features)
        bias = float(rng.uniform(-1, 1))
        xs = rng.uniform(-1, 1, (batches, features, eng.num_slots))

        # one vectorized encode for the whole input; the warm-up call
        # builds the codec's tables, so codec_share is the steady state
        msgs = [xs[b, f] for b in range(batches) for f in range(features)]
        _ = eng.encodecrypt_batch(msgs)
        sync()
        t0 = time.perf_counter()
        flat = eng.encodecrypt_batch(msgs)
        sync()
        enc_s = time.perf_counter() - t0
        cts = [flat[b * features : (b + 1) * features]
               for b in range(batches)]
        _ = eng.evk

        outs = [score_batch(eng, b, w, bias) for b in cts]  # warm-up
        dt = self.timeit(lambda: [score_batch(eng, b, w, bias)
                                  for b in cts], iters=iters)
        samples = batches * eng.num_slots
        res.add_scalar("samples_per_s", samples / dt, "samples/s")
        res.add_scalar("latency_per_batch_ms",
                       dt / batches * 1e3, "ms")

        zs = (xs * w[None, :, None]).sum(axis=1) + bias
        expect = 0.5 + 0.25 * zs - zs**3 / 48.0
        _ = eng.decryptcode_batch(outs, is_real=True)  # warm-up
        t0 = time.perf_counter()
        got = eng.decryptcode_batch(outs, is_real=True)
        dec_s = time.perf_counter() - t0
        res.add_scalar("max_err", float(np.abs(got - expect).max()))
        res.add_scalar("samples", samples)
        res.add_scalar("features", features)
        res.add_scalar("encode_ms", enc_s * 1e3, "ms")
        res.add_scalar("decode_ms", dec_s * 1e3, "ms")
        res.add_scalar(
            "codec_share",
            (enc_s + dec_s) / (enc_s + dec_s + dt),
        )
        return res
