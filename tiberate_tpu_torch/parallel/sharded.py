"""The fused multiply step: rescale -> tensor product -> relinearize.

The single-device counterpart of ``tiberate_tpu/parallel/sharded.py``
(``make_mult_step`` / ``mult_step_params`` with ``pre_rescale=True``, the
form ``cc_mult`` runs).  A batch of ciphertexts is the leading dimension of
the step's operands.  The mesh (rns / coef) branches come with the
multi-GPU slice of the port.

The keyswitch route follows the JAX package: ``prm["parts_fused"]`` set
(logN <= 16) runs all parts in one ``ntt_keymul_parts`` kernel; None
(logN 17) runs the per-part chain with the in-part shortcut
(``prm["inpart"]``).  A caller forces the other route by replacing
``parts_fused`` in ``prm``.
"""

from tiberate_tpu_torch.engine.ckks_engine import (
    _ccmult_tensor_core,
    _relin_core,
    _rescale_core,
)


def prepare_step_ksk(eng, level: int = 0, ksk=None):
    """The ksk argument for :func:`make_mult_step`'s step function: the
    evk's per-part (k0, k1) rows at the work level ``level + 1``, which the
    per-part chain reads (the all-parts route reads its stacked keys from
    ``prm["parts_fused"]``)."""
    return eng._ksk_args(ksk or eng.evk, level + 1)[0]


def mult_step_params(eng, level: int = 0, ksk=None):
    """The parameter dict for :func:`make_mult_step`'s step function; the
    key-derived entries (``inpart``, ``parts_fused``) come from ``ksk``
    (default: the engine's evk) and are cached on it."""
    work_level = level + 1
    ksk = ksk or eng.evk
    return dict(
        rescale_scale=eng.params.rescale_scales[level],
        lp_ord=eng._lp(work_level, False),
        lp_sp=eng._lp(work_level, True),
        parts=tuple(eng.params.parts[work_level]),
        PiRs=tuple(eng.params.PiRs[work_level]),
        inpart=eng._ksk_inpart(ksk, work_level),
        parts_fused=eng._ksk_parts_fused(ksk, work_level),
    )


def make_mult_step(eng, level: int = 0):
    """Returns step_fn(a0, a1, b0, b1, ksk_parts, prm) -> (ct0, ct1).

    ``a*``/``b*``: [..., C, N] ciphertext rows at ``level``; the result is
    at ``level + 1``.  ``ksk_parts`` from :func:`prepare_step_ksk`; ``prm``
    from :func:`mult_step_params`.
    """
    S = eng.ckksCfg.num_special_primes
    round_at = eng.params.q[level] // 2
    work_level = level + 1

    def step(a0, a1, b0, b1, ksk_parts, prm):
        rs, lp = prm["rescale_scale"], prm["lp_ord"]
        a0, a1, b0, b1 = (_rescale_core(x, rs, lp, round_at)
                          for x in (a0, a1, b0, b1))
        d0, d1, d2 = _ccmult_tensor_core(a0, a1, b0, b1, lp)
        return _relin_core(d0, d1, d2, ksk_parts, prm["parts"],
                           prm["lp_sp"], lp, prm["PiRs"], work_level, S,
                           inpart=prm["inpart"],
                           parts_fused=prm["parts_fused"])

    return step
