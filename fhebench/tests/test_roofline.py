"""The roofline's products against the program's count of its kernels'
REDCs (``tiberate_tpu_torch/ops/roofline.py``) at the same shapes: every
difference is a product the algorithm does not need."""

import pytest
from tiberate_tpu_torch.ops import roofline as port

from fhebench.roofline import work

SHAPES = [(17, 73, 6), (15, 17, 2), (16, 37, 4), (7, 11, 3)]


def T(logN):
    return (1 << logN) // 2 * logN


def port_keyswitch(logN, P, S, level, B):
    """REDCs of G2, K6 and the P-division (K4, the special rows' inverse
    NTT, G3) for both accumulators."""
    N = 1 << logN
    C = P - level
    alphas = work.part_sizes(P, S, level)
    return (port.parts_digits(B, alphas, N)
            + port.ntt_keymul_parts(B, alphas, C + S, logN)
            + 2 * (port.intt_pdiv(B * C, logN, S)
                   + port.intt(B * S, logN, "exit_reduce")
                   + port.pdiv_p0(B, S, N)))


@pytest.mark.parametrize("logN,P,S", SHAPES)
def test_step_products_against_the_kernels_redcs(logN, P, S):
    B, level = 8, 0
    N = 1 << logN
    C1 = P - level - 1
    Csp = C1 + S
    alphas = work.part_sizes(P, S, level + 1)
    kernels = (4 * port.rescale(B * C1, N)
               + port.ntt_tensor(B * C1, logN)
               + 3 * port.intt(B * C1, logN, "exit_reduce")
               + port_keyswitch(logN, P, S, level + 1, B))
    explained = B * (
        4 * C1 * N            # K5's x R entry of its four inputs
        + C1 * N              # K5's fourth product (Karatsuba needs three)
        + 3 * 2 * C1 * N      # the x N^-1 R and exit REDCs of three iNTTs
        # K6 extends onto, and transforms, the part's own rows too
        + sum(N * (a * a - a + Csp) + a * T(logN) for a in alphas)
        + 2 * 2 * Csp * N)    # the P-division's N^-1 R and exit REDCs
    ours = work.cc_mult(logN, P, S, level, B).products
    assert kernels - ours == explained
    assert ours < kernels


@pytest.mark.parametrize("logN,P,S", SHAPES)
def test_rotation_products_against_the_kernels_redcs(logN, P, S):
    B, level = 8, 0
    N = 1 << logN
    Csp = P - level + S
    alphas = work.part_sizes(P, S, level)
    kernels = port_keyswitch(logN, P, S, level, B)
    # K6's extension of the part's own rows (the input transformed once
    # suffices for them) and the P-division's folds, as above
    explained = B * (sum(N * (a * a - a + Csp) for a in alphas)
                     + 2 * 2 * Csp * N)
    ours = work.keyswitch(logN, P, S, level, B, in_eval_domain=False)
    assert kernels - ours.products == explained


def test_parts_are_the_programs():
    """The part sizes the roofline counts are the program's partition."""
    from tiberate_tpu_torch.context.ntt_context import CkksParams
    from tiberate_tpu_torch.config.toy import toy_config

    cfg = toy_config(logN=7, num_scales=10, num_special_primes=3)
    params = CkksParams(cfg, "cpu")
    for level in range(3):
        assert work.part_sizes(params.P, params.S, level) == [
            p.alpha for p in params.parts[level]]


def test_ceiling():
    assert work.ceiling(1.98e9) == pytest.approx(4.18176e12)
    w = work.Work(products=int(4.18176e12), nbytes=1)
    assert w.least_s(1.98e9) == pytest.approx(1.0)
    assert work.Work(1, 3.35e12).least_s(1.98e9) == pytest.approx(1.0)
