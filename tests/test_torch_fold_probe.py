"""The fold-rate probe's plain versions against the JAX package's folds.

``tiberate_tpu_torch.ops.fold_probe`` is the counterpart of the TPU's VPU
op-rate probe (``benchmarks/profiling/vpu_microbench.py``, which launches a
Pallas kernel on a TPU when imported, so it is not imported here).  Its
Shoup chain is held to K = 32 chained ``pallas_mxu._shoup_mult`` run in jnp
on u32 pairs, as the probe's kernel body runs it, with the probe's
constants (q = 2^41 - 143, w = q - 12345, x < 2^60: xhi < 2^28) and with the
largest modulus of the logN15 chain; its REDC chain, in both lanes, to
K = 32 chained ``tiberate_tpu.ops.mont.mont_mult_raw`` and to the exact
Python-int REDC ``mont_mult_oracle`` on sampled elements.  Inputs are drawn
with numpy from a seed at [2, 8, 128].  Tolerance: none — every output is
bit-identical.

Also: the wrappers dispatch on the device of their input and raise where
their arithmetic stops being exact, and the probe's entry point raises
without a card.  The CUDA kernels themselves are held to these plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiberate_tpu.ops import mont as jmont
from tiberate_tpu.ops import pallas_mxu as P
from tiberate_tpu_torch.benchmarks.profiling import fold_microbench as fm
from tiberate_tpu_torch.ops import fold_probe as fp
from tiberate_tpu_torch.ops import mont as tmont

torch.set_num_threads(1)

K = 32
SHAPE = (2, 8, 128)
Q60 = fm.constants("fold_redc")[0]  # the logN15 chain's largest modulus
M31 = (1 << 31) - 1


def _jax_shoup_chain(x, w, q):
    """K chained _shoup_mult on the u32 pair of int64 ``x``, as the TPU
    probe's kernel body (vpu_microbench.py:39-44) runs it; back to int64."""
    wp = (w << 62) // q
    u32 = np.uint32
    consts = (u32(w & M31), u32(w >> 31), u32(wp & M31), u32(wp >> 31),
              u32(q & M31), u32(q >> 31), u32((2 * q) & 0xFFFFFFFF),
              u32((2 * q) >> 32))
    lo = jnp.asarray((x & 0xFFFFFFFF).astype(np.uint32))
    hi = jnp.asarray((x >> 32).astype(np.uint32))
    for _ in range(K):
        lo, hi = P._shoup_mult(lo, hi, *consts)
    return (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(
        np.int64)


@pytest.mark.parametrize("q", [fm.Q_PROBE, Q60], ids=["q41", "q60"])
def test_fold_shoup_plain_matches_jax_shoup_chain(q):
    rng = np.random.default_rng(q % 1000)
    xlo = rng.integers(0, 1 << 32, SHAPE, dtype=np.int64)
    xhi = rng.integers(0, 1 << 28, SHAPE, dtype=np.int64)
    x = xlo | (xhi << 32)
    w = q - 12345
    want = _jax_shoup_chain(x, w, q)
    got = fp.fold_shoup_plain(torch.from_numpy(x), w, q, K)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    # the chain ends lazy in [0, 2q), and the wrapper runs the plain version
    assert want.min() >= 0 and want.max() < 2 * q
    assert torch.equal(fp.fold_shoup(torch.from_numpy(x), w, q, K), got)


# lane (R bits) -> (probe mode, numpy dtype)
REDC_LANES = {62: ("fold_redc", np.int64), 30: ("fold_redc_30", np.int32)}


@pytest.mark.parametrize("lane", sorted(REDC_LANES))
def test_fold_redc_plain_matches_jax_redc_chain(lane):
    mode, dt = REDC_LANES[lane]
    q, w = fm.constants(mode)
    rng = np.random.default_rng(lane)
    x = rng.integers(0, 2 * q, SHAPE, dtype=np.int64).astype(dt)
    pk = jmont.ModPack.from_q([q], R_bits=lane)
    consts = (pk.ql[0, 0], pk.qh[0, 0], pk.kl[0, 0], pk.kh[0, 0])
    want = jnp.asarray(x)
    wj = jnp.asarray(np.array(w, dtype=dt))
    for _ in range(K):
        want = jmont.mont_mult_raw(want, wj, *consts)
    want = np.asarray(want)
    got = fp.fold_redc_plain(torch.from_numpy(x), w, q, K)
    assert got.numpy().dtype == want.dtype == dt
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(fp.fold_redc(torch.from_numpy(x), w, q, K), got)
    # the exact REDC with Python ints, on sampled elements
    flat, out = x.reshape(-1), got.numpy().reshape(-1)
    for i in rng.choice(flat.size, 16, replace=False):
        v = int(flat[i])
        for _ in range(K):
            v = tmont.mont_mult_oracle(v, w, q, R_bits=lane)
        assert v == int(out[i]) and 0 <= v < 2 * q


def test_probe_constants_are_the_tpu_probes_and_the_chains():
    """The Shoup mode uses vpu_microbench.py's q and w (:25-26); the REDC
    modes the largest modulus of the logN15 / logN15_30 chains, each inside
    its lane's bound."""
    assert fm.constants("fold_shoup") == ((1 << 41) - 143,
                                          (1 << 41) - 143 - 12345)
    assert fm.SHAPE == (64, 256, 512) and fm.K_SHORT == 32
    q62, q30 = fm.constants("fold_redc")[0], fm.constants("fold_redc_30")[0]
    assert 1 << 59 < q62 < 1 << 60 and 1 << 27 < q30 < 1 << 28


def test_wrappers_dispatch_on_device():
    """A CPU tensor runs the plain version and counts no launch; a device
    other than cpu or cuda raises."""
    x = torch.arange(1000, dtype=torch.int64)
    fp.reset_launch_counts()
    assert torch.equal(fp.fold_shoup(x, 7, fm.Q_PROBE, 3),
                       fp.fold_shoup_plain(x, 7, fm.Q_PROBE, 3))
    assert torch.equal(fp.fold_redc(x, 7, Q60, 3),
                       fp.fold_redc_plain(x, 7, Q60, 3))
    q30 = fm.constants("fold_redc_30")[0]
    x30 = x.to(torch.int32)
    assert torch.equal(fp.fold_redc(x30, 7, q30, 3),
                       fp.fold_redc_plain(x30, 7, q30, 3))
    assert sum(fp.LAUNCHES.values()) == 0
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fp.fold_shoup(meta, 7, fm.Q_PROBE, 3)
    with pytest.raises(ValueError, match="device"):
        fp.fold_redc(meta, 7, Q60, 3)


def test_fold_shoup_raises_outside_its_exact_range():
    q = fm.Q_PROBE
    x = torch.zeros(4, dtype=torch.int64)
    for bad_q in (1 << 61, 0):
        with pytest.raises(ValueError, match="q="):
            fp.fold_shoup(x, 1, bad_q, K)
    with pytest.raises(ValueError, match="w="):
        fp.fold_shoup(x, q, q, K)
    for bad_x in (1 << 61, -1):
        with pytest.raises(ValueError, match="outside"):
            fp.fold_shoup(torch.tensor([bad_x]), 1, q, K)
    with pytest.raises(TypeError, match="int64"):
        fp.fold_shoup(x.to(torch.int32), 1, q, K)
    with pytest.raises(TypeError, match="int64"):
        fp.fold_shoup_plain(x.double(), 1, q, K)
    with pytest.raises(ValueError, match="chain length"):
        fp.fold_shoup(x, 1, q, 0)


@pytest.mark.parametrize("lane", sorted(REDC_LANES))
def test_fold_redc_raises_outside_its_exact_range(lane):
    mode, dt = REDC_LANES[lane]
    q = fm.constants(mode)[0]
    x = torch.zeros(4, dtype=getattr(torch, np.dtype(dt).name))
    limit = 1 << (lane - 2)  # q < R / 4: the chain stays in [0, 2q)
    for bad_q in (q + 1, limit + 1, -q):  # even; odd but too large; < 0
        with pytest.raises(ValueError, match="q="):
            fp.fold_redc(x, 1, bad_q, K)
    with pytest.raises(ValueError, match="w="):
        fp.fold_redc(x, 2 * q, q, K)
    for bad_x in (2 * q, -1):
        with pytest.raises(ValueError, match="outside"):
            fp.fold_redc(torch.full((3,), bad_x, dtype=x.dtype), 1, q, K)
    with pytest.raises(TypeError, match="dtype"):
        fp.fold_redc(x.double(), 1, q, K)
    with pytest.raises(ValueError, match="chain length"):
        fp.fold_redc(x, 1, q, -1)


_SASS = """
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/                   IMAD.X R3, R5, 0x1, R3, P0 ;
        /*0020*/               @P1 BRA 0x0 ;
        /*0030*/                   LDG.E.64 R2, desc[UR6][R4.64] ;
        /*0040*/                   IMAD.WIDE.U32 R6, R9, UR12, RZ ;
        /*0050*/                   NOP ;
        /*0060*/                   LOP3.LUT R9, R8, 0x3fffffff, RZ, 0xc0, !PT ;
        /*0070*/              @!P0 BRA 0x40 ;
        /*0080*/                   STG.E.64 desc[UR6][R6.64], R8 ;
        /*0090*/              @!P0 BRA 0x30 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
"""


def test_chain_step_counts_the_nested_innermost_loop():
    """The SASS counter takes the loop nested in the grid-stride loop (here
    0x40-0x70), not the unnested copy loop (0x00-0x20) nor the trap branch;
    NOPs do not count."""
    assert fm.chain_step(_SASS) == (1, 3)
    assert fm.chain_step(_SASS.replace("@!P0 BRA 0x30", "EXIT")) is None


_NO_JAX = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import torch
import chip_smoke
from tiberate_tpu_torch.benchmarks.profiling import fold_microbench as fm
from tiberate_tpu_torch.ops import fold_probe, roofline
x = torch.arange(64, dtype=torch.int64)
q, w = fm.constants("fold_redc")
assert torch.equal(fold_probe.fold_redc(x, w, q, 4),
                   fold_probe.fold_redc_plain(x, w, q, 4))
assert roofline.ntt(1, 4, True) == 8 * 4 + 16
assert "tiberate_tpu" not in sys.modules
print("ok")
"""


def test_probe_runs_without_jax():
    """The probe, the roofline and chip_smoke.py import nothing of jax or
    of the JAX package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_probe_entry_point_raises_without_a_card():
    """The probe reports no rate from the CPU: it raises on a CPU device,
    and on "cuda" where no card is present."""
    with pytest.raises(RuntimeError, match="CUDA card only"):
        fm.measure("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card only"):
            fm.measure("cuda")
        with pytest.raises(RuntimeError, match="CUDA card only"):
            fm.main()
