"""The CKKS engine over torch tensors: the torch counterpart of
``tiberate_tpu/engine/ckks_engine.py`` — keygen (rotation, Galois and
conjugation keys included), encrypt/decrypt, cc_mult, switch_key, the
rotations and conjugation, add/sub, plaintext and scalar ops, level
management and the statistics built on them.

Each core below is the torch twin of the jnp core of the same name, with a
batch written out as leading dimensions where the JAX package ``vmap``s:
the JAX package's ``_encrypt_batch_core``, ``_decrypt_double_batch_core``
and ``_final_scale_batch`` are :func:`_encrypt_core`,
:func:`_decrypt_double_core` and :func:`_final_scale` on ``[B, C, N]``
operands.  Keys and noise come from the counter-mode ChaCha20 CSPRNG
(:mod:`tiberate_tpu_torch.rng.csprng`) on the engine's device, drawn in
the JAX package's order, so the same ``(seed, nonce)`` gives the JAX
package's keys and ciphertexts byte for byte.
The NTTs, the tensor product, the keyswitch (all parts in one kernel,
``ntt_keymul_parts``, at every logN) and the P-division go through the
kernel wrappers of :mod:`tiberate_tpu_torch.ops.ntt_kernels`, and the
step's glue between them (the rescale, the keyswitch digits and the
special rows of the P-division), and the modular add, subtract and
product by a column of ``cc_add``, ``cc_sub``, ``level_up`` and the
scalar products, through those of
:mod:`tiberate_tpu_torch.ops.glue_kernels`, and the stacked linear op's
matrix product (:meth:`CkksEngine.mult_matrix`, which the JAX package
lacks) through :mod:`tiberate_tpu_torch.ops.matmul`: one code path, which
launches the Hopper kernels for CUDA tensors and runs their plain
versions for CPU tensors.  Outputs are bit-identical to the JAX
package's jnp path on the same inputs.

One route differs from the JAX package's on purpose.  The JAX engine
switches keys at logN17 and above through the per-part chain
(``tiberate_tpu/engine/ckks_engine.py:908-912``), because its Pallas
all-parts kernel keeps the part sums in VMEM scratch and that working set
does not fit at logN17.  The H100 kernel keeps them in registers, so here
every logN takes the all-parts kernel, the one keyswitch route on one
device; both routes give the same bytes.  The per-part chain lives on only
in the mesh switcher (:mod:`tiberate_tpu_torch.parallel.rns_sharded`).
"""

import functools
import logging
import math
import types
import uuid
from hashlib import sha256
from typing import NamedTuple

import numpy as np
import torch

from tiberate_tpu_torch import errors
from tiberate_tpu_torch.config import CkksConfig, Preset
from tiberate_tpu_torch.context.ntt_context import CkksParams, PartPack
from tiberate_tpu_torch.ops import glue_kernels as glue
from tiberate_tpu_torch.ops import matmul as mm
from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt_kernels as kern
from tiberate_tpu_torch.parallel.mesh import (
    ShardedArray,
    all_gather,
    fitting_spec,
    reshard,
)
from tiberate_tpu_torch.rng.csprng import Csprng
from tiberate_tpu_torch.typing import (
    FLAGS,
    Ciphertext,
    CiphertextTriplet,
    ConjugationKey,
    DataStruct,
    EvaluationKey,
    GaloisKey,
    KeySwitchKey,
    Plaintext,
    PublicKey,
    RotationKey,
    SecretKey,
    register_default_engine,
)
from tiberate_tpu_torch.utils import encoding as codec
from tiberate_tpu_torch.utils import trace
from tiberate_tpu_torch.utils.massive import decompose_rot_offsets

logger = logging.getLogger("tiberate_tpu_torch")

# ======================================================================
# Cores.
# ======================================================================


class MatrixWeights(NamedTuple):
    """A weight matrix encoded for :meth:`CkksEngine.mult_matrix` at one
    level: ``limbs`` the balanced bytes [L, F_in, F_out] int8, stored F_in
    fastest (``ops/matmul.weight_limbs``), on the engine's device, of each
    weight's signed integer, as ``mult_scalar`` encodes a scalar there."""

    level: int
    limbs: torch.Tensor


def _t(x):
    """A key's data as one tensor: a mesh-laid key gathered (cached on its
    ShardedArray), a tensor as it is."""
    return x.gather() if isinstance(x, ShardedArray) else x


def _keygen_sk_core(ternary, lp):
    """uniform ternary -> NTT+Montgomery secret key."""
    return kern.ntt(mont.tile_unsigned(ternary, lp.pack), lp, enter=True)


def _keygen_pk_core(e, a, sk, lp):
    """pk0 = e - a*s (NTT domain)."""
    pk = lp.pack
    e_t = kern.ntt(mont.tile_unsigned(e, pk), lp, enter=True)
    return mont.mont_sub(e_t, mont.mont_mult(a, sk, pk), pk)


def _ksk_shard_core(pk0, Psk, lo, alpha, pack_part):
    """Add the P-scaled source-key shard into a ksk part's pk0."""
    out = pk0.clone()
    out[lo : lo + alpha] = mont.mont_add(pk0[lo : lo + alpha], Psk,
                                         pack_part)
    return out


def _encrypt_core(pt, dc_rns, e0, e1, v, pk0, pk1, lp):
    """pt/e0/e1/v: [..., N] signed; pk0/pk1: [C, N]; dc_rns: [..., C]
    bias-guard DC residues (zeros when bias_guard is off), in the storage
    dtype.
    -> (ct0, ct1), each [..., C, N]."""
    pk = lp.pack
    e0_t = mont.tile_unsigned(e0, pk)
    e1_t = mont.tile_unsigned(e1, pk)
    pt_t = mont.tile_unsigned(pt, pk).clone()
    pt_t[..., 0] += dc_rns
    pt_t = mont.mont_enter(pt_t, lp.Rs_scale, pk)
    pt_t = mont.mont_reduce(pt_t, pk)
    pte0 = mont.mont_add(pt_t, e0_t, pk)

    v_t = mont.tile_unsigned(v, pk).contiguous()
    vpk0, vpk1 = kern.ntt_keymul(v_t, lp, (pk0, pk1), enter=True)
    vpk0 = kern.intt(vpk0, lp, "exit")
    vpk1 = kern.intt(vpk1, lp, "exit")

    ct0 = mont.reduce_2q(mont.mont_add(vpk0, pte0, pk), pk)
    ct1 = mont.reduce_2q(mont.mont_add(vpk1, e1_t, pk), pk)
    return ct0, ct1


def _final_scale(pt, base_lp, final_scalar, rounding_half, base_at,
                 final_round):
    """Common decrypt epilogue: (base - scaler) * q_lvl^-1, signed,
    rounded.  pt: [..., C, N] -> [..., 1, N]."""
    bpk = base_lp.pack
    base = pt[..., base_at : base_at + 1, :]
    scaler = pt[..., 0:1, :]
    scaled = mont.mont_sub(base, scaler, bpk)
    scaled = mont.mont_mult(scaled, final_scalar, bpk)
    scaled = mont.reduce_2q(scaled, bpk)
    scaled = mont.make_signed(scaled, bpk)
    if final_round:
        scaled = scaled + (scaler > rounding_half).to(scaled.dtype)
    return scaled


def _decrypt_double_core(ct0, ct1, sk, lp, base_lp, final_scalar,
                         rounding_half, base_at, final_round):
    """-> (scaled [..., 1, N], pt [..., C, N])."""
    pk = lp.pack
    (sa,) = kern.ntt_keymul(ct1, lp, (sk,), enter=True)
    sa = kern.intt(sa, lp, "exit")
    pt = mont.reduce_2q(mont.mont_add(ct0, sa, pk), pk)
    scaled = _final_scale(pt, base_lp, final_scalar, rounding_half,
                          base_at, final_round)
    return scaled, pt


def _decrypt_triplet_core(d0, d1, d2, sk, lp, base_lp, final_scalar,
                          rounding_half, base_at, final_round):
    """Decrypt an NTT/Montgomery-state triplet: d0 + d1 s + d2 s^2.
    -> (scaled [..., 1, N], pt [..., C, N])."""
    pk = lp.pack
    d0x = kern.intt(d0, lp, "exit_reduce")
    d1_s = mont.mont_mult(d1, sk, pk)
    s2 = mont.mont_mult(sk, sk, pk)
    d2_s2 = mont.mont_mult(d2, s2, pk)
    d1_s = kern.intt(d1_s, lp, "exit")
    d2_s2 = kern.intt(d2_s2, lp, "exit")
    pt = mont.mont_add(d0x, d1_s, pk)
    pt = mont.mont_add(pt, d2_s2, pk)
    pt = mont.reduce_2q(pt, pk)
    scaled = _final_scale(pt, base_lp, final_scalar, rounding_half,
                          base_at, final_round)
    return scaled, pt


def _intt_exit_to_mont(x, lp):
    """iNTT keeping the Montgomery factor (key material leaves the NTT
    domain this way before a rotation permutes it)."""
    return kern.intt(x, lp, "mont")


def _check_plain_state(ct):
    """A ciphertext to decrypt is in neither the NTT nor the Montgomery
    state.  The reference checks it before the secret key in
    ``decrypt_double`` and after it in ``decryptcode``; so does the port."""
    if ct.has_flag(FLAGS.NTT_STATE):
        raise errors.NTTStateError(expected=False)
    if ct.has_flag(FLAGS.MONTGOMERY_STATE):
        raise errors.MontgomeryStateError(expected=False)


def _check_ntt_mont_state(ds):
    """A key, or a triplet to decrypt, is in the NTT and the Montgomery
    state."""
    if not ds.has_flag(FLAGS.NTT_STATE):
        raise errors.NTTStateError(expected=True)
    if not ds.has_flag(FLAGS.MONTGOMERY_STATE):
        raise errors.MontgomeryStateError(expected=True)


def _rescale_core(d, rescale_scale, lp_next, round_at, exact_rounding=True):
    """Drop the top RNS channel, rounding exactly unless told not to.
    d: [..., C, N] in [0, q) -> [..., C-1, N]: one G1 kernel
    (``glue_kernels.rescale``), which reads the dropped row and the kept
    rows of ``d`` in place."""
    return glue.rescale(d[..., 0:1, :], d[..., 1:, :], rescale_scale,
                        lp_next, round_at, exact_rounding)


def _ccmult_tensor_core(x0, x1, y0, y1, lp):
    """Tensor product in the NTT domain: d0 = x0y0, d1 = x0y1 + x1y0,
    d2 = x1y1."""
    return kern.ntt_tensor(*(x.contiguous() for x in (x0, x1, y0, y1)), lp)


def _cc_add_core(a, b, lp):
    """(a + b) mod q in [0, q): one G4 kernel (``glue_kernels.mod_add``)."""
    return glue.mod_add(a, b, lp)


def _cc_sub_core(a, b, lp):
    """(a - b) mod q in [0, q): one G4 kernel (``glue_kernels.mod_sub``)."""
    return glue.mod_sub(a, b, lp)


def _perm_core(d, src, sign):
    """Bare Galois coefficient permutation (key material): a gather along
    the last dimension and a sign multiply, ``sign * d[..., src]``."""
    return sign * d[..., src]


def _rotate_data_core(d, src, sign, lp):
    """Galois permutation of ciphertext rows, back to [0, q)."""
    out = mont.make_unsigned(_perm_core(d, src, sign), lp.pack)
    return mont.reduce_2q(out, lp.pack)


def _ntt_plain(x, lp):
    """Forward NTT of Montgomery-form input, no entry (K1): the JAX
    package's ``_ntt_plain(signed=True)``.  The input may hold negative
    representatives (the sign-flipped, permuted secret key of a rotation or
    conjugation key); the kernel's butterflies, like the plain ones, take
    them as they are."""
    return kern.ntt(x.contiguous(), lp, enter=False)


def _pc_add_core(pt_m, ct0, lp):
    """pt (cached, = pt * scale * R) + ct0."""
    pk = lp.pack
    new0 = mont.mont_enter(ct0, lp.Rs, pk)
    s = mont.mont_add(pt_m, new0, pk)
    s = mont.mont_reduce(s, pk)
    return mont.reduce_2q(s, pk)


def _pc_mult_core(pt_ntt, ct0, ct1, lp):
    """pt (cached: its enter-NTT row [C, N]) * ct: one ``ntt_keymul`` (K3,
    one key, with entry) and one ``exit_reduce`` iNTT (K2) per ciphertext
    polynomial.  The plain versions are the JAX package's CPU branch:
    enter-NTT, ``mont_mult`` by the row, iNTT."""
    (d0,) = kern.ntt_keymul(ct0.contiguous(), lp, (pt_ntt,), enter=True)
    (d1,) = kern.ntt_keymul(ct1.contiguous(), lp, (pt_ntt,), enter=True)
    return kern.intt(d0, lp, "exit_reduce"), kern.intt(d1, lp, "exit_reduce")


def _mont_scalar_core(d, scalar_col, lp):
    """d times a column (REDC), in [0, q): one G4 kernel
    (``glue_kernels.mont_scalar``), which reads ``d`` in place."""
    return glue.mont_scalar(d, scalar_col, lp)


def _add_scalar_core(ct0, scalar_col, lp):
    """Add one value per channel ([C, 1], or [B, C, 1]: one column per
    stacked ciphertext) to coefficient 0."""
    out = ct0.clone()
    out[..., 0] += scalar_col[..., 0]
    return mont.reduce_2q(out, lp.pack)


def _negate_core(d, lp):
    """-d normalized to [0, q)."""
    s = mont.make_signed(-d, lp.pack)
    return mont.make_unsigned(s, lp.pack)


def _prepare_pc_add_cache(pt, lp):
    """Encoded coefficients [N] -> pt * scale * R residues [C, N]."""
    pk = lp.pack
    return mont.mont_enter(mont.tile_unsigned(pt, pk), lp.Rs_scale, pk)


def _prepare_pc_mult_cache(pt, lp):
    """Encoded coefficients [N] -> their enter-NTT row [C, N] (K1), the key
    row ``_pc_mult_core``'s K3 takes."""
    return kern.ntt(mont.tile_unsigned(pt, lp.pack).contiguous(), lp,
                    enter=True)


def _pre_extend(a_part, part: PartPack, plp):
    """Mixed-radix (Garner) digits of the part residues.

    a_part: [..., alpha, N] values in [0, q); returns [..., alpha, N]
    signed digits: G2 (``glue_kernels.parts_digits``) with one part.
    """
    return glue.parts_digits(a_part, (part,), plp, part.alpha,
                             lo_base=part.lo)[..., 0, :, :]


def _extend(state, part: PartPack, lp_sp, lvl: int):
    """Basis-extend mixed-radix digits [..., alpha, N] onto the full
    with-special basis: [..., C_sp, N] in Montgomery form."""
    pk = lp_sp.pack
    ext = mont.mont_enter(state[..., 0:1, :], lp_sp.Rs, pk)
    for i in range(part.alpha - 1):
        Y = mont.mont_mult(state[..., i + 1 : i + 2, :],
                           part.L_enter[i][lvl:], pk)
        ext = mont.mont_add(ext, Y, pk)
    return ext


def _pdiv_fused(acc, lp_sp, lp_ord, PiRs, S):
    """iNTT + P-division of one keyswitch accumulator [..., C+S, N].

    Phase 1 ([..., S, N]): inverse-transform the special rows and replay
    the successive rescale on the special block alone, giving the plain
    row each division subtracts.  Phase 2: one ``intt_pdiv`` on the
    ordinary rows.  Returns canonical [0, q) ordinary rows.
    """
    C = lp_ord.num_channels
    lp_spec = lp_sp[C:]
    cur = kern.intt(acc[..., C:, :].contiguous(), lp_spec, "exit_reduce")
    return kern.intt_pdiv(acc, glue.pdiv_p0(cur, lp_spec, PiRs, C, S),
                          lp_ord, PiRs)


def _parts_digits(a, parts, lp_ord, amax):
    """Every part's mixed-radix digits, zero-padded to ``amax`` rows:
    [..., n_parts, amax, N] (the ``ntt_keymul_parts`` operand), in one G2
    kernel (``glue_kernels.parts_digits``)."""
    return glue.parts_digits(a, parts, lp_ord, amax)


def _parts_consts(params, level):
    """(ec, alphas) of the all-parts keyswitch at ``level``: the extension
    constants [n_parts, C_sp, amax] (``Rs``, then the part's ``L_enter``
    rows, zero past its alpha) and the int32 alphas."""
    parts = params.parts[level]
    lp_sp = params.lp(level, True)
    amax = max(pt.alpha for pt in parts)
    zrow = torch.zeros_like(lp_sp.Rs)
    ec = torch.stack([
        torch.cat(
            [lp_sp.Rs]
            + [pt.L_enter[i][level:] if pt.alpha > i + 1 else zrow
               for i in range(amax - 1)],
            dim=-1,
        )
        for pt in parts
    ])
    alphas = torch.tensor([pt.alpha for pt in parts], dtype=torch.int32,
                          device=params.device)
    return ec.contiguous(), alphas


def _switcher_body(a, ksk, parts, lp_sp, lp_ord, PiRs, S, exit_ntt):
    """Key switching of ``a`` [..., C, N] (coefficient domain, [0, q); NTT
    domain with ``exit_ntt``): returns (c0, c1) canonical ordinary rows.

    ``ksk`` = (keys, tables, ec, alphas) from
    :meth:`CkksEngine._ksk_parts_fused`: every part's digits go to ONE
    ``ntt_keymul_parts`` call, which extends, transforms, multiplies by
    both evk components (read in place through ``tables``) and sums the
    parts.
    """
    if exit_ntt:
        a = kern.intt(a, lp_ord, "exit_reduce")
    keys, tables, ec, alphas = ksk
    st = _parts_digits(a, parts, lp_ord, ec.shape[-1])
    acc = kern.ntt_keymul_parts(st, ec, alphas, keys, lp_sp, tables)
    c0 = _pdiv_fused(acc[0], lp_sp, lp_ord, PiRs, S)
    c1 = _pdiv_fused(acc[1], lp_sp, lp_ord, PiRs, S)
    return c0, c1


def _switch_key_core(ct0, a, ksk, parts, lp_sp, lp_ord, PiRs, S, exit_ntt):
    """switch_key: new ct0 = ct0 + c0, new ct1 = c1 (the spans
    ``keyswitch`` and ``switch_key.close``)."""
    with trace.annotate("keyswitch"):
        c0, c1 = _switcher_body(a, ksk, parts, lp_sp, lp_ord, PiRs, S,
                                exit_ntt)
    with trace.annotate("switch_key.close"):
        new0 = mont.reduce_2q(mont.mont_add(ct0, c0, lp_ord.pack),
                              lp_ord.pack)
    return new0, c1


def _relin_core(d0, d1, d2, ksk, parts, lp_sp, lp_ord, PiRs, S):
    """relinearize a triplet in the NTT domain -> (ct0, ct1) (the spans
    ``keyswitch`` and ``relin.close``, the closing adds)."""
    d0 = kern.intt(d0, lp_ord, "exit_reduce")
    d1 = kern.intt(d1, lp_ord, "exit_reduce")
    d2 = kern.intt(d2, lp_ord, "exit_reduce")
    with trace.annotate("keyswitch"):
        c0, c1 = _switcher_body(d2, ksk, parts, lp_sp, lp_ord, PiRs, S,
                                False)
    with trace.annotate("relin.close"):
        ct0 = mont.reduce_2q(d0 + c0, lp_ord.pack)
        ct1 = mont.reduce_2q(d1 + c1, lp_ord.pack)
    return ct0, ct1


# ======================================================================
# The engine mesh.
# ======================================================================

_CTS = (Ciphertext, CiphertextTriplet)


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return (a.type, a.index or 0) == (b.type, b.index or 0)


def _holds_sharded(obj) -> bool:
    """A ShardedArray, or a ciphertext (triplet) whose data is one, in
    ``obj`` (args and kwargs); keys do not count: their readers gather
    them (:func:`_t`)."""
    if isinstance(obj, ShardedArray):
        return True
    if isinstance(obj, _CTS):
        return any(isinstance(d, ShardedArray) for d in obj.data)
    if isinstance(obj, (list, tuple)):
        return any(_holds_sharded(o) for o in obj)
    if isinstance(obj, dict):
        return any(_holds_sharded(o) for o in obj.values())
    return False


def _local(obj):
    """``obj`` with every ShardedArray and mesh-laid ciphertext gathered
    onto the mesh's first device."""
    if isinstance(obj, ShardedArray):
        return obj.gather()
    if isinstance(obj, _CTS) and _holds_sharded(obj):
        return type(obj)(data=tuple(_t(d) for d in obj.data),
                         flags=obj._flags, level=obj.level, **obj.misc)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_local(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _local(v) for k, v in obj.items()}
    return obj


def _mesh_op(sharded=None, local_out=False):
    """An engine op on the mesh form.  Without an engine mesh, or with no
    mesh-laid ciphertext among the arguments, the op runs as it is.
    Otherwise the method named ``sharded`` runs it per shard; where that
    returns NotImplemented (its gates failed), or there is none, the op
    takes the gathered route: its ciphertexts gathered onto the mesh's
    first device, the single-device op, the result laid back out (not with
    ``local_out``: decrypts), counted in ``engine.gathered_ops``."""
    def deco(fn):
        @functools.wraps(fn)
        def op(self, *args, **kwargs):
            if self.mesh is None or not _holds_sharded((args, kwargs)):
                return fn(self, *args, **kwargs)
            if sharded is not None:
                out = getattr(self, sharded)(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            name = fn.__name__
            self.gathered_ops[name] = self.gathered_ops.get(name, 0) + 1
            out = fn(self, *_local(args), **_local(kwargs))
            return out if local_out else self.to_mesh(out)
        return op
    return deco


# ======================================================================
# The engine.
# ======================================================================


class _RotkCache:
    """``engine.rotk`` view: subscripting generates keys on demand,
    membership checks consult only the existing store."""

    def __init__(self, eng):
        self._eng = eng

    def __getitem__(self, delta: int):
        return self._eng.get_rotation_key(delta)

    def __contains__(self, delta) -> bool:
        return delta in self._eng._rotk_store

    def keys(self):
        return self._eng._rotk_store.keys()

    def __iter__(self):
        return iter(self._eng._rotk_store)

    def __len__(self):
        return len(self._eng._rotk_store)


class CkksEngine:
    """CKKS engine on one device, or on a mesh of them.

    ``device`` is explicit: "cuda" (the default) raises when no GPU is
    present; pass "cpu" to run the plain torch versions.  ``mesh``
    (:func:`parallel.mesh.make_mesh`): keys and fresh ciphertexts are laid
    out over it (:meth:`to_mesh`), every op takes and returns that form and
    gives the single-device engine's bytes; the engine's device is the
    mesh's first.  ``cc_mult``, ``relinearize``, ``create_switcher`` /
    ``switch_key``, the rotations and ``conjugate`` run per shard where the
    rns axis divides the level's channels, ``rescale``, add/sub,
    ``negate``, ``pc_add``, ``pc_mult`` (coefficients whole) and the scalar
    ops per block; every other op on mesh-laid ciphertexts takes the
    gathered route (:func:`_mesh_op`, counted in ``gathered_ops``).  ``seed`` and
    ``nonce`` key the CSPRNG as in the JAX package: an int seed without a
    nonce is fully deterministic; None draws from ``os.urandom``.
    ``allow_sk_gen=False`` refuses to make a secret key (or a rotation key
    that is missing); ``norm`` is the codec's FFT normalization.  Every
    engine registers itself (``typing.register_default_engine``): as the
    default of its logN if it is the first, and under its ``hash``, so the
    typed structures' operators find it.
    """

    def __init__(self, ckks_config=None, device=None, *,
                 allow_sk_gen: bool = True, bias_guard: bool = True,
                 norm: str = "forward", seed=None, nonce=None, mesh=None):
        if mesh is not None:
            if device is not None and not _same_device(device,
                                                       mesh.first_device):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.first_device}")
            device = mesh.first_device
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly for the CPU path"
            )
        if ckks_config is None:
            ckks_config = Preset.logN15
        if isinstance(ckks_config, CkksConfig) or (
            hasattr(ckks_config, "q") and hasattr(ckks_config, "logN")
        ):
            # any duck-typed config carrying a prime chain (toy configs)
            self.ckksCfg = ckks_config
        else:
            self.ckksCfg = CkksConfig.parse(ckks_config)

        self.params = CkksParams(self.ckksCfg, self.device)
        self.montCtx = self.params.montCtx
        self.rnsPart = self.params.rnsPart
        self.rng = self._csprng(seed, nonce)
        self.bias_guard = bias_guard
        self.norm = norm
        self.id = str(uuid.uuid4())
        self.allow_sk_gen = allow_sk_gen
        self.__sk = None
        self.__pk = None
        self.__evk = None
        self.__gk = None
        self.__rotk = {}
        self.__conjk = None
        self._steps = {}    # level -> fused step
        self._consts = {}   # level -> all-parts keyswitch constants
        self._perms = {}    # Galois leap -> (src, sign) on the device
        # the engine mesh: keys and fresh ciphertexts are laid out over it
        # (``_shard``), and the ops take and return that form
        self.mesh = mesh
        self._mesh_cache = {}
        # engine op -> calls that took the gathered route (``_mesh_op``)
        self.gathered_ops = {}
        # the typed structures' operators dispatch through the registry
        register_default_engine(self.ckksCfg.logN, self)
        logger.info(
            "CkksEngine %s ready: logN=%d levels=%d special=%d device=%s "
            "mesh=%s", self.id[:8], self.ckksCfg.logN, self.num_levels,
            self.ckksCfg.num_special_primes, self.device, self.mesh,
        )

    # ------------------------------------------------------------------

    @property
    def num_levels(self) -> int:
        return self.ckksCfg.num_scales

    @property
    def num_slots(self) -> int:
        return self.ckksCfg.N // 2

    @functools.cached_property
    def hash(self) -> str:
        q_str = ",".join(map(str, self.montCtx.q))
        return sha256(f"{self.ckksCfg!r}_{q_str}".encode()).hexdigest()

    def __str__(self):
        return f"{type(self).__name__} ({self.id}) {self.ckksCfg}"

    @property
    def deviations(self):
        return self.params.deviations

    @property
    def corrections(self):
        return self.params.corrections

    @property
    def base_prime(self):
        return self.params.base_prime

    def _meta(self):
        return dict(logN=self.ckksCfg.logN, creator_hash=self.hash)

    def _lp(self, lvl, special=False):
        return self.params.lp(lvl, special)

    def _lp_for(self, ds):
        return self._lp(ds.level, ds.has_flag(FLAGS.INCLUDE_SPECIAL))

    # ------------------------------------------------------------------
    # The engine mesh.
    # ------------------------------------------------------------------

    def _shard(self, x):
        """Lay a [..., C, N] tensor onto the engine mesh (no-op without
        one): channels over 'rns' and coefficients over 'coef' where the
        axis' extent divides the dimension, every other dimension whole."""
        if self.mesh is None or not isinstance(x, torch.Tensor) or x.ndim < 2:
            return x
        return ShardedArray.from_tensor(x, self.mesh,
                                        fitting_spec(x.shape, self.mesh))

    def _as_sharded(self, x):
        return x if isinstance(x, ShardedArray) else self._shard(x)

    def to_mesh(self, obj):
        """A ciphertext's, triplet's or key's tensors (or a tensor, or a
        tuple or list of these) laid out over the engine mesh."""
        if self.mesh is None:
            return obj
        if isinstance(obj, torch.Tensor):
            return self._shard(obj)
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.to_mesh(o) for o in obj)
        if isinstance(obj, DataStruct) and not isinstance(obj, Plaintext):
            return type(obj)(data=self.to_mesh(obj.data), flags=obj._flags,
                             level=obj.level, **obj.misc)
        return obj

    def _block_lp(self, level, special, r0, r1, device):
        """Rows [r0, r1) of a level view on ``device``, cached."""
        key = ("lp", level, special, r0, r1, device)
        if key not in self._mesh_cache:
            self._mesh_cache[key] = self._lp(level, special)[r0:r1].to(device)
        return self._mesh_cache[key]

    def _blockwise(self, fn, arrays, level, special=False):
        """``fn(blk, *blocks)`` per coordinate over ShardedArrays laid out
        as the first; ``blk`` carries the coordinate ``c``, the block's
        ``rows`` and ``cols`` slices, its rows' LevelPack ``lp`` and its
        ``device``."""
        arrays = [self._as_sharded(a) for a in arrays]
        spec = arrays[0].spec
        arrays = [reshard(a, spec) for a in arrays]
        first = arrays[0]
        out = {}
        for c in first.blocks:
            sl = first.slices(c)
            dev = self.mesh.device(c)
            blk = types.SimpleNamespace(
                c=c, rows=sl[-2], cols=sl[-1], device=dev,
                lp=self._block_lp(level, special, sl[-2].start, sl[-2].stop,
                                  dev))
            out[c] = fn(blk, *(a.blocks[c] for a in arrays))
        return ShardedArray(out, self.mesh, spec, first.shape, first.dtype)

    def _mesh_gate(self, level):
        """(rns axis, coef axis) of the sharded keyswitch at ``level``: the
        rns axis None where it does not divide the channels."""
        from tiberate_tpu_torch.parallel import sharded

        return sharded._rns_axis(self, level), sharded._coef_axis(self)

    def _cc_double_mesh(self, core, a, b):
        if a.has_flag(FLAGS.NTT_STATE) or b.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=False)
        a, b = (self.to_mesh(x) for x in self.align_level(a, b))
        return Ciphertext(
            data=tuple(self._blockwise(lambda k, x, y: core(x, y, k.lp),
                                       (x, y), a.level)
                       for x, y in zip(a.data, b.data)),
            level=a.level, **self._meta())

    def _cc_triplet_mesh(self, core, a, b):
        if not (a.has_flag(FLAGS.NTT_STATE) and b.has_flag(FLAGS.NTT_STATE)):
            raise errors.NTTStateError(expected=True)
        a, b = self.to_mesh(a), self.to_mesh(b)
        return CiphertextTriplet(
            data=tuple(self._blockwise(lambda k, x, y: core(x, y, k.lp),
                                       (x, y), a.level)
                       for x, y in zip(a.data, b.data)),
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.NEED_RELINERIZE, level=a.level, **self._meta())

    def _negate_mesh(self, ct):
        special = ct.has_flag(FLAGS.INCLUDE_SPECIAL)
        return Ciphertext(
            data=tuple(self._blockwise(lambda k, x: _negate_core(x, k.lp),
                                       (d,), ct.level, special)
                       for d in ct.data),
            flags=ct._flags, level=ct.level, **self._meta())

    def _mult_mont_scalar_mesh(self, ct, mont_scalar):
        col = self._scalar_col(mont_scalar, ct.level)
        return Ciphertext(
            data=tuple(self._blockwise(
                lambda k, x: _mont_scalar_core(x, col[k.rows].to(k.device),
                                               k.lp), (d,), ct.level)
                for d in ct.data),
            level=ct.level, **self._meta())

    def _add_scalar_mesh(self, ct, scalar):
        col = self._scalar_col(self._add_scalar_values(ct, scalar), ct.level)

        def add(k, x):   # coefficient 0 lies in the first coef block
            if k.cols.start:
                return x
            return _add_scalar_core(x, col[k.rows].to(k.device), k.lp)
        new0 = self._blockwise(add, (ct.data[0],), ct.level)
        return Ciphertext(data=(new0, ct.data[1]), flags=ct._flags,
                          level=ct.level, **self._meta())

    def _pc_add_mesh(self, pt, ct):
        pt_m = self._pt_cached(pt, ct.level, "pc_add")
        new0 = self._blockwise(
            lambda k, x: _pc_add_core(pt_m[k.rows, k.cols].contiguous()
                                      .to(k.device), x, k.lp),
            (ct.data[0],), ct.level)
        return Ciphertext(data=(new0, ct.data[1]), flags=ct._flags,
                          level=ct.level, **self._meta())

    def _pc_mult_mesh(self, pt, ct, post_rescale=True):
        """Per block where the coefficients are whole (the transforms are
        row-local); NotImplemented on a coef-sharded ciphertext."""
        d0, d1 = (self._as_sharded(d) for d in ct.data)
        if d0.spec[-1] is not None:
            return NotImplemented
        pt_ntt = self._pt_cached(pt, ct.level, "pc_mult")
        both = self._blockwise(
            lambda k, x, y: torch.stack(_pc_mult_core(
                pt_ntt[k.rows].to(k.device), x, y, k.lp)),
            (d0, d1), ct.level)
        data = tuple(
            ShardedArray({c: v[i] for c, v in both.blocks.items()},
                         self.mesh, both.spec, both.shape, both.dtype)
            for i in range(2))
        new_ct = Ciphertext(data=data, level=ct.level, **self._meta())
        return self.rescale(new_ct) if post_rescale else new_ct

    def _rescale_mesh(self, ct, exact_rounding=True):
        from tiberate_tpu_torch.parallel import sharded

        level = ct.level
        if level + 1 >= self.num_levels:
            raise errors.MaximumLevelError(level=level,
                                           level_max=self.num_levels)
        data = []
        for d in ct.data:
            d = self._as_sharded(d)
            shape = d.shape[:-2] + (d.shape[-2] - 1, d.shape[-1])
            spec = d.spec[:-2] + fitting_spec(shape, self.mesh)[-2:]
            data.append(sharded.rescale_sharded(self, d, level, spec,
                                                exact_rounding))
        return Ciphertext(data=tuple(data), level=level + 1, **self._meta())

    def _cc_mult_mesh(self, a, b, evk=None, *, pre_rescale=True,
                      post_relin=True):
        """The fused step per shard, where its gate allows."""
        from tiberate_tpu_torch.parallel import sharded

        if not (pre_rescale and post_relin
                and (evk is None or evk is self.evk)):
            return NotImplemented
        a, b = self.align_level(a, b)
        if a.level + 1 >= self.num_levels:
            raise errors.MaximumLevelError(level=a.level,
                                           level_max=self.num_levels)
        if self._mesh_gate(a.level + 1)[0] is None:
            return NotImplemented
        step = self._fused_mult_step(a.level, True)
        ct0, ct1 = step(a.data[0], a.data[1], b.data[0], b.data[1],
                        sharded.prepare_step_ksk(self, a.level),
                        sharded.mult_step_params(self, a.level))
        return Ciphertext(data=(ct0, ct1), level=a.level + 1, **self._meta())

    def _relinearize_mesh(self, ct_triplet, evk=None):
        from tiberate_tpu_torch.parallel import sharded

        evk = evk or self.evk
        _check_ntt_mont_state(ct_triplet)
        level = ct_triplet.level
        axis, caxis = self._mesh_gate(level)
        if axis is None:
            return NotImplemented
        ct0, ct1 = sharded.relin_sharded(
            self, *(self._as_sharded(d) for d in ct_triplet.data), level,
            sharded.rns_ksk(self, evk, level), axis, caxis)
        return Ciphertext(data=(ct0, ct1), level=level, **self._meta())

    def _create_switcher_mesh(self, a, ksk, level, exit_ntt=False):
        from tiberate_tpu_torch.parallel import sharded

        axis, caxis = self._mesh_gate(level)
        if axis is None:
            return NotImplemented
        a = self._as_sharded(a)
        a = reshard(a, a.spec[:-2] + (axis, caxis))
        if exit_ntt:
            a = ShardedArray(
                sharded.intt_sharded(self, [a], level, axis, caxis)[0],
                self.mesh, a.spec, a.shape, a.dtype)
        sw = sharded._rns_switcher(self, level, axis, caxis)
        return sw(a, sharded.rns_ksk(self, ksk, level))

    def _switch_key_mesh(self, ct, ksk):
        level = ct.level
        d1 = self._as_sharded(ct.data[1])
        out = self._create_switcher_mesh(d1, ksk, level,
                                         ct.has_flag(FLAGS.NTT_STATE))
        if out is NotImplemented:
            return NotImplemented
        c0, c1 = out
        new0 = self._blockwise(
            lambda k, x, y: mont.reduce_2q(mont.mont_add(x, y, k.lp.pack),
                                           k.lp.pack),
            (c0, ct.data[0]), level)
        return Ciphertext(data=(new0, c1), flags=ct._flags, level=level,
                          **self._meta())

    def _permute_mesh(self, ct, leap):
        """The Galois permutation per block: row-local where the
        coefficients are whole, else after one all_gather over 'coef'."""
        special = ct.has_flag(FLAGS.INCLUDE_SPECIAL)
        data = []
        for d in ct.data:
            d = self._as_sharded(d)
            full = (d.blocks if d.spec[-1] is None else
                    all_gather(d.blocks, self.mesh, d.spec[-1], dim=-1))

            def perm(k, x, full=full):
                src, sign = self._perm_tables_on(leap, k.device)
                return _rotate_data_core(full[k.c], src[k.cols],
                                         sign[k.cols], k.lp)
            data.append(self._blockwise(perm, (d,), ct.level, special))
        return Ciphertext(data=tuple(data), flags=ct._flags, level=ct.level,
                          **self._meta())

    def _perm_tables_on(self, leap, device):
        key = ("perm", leap, device)
        if key not in self._mesh_cache:
            self._mesh_cache[key] = tuple(
                t.to(device) for t in self._perm_tables(leap))
        return self._mesh_cache[key]

    def _rotate_single_mesh(self, ct, rotk, post_key_switching=True):
        rotated = self._permute_mesh(
            ct, codec.rotate_leap(rotk.delta, self.params.N))
        if post_key_switching:
            rotated = self.switch_key(rotated, rotk)
        return rotated

    def _conjugate_mesh(self, ct, conjk=None):
        conj = self._permute_mesh(ct, codec.conjugate_leap(self.params.N))
        return self.switch_key(conj, conjk or self.conjk)

    def _to_dev(self, x):
        """Host draws and codec output -> the device, in the storage dtype
        (int32 in the 30-bit mode, where every value is below 2^28)."""
        return torch.as_tensor(x).to(self.device, self.params.dtype)

    @property
    def _rounding_half(self):
        # decrypt rounding prime: q list index [-S-2]
        return self.params.q[-self.ckksCfg.num_special_primes - 2] // 2

    # ------------------------------------------------------------------
    # Keys (setting sk drops the keys derived from it).
    # ------------------------------------------------------------------

    @property
    def sk(self) -> SecretKey:
        if self.__sk is None:
            if not self.allow_sk_gen:
                raise RuntimeError("Secret key generation is disabled.")
            self.sk = self._create_secret_key()
        return self.__sk

    @sk.setter
    def sk(self, sk: SecretKey):
        self.__pk = None
        self.__evk = None
        self.__gk = None
        self.__rotk = {}
        self.__conjk = None
        self.__sk = sk

    @property
    def pk(self) -> PublicKey:
        if self.__pk is None:
            self.__pk = self._create_public_key(self.sk)
        return self.__pk

    @pk.setter
    def pk(self, pk: PublicKey):
        self.__pk = pk

    @property
    def evk(self) -> EvaluationKey:
        if self.__evk is None:
            self.__evk = self._create_evk(self.sk)
        return self.__evk

    @evk.setter
    def evk(self, evk: EvaluationKey):
        self.__evk = evk

    @property
    def gk(self) -> GaloisKey:
        if self.__gk is None:
            self.__gk = self._create_galois_key(self.sk)
        return self.__gk

    @gk.setter
    def gk(self, gk: GaloisKey):
        self.__gk = gk

    @property
    def rotk(self) -> _RotkCache:
        """Rotation-key cache; ``engine.rotk[delta]`` generates on first
        access."""
        return _RotkCache(self)

    @rotk.setter
    def rotk(self, rotk):
        self.__rotk = dict(rotk)

    @property
    def _rotk_store(self) -> dict:
        return self.__rotk

    def get_rotation_key(self, delta: int) -> RotationKey:
        """The rotation key for ``delta``, made on first use."""
        if delta not in self.__rotk:
            if not self.allow_sk_gen:
                raise RuntimeError(
                    f"No rotation key for delta={delta} and key generation "
                    f"is disabled."
                )
            self.__rotk[delta] = self._create_rotation_key(delta, sk=self.sk)
        return self.__rotk[delta]

    @property
    def conjk(self) -> ConjugationKey:
        if self.__conjk is None:
            self.__conjk = self.create_conjugation_key(self.sk)
        return self.__conjk

    def _csprng(self, seed, nonce):
        """The engine's channel model: P channels, max(S, 2) repeating
        ones, on the engine's device."""
        return Csprng(
            num_coefs=self.ckksCfg.N,
            num_channels=[self.params.P],
            num_repeating_channels=max(self.ckksCfg.num_special_primes, 2),
            sigma=self.ckksCfg.sigma,
            seed=seed,
            nonce=nonce,
            device=self.device,
        )

    def _create_secret_key(self) -> SecretKey:
        lp = self._lp(0, True)
        ternary = self.rng.randint(amax=3, shift=-1, repeats=1)[0]
        return SecretKey(
            data=self._shard(_keygen_sk_core(self._to_dev(ternary), lp)),
            flags=FLAGS.INCLUDE_SPECIAL | FLAGS.MONTGOMERY_STATE
            | FLAGS.NTT_STATE,
            level=0,
            **self._meta(),
        )

    def _a_moduli(self, include_special: bool):
        """(moduli, repeats) of a uniform ``a``: the special primes come
        from the repeating channels."""
        if include_special:
            return self.params.q, self.ckksCfg.num_special_primes
        return self.params.q[: self.params.P], 0

    def _create_public_key(self, sk: SecretKey = None, *,
                           include_special: bool = False, a=None
                           ) -> PublicKey:
        """pk = (e - a*s, a), optionally under a given uniform ``a``."""
        sk = sk or self.sk
        if include_special and not sk.has_flag(FLAGS.INCLUDE_SPECIAL):
            raise errors.SecretKeyNotIncludeSpecialPrime()
        lp = self._lp(0, include_special)
        C = lp.num_channels
        e = self.rng.discrete_gaussian(repeats=1)[0]
        if a is None:
            amax = self._a_moduli(include_special)[0]
            repeats = (self.ckksCfg.num_special_primes
                       if sk.has_flag(FLAGS.INCLUDE_SPECIAL) else 0)
            a = self.rng.randint(amax=amax, repeats=repeats)
        a = self._to_dev(a)
        pk0 = _keygen_pk_core(self._to_dev(e), a, _t(sk.data)[:C], lp)
        return PublicKey(
            data=(self._shard(pk0), self._shard(a)),
            flags=(FLAGS.INCLUDE_SPECIAL if include_special else FLAGS(0))
            | FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE,
            level=0,
            **self._meta(),
        )

    def create_key_switching_key(self, sk_from: SecretKey, sk_to: SecretKey,
                                 a=None, a_seed=None) -> KeySwitchKey:
        """Per-part P-scaled source-key shards folded into fresh public
        keys under ``sk_to``; ``a`` optionally gives each part's uniform
        polynomial ([P+S, N] each).

        ``a_seed``: draw those polynomials from a CSPRNG keyed by this
        seed (:meth:`_seed_rng`): the key is then seed-expandable —
        :meth:`compress_ksk` drops the ``a`` halves and :meth:`expand_ksk`
        regenerates them."""
        for key in (sk_from, sk_to):
            _check_ntt_mont_state(key)
        if a_seed is not None:
            if a is not None:
                raise ValueError("pass either a or a_seed")
            a = self._expand_ksk_a(a_seed)
        P = self.params.P
        lp_ord = self._lp(0, False)
        Psk = mont.mont_mult(_t(sk_from.data)[:P], self.params.mont_PR,
                             lp_ord.pack)
        ksk_parts = []
        for part_id, part in enumerate(self.params.parts[0]):
            crs = a[part_id] if a is not None else None
            pk = self._create_public_key(sk_to, include_special=True, a=crs)
            pk0, pk1 = pk.data
            part_pack = self.params.pack[part.g0 : part.g0 + part.alpha]
            pk0 = _ksk_shard_core(_t(pk0), Psk[part.lo : part.hi], part.g0,
                                  part.alpha, part_pack)
            ksk_parts.append((self._shard(pk0), pk1))
        return KeySwitchKey(
            data=tuple(ksk_parts),
            flags=FLAGS.INCLUDE_SPECIAL | FLAGS.MONTGOMERY_STATE
            | FLAGS.NTT_STATE,
            level=0,
            a_seed=a_seed,
            **self._meta(),
        )

    def _seed_rng(self, a_seed: int):
        """A fresh CSPRNG with the engine's channel model, keyed by
        ``a_seed`` (nonce 0x5EED)."""
        return self._csprng(a_seed, 0x5EED)

    def _expand_ksk_a(self, a_seed: int):
        """Deterministic per-part uniform ``a`` polynomials from a seed."""
        rng = self._seed_rng(a_seed)
        amax, repeats = self._a_moduli(True)
        return [rng.randint(amax=amax, repeats=repeats)
                for _ in self.params.parts[0]]

    def create_public_key(self, sk: SecretKey = None, *,
                          include_special: bool = False, a_seed=None
                          ) -> PublicKey:
        """Public keygen with an optional seed-expandable ``a`` (see
        :meth:`create_key_switching_key`); :meth:`compress_pk` /
        :meth:`expand_pk` halve the stored bytes."""
        a = None
        if a_seed is not None:
            amax, repeats = self._a_moduli(include_special)
            a = self._seed_rng(a_seed).randint(amax=amax, repeats=repeats)
        pk = self._create_public_key(sk, include_special=include_special,
                                     a=a)
        pk.misc["a_seed"] = a_seed
        pk.misc["include_special"] = bool(include_special)
        return pk

    @staticmethod
    def _compressed_misc(key):
        if key.misc.get("a_seed") is None:
            raise ValueError("only keys created with a_seed= are "
                             "compressible")
        # the key-form caches (_parts_tables, _rns_ksk) hold the a halves
        misc = {k: v for k, v in key.misc.items() if not k.startswith("_")}
        return dict(misc, compressed=True)

    @staticmethod
    def _expanded_misc(key):
        misc = dict(key.misc)
        misc.pop("compressed", None)
        return misc

    def compress_pk(self, pk: PublicKey) -> PublicKey:
        """Drop the regenerable ``a`` half of a seed-expanded public key."""
        return PublicKey(data=(pk.data[0],), flags=pk._flags, level=pk.level,
                         **self._compressed_misc(pk))

    def expand_pk(self, cpk: PublicKey) -> PublicKey:
        """Regenerate a compressed public key's ``a`` from its seed."""
        if not cpk.misc.get("compressed"):
            return cpk
        amax, repeats = self._a_moduli(bool(cpk.misc.get("include_special")))
        a = self._seed_rng(cpk.misc["a_seed"]).randint(amax=amax,
                                                       repeats=repeats)
        return PublicKey(data=(cpk.data[0], self._shard(self._to_dev(a))),
                         flags=cpk._flags, level=cpk.level,
                         **self._expanded_misc(cpk))

    def compress_ksk(self, ksk: KeySwitchKey) -> KeySwitchKey:
        """Drop the regenerable ``a`` halves of a seed-expanded key-switching
        key: half the bytes; :meth:`expand_ksk` restores it."""
        return KeySwitchKey(data=tuple(k0 for k0, _ in ksk.data),
                            flags=ksk._flags, level=ksk.level,
                            **self._compressed_misc(ksk))

    def expand_ksk(self, cksk: KeySwitchKey) -> KeySwitchKey:
        """Regenerate a compressed key's ``a`` halves from its seed."""
        if not cksk.misc.get("compressed"):
            return cksk
        a_list = self._expand_ksk_a(cksk.misc["a_seed"])
        return KeySwitchKey(
            data=tuple((k0, self._shard(self._to_dev(a)))
                       for k0, a in zip(cksk.data, a_list)),
            flags=cksk._flags, level=cksk.level,
            **self._expanded_misc(cksk))

    def _create_evk(self, sk: SecretKey = None) -> EvaluationKey:
        sk = sk or self.sk
        lp = self._lp(0, True)
        sk2 = SecretKey(
            data=mont.mont_mult(_t(sk.data), _t(sk.data), lp.pack),
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )
        return EvaluationKey.wrap(self.create_key_switching_key(sk2, sk))

    def _parts_consts(self, level: int):
        if level not in self._consts:
            self._consts[level] = _parts_consts(self.params, level)
        return self._consts[level]

    @staticmethod
    def _key_cache(ksk: KeySwitchKey, name: str) -> dict:
        cache = ksk.misc.get(name)
        if cache is None:
            cache = ksk.misc[name] = {}
        return cache

    def _ksk_parts_fused(self, ksk: KeySwitchKey, level: int):
        """The key form every single-device keyswitch reads at ``level``:
        (keys, tables, ec, alphas) for ``ntt_keymul_parts``.  ``keys``
        holds each live part's (k0, k1) evk rows ``[level:]`` ([C_sp, N]
        views into the key, no copy), in ``parts_alloc`` order; ``tables``
        their pointer tables (``ntt_kernels.key_tables``; cached on the key
        beside the views they point into); then :meth:`_parts_consts`."""
        cache = self._key_cache(ksk, "_parts_tables")
        if level not in cache:
            keys = tuple(
                tuple(_t(k)[level:] for k in ksk.data[g])
                for g in self.params.parts_alloc[level]
            )
            cache[level] = (keys, kern.key_tables(keys))
        return (*cache[level], *self._parts_consts(level))

    # ------------------------------------------------------------------
    # Encode / decode (host codec).
    # ------------------------------------------------------------------

    def encode(self, m, level: int = 0, padding=True, scale=None):
        """Message -> signed integer coefficients [N] (numpy int64), at
        ``scale`` (default: the configuration's)."""
        if padding:
            m = codec.padding(m, num_slots=self.num_slots)
        return codec.encode(
            m, scale=scale or self.ckksCfg.scale, rng=self.rng,
            deviation=self.params.deviations[level], norm=self.norm,
        )

    def decode(self, m, level=0, is_real: bool = False):
        """Signed coefficients [N] (or [1, N]) -> message slots."""
        m = np.asarray(torch.as_tensor(m).cpu()).reshape(-1)
        decoded = codec.decode(
            m, scale=self.ckksCfg.scale,
            correction=self.params.corrections[level], norm=self.norm,
        )[: self.num_slots]
        return decoded.real if is_real else decoded

    # ------------------------------------------------------------------
    # Encrypt / decrypt.
    # ------------------------------------------------------------------

    def _encrypt(self, pt, dc_rns, e0, e1, v, pk, level):
        """pt, e0, e1, v: [..., N]; dc_rns: [..., C] -> Ciphertext with
        data [..., C, N]."""
        include_special = pk.has_flag(FLAGS.INCLUDE_SPECIAL)
        lp = self._lp(level, include_special)
        C = lp.num_channels
        ct0, ct1 = _encrypt_core(
            *map(self._to_dev, (pt, dc_rns, e0, e1, v)),
            _t(pk.data[0])[level : level + C],
            _t(pk.data[1])[level : level + C], lp,
        )
        return Ciphertext(
            data=(ct0, ct1),
            flags=FLAGS.INCLUDE_SPECIAL if include_special else FLAGS(0),
            level=level,
            **self._meta(),
        )

    def _channels(self, pk, level):
        return self._lp(level, pk.has_flag(FLAGS.INCLUDE_SPECIAL)
                        ).num_channels

    def encrypt(self, pt, pk: PublicKey = None, *, level: int = 0
                ) -> Ciphertext:
        """Encrypt encoded coefficients pt ([N] integers)."""
        pk = pk or self.pk
        dc_rns = np.zeros(self._channels(pk, level),
                          dtype=self.ckksCfg.numpy_dtype)
        e, v = self.rng.encrypt_noise_batch(1)
        return self.to_mesh(
            self._encrypt(pt, dc_rns, e[0, 0], e[0, 1], v[0], pk, level))

    def _dc_residues(self, dc_integral, level, C):
        """Bias guard: the DC integral parts [...] times the scale, as
        residues [..., C] of the level's primes."""
        scale = int(self.ckksCfg.scale)
        return np.array(
            [[int(d) * scale % self.params.q[i] for i in range(level,
                                                               level + C)]
             for d in np.reshape(dc_integral, -1)],
            dtype=self.ckksCfg.numpy_dtype,
        ).reshape(*np.shape(dc_integral), C)

    def encodecrypt(self, m, pk: PublicKey = None, *, level: int = 0,
                    padding=True) -> Ciphertext:
        """:meth:`encodecrypt_batch` of one message."""
        return self.encodecrypt_batch([m], pk, level=level,
                                      padding=padding)[0]

    def encodecrypt_batch(self, ms, pk: PublicKey = None, *,
                          level: int = 0, padding=True) -> list:
        """Encrypt a batch of messages: one vectorized encode (one host FFT,
        one ``randround_batch``), one ``encrypt_noise_batch`` and one
        encrypt core on [B, C, N] (one launch of each kernel).  The
        ciphertexts are the bytes of sequential :meth:`encodecrypt` calls,
        with the bias guard on or off.  Traced as the span
        ``encodecrypt_batch``, with the children ``encode`` (the host FFT
        and the random rounding), ``draw`` (the noise) and ``encrypt``."""
        with trace.annotate("encodecrypt_batch"):
            pk = pk or self.pk
            with trace.annotate("encode"):
                if padding:
                    ms = [codec.padding(m, num_slots=self.num_slots)
                          for m in ms]
                ms = np.stack([np.asarray(m) for m in ms])
                deviation = self.params.deviations[level]
                C = self._channels(pk, level)
                B = ms.shape[0]
                scale = self.ckksCfg.scale
                dc_rns = np.zeros((B, C), dtype=self.ckksCfg.numpy_dtype)
                if self.bias_guard:
                    pts = codec.encode_batch(
                        ms, scale=scale, deviation=deviation, rng=self.rng,
                        norm=self.norm, return_without_scaling=True,
                    ).copy()
                    dc_integral = np.floor(pts[:, 0])
                    pts[:, 0] -= dc_integral
                    dc_rns = self._dc_residues(dc_integral, level, C)
                    pts = self.rng.randround_batch(pts * np.float64(scale))
                else:
                    pts = codec.encode_batch(ms, scale=scale,
                                             deviation=deviation,
                                             rng=self.rng, norm=self.norm)
            with trace.annotate("draw"):
                e, v = self.rng.encrypt_noise_batch(B)
            with trace.annotate("encrypt"):
                ct = self._encrypt(pts, dc_rns, e[:, 0], e[:, 1], v, pk,
                                   level)
                return [Ciphertext(data=(self._shard(d0), self._shard(d1)),
                                   flags=ct._flags, level=level,
                                   **self._meta())
                        for d0, d1 in zip(*ct.data)]

    def _decrypt_args(self, level):
        C = self._lp(level, False).num_channels
        return (self._lp(level, False), self.params.base_lp(),
                self.params.final_scalar[level], self._rounding_half, C - 1)

    @_mesh_op(local_out=True)
    def decrypt_double(self, ct: Ciphertext, sk: SecretKey = None, *,
                       final_round=True):
        """-> signed scaled coefficients [1, N]."""
        sk = sk or self.sk
        _check_plain_state(ct)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        lp, base_lp, fs, rh, base_at = self._decrypt_args(ct.level)
        C = base_at + 1
        scaled, _ = _decrypt_double_core(
            ct.data[0][..., :C, :], ct.data[1][..., :C, :],
            _t(sk.data)[ct.level : ct.level + C], lp, base_lp, fs, rh,
            base_at, final_round=final_round,
        )
        return scaled

    @_mesh_op(local_out=True)
    def decrypt_triplet(self, ct_mult: CiphertextTriplet,
                        sk: SecretKey = None, *, final_round=True):
        """-> signed scaled coefficients [1, N] of d0 + d1 s + d2 s^2."""
        sk = sk or self.sk
        _check_ntt_mont_state(ct_mult)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        level = ct_mult.level
        lp, base_lp, fs, rh, base_at = self._decrypt_args(level)
        C = base_at + 1
        scaled, _ = _decrypt_triplet_core(
            *ct_mult.data, _t(sk.data)[level : level + C], lp, base_lp, fs,
            rh,
            base_at, final_round=final_round,
        )
        return scaled

    def decrypt(self, ct, sk: SecretKey = None, *, final_round=True):
        """:meth:`decrypt_triplet` or :meth:`decrypt_double` by kind."""
        if isinstance(ct, CiphertextTriplet):
            return self.decrypt_triplet(ct, sk, final_round=final_round)
        return self.decrypt_double(ct, sk, final_round=final_round)

    def _dc_crt(self, residues, level, base_at):
        """Bias guard: the exact DC values from their residues [..., 3]
        mod (q[level + base_at], q[level], q[level + 1]) by CRT, divided
        by q[level] rounding up; a list of python ints."""
        q = self.params.q
        q0, q1, q2 = q[level + base_at], q[level], q[level + 1]
        Q = q0 * q1 * q2
        m0 = pow(q1 * q2, -1, q0) * q1 * q2
        m1 = pow(q0 * q2, -1, q1) * q0 * q2
        m2 = pow(q0 * q1, -1, q2) * q0 * q1
        dcs = []
        for r0, r1, r2 in np.asarray(residues.cpu()).reshape(-1, 3).tolist():
            dc = (r0 * m0 + r1 * m1 + r2 * m2) % Q
            dc = dc if dc <= Q // 2 else dc - Q
            dcs.append((dc + (q1 - 1)) // q1)
        return dcs

    def _decrypt_scaled(self, core, sk, level, final_round):
        """The decrypt epilogue of :meth:`decryptcode` and
        :meth:`decryptcode_batch` over leading dims [..., C, N]: ``core``
        (a decrypt core with its ciphertext bound) -> (scaled [..., 1, N],
        the exact DC values as a list of python ints, or None).  With the
        bias guard (and >= 3 channels left) the DC slots are zeroed before
        the final scale and recovered by a 3-prime CRT; only their three
        residues leave the device."""
        lp, base_lp, fs, rh, base_at = self._decrypt_args(level)
        C = base_at + 1
        args = (_t(sk.data)[level : level + C], lp, base_lp, fs, rh, base_at)
        if not (C >= 3 and self.bias_guard):
            scaled, _ = core(*args, final_round=final_round)
            return scaled, None
        _, pt = core(*args, final_round=False)
        dcs = self._dc_crt(pt[..., [base_at, 0, 1], 0], level, base_at)
        pt_z = pt.clone()
        pt_z[..., base_at, 0] = 0
        pt_z[..., 0, 0] = 0
        return _final_scale(pt_z, base_lp, fs, rh, base_at,
                            final_round=final_round), dcs

    @_mesh_op(local_out=True)
    def decryptcode(self, ct, sk: SecretKey = None, *, is_real=False,
                    final_round=True):
        """Decrypt and decode one ciphertext or triplet; with bias_guard
        (and >= 3 channels left) the DC slot is recovered exactly by a
        3-prime CRT."""
        sk = sk or self.sk
        _check_ntt_mont_state(sk)
        level = ct.level
        C = self._lp(level, False).num_channels
        if isinstance(ct, CiphertextTriplet):
            _check_ntt_mont_state(ct)
            core = functools.partial(_decrypt_triplet_core, *ct.data)
        else:
            _check_plain_state(ct)
            core = functools.partial(_decrypt_double_core,
                                     ct.data[0][..., :C, :],
                                     ct.data[1][..., :C, :])
        scaled, dcs = self._decrypt_scaled(core, sk, level, final_round)

        correction = self.params.corrections[level]
        decoded = codec.decode(
            np.asarray(scaled.cpu()).reshape(-1),
            scale=self.ckksCfg.scale, correction=correction, norm=self.norm,
            return_without_scaling=True,
        )[: self.num_slots]
        decoded = decoded / self.ckksCfg.scale * correction
        if dcs is not None:
            decoded = decoded + dcs[0] / self.ckksCfg.scale * correction
        return decoded.real if is_real else decoded

    @_mesh_op(local_out=True)
    def decryptcode_batch(self, cts, sk: SecretKey = None, *,
                          is_real=False, final_round=True):
        """Decrypt and decode same-level ciphertexts with one decrypt core
        on [B, C, N] and one vectorized decode; per message the result is
        :meth:`decryptcode`'s up to the decode's float summation order.
        Returns [B, slots].  Traced as the span ``decryptcode_batch``, with
        the children ``decrypt`` and ``decode`` (the copy to the host and
        the host decode)."""
        sk = sk or self.sk
        _check_ntt_mont_state(sk)
        level = cts[0].level
        if any(ct.level != level for ct in cts):
            raise errors.NotMatchType(origin="mixed ciphertext levels",
                                      to="decryptcode_batch")
        for ct in cts:
            _check_plain_state(ct)
        with trace.annotate("decryptcode_batch"):
            with trace.annotate("decrypt"):
                C = self._lp(level, False).num_channels
                core = functools.partial(
                    _decrypt_double_core,
                    torch.stack([ct.data[0][:C] for ct in cts]),
                    torch.stack([ct.data[1][:C] for ct in cts]),
                )
                scaled, dcs = self._decrypt_scaled(core, sk, level,
                                                   final_round)
            with trace.annotate("decode"):
                correction = self.params.corrections[level]
                decoded = codec.decode_batch(
                    np.asarray(scaled.cpu()).reshape(len(cts), -1),
                    scale=self.ckksCfg.scale, correction=correction,
                    norm=self.norm,
                )[:, : self.num_slots]
                if dcs is not None:
                    decoded = decoded + (
                        np.asarray(dcs, dtype=np.float64)[:, None]
                        / self.ckksCfg.scale * correction
                    )
        return decoded.real if is_real else decoded

    # ------------------------------------------------------------------
    # Rescale / multiply.
    # ------------------------------------------------------------------

    @_mesh_op("_rescale_mesh")
    def rescale(self, ct: Ciphertext, exact_rounding=True) -> Ciphertext:
        """Drop the top RNS channel of both polynomials (rounding exactly
        unless ``exact_rounding`` is False)."""
        level = ct.level
        if level + 1 >= self.num_levels:
            raise errors.MaximumLevelError(level=level,
                                           level_max=self.num_levels)
        lp_next = self._lp(level + 1, False)
        round_at = self.params.q[level] // 2
        data = tuple(
            _rescale_core(d, self.params.rescale_scales[level], lp_next,
                          round_at, exact_rounding)
            for d in ct.data
        )
        return Ciphertext(data=data, level=level + 1, **self._meta())

    def _fused_mult_step(self, level: int, rns_shard: bool = False):
        """The fused step function at ``level``, built once per route
        (``rns_shard``: the engine mesh's sharded step)."""
        if (level, rns_shard) not in self._steps:
            from tiberate_tpu_torch.parallel import sharded

            self._steps[level, rns_shard] = sharded.make_mult_step(
                self, level, rns_shard=rns_shard)
        return self._steps[level, rns_shard]

    @_mesh_op("_cc_mult_mesh")
    def cc_mult(self, a: Ciphertext, b: Ciphertext,
                evk: EvaluationKey = None, *, pre_rescale=True,
                post_relin=True):
        """The operands are first brought to one level (:meth:`align_level`);
        one unstacked operand against a stack is repeated along the
        stack's leading dims (a copy).
        With both flags and the engine's evk: rescale -> tensor product ->
        relinearize through the fused step
        (``parallel/sharded.make_mult_step``).  Otherwise (optionally)
        :meth:`rescale`, the tensor product (K5) into a
        :class:`CiphertextTriplet`, and (optionally) :meth:`relinearize`.
        Leading batch dimensions of the data are carried.  Traced as the
        span ``cc_mult``; the fused route's host work before the step is
        its child ``cc_mult.prepare``."""
        fused = pre_rescale and post_relin and (evk is None
                                                or evk is self.evk)
        with trace.annotate("cc_mult"):
            with trace.annotate("cc_mult.prepare"):
                a, b = _broadcast_pair(*self.align_level(a, b))
                if fused:
                    if a.level + 1 >= self.num_levels:
                        raise errors.MaximumLevelError(
                            level=a.level, level_max=self.num_levels)
                    from tiberate_tpu_torch.parallel import sharded

                    evk = self.evk
                    step = self._fused_mult_step(a.level)
                    ksk = sharded.prepare_step_ksk(self, a.level, ksk=evk,
                                                   rns_shard=False)
                    prm = sharded.mult_step_params(self, a.level,
                                                   rns_shard=False)
            if fused:
                ct0, ct1 = step(a.data[0], a.data[1], b.data[0], b.data[1],
                                ksk, prm)
                return Ciphertext(data=(ct0, ct1), level=a.level + 1,
                                  **self._meta())
            x, y = ((self.rescale(a), self.rescale(b)) if pre_rescale
                    else (a, b))
            level = x.level
            d = _ccmult_tensor_core(x.data[0], x.data[1], y.data[0],
                                    y.data[1], self._lp(level, False))
            ct_mult = CiphertextTriplet(
                data=d,
                flags=FLAGS.NTT_STATE | FLAGS.MONTGOMERY_STATE
                | FLAGS.NEED_RELINERIZE,
                level=level,
                **self._meta(),
            )
            if post_relin:
                ct_mult = self.relinearize(ct_mult, evk or self.evk)
            return ct_mult

    def square(self, ct: Ciphertext, evk: EvaluationKey = None, *,
               pre_rescale=True, post_relin=True):
        """ct^2 (:meth:`cc_mult` of ``ct`` with itself)."""
        return self.cc_mult(ct, ct, evk, pre_rescale=pre_rescale,
                            post_relin=post_relin)

    @_mesh_op("_relinearize_mesh")
    def relinearize(self, ct_triplet: CiphertextTriplet,
                    evk: EvaluationKey = None) -> Ciphertext:
        """Triplet (NTT and Montgomery state) -> ciphertext: the keyswitch
        of d2, all parts in one kernel."""
        evk = evk or self.evk
        _check_ntt_mont_state(ct_triplet)
        level = ct_triplet.level
        ct0, ct1 = _relin_core(
            *ct_triplet.data, self._ksk_parts_fused(evk, level),
            tuple(self.params.parts[level]), self._lp(level, True),
            self._lp(level, False), tuple(self.params.PiRs[level]),
            self.ckksCfg.num_special_primes,
        )
        return Ciphertext(data=(ct0, ct1), level=level, **self._meta())

    # ------------------------------------------------------------------
    # Key switching.
    # ------------------------------------------------------------------

    @_mesh_op("_create_switcher_mesh")
    def create_switcher(self, a, ksk: KeySwitchKey, level: int,
                        exit_ntt: bool = False):
        """Key-switch ``a`` [..., C, N] at ``level``: (c0, c1) with
        c0 + c1 s_to = a s_from (approximately)."""
        return _switcher_body(
            a, self._ksk_parts_fused(ksk, level),
            tuple(self.params.parts[level]), self._lp(level, True),
            self._lp(level, False), tuple(self.params.PiRs[level]),
            self.ckksCfg.num_special_primes, exit_ntt,
        )

    @_mesh_op("_switch_key_mesh")
    def switch_key(self, ct: Ciphertext, ksk: KeySwitchKey) -> Ciphertext:
        """Re-encrypt ``ct`` from ``ksk``'s source key to its target key
        (``create_key_switching_key(sk_from, sk_to)``).  Traced as the
        span ``switch_key``."""
        level = ct.level
        with trace.annotate("switch_key"):
            new0, new1 = _switch_key_core(
                ct.data[0], ct.data[1], self._ksk_parts_fused(ksk, level),
                tuple(self.params.parts[level]), self._lp(level, True),
                self._lp(level, False), tuple(self.params.PiRs[level]),
                self.ckksCfg.num_special_primes,
                ct.has_flag(FLAGS.NTT_STATE),
            )
        return Ciphertext(data=(new0, new1), flags=ct._flags, level=level,
                          **self._meta())

    # ------------------------------------------------------------------
    # Rotations / conjugation.
    # ------------------------------------------------------------------

    def _perm_tables(self, leap: int):
        """(src, sign) of a Galois permutation on the engine's device:
        int64 gather indices and the signs in the storage dtype; built once
        per leap."""
        if leap not in self._perms:
            src, sign = codec.rotation_perm_tables(self.params.N, leap)
            self._perms[leap] = (
                torch.from_numpy(src.astype(np.int64)).to(self.device),
                self._to_dev(sign),
            )
        return self._perms[leap]

    def _galois_secret_key(self, sk: SecretKey, leap: int) -> SecretKey:
        """The secret key under a Galois permutation: its ordinary rows
        leave the NTT domain keeping R (K2 "mont"), are permuted with their
        signs, and return by K1 without entry on the signed words; the
        special rows stay (key-switching keys read only the ordinary
        ones)."""
        P = self.params.P
        lp = self._lp(0, False)
        sk_ord = _intt_exit_to_mont(_t(sk.data)[:P], lp)
        perm = _perm_core(sk_ord, *self._perm_tables(leap))
        full = _t(sk.data).clone()
        full[:P] = _ntt_plain(perm, lp)
        return SecretKey(
            data=full,
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )

    def _create_rotation_key(self, delta: int, a=None, sk: SecretKey = None
                             ) -> RotationKey:
        sk = sk or self.sk
        sk_rot = self._galois_secret_key(
            sk, codec.rotate_leap(delta, self.params.N))
        return RotationKey.wrap(
            self.create_key_switching_key(sk_rot, sk, a=a), delta=delta
        )

    def _create_galois_key(self, sk: SecretKey = None) -> GaloisKey:
        """Rotation keys for the deltas 1, 2, ..., 2^(logN-2)."""
        sk = sk or self.sk
        deltas = [2**i for i in range(self.ckksCfg.logN - 1)]
        return GaloisKey(
            data=[self._create_rotation_key(d, sk=sk) for d in deltas],
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )

    def create_conjugation_key(self, sk: SecretKey = None
                               ) -> ConjugationKey:
        sk = sk or self.sk
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        sk_conj = self._galois_secret_key(
            sk, codec.conjugate_leap(self.params.N))
        return ConjugationKey.wrap(
            self.create_key_switching_key(sk_conj, sk))

    def _permute(self, ct: Ciphertext, leap: int) -> Ciphertext:
        src, sign = self._perm_tables(leap)
        lp = self._lp_for(ct)
        return Ciphertext(
            data=tuple(_rotate_data_core(d, src, sign, lp) for d in ct.data),
            flags=ct._flags, level=ct.level, **self._meta(),
        )

    @_mesh_op("_rotate_single_mesh")
    def rotate_single(self, ct: Ciphertext, rotk: RotationKey,
                      post_key_switching=True) -> Ciphertext:
        """Rotate the slots by ``rotk.delta``: the Galois permutation of
        both polynomials, then (by default) the keyswitch back to the
        engine's key.  Traced as the span ``rotate_single``, with the
        children ``rotate.permute`` and ``switch_key``."""
        with trace.annotate("rotate_single"):
            with trace.annotate("rotate.permute"):
                rotated = self._permute(
                    ct, codec.rotate_leap(rotk.delta, self.params.N))
            if post_key_switching:
                rotated = self.switch_key(rotated, rotk)
            return rotated

    def rotate_offset(self, ct: Ciphertext, offset: int,
                      return_decomposed_offsets=False) -> Ciphertext:
        """Rotate by ``offset`` slots: one key where the engine holds it,
        else a composition of keys (:func:`decompose_rot_offsets`), each
        made on first use."""
        if offset == 0:
            return ct
        if offset in self.rotk:
            return self.rotate_single(ct, self.get_rotation_key(offset))
        offsets = decompose_rot_offsets(offset, self.num_slots,
                                        rotks=self.rotk)
        for delta in offsets:
            ct = self.rotate_single(ct, self.get_rotation_key(delta))
        if return_decomposed_offsets:
            return ct, offsets
        return ct

    def rotate_galois(self, ct: Ciphertext, gk: GaloisKey = None, *,
                      delta: int, return_circuit=False):
        """Deprecated; :meth:`rotate_offset` by ``delta``."""
        return self.rotate_offset(
            ct, delta, return_decomposed_offsets=return_circuit
        )

    @_mesh_op("_conjugate_mesh")
    def conjugate(self, ct: Ciphertext, conjk: ConjugationKey = None
                  ) -> Ciphertext:
        conjk = conjk or self.conjk
        conj = self._permute(ct, codec.conjugate_leap(self.params.N))
        return self.switch_key(conj, conjk)

    @_mesh_op("_negate_mesh")
    def negate(self, ct: Ciphertext) -> Ciphertext:
        lp = self._lp_for(ct)
        return Ciphertext(
            data=tuple(_negate_core(d, lp) for d in ct.data),
            flags=ct._flags, level=ct.level, **self._meta(),
        )

    # ------------------------------------------------------------------
    # Add / sub.
    # ------------------------------------------------------------------

    @_mesh_op("_cc_double_mesh")
    def _cc_double(self, core, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.has_flag(FLAGS.NTT_STATE) or b.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=False)
        a, b = self.align_level(a, b)
        lp = self._lp(a.level, False)
        return Ciphertext(
            data=tuple(core(x, y, lp) for x, y in zip(a.data, b.data)),
            level=a.level, **self._meta(),
        )

    @_mesh_op("_cc_triplet_mesh")
    def _cc_triplet(self, core, a: CiphertextTriplet, b: CiphertextTriplet
                    ) -> CiphertextTriplet:
        if not (a.has_flag(FLAGS.NTT_STATE) and b.has_flag(FLAGS.NTT_STATE)):
            raise errors.NTTStateError(expected=True)
        lp = self._lp(a.level, False)
        return CiphertextTriplet(
            data=tuple(core(x, y, lp) for x, y in zip(a.data, b.data)),
            flags=FLAGS.MONTGOMERY_STATE | FLAGS.NTT_STATE
            | FLAGS.NEED_RELINERIZE,
            level=a.level,
            **self._meta(),
        )

    def _cc_by_kind(self, double, triplet, a, b):
        if isinstance(a, Ciphertext) and isinstance(b, Ciphertext):
            return double(a, b)
        if isinstance(a, CiphertextTriplet) and isinstance(
            b, CiphertextTriplet
        ):
            return triplet(a, b)
        raise errors.DifferentTypeError(a=type(a), b=type(b))

    def cc_add_double(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._cc_double(_cc_add_core, a, b)

    def cc_add_triplet(self, a: CiphertextTriplet, b: CiphertextTriplet
                       ) -> CiphertextTriplet:
        return self._cc_triplet(_cc_add_core, a, b)

    def cc_add(self, a, b):
        return self._cc_by_kind(self.cc_add_double, self.cc_add_triplet,
                                a, b)

    def cc_sub_double(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._cc_double(_cc_sub_core, a, b)

    def cc_sub_triplet(self, a: CiphertextTriplet, b: CiphertextTriplet
                       ) -> CiphertextTriplet:
        return self._cc_triplet(_cc_sub_core, a, b)

    def cc_sub(self, a, b):
        return self._cc_by_kind(self.cc_sub_double, self.cc_sub_triplet,
                                a, b)

    # ------------------------------------------------------------------
    # Level management.
    # ------------------------------------------------------------------

    @_mesh_op()
    def level_up(self, ct: Ciphertext, dst_level: int) -> Ciphertext:
        """Bring ``ct`` down to ``dst_level``: one rescale, the channels
        between dropped, and the scale corrected by one multiply."""
        if ct.level == dst_level:
            return ct
        new_ct = self.rescale(ct)
        src_level = ct.level + 1
        dev = self.params.deviations
        diff_deviation = dev[dst_level] / np.sqrt(dev[src_level])
        deviated_delta = round(self.ckksCfg.scale * diff_deviation)
        drop = dst_level - src_level
        R = self.montCtx.R
        multiplier = self._scalar_col(
            [(deviated_delta * R) % qi for qi in self.params.q], dst_level)
        lp = self._lp(dst_level, False)
        data = tuple(
            _mont_scalar_core(d[..., drop:, :] if drop > 0 else d,
                              multiplier, lp)
            for d in new_ct.data
        )
        return Ciphertext(data=data, level=dst_level, **self._meta())

    def align_level(self, ct0, ct1):
        diff = ct0.level - ct1.level
        if diff < 0:
            return self.level_up(ct0, ct1.level), ct1
        if diff > 0:
            return ct0, self.level_up(ct1, ct0.level)
        return ct0, ct1

    # ------------------------------------------------------------------
    # Plaintext / scalar ops.
    # ------------------------------------------------------------------

    def _pt_cached(self, pt: Plaintext, level: int, op: str):
        """``pt``'s row for ``op`` at ``level``, encoded (a CSPRNG draw)
        and prepared on first use: "pc_add" the pt * scale * R residues,
        "pc_mult" the enter-NTT row that K3 takes as its key."""
        if op not in pt.cache[level]:
            m = pt.src * math.sqrt(self.params.deviations[level + 1])
            encoded = self.encode(m, level, scale=pt.scale)
            prepare = (_prepare_pc_add_cache if op == "pc_add"
                       else _prepare_pc_mult_cache)
            pt.cache[level][op] = prepare(encoded, self._lp(level, False))
        return pt.cache[level][op]

    @_mesh_op("_pc_add_mesh")
    def pc_add(self, pt: Plaintext, ct: Ciphertext) -> Ciphertext:
        level = ct.level
        new0 = _pc_add_core(self._pt_cached(pt, level, "pc_add"), ct.data[0],
                            self._lp(level, False))
        return Ciphertext(data=(new0, ct.data[1]), flags=ct._flags,
                          level=level, **self._meta())

    @_mesh_op("_pc_mult_mesh")
    def pc_mult(self, pt: Plaintext, ct: Ciphertext, post_rescale=True
                ) -> Ciphertext:
        level = ct.level
        d = _pc_mult_core(self._pt_cached(pt, level, "pc_mult"), *ct.data,
                          self._lp(level, False))
        new_ct = Ciphertext(data=d, level=level, **self._meta())
        if post_rescale:
            new_ct = self.rescale(new_ct)
        return new_ct

    def mc_mult(self, m, ct: Ciphertext, post_rescale=True) -> Ciphertext:
        return self.pc_mult(Plaintext(m), ct, post_rescale=post_rescale)

    def mc_add(self, m, ct: Ciphertext) -> Ciphertext:
        return self.pc_add(Plaintext(m), ct)

    def _scalar_col(self, values_per_prime, level):
        """One value per ordinary channel from ``level`` on: [C, 1] on the
        device; [B, C, 1] for a list of B such lists (one a stacked
        ciphertext)."""
        values = np.array(values_per_prime, dtype=self.ckksCfg.numpy_dtype)
        return self._to_dev(values[..., level:self.params.P, None])

    @staticmethod
    def _per_row(ct, scalar, values):
        """``values(scalar)``; for a sequence of scalars, one per stacked
        ciphertext of ``ct`` (its data's leading dim), the list of each
        one's ``values``."""
        if np.ndim(scalar) == 0:
            return values(scalar)
        shape = tuple(ct.data[0].shape)
        if np.ndim(scalar) != 1 or len(shape) != 3 or len(scalar) != shape[0]:
            raise ValueError(f"scalars of shape {np.shape(scalar)} for "
                             f"ciphertext data of shape {shape}")
        return [values(x) for x in scalar]

    @_mesh_op("_mult_mont_scalar_mesh")
    def _mult_mont_scalar(self, ct: Ciphertext, mont_scalar) -> Ciphertext:
        col = self._scalar_col(mont_scalar, ct.level)
        lp = self._lp(ct.level, False)
        return Ciphertext(
            data=tuple(_mont_scalar_core(d, col, lp) for d in ct.data),
            level=ct.level, **self._meta(),
        )

    def mult_int_scalar(self, ct: Ciphertext, scalar) -> Ciphertext:
        R = self.montCtx.R
        return self._mult_mont_scalar(
            ct, [(int(scalar) * R) % qi for qi in self.params.q])

    def mult_scalar(self, ct: Ciphertext, scalar) -> Ciphertext:
        """ct * scalar at the scale, then :meth:`rescale`.  ``scalar`` may
        be one value per stacked ciphertext ([B, C, N] data, B values):
        row i is then the call on row i alone with ``scalar[i]``."""
        R = self.montCtx.R
        root = np.sqrt(self.params.deviations[ct.level + 1])

        def mont_values(x):
            scaled_scalar = int(x * self.ckksCfg.scale * root + 0.5)
            return [(scaled_scalar * R) % qi for qi in self.params.q]

        new_ct = self._mult_mont_scalar(
            ct, self._per_row(ct, scalar, mont_values))
        return self.rescale(new_ct)

    @_mesh_op("_add_scalar_mesh")
    def add_scalar(self, ct: Ciphertext, scalar) -> Ciphertext:
        """ct + scalar; one value per stacked ciphertext as in
        :meth:`mult_scalar`."""
        col = self._scalar_col(self._per_row(
            ct, scalar, lambda x: self._add_scalar_values(ct, x)), ct.level)
        new0 = _add_scalar_core(ct.data[0], col, self._lp(ct.level, False))
        return Ciphertext(data=(new0, ct.data[1]), flags=ct._flags,
                          level=ct.level, **self._meta())

    def _add_scalar_values(self, ct, scalar):
        """``scalar`` at the ciphertext's scale, per prime."""
        scaled_scalar = int(
            scalar * self.ckksCfg.scale * self.params.deviations[ct.level]
            + 0.5
        )
        if self.norm == "backward":
            scaled_scalar *= self.ckksCfg.N
        scaled_scalar *= self.ckksCfg.int_scale
        return [scaled_scalar % qi for qi in self.params.q]

    def refresh(self):
        self.rng.refresh()

    def reduce_error(self, ct):
        return self.mult_scalar(ct, 1.0)

    # ------------------------------------------------------------------
    # Statistics.
    # ------------------------------------------------------------------

    def _fold_slots(self, ct: Ciphertext) -> Ciphertext:
        """Every slot the sum of all: logN - 1 rotations by 2^i, each added
        to the running sum."""
        for roti in range(self.ckksCfg.logN - 1):
            rot_ct = self.rotate_single(ct, self.get_rotation_key(2**roti))
            ct = self.cc_add(rot_ct, ct)
        return ct

    def sum(self, ct: Ciphertext) -> Ciphertext:
        """Every slot the sum of all; traced as the span ``sum``."""
        with trace.annotate("sum"):
            return self._fold_slots(ct)

    def mean(self, ct: Ciphertext, *, alpha=1) -> Ciphertext:
        return self._fold_slots(self.mc_mult(
            m=np.full(self.num_slots, 1 / self.num_slots / alpha), ct=ct))

    def cov(self, ct_a: Ciphertext, ct_b: Ciphertext,
            evk: EvaluationKey = None) -> Ciphertext:
        evk = evk or self.evk
        cta_dev = self.cc_sub(ct_a, self.mean(ct_a))
        ctb_dev = self.cc_sub(ct_b, self.mean(ct_b))
        return self.mc_mult(
            m=np.full(self.num_slots, 1 / (self.num_slots - 1)),
            ct=self.cc_mult(cta_dev, ctb_dev, evk),
        )

    def pow(self, ct: Ciphertext, power: int, evk: EvaluationKey = None
            ) -> Ciphertext:
        evk = evk or self.evk
        current_exponent = 2
        pow_list = [ct]
        while current_exponent <= power:
            pow_list.append(self.cc_mult(pow_list[-1], pow_list[-1], evk))
            current_exponent *= 2
        remaining = power - current_exponent // 2
        new_ct = pow_list[-1]
        while remaining > 0:
            pow_ind = math.floor(math.log2(remaining))
            new_ct, pow_term = self.align_level(new_ct, pow_list[pow_ind])
            new_ct = self.cc_mult(new_ct, pow_term, evk)
            remaining -= 2**pow_ind
        return new_ct

    def sqrt(self, ct: Ciphertext, evk: EvaluationKey = None, e=0.0001,
             alpha=0.0001) -> Ciphertext:
        """Wilkes square-root iteration."""
        a = ct
        b = ct
        evk = evk or self.evk
        while e <= 1 - alpha:
            k = float(np.roots([1 - e**3, -6 + 6 * e**2, 9 - 9 * e])[1])
            t = self.mult_scalar(a, k)
            b0 = self.add_scalar(t, -3)
            b1 = self.mult_scalar(b, (k**0.5) / 2)
            b0, b1 = self.align_level(b0, b1)
            b = self.cc_mult(b0, b1, evk)

            a0 = self.mult_scalar(a, (k**3) / 4)
            t = self.add_scalar(a, -3 / k)
            a1 = self.cc_mult(t, t, evk)
            a0, a1 = self.align_level(a0, a1)
            a = self.cc_mult(a0, a1, evk)
            e = k * (3 - k) ** 2 / 4
        return b

    def randn(self, amin=-1, amax=1, decimal_places: int = 10, level=0,
              return_src=False):
        """Encrypt a random complex message (numpy's global generator)."""
        def integral_bits_available():
            max_bits = math.floor(math.log2(self.params.base_prime))
            return max_bits - self.ckksCfg.scale_bits

        if amin is None:
            amin = -(2 ** integral_bits_available())
        if amax is None:
            amax = 2 ** integral_bits_available()
        base = 10**decimal_places
        a = np.random.randint(amin * base, amax * base, self.num_slots) / base
        b = np.random.randint(amin * base, amax * base, self.num_slots) / base
        sample = a + b * 1j
        encrypted = self.encodecrypt(sample, level=level)
        return (encrypted, sample) if return_src else encrypted

    def var(self, ct: Ciphertext, evk: EvaluationKey = None, *,
            post_relin=False) -> Ciphertext:
        evk = evk or self.evk
        dev = self.cc_sub(ct, self.mean(ct))
        dev = self.square(dev, evk, post_relin=post_relin)
        if not post_relin:
            dev = self.relinearize(dev, evk)
        return self.mean(dev)

    def std(self, ct: Ciphertext, evk: EvaluationKey = None,
            post_relin=False) -> Ciphertext:
        ct_var = self.var(ct, evk or self.evk, post_relin=post_relin)
        return self.sqrt(ct_var, evk or self.evk)

    # ------------------------------------------------------------------
    # Stacked linear layers (features as ciphertexts).
    # ------------------------------------------------------------------

    def encode_matrix(self, weight, level: int) -> MatrixWeights:
        """``weight`` [F_in, F_out] (real) for :meth:`mult_matrix` on
        ciphertexts at ``level``: each weight the integer
        ``int(w * scale * sqrt(dev[level + 1]) + 0.5)``, as
        :meth:`mult_scalar` encodes a scalar, split into bytes once and
        kept on the device.  Any integer below 2^62 in magnitude: |w| up
        to about 2^22 at a 2^40 scale."""
        w = np.asarray(weight, dtype=np.float64)
        if w.ndim != 2:
            raise ValueError(f"weight must be [F_in, F_out], got {w.shape}")
        root = np.sqrt(self.params.deviations[level + 1])
        scaled = w * self.ckksCfg.scale * root + 0.5
        if not np.all(np.abs(scaled) < 2.0**62):
            raise ValueError(f"a weight of {np.abs(w).max()} encodes to "
                             f"2^62 or more at level {level}")
        ints = np.trunc(scaled).astype(np.int64)     # int(), to zero
        limbs = mm.weight_limbs(torch.from_numpy(ints))
        return MatrixWeights(level, limbs.to(self.device))

    def _matrix_sum(self, ct: Ciphertext, weights: MatrixWeights,
                    acc: Ciphertext = None) -> Ciphertext:
        """``sum_i W[i, j] ct[i]`` at ``ct``'s level, not rescaled: one
        modular matrix product (``ops/matmul``) over the stack ``ct``
        [F_in, C, N], for both polynomials.  With ``acc`` (a stack of
        F_out at the same level) the sums are added into ``acc``'s data in
        place, which is returned."""
        if _holds_sharded(ct):
            raise NotImplementedError("mult_matrix runs on one device")
        if weights.level != ct.level:
            raise ValueError(f"weights encoded for level {weights.level}, "
                             f"ciphertexts at {ct.level}")
        if acc is not None and acc.level != ct.level:
            raise ValueError(f"accumulator at level {acc.level}, "
                             f"ciphertexts at {ct.level}")
        lp = self._lp(ct.level, False)
        data = mm.matmul(ct.data[0], ct.data[1], weights.limbs, lp,
                         None if acc is None else acc.data)
        return Ciphertext(data=data, level=ct.level, **self._meta())

    def mult_matrix(self, ct: Ciphertext, weight: MatrixWeights,
                    bias=None) -> Ciphertext:
        """The stacked linear op: a stack of F_in ciphertexts (``[F_in,
        C, N]`` data, one feature each) to a stack of F_out,
        ``out[j] = sum_i w[i, j] ct[i] + bias[j]``, ``weight`` the real
        [F_in, F_out] matrix ``w`` as :meth:`encode_matrix` encodes it for
        ``ct``'s level.  The weighted sums (unrescaled,
        :meth:`_matrix_sum`), one :meth:`rescale`, then the bias a row
        through :meth:`add_scalar`: the residues of
        ``sum_i mult_int_scalar(ct[i], W[i, j])`` rescaled, with ``W``
        the integers :meth:`encode_matrix` makes.  Traced as the span
        ``mult_matrix``."""
        with trace.annotate("mult_matrix"):
            out = self.rescale(self._matrix_sum(ct, weight))
            if bias is not None:
                out = self.add_scalar(out, bias)
        return out

    def feed_forward(self, w1, b1, w2, b2):
        """The feature-wise encrypted feed-forward sub-layer on this engine:
        :class:`tiberate_tpu_torch.extension.nn.HEFeedForwardFeatureWise`,
        ``y = x + w2^T quad(w1^T x + b1) + b2`` over one stack of feature
        ciphertexts."""
        from tiberate_tpu_torch.extension.nn import HEFeedForwardFeatureWise

        return HEFeedForwardFeatureWise(w1, b1, w2, b2, self)

    def layer_norm(self, gamma, beta, **kwargs):
        """The feature-wise encrypted LayerNorm on this engine:
        :class:`tiberate_tpu_torch.extension.nn.HELayerNormFeatureWise`
        (``kwargs``: ``eps``, ``var_range``, ``iters``), which takes a list
        of feature ciphertexts or one stack of them."""
        from tiberate_tpu_torch.extension.nn import HELayerNormFeatureWise

        return HELayerNormFeatureWise(gamma, beta, self, **kwargs)


def _broadcast_pair(a, b):
    """(a, b) with an unstacked operand ([C, N] data) against a stacked one
    ([B, C, N]) repeated along the stack's leading dims; equal shapes as
    they are."""
    sa, sb = a.data[0].shape, b.data[0].shape
    if sa == sb:
        return a, b

    def rep(ct, shape):
        return type(ct)(data=tuple(d.expand(shape).contiguous()
                                   for d in ct.data),
                        flags=ct._flags, level=ct.level, **ct.misc)

    if len(sa) < len(sb):
        return rep(a, sb), b
    return a, rep(b, sa)


def stack_ciphertexts(cts) -> Ciphertext:
    """Stack same-level ciphertexts into one with a leading batch dim."""
    level = cts[0].level
    if any(ct.level != level for ct in cts):
        raise errors.NotMatchType(origin="mixed levels", to="a batch")
    return Ciphertext(
        data=tuple(torch.stack([ct.data[i] for ct in cts]) for i in (0, 1)),
        level=level, **dict(cts[0].misc),
    )


def unstack_ciphertext(ct: Ciphertext) -> list:
    """Split a batched ciphertext along its leading dim."""
    return [
        Ciphertext(data=(d0, d1), level=ct.level, **dict(ct.misc))
        for d0, d1 in zip(ct.data[0], ct.data[1])
    ]


__all__ = ["CkksEngine", "MatrixWeights", "stack_ciphertexts",
           "unstack_ciphertext"]
