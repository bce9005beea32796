"""The CKKS engine over torch tensors: the keygen -> encrypt -> cc_mult ->
decrypt and switch_key slice of ``tiberate_tpu/engine/ckks_engine.py``.

Each core below is the torch twin of the jnp core of the same name, with a
batch written out as leading dimensions where the JAX package ``vmap``s:
the JAX package's ``_encrypt_batch_core``, ``_decrypt_double_batch_core``
and ``_final_scale_batch`` are :func:`_encrypt_core`,
:func:`_decrypt_double_core` and :func:`_final_scale` on ``[B, C, N]``
operands.  Keys and noise come from the counter-mode ChaCha20 CSPRNG
(:mod:`tiberate_tpu_torch.rng.csprng`) on the engine's device, drawn in
the JAX package's order, so the same ``(seed, nonce)`` gives the JAX
package's keys and ciphertexts byte for byte.
The NTTs, the tensor product, the keyswitch (all parts in one kernel at
logN <= 16, the per-part chain at logN 17, as the JAX package routes it)
and the P-division go through the kernel wrappers of
:mod:`tiberate_tpu_torch.ops.ntt_kernels`:
one code path, which launches the Hopper kernels for CUDA tensors and runs
their plain versions for CPU tensors.  Outputs are bit-identical to the JAX
package's jnp path on the same inputs.
"""

import functools
from hashlib import sha256

import numpy as np
import torch

from tiberate_tpu_torch import errors
from tiberate_tpu_torch.config import CkksConfig, Preset
from tiberate_tpu_torch.context.ntt_context import CkksParams, PartPack
from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt_kernels as kern
from tiberate_tpu_torch.rng.csprng import Csprng
from tiberate_tpu_torch.typing import (
    FLAGS,
    Ciphertext,
    CiphertextTriplet,
    EvaluationKey,
    KeySwitchKey,
    PublicKey,
    SecretKey,
)
from tiberate_tpu_torch.utils import encoding as codec

# ======================================================================
# Cores.
# ======================================================================


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


def _rescale_core(d, rescale_scale, lp_next, round_at):
    """Drop the top RNS channel with exact rounding.  d: [..., C, N] in
    [0, q) -> [..., C-1, N]."""
    rescaler = d[..., 0:1, :]
    data = d[..., 1:, :] - rescaler
    data = mont.mont_mult(data, rescale_scale, lp_next.pack)
    data = data + (rescaler > round_at).to(data.dtype)
    # REDC of a signed difference can land marginally below zero
    data = mont.make_unsigned(data, lp_next.pack)
    return mont.reduce_2q(data, lp_next.pack)


def _ccmult_tensor_core(x0, x1, y0, y1, lp):
    """Tensor product in the NTT domain: d0 = x0y0, d1 = x0y1 + x1y0,
    d2 = x1y1."""
    return kern.ntt_tensor(x0, x1, y0, y1, lp)


def _pre_extend(a_part, part: PartPack, plp):
    """Mixed-radix (Garner) digits of the part residues.

    a_part: [..., alpha, N] values in [0, q); returns [..., alpha, N]
    signed digits.
    """
    alpha = part.alpha
    pk = plp.pack
    rows = [a_part[..., 0, :]] * alpha
    for i in range(alpha - 1):
        ql, qh = pk.ql[i + 1], pk.qh[i + 1]
        kl, kh = pk.kl[i + 1], pk.kh[i + 1]
        y = a_part[..., i + 1, :] - rows[i + 1]
        y = mont.mont_mult_raw(y, part.Y_scalar[i], ql, qh, kl, kh)
        rows[i + 1] = y
        if i + 2 < alpha:
            suffix = pk[i + 2 : alpha]
            ynew = mont.mont_mult_raw(
                y[..., None, :], part.L_scalar[i],
                suffix.ql, suffix.qh, suffix.kl, suffix.kh,
            )
            for j, r in enumerate(range(i + 2, alpha)):
                rows[r] = rows[r] + ynew[..., j, :]
    return torch.stack(rows, dim=-2)


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
    rows = []
    for i in range(S):
        r = cur[..., S - 1 - i, :]
        rows.append(r)
        if i < S - 1:
            upd = mont.mont_sub(cur, r[..., None, :], lp_spec.pack)
            cur = mont.mont_mult(upd, PiRs[i][C:], lp_spec.pack)
    return kern.intt_pdiv(acc, torch.stack(rows, dim=-2), lp_ord, PiRs)


def _parts_digits(a, parts, lp_ord, amax):
    """Every part's mixed-radix digits, zero-padded to ``amax`` rows:
    [..., n_parts, amax, N] (the ``ntt_keymul_parts`` operand)."""
    sts = []
    for part in parts:
        st = _pre_extend(a[..., part.lo : part.hi, :], part,
                         lp_ord[part.lo : part.hi])
        if part.alpha < amax:
            pad = st.new_zeros((*st.shape[:-2], amax - part.alpha,
                                st.shape[-1]))
            st = torch.cat([st, pad], dim=-2)
        sts.append(st)
    return torch.stack(sts, dim=-3)


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


def _switcher_body(a, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl, S,
                   exit_ntt, a_ntt=None, inpart=None, parts_fused=None):
    """Key switching of ``a`` [..., C, N] (coefficient domain, [0, q); NTT
    domain with ``exit_ntt``): returns (c0, c1) canonical ordinary rows.

    ``parts_fused`` = (k0, k1, ec, alphas) from
    :meth:`CkksEngine._ksk_parts_fused`: every part's digits go to ONE
    ``ntt_keymul_parts`` call, which extends, transforms, multiplies by
    both evk components and sums the parts.

    ``parts_fused`` None: the per-part chain over ``ksk_parts`` (each
    part's (k0, k1) evk rows at the level, :meth:`CkksEngine._ksk_args`):
    per part ``_pre_extend`` + ``_extend``, then one ``ntt_keymul_accum``
    that adds both key products into the running accumulators in place.
    ``a_ntt`` + ``inpart`` (= (diag_keys, skips), see
    :meth:`CkksEngine._ksk_inpart`) enable the in-part shortcut: the
    extension is the identity on a part's own channels, so with the NTT
    form of ``a`` at hand (relinearize: the tensor product's d2) those
    rows' key products seed the accumulators and each part transforms only
    its out-of-part rows.  Without the shortcut the first part has no
    accumulator yet and runs the plain two-key ``ntt_keymul``.
    """
    if exit_ntt:
        a = kern.intt(a, lp_ord, "exit_reduce")
    if parts_fused is not None:
        k0, k1, ec, alphas = parts_fused
        st = _parts_digits(a, parts, lp_ord, ec.shape[-1])
        acc = kern.ntt_keymul_parts(st, ec, alphas, (k0, k1), lp_sp)
    else:
        acc = None
        skips = (None,) * len(parts)
        if a_ntt is not None and inpart is not None:
            diag_keys, skips = inpart
            zeros = a_ntt.new_zeros(
                (*a_ntt.shape[:-2], lp_sp.num_channels - lp_ord.num_channels,
                 a_ntt.shape[-1]))
            acc = tuple(
                torch.cat([mont.mont_mult(a_ntt, dk, lp_ord.pack), zeros],
                          dim=-2)
                for dk in diag_keys
            )
        for part, skip, keys in zip(parts, skips, ksk_parts):
            state = _pre_extend(a[..., part.lo : part.hi, :], part,
                                lp_ord[part.lo : part.hi])
            ext = _extend(state, part, lp_sp, lvl)
            if acc is None:
                acc = kern.ntt_keymul(ext, lp_sp, keys, enter=False)
            else:
                kern.ntt_keymul_accum(ext, lp_sp, keys, acc, skip)
    c0 = _pdiv_fused(acc[0], lp_sp, lp_ord, PiRs, S)
    c1 = _pdiv_fused(acc[1], lp_sp, lp_ord, PiRs, S)
    return c0, c1


def _switch_key_core(ct0, a, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl, S,
                     exit_ntt, parts_fused=None):
    """switch_key: new ct0 = ct0 + c0, new ct1 = c1."""
    c0, c1 = _switcher_body(a, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl,
                            S, exit_ntt, parts_fused=parts_fused)
    new0 = mont.reduce_2q(mont.mont_add(ct0, c0, lp_ord.pack), lp_ord.pack)
    return new0, c1


def _relin_core(d0, d1, d2, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl, S,
                inpart=None, parts_fused=None):
    """relinearize a triplet in the NTT domain -> (ct0, ct1)."""
    d2_ntt = d2
    d0 = kern.intt(d0, lp_ord, "exit_reduce")
    d1 = kern.intt(d1, lp_ord, "exit_reduce")
    d2 = kern.intt(d2, lp_ord, "exit_reduce")
    c0, c1 = _switcher_body(d2, ksk_parts, parts, lp_sp, lp_ord, PiRs, lvl,
                            S, False, a_ntt=d2_ntt, inpart=inpart,
                            parts_fused=parts_fused)
    ct0 = mont.reduce_2q(d0 + c0, lp_ord.pack)
    ct1 = mont.reduce_2q(d1 + c1, lp_ord.pack)
    return ct0, ct1


# ======================================================================
# The engine.
# ======================================================================


class CkksEngine:
    """CKKS engine on one device.

    ``device`` is explicit: "cuda" (the default) raises when no GPU is
    present; pass "cpu" to run the plain torch versions.  ``seed`` and
    ``nonce`` key the CSPRNG as in the JAX package: an int seed without a
    nonce is fully deterministic; None draws from ``os.urandom``.
    """

    def __init__(self, ckks_config=None, device="cuda", *,
                 bias_guard: bool = True, seed=None, nonce=None):
        self.device = torch.device(device)
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
        self.rng = self._csprng(seed, nonce)
        self.bias_guard = bias_guard
        self.__sk = None
        self.__pk = None
        self.__evk = None
        self._steps = {}    # level -> fused step
        self._consts = {}   # level -> all-parts keyswitch constants

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

    def _meta(self):
        return dict(logN=self.ckksCfg.logN, creator_hash=self.hash)

    def _lp(self, lvl, special=False):
        return self.params.lp(lvl, special)

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
            self.sk = self._create_secret_key()
        return self.__sk

    @sk.setter
    def sk(self, sk: SecretKey):
        self.__pk = None
        self.__evk = None
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
            data=_keygen_sk_core(self._to_dev(ternary), lp),
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
        pk0 = _keygen_pk_core(self._to_dev(e), a, sk.data[:C], lp)
        return PublicKey(
            data=(pk0, a),
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
        Psk = mont.mont_mult(sk_from.data[:P], self.params.mont_PR,
                             lp_ord.pack)
        ksk_parts = []
        for part_id, part in enumerate(self.params.parts[0]):
            crs = a[part_id] if a is not None else None
            pk = self._create_public_key(sk_to, include_special=True, a=crs)
            pk0, pk1 = pk.data
            part_pack = self.params.pack[part.g0 : part.g0 + part.alpha]
            pk0 = _ksk_shard_core(pk0, Psk[part.lo : part.hi], part.g0,
                                  part.alpha, part_pack)
            ksk_parts.append((pk0, pk1))
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
        # the key-form caches (_parts_fused, _inpart) hold the a halves
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
        return PublicKey(data=(cpk.data[0], self._to_dev(a)),
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
            data=tuple((k0, self._to_dev(a))
                       for k0, a in zip(cksk.data, a_list)),
            flags=cksk._flags, level=cksk.level,
            **self._expanded_misc(cksk))

    def _create_evk(self, sk: SecretKey = None) -> EvaluationKey:
        sk = sk or self.sk
        lp = self._lp(0, True)
        sk2 = SecretKey(
            data=mont.mont_mult(sk.data, sk.data, lp.pack),
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

    def _ksk_args(self, ksk: KeySwitchKey, level: int):
        """(ksk_parts, parts) at ``level``: each live part's (k0, k1) evk
        rows ``[level:]`` ([C_sp, N] views), in ``parts_alloc`` order."""
        ksk_parts = tuple(
            tuple(k[level:] for k in ksk.data[g])
            for g in self.params.parts_alloc[level]
        )
        return ksk_parts, tuple(self.params.parts[level])

    @staticmethod
    def _key_cache(ksk: KeySwitchKey, name: str) -> dict:
        cache = ksk.misc.get(name)
        if cache is None:
            cache = ksk.misc[name] = {}
        return cache

    def _ksk_parts_stacked(self, ksk: KeySwitchKey, level: int):
        """(k0, k1, ec, alphas) for ``ntt_keymul_parts`` at ``level``: the
        live parts' evk rows stacked [n_parts, C_sp, N] and
        :meth:`_parts_consts`.  Cached on the key."""
        cache = self._key_cache(ksk, "_parts_fused")
        if level not in cache:
            ksk_parts, _ = self._ksk_args(ksk, level)
            keys = tuple(torch.stack([kp[i] for kp in ksk_parts])
                         for i in range(2))
            cache[level] = (*keys, *self._parts_consts(level))
        return cache[level]

    def _ksk_parts_fused(self, ksk: KeySwitchKey, level: int):
        """The all-parts keyswitch's key form (:meth:`_ksk_parts_stacked`)
        at logN <= 16; None at logN >= 17, where the keyswitch runs the
        per-part chain, as the JAX package routes it."""
        if self.ckksCfg.logN >= 17:
            return None
        return self._ksk_parts_stacked(ksk, level)

    def _ksk_inpart(self, ksk: KeySwitchKey, level: int):
        """(diag_keys, skips) for the keyswitch in-part shortcut:
        ``diag_keys[i]`` [C, N] holds in row j row j of part(j)'s evk
        component i (the key the identity extension row multiplies), and
        ``skips`` each part's own channel range (lo, hi).  Cached on the
        key."""
        cache = self._key_cache(ksk, "_inpart")
        if level not in cache:
            ksk_parts, parts = self._ksk_args(ksk, level)
            diag_keys = tuple(
                torch.cat([kp[i][pt.lo : pt.hi]
                           for kp, pt in zip(ksk_parts, parts)])
                for i in range(2)
            )
            cache[level] = (diag_keys,
                            tuple((pt.lo, pt.hi) for pt in parts))
        return cache[level]

    # ------------------------------------------------------------------
    # Encode / decode (host codec).
    # ------------------------------------------------------------------

    def encode(self, m, level: int = 0, padding=True):
        """Message -> signed integer coefficients [N] (int64, on the
        device)."""
        if padding:
            m = codec.padding(m, num_slots=self.num_slots)
        return codec.encode(
            m, scale=self.ckksCfg.scale, rng=self.rng,
            deviation=self.params.deviations[level],
        )

    def decode(self, m, level=0, is_real: bool = False):
        """Signed coefficients [N] (or [1, N]) -> message slots."""
        m = np.asarray(torch.as_tensor(m).cpu()).reshape(-1)
        decoded = codec.decode(
            m, scale=self.ckksCfg.scale,
            correction=self.params.corrections[level],
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
            pk.data[0][level : level + C], pk.data[1][level : level + C], lp,
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
        return self._encrypt(pt, dc_rns, e[0, 0], e[0, 1], v[0], pk, level)

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
        with the bias guard on or off."""
        pk = pk or self.pk
        if padding:
            ms = [codec.padding(m, num_slots=self.num_slots) for m in ms]
        ms = np.stack([np.asarray(m) for m in ms])
        deviation = self.params.deviations[level]
        C = self._channels(pk, level)
        B = ms.shape[0]
        scale = self.ckksCfg.scale
        dc_rns = np.zeros((B, C), dtype=self.ckksCfg.numpy_dtype)
        if self.bias_guard:
            pts = codec.encode_batch(
                ms, scale=scale, deviation=deviation, rng=self.rng,
                return_without_scaling=True,
            ).copy()
            dc_integral = np.floor(pts[:, 0])
            pts[:, 0] -= dc_integral
            dc_rns = self._dc_residues(dc_integral, level, C)
            pts = self.rng.randround_batch(pts * np.float64(scale))
        else:
            pts = codec.encode_batch(ms, scale=scale, deviation=deviation,
                                     rng=self.rng)
        e, v = self.rng.encrypt_noise_batch(B)
        ct = self._encrypt(pts, dc_rns, e[:, 0], e[:, 1], v, pk, level)
        return [Ciphertext(data=(d0, d1), flags=ct._flags, level=level,
                           **self._meta())
                for d0, d1 in zip(*ct.data)]

    def _decrypt_args(self, level):
        C = self._lp(level, False).num_channels
        return (self._lp(level, False), self.params.base_lp(),
                self.params.final_scalar[level], self._rounding_half, C - 1)

    def decrypt_double(self, ct: Ciphertext, sk: SecretKey = None):
        """-> signed scaled coefficients [1, N]."""
        sk = sk or self.sk
        _check_plain_state(ct)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        lp, base_lp, fs, rh, base_at = self._decrypt_args(ct.level)
        C = base_at + 1
        scaled, _ = _decrypt_double_core(
            ct.data[0][..., :C, :], ct.data[1][..., :C, :],
            sk.data[ct.level : ct.level + C], lp, base_lp, fs, rh,
            base_at, final_round=True,
        )
        return scaled

    def decrypt_triplet(self, ct_mult: CiphertextTriplet,
                        sk: SecretKey = None):
        """-> signed scaled coefficients [1, N] of d0 + d1 s + d2 s^2."""
        sk = sk or self.sk
        _check_ntt_mont_state(ct_mult)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)
        level = ct_mult.level
        lp, base_lp, fs, rh, base_at = self._decrypt_args(level)
        C = base_at + 1
        scaled, _ = _decrypt_triplet_core(
            *ct_mult.data, sk.data[level : level + C], lp, base_lp, fs, rh,
            base_at, final_round=True,
        )
        return scaled

    def decrypt(self, ct, sk: SecretKey = None):
        """:meth:`decrypt_triplet` or :meth:`decrypt_double` by kind."""
        if isinstance(ct, CiphertextTriplet):
            return self.decrypt_triplet(ct, sk)
        return self.decrypt_double(ct, sk)

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

    def _decrypt_scaled(self, core, sk, level):
        """The decrypt epilogue of :meth:`decryptcode` and
        :meth:`decryptcode_batch` over leading dims [..., C, N]: ``core``
        (a decrypt core with its ciphertext bound) -> (scaled [..., 1, N],
        the exact DC values as a list of python ints, or None).  With the
        bias guard (and >= 3 channels left) the DC slots are zeroed before
        the final scale and recovered by a 3-prime CRT; only their three
        residues leave the device."""
        lp, base_lp, fs, rh, base_at = self._decrypt_args(level)
        C = base_at + 1
        args = (sk.data[level : level + C], lp, base_lp, fs, rh, base_at)
        if not (C >= 3 and self.bias_guard):
            scaled, _ = core(*args, final_round=True)
            return scaled, None
        _, pt = core(*args, final_round=False)
        dcs = self._dc_crt(pt[..., [base_at, 0, 1], 0], level, base_at)
        pt_z = pt.clone()
        pt_z[..., base_at, 0] = 0
        pt_z[..., 0, 0] = 0
        return _final_scale(pt_z, base_lp, fs, rh, base_at,
                            final_round=True), dcs

    def decryptcode(self, ct, sk: SecretKey = None, *, is_real=False):
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
        scaled, dcs = self._decrypt_scaled(core, sk, level)

        correction = self.params.corrections[level]
        decoded = codec.decode(
            np.asarray(scaled.cpu()).reshape(-1),
            scale=self.ckksCfg.scale, correction=correction,
            return_without_scaling=True,
        )[: self.num_slots]
        decoded = decoded / self.ckksCfg.scale * correction
        if dcs is not None:
            decoded = decoded + dcs[0] / self.ckksCfg.scale * correction
        return decoded.real if is_real else decoded

    def decryptcode_batch(self, cts, sk: SecretKey = None, *,
                          is_real=False):
        """Decrypt and decode same-level ciphertexts with one decrypt core
        on [B, C, N] and one vectorized decode; per message the result is
        :meth:`decryptcode`'s up to the decode's float summation order.
        Returns [B, slots]."""
        sk = sk or self.sk
        _check_ntt_mont_state(sk)
        level = cts[0].level
        if any(ct.level != level for ct in cts):
            raise errors.NotMatchType(origin="mixed ciphertext levels",
                                      to="decryptcode_batch")
        for ct in cts:
            _check_plain_state(ct)
        C = self._lp(level, False).num_channels
        core = functools.partial(
            _decrypt_double_core,
            torch.stack([ct.data[0][:C] for ct in cts]),
            torch.stack([ct.data[1][:C] for ct in cts]),
        )
        scaled, dcs = self._decrypt_scaled(core, sk, level)

        correction = self.params.corrections[level]
        decoded = codec.decode_batch(
            np.asarray(scaled.cpu()).reshape(len(cts), -1),
            scale=self.ckksCfg.scale, correction=correction,
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

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Drop the top RNS channel of both polynomials, rounding exactly."""
        level = ct.level
        if level + 1 >= self.num_levels:
            raise errors.MaximumLevelError(level=level,
                                           level_max=self.num_levels)
        lp_next = self._lp(level + 1, False)
        round_at = self.params.q[level] // 2
        data = tuple(
            _rescale_core(d, self.params.rescale_scales[level], lp_next,
                          round_at)
            for d in ct.data
        )
        return Ciphertext(data=data, level=level + 1, **self._meta())

    def _fused_mult_step(self, level: int):
        """The fused step function at ``level``, built once."""
        if level not in self._steps:
            from tiberate_tpu_torch.parallel import sharded

            self._steps[level] = sharded.make_mult_step(self, level)
        return self._steps[level]

    def cc_mult(self, a: Ciphertext, b: Ciphertext,
                evk: EvaluationKey = None) -> Ciphertext:
        """rescale -> tensor product -> relinearize, through the fused step
        (``parallel/sharded.make_mult_step``).  Both operands must share a
        level; leading batch dimensions of their data are carried."""
        if a.level != b.level:
            raise errors.NotMatchType(origin=f"levels {a.level}/{b.level}",
                                      to="cc_mult (align levels first)")
        if a.level + 1 >= self.num_levels:
            raise errors.MaximumLevelError(level=a.level,
                                           level_max=self.num_levels)
        from tiberate_tpu_torch.parallel import sharded

        evk = evk or self.evk
        step = self._fused_mult_step(a.level)
        ct0, ct1 = step(a.data[0], a.data[1], b.data[0], b.data[1],
                        sharded.prepare_step_ksk(self, a.level, evk),
                        sharded.mult_step_params(self, a.level, evk))
        return Ciphertext(data=(ct0, ct1), level=a.level + 1,
                          **self._meta())

    # ------------------------------------------------------------------
    # Key switching.
    # ------------------------------------------------------------------

    def create_switcher(self, a, ksk: KeySwitchKey, level: int,
                        exit_ntt: bool = False):
        """Key-switch ``a`` [..., C, N] at ``level``: (c0, c1) with
        c0 + c1 s_to = a s_from (approximately)."""
        ksk_parts, parts = self._ksk_args(ksk, level)
        return _switcher_body(
            a, ksk_parts, parts, self._lp(level, True),
            self._lp(level, False), tuple(self.params.PiRs[level]), level,
            self.ckksCfg.num_special_primes, exit_ntt,
            parts_fused=self._ksk_parts_fused(ksk, level),
        )

    def switch_key(self, ct: Ciphertext, ksk: KeySwitchKey) -> Ciphertext:
        """Re-encrypt ``ct`` from ``ksk``'s source key to its target key
        (``create_key_switching_key(sk_from, sk_to)``)."""
        level = ct.level
        ksk_parts, parts = self._ksk_args(ksk, level)
        new0, new1 = _switch_key_core(
            ct.data[0], ct.data[1], ksk_parts, parts,
            self._lp(level, True), self._lp(level, False),
            tuple(self.params.PiRs[level]), level,
            self.ckksCfg.num_special_primes, ct.has_flag(FLAGS.NTT_STATE),
            parts_fused=self._ksk_parts_fused(ksk, level),
        )
        return Ciphertext(data=(new0, new1), flags=ct._flags, level=level,
                          **self._meta())


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


__all__ = ["CkksEngine", "stack_ciphertexts", "unstack_ciphertext"]
