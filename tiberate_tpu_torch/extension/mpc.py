"""Multiparty (threshold) CKKS.

The torch counterpart of ``tiberate_tpu/extension/mpc.py``, method for
method:

* common-reference-string public keys: every party builds ``pk_i = (e_i -
  a*sk_i, a)`` under one shared uniform ``a``;
* the collective public key ``cpk = (sum_i pk_i[0], a)``: encryptions
  under it decrypt under the joint key ``S = sum_i sk_i``;
* distributed decryption: one party computes the *head* (``ct0 +
  a*sk_1``), the others *partials* (``a*sk_i``); the fusion sums them,
  scales and decodes;
* collective key-switching, rotation and Galois keys by summing the
  parties' shares under per-part common ``a``;
* the evaluation key by the three rounds share-sum -> multiply by sk ->
  share-sum.

The partial decryptions run K3 (one key, with entry) and K2 ("exit"), the
rotation keys K1, and the fusion the decrypt epilogue ``_final_scale`` on
the engine's device.
"""

import numpy as np

from tiberate_tpu_torch import errors
from tiberate_tpu_torch.engine.ckks_engine import CkksEngine, _final_scale
from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt_kernels as kern
from tiberate_tpu_torch.typing import (
    FLAGS,
    Ciphertext,
    DataStruct,
    EvaluationKey,
    GaloisKey,
    KeySwitchKey,
    PublicKey,
    RotationKey,
    SecretKey,
)
from tiberate_tpu_torch.utils import encoding as codec


class CkksEngineMPCExtension(CkksEngine):
    # ------------------------------------------------------------------
    # Collective public keys.
    # ------------------------------------------------------------------

    def multiparty_public_crs(self, pk: PublicKey):
        """The common random polynomial ``a`` of a public key, a copy on
        the engine's device."""
        return pk.data[1].to(self.device, copy=True)

    def multiparty_create_public_key(
        self, sk: SecretKey, a=None, include_special: bool = False
    ) -> PublicKey:
        """A party's pk share under the (optionally shared) ``a``."""
        return self._create_public_key(
            sk, include_special=include_special, a=a
        )

    def multiparty_create_collective_public_key(
        self, pks: list[PublicKey]
    ) -> PublicKey:
        pk0 = pks[0]
        include_special = pk0.has_flag(FLAGS.INCLUDE_SPECIAL)
        lp = self._lp(0, include_special)
        b = pks[0].data[0]
        for pk in pks[1:]:
            b = mont.mont_add(b, pk.data[0], lp.pack)
        return PublicKey(
            data=(b, pks[0].data[1]),
            flags=pk0._flags,
            level=pk0.level,
            **self._meta(),
        )

    # ------------------------------------------------------------------
    # Distributed decryption.
    # ------------------------------------------------------------------

    def _partial_sa(self, ct: Ciphertext, sk: SecretKey):
        """a * sk at the ciphertext's level, out of the NTT domain."""
        level = ct.level
        lp = self._lp(level, False)
        C = lp.num_channels
        (sa,) = kern.ntt_keymul(ct.data[1][..., :C, :], lp,
                                (sk.data[level : level + C],), enter=True)
        return kern.intt(sa, lp, "exit")

    @staticmethod
    def _check_share_args(ct: Ciphertext, sk: SecretKey):
        if ct.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=False)
        if not sk.has_flag(FLAGS.NTT_STATE):
            raise errors.NTTStateError(expected=True)

    def multiparty_decrypt_head(self, ct: Ciphertext, sk: SecretKey):
        """ct0 + a*sk for the initiating party."""
        self._check_share_args(ct, sk)
        lp = self._lp(ct.level, False)
        C = lp.num_channels
        sa = self._partial_sa(ct, sk)
        return mont.mont_add(ct.data[0][..., :C, :], sa, lp.pack)

    def multiparty_decrypt_partial(self, ct: Ciphertext, sk: SecretKey):
        """a*sk for each non-initiating party."""
        self._check_share_args(ct, sk)
        return self._partial_sa(ct, sk)

    def multiparty_decrypt_fusion(
        self, pcts: list, level: int = 0, final_round: bool = True,
        is_real: bool = False,
    ):
        """Sum the partial decryptions, scale, and decode to a message."""
        lp = self._lp(level, False)
        C = lp.num_channels
        pt = pcts[0]
        for pct in pcts[1:]:
            pt = mont.mont_add(pt, pct, lp.pack)
        pt = mont.reduce_2q(pt, lp.pack)

        scaled = _final_scale(
            pt, self.params.base_lp(), self.params.final_scalar[level],
            self._rounding_half, base_at=C - 1, final_round=final_round,
        )
        decoded = codec.decode(
            np.asarray(scaled.cpu()).reshape(-1),
            scale=self.ckksCfg.scale,
            correction=self.corrections[level],
            norm=self.norm,
        )[: self.num_slots]
        return decoded.real if is_real else decoded

    # ------------------------------------------------------------------
    # Multiparty key switching / rotation / Galois.
    # ------------------------------------------------------------------

    def multiparty_create_key_switching_key(
        self, sk_src: SecretKey, sk_dst: SecretKey, a=None
    ) -> KeySwitchKey:
        """The single-party ksk's construction, under per-part common
        ``a``."""
        return self.create_key_switching_key(sk_src, sk_dst, a=a)

    def multiparty_create_rotation_key(
        self, sk: SecretKey, delta: int, a=None
    ) -> RotationKey:
        return self._create_rotation_key(delta, a=a, sk=sk)

    def _sum_ksk_shares(self, ksks: list, component=(0,)):
        """The parties' ksk parts summed, ``component`` by component."""
        lp = self._lp(0, True)
        parts = []
        for part_idx in range(len(ksks[0].data)):
            comps = list(ksks[0].data[part_idx])
            for other in ksks[1:]:
                for c in component:
                    comps[c] = mont.mont_add(
                        comps[c], other.data[part_idx][c], lp.pack
                    )
            parts.append(tuple(comps))
        return parts

    def multiparty_generate_rotation_key(
        self, rotks: list[RotationKey]
    ) -> RotationKey:
        parts = self._sum_ksk_shares(rotks, component=(0,))
        return RotationKey(
            data=tuple(parts),
            flags=rotks[0]._flags,
            level=rotks[0].level,
            **{**rotks[0].misc},
        )

    def generate_rotation_crs(self, rotk: RotationKey | KeySwitchKey):
        return [part[1] for part in rotk.data]

    def generate_galois_crs(self, galk: GaloisKey):
        return [
            [part[1] for part in rotk.data] for rotk in galk.data
        ]

    def multiparty_create_galois_key(
        self, sk: SecretKey, a: list
    ) -> GaloisKey:
        deltas = [2**i for i in range(self.ckksCfg.logN - 1)]
        parts = [
            self.multiparty_create_rotation_key(sk, deltas[i], a=a[i])
            for i in range(len(deltas))
        ]
        return GaloisKey(
            data=parts,
            flags=FLAGS.NTT_STATE | FLAGS.MONTGOMERY_STATE
            | FLAGS.INCLUDE_SPECIAL,
            level=0,
            **self._meta(),
        )

    def multiparty_generate_galois_key(
        self, galks: list[GaloisKey]
    ) -> GaloisKey:
        rotks = [
            self.multiparty_generate_rotation_key(
                [g.data[rot_idx] for g in galks])
            for rot_idx in range(len(galks[0].data))
        ]
        return GaloisKey(
            data=rotks,
            flags=galks[0]._flags,
            level=galks[0].level,
            **{**galks[0].misc},
        )

    # ------------------------------------------------------------------
    # Multiparty evaluation key (3-round protocol).
    # ------------------------------------------------------------------

    def multiparty_sum_evk_share(self, evks_share: list[DataStruct]):
        parts = self._sum_ksk_shares(evks_share, component=(0,))
        return EvaluationKey(
            data=tuple(parts),
            flags=evks_share[0]._flags,
            level=evks_share[0].level,
            **{**evks_share[0].misc},
        )

    def multiparty_mult_evk_share_sum(
        self, evk_sum: DataStruct, sk: SecretKey
    ):
        lp = self._lp(0, True)
        parts = [
            (mont.mont_mult(p0, sk.data, lp.pack),
             mont.mont_mult(p1, sk.data, lp.pack))
            for p0, p1 in evk_sum.data
        ]
        return EvaluationKey(
            data=tuple(parts),
            flags=evk_sum._flags,
            level=evk_sum.level,
            **{**evk_sum.misc},
        )

    def multiparty_sum_evk_share_mult(
        self, evk_sum_mult: list[DataStruct]
    ):
        parts = self._sum_ksk_shares(evk_sum_mult, component=(0, 1))
        return EvaluationKey(
            data=tuple(parts),
            flags=evk_sum_mult[0]._flags,
            level=evk_sum_mult[0].level,
            **{**evk_sum_mult[0].misc},
        )
