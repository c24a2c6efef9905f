"""R1CS proof container and wire encoding (reference src/r1cs/proof.rs).

Layout (arkworks derived CanonicalSerialize, compressed): 11 points
A_I1, A_O1, S1, A_I2, A_O2, S2, T_1, T_3, T_4, T_5, T_6 (no T_2 — its
commitment is folded into the V term), 3 scalars t_x, t_x_blinding,
e_blinding, then the nested inner-product proof.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import R1CSFormatError
from ..ipp import InnerProductProof

_POINT_FIELDS = ("A_I1", "A_O1", "S1", "A_I2", "A_O2", "S2",
                 "T_1", "T_3", "T_4", "T_5", "T_6")
_SCALAR_FIELDS = ("t_x", "t_x_blinding", "e_blinding")


@dataclass
class R1CSProof:
    A_I1: object
    A_O1: object
    S1: object
    A_I2: object
    A_O2: object
    S2: object
    T_1: object
    T_3: object
    T_4: object
    T_5: object
    T_6: object
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp_proof: InnerProductProof

    def to_bytes(self, curve) -> bytes:
        out = bytearray()
        for name in _POINT_FIELDS:
            out += curve.serialize_compressed(getattr(self, name))
        for name in _SCALAR_FIELDS:
            out += curve.fr.to_bytes(getattr(self, name))
        out += self.ipp_proof.to_bytes(curve)
        return bytes(out)

    @classmethod
    def from_bytes(cls, curve, data: bytes) -> "R1CSProof":
        try:
            psize = len(curve.serialize_compressed(curve.gen))
            ssize = curve.fr.byte_size
            off = 0
            kwargs = {}
            for name in _POINT_FIELDS:
                kwargs[name] = curve.deserialize_compressed(data[off: off + psize])
                off += psize
            for name in _SCALAR_FIELDS:
                kwargs[name], _ = curve.fr.from_bytes(data[off: off + ssize])
                off += ssize
            ipp, consumed = InnerProductProof.from_bytes(curve, data[off:])
            off += consumed
            if off != len(data):
                raise ValueError("trailing bytes")
            return cls(ipp_proof=ipp, **kwargs)
        except (ValueError, IndexError) as e:
            raise R1CSFormatError(str(e)) from e
