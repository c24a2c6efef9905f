"""Curve registry: the curve cycle and companions supported by the reference.

- secq256k1 (reference tests/r1cs_secq256k1.rs): y^2 = x^3 + 7 over the
  secp256k1 *scalar* field; its scalar field is the secp256k1 base field
  (curve cycle, reference README.md:6-12).
- secp256k1: companion of the cycle.
- zorro (reference src/curve/zorro/): y^2 = x^3 + 6x + b over a 256-bit
  prime; scalar field is the ed25519 base field 2^255 - 19.
- curve25519 (reference tests/r1cs_curve25519.rs): the twisted-Edwards form
  of curve25519 with a = 486664, d = 486660, cofactor 8.
"""

from .. import fields
from .models import SWCurve, TECurve

secq256k1 = SWCurve(
    name="secq256k1",
    fq=fields.secq256k1_fq,
    fr=fields.secq256k1_fr,
    a=0,
    b=7,
    cofactor=1,
    # ark-secq256k1 0.4 generator.
    gen=(
        53718550993811904772965658690407829053653678808745171666022356150019200052646,
        28941648020349172432234515805717979317553499307621291159490218670604692907903,
    ),
)

secp256k1 = SWCurve(
    name="secp256k1",
    fq=fields.secp256k1_fq,
    fr=fields.secp256k1_fr,
    a=0,
    b=7,
    cofactor=1,
    gen=(
        55066263022277343669578718895168534326250603453777594175500187360389116729240,
        32670510020758816978083085130507043184471273380659243275938904335757337482424,
    ),
)

zorro = SWCurve(
    name="zorro",
    fq=fields.zorro_fq,
    fr=fields.zorro_fr,
    a=6,
    # reference src/curve/zorro/g1.rs:27-29
    b=7277470329389939148381533754641607518092114590371880995609984561067837624798,
    cofactor=1,
    # reference src/curve/zorro/g1.rs:41-46
    gen=(
        2,
        19711758720854384559191066596451394956860102304684364148268676039962145446511,
    ),
)

curve25519 = TECurve(
    name="curve25519",
    fq=fields.ed25519_fq,
    fr=fields.ed25519_fr,
    a=486664,
    d=486660,
    cofactor=8,
    # ark-curve25519 0.4 generator (y = 4/5 mod p).
    gen=(
        38213832894368730265794714087330135568483813637251082400757400312561599933396,
        46316835694926478169428394003475163141307993866256225615783033603165251855960,
    ),
)

ALL_CURVES = {
    "secq256k1": secq256k1,
    "secp256k1": secp256k1,
    "zorro": zorro,
    "curve25519": curve25519,
}
