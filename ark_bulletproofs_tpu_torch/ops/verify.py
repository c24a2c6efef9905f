"""Device vector helpers shared with the verifier (counterpart of
ark_bulletproofs_tpu/ops/verify.py).

Only `_pow_vector` is ported so far, for the prover's vector phase
(ops/prove.py). The rest of the JAX file, the device scalar pipeline of
the R1CS verifier and `ipa_gh_msm`, comes with a later slice.
"""

from __future__ import annotations

import torch

from . import field as df


def _pow_vector(fr, base: torch.Tensor, n: int, lg_n: int) -> torch.Tensor:
    """[base^0, base^1, ..., base^(n-1)] in Montgomery form, (16, n), for a
    (16, 1) Montgomery `base`: lg_n squarings give base^(2^k), then lg_n
    masked products over the bits of the lane index."""
    idx = torch.arange(n, device=base.device)
    one = df.mont_one(fr, n, base.device)
    v = one
    pw = base
    for k in range(lg_n):
        mask = ((idx >> k) & 1) > 0
        v = df.mont_mul(fr, v, df.select(mask, pw.expand(-1, n), one))
        if k + 1 < lg_n:
            pw = df.mont_mul(fr, pw, pw)
    return v
