"""The resident PDHG kernel's tile plan (ops/lpsolve_kernels.py
`resident_plan`), a plain host function, on the CPU.

The plan decides before a launch, from the envelope and two device
attributes only, whether the scaled operator B × (me+mi) × n stays in the
SMs' shared memory for the whole solve (the resident kernel, one block per
tile) or is streamed (the streaming kernel).  The card here is an H100 SXM:
132 SMs and 227 KB (232 448 bytes) of shared memory a block can opt into,
of which the resident kernel's static shared memory takes 18 592 bytes."""

import numpy as np
import pytest

from karpenter_tpu_torch.ops import lpsolve_kernels as lk

SMS = 132
OPTIN = 232_448
STATIC = 18_592
HEADLINE = (1, 768, 8192)       # the guided headline's master (me 256, mi 512)

# name -> (B, mt, n, sms, smem per block, expected: "plan" | "fewer" | None)
ENVELOPES = {
    "headline at 227 KB": (*HEADLINE, SMS, OPTIN, "plan"),
    "headline, less the static shared memory": (*HEADLINE, SMS,
                                                OPTIN - STATIC, "plan"),
    "headline B=2": (2, 768, 8192, SMS, OPTIN - STATIC, None),
    "lp-100 master 1": (1, 192, 512, SMS, OPTIN - STATIC, "plan"),
    "lp-100 master 2": (1, 384, 2048, SMS, OPTIN - STATIC, "plan"),
    "lp-250 master 1": (1, 384, 1024, SMS, OPTIN - STATIC, "plan"),
    "lp-250 master 2": (1, 512, 4096, SMS, OPTIN - STATIC, "plan"),
    "random (20, 5, 8)": (1, 16, 32, SMS, OPTIN - STATIC, "fewer"),
    "random (80, 20, 30)": (1, 64, 128, SMS, OPTIN - STATIC, "fewer"),
    "batch B=4 at 32": (4, 64, 32, SMS, OPTIN - STATIC, "fewer"),
    "odd widths": (3, 7, 5, SMS, OPTIN - STATIC, "fewer"),
    "random (1500, 40, 60)": (1, 128, 2048, SMS, OPTIN - STATIC, "plan"),
    "too wide for one row": (1, 2, 60_000, SMS, OPTIN - STATIC, "plan"),
    "over the card": (1, 8192, 8192, SMS, OPTIN - STATIC, None),
    "few SMs": (1, 768, 8192, 16, OPTIN - STATIC, None),
}


@pytest.mark.parametrize("name", sorted(ENVELOPES))
def test_resident_plan(name):
    B, mt, n, sms, smem, expect = ENVELOPES[name]
    plan = lk.resident_plan(B, mt, n, sms, smem)
    if expect is None:
        assert plan is None
        return
    assert plan is not None
    assert plan.blocks <= sms and plan.smem_bytes <= smem
    assert plan.band_cols % 4 == 0
    if expect == "fewer":
        assert plan.blocks < sms
    # every element of the B × mt × n operator in exactly one tile, and no
    # tile empty or outside it
    cover = np.zeros((B, mt, n), np.int32)
    tiles = list(plan.tiles())
    assert len(tiles) == plan.blocks
    for b, r0, r1, c0, c1 in tiles:
        assert 0 <= b < B and 0 <= r0 < r1 <= mt and 0 <= c0 < c1 <= n
        assert r1 - r0 <= plan.band_rows and c1 - c0 <= plan.band_cols
        assert lk.resident_smem_bytes(plan.band_rows, plan.band_cols) \
            <= smem
        cover[b, r0:r1, c0:c1] += 1
    assert (cover == 1).all()
