"""The hand-written CUDA repack kernel against its plain PyTorch version.

Needs a CUDA device and skips without one. Imports no JAX, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_repack_cuda.py

The cases are ``ops/repack_cases.py``'s: the ones
``tests/test_torch_consolidate.py`` holds the plain version to against the
JAX package on the CPU (the random family of ``tests/test_repack_pallas.py``,
a candidate subset, an empty node, nothing-fits, self-exclusion, a float
hostname cap), the float cap's uint16 wire, and two past the shared-memory
budget, where the kernel runs on its global scratch: N = 8,192 (one pass of
its node loop) and N = 12,000 (two passes). ``ok`` must be equal exactly.
"""

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu_torch.ops import consolidate, repack_cases, repack_cuda


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cases = {**repack_cases.small_cases(), **repack_cases.large_cases()}
    float_cap = cases["float_cap"]
    cases["uint16_cap"] = float_cap[:4] + (float_cap[4].astype(np.uint16),) + float_cap[5:]
    for name, args in sorted(cases.items()):
        t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args]
        launches = repack_cuda.LAUNCHES
        got = repack_cuda.repack_check(*t)
        torch.cuda.synchronize()
        assert repack_cuda.LAUNCHES == launches + 1, name
        want = consolidate.repack_check(*t)
        assert got.dtype == torch.bool and got.shape == want.shape, name
        assert torch.equal(got, want), (name, int((got != want).sum()))
        if name == "self_exclusion":
            assert got.tolist() == [False, True]
        if name == "nothing_fits":
            assert not got.any()
        if name in ("float_cap", "two_tiles_12000"):
            assert 0 < int(got.sum()) < got.numel(), name  # verdicts split
