"""The hand-written CUDA repack kernels against their plain PyTorch version.

Needs a CUDA device and skips without one. Imports no JAX, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_repack_cuda.py

The cases are ``ops/repack_cases.py``'s: the ones
``tests/test_torch_consolidate.py`` holds the plain version to against the
JAX package on the CPU (the random family of ``tests/test_repack_pallas.py``,
a candidate subset, an empty node, nothing-fits, self-exclusion, a float
hostname cap), the float cap's uint16 wire, the cases aimed at the table
design (a row touched twice, negative counts, candidates filling hundreds
of rows, nodes without pods), two wide ones with sparse targets (N = 8,192
and N = 12,000) and a dense cluster of 5,000 large nodes with 8 live slots
each. ``ok`` must be equal exactly. A negative request must fault the
kernels rather than give a verdict (in a child process: a device fault
ends its CUDA context).
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu_torch.ops import consolidate, repack_cases, repack_cuda


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cases = {**repack_cases.small_cases(), **repack_cases.path_cases(),
             **repack_cases.large_cases(), **repack_cases.dense_cases()}
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
        if name in ("float_cap", "two_tiles_12000", "long_touch", "repeat_group"):
            assert 0 < int(got.sum()) < got.numel(), name  # verdicts split


@pytest.mark.cuda
def test_cuda_kernel_faults_on_a_negative_request():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    child = textwrap.dedent("""
        import torch
        from karpenter_provider_aws_tpu_torch.ops import repack_cuda
        dev = torch.device("cuda")
        free = torch.tensor([[0.0, 0.0], [0.0, 5.0], [0.0, 0.0]], device=dev)
        requests = torch.tensor([[-1.0, 1.0], [1.0, 0.0]], device=dev)
        gids = torch.tensor([[0, 1, 1]] * 3, dtype=torch.int32, device=dev)
        counts = torch.tensor([[1, 1, 1], [0, 0, 0], [0, 0, 0]], dtype=torch.int32, device=dev)
        cap = torch.ones(2, 3, dtype=torch.bool, device=dev)
        cand = torch.zeros(1, dtype=torch.int32, device=dev)
        try:
            ok = repack_cuda.repack_check(free, requests, gids, counts, cap, cand)
            print("verdict", ok.tolist())
        except RuntimeError as e:
            print("raised", type(e).__name__)
    """)
    out = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                         timeout=300)
    assert "raised " in out.stdout, (out.stdout, out.stderr[-2000:])  # a RuntimeError
    assert "verdict" not in out.stdout
    assert "requests[0, 0]" in out.stdout + out.stderr
