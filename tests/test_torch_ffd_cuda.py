"""The hand-written CUDA FFD kernel against its plain PyTorch version.

Needs a CUDA device and skips without one. Imports no JAX, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_ffd_cuda.py

The cases are ``ops/ffd_cases.py``'s: the small ones, which
``tests/test_torch_ffd.py`` holds the plain version to against the JAX
package on the CPU (a random family, row exhaustion, pre-opened rows,
count-0 groups between real ones, an opened range across the kernel's
per-CTA slices, row exhaustion across a slice edge, R = 16, pre-opened rows
beside hostname-capped groups), and three only the card runs: the kernel's
global-memory branch (20,480 rows, 12,000 pre-opened), T = 2,048, and a
group that requests nothing (its fit is 2^30 a row).
The lane launch (``ffd_solve_lanes``: 8 lanes in one launch, each from no
open rows, built by the optimizer lane's own ``first_round``, so the lanes
differ in group order and price mask as its lanes do) is held to 8 plain
solves on the one-CTA branch (256 rows), the 8-CTA shared-memory branch
(3,300 and 4,096 rows) and the global-memory branch (20,480 rows).
Integers must be equal exactly; ``node_price`` and ``used`` to rtol 1e-6 /
atol 1e-3 (f32 accumulation order may differ).
"""

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu_torch.interop import state_from_reference
from karpenter_provider_aws_tpu_torch.ops import ffd as tffd
from karpenter_provider_aws_tpu_torch.ops import ffd_cases, ffd_cuda
from karpenter_provider_aws_tpu_torch.scheduling import optimizer


def _torch_args(args, device="cpu"):
    requests, counts, compat, capacity, price, gw, tw, mpn = args

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(requests), t(counts), t(compat), t(capacity), t(price),
            t(tffd.pack_window_bits(gw)), t(tffd.pack_window_bits(tw))), t(mpn)


#: name -> (name, args, max_nodes, init arrays or None, n_pre, Z, C)
CASES = {name: (name, *case) for name, case in ffd_cases.small_cases().items()}


def _port(case, solve, device="cpu"):
    _name, args, N, init, n_pre, Z, C = case
    targs, mpn = _torch_args(args, device)
    state = None
    if init is not None:
        state = state_from_reference(*init, n_open=n_pre, device=device)
    return solve(*targs, max_per_node=mpn, max_nodes=N, init_state=state, n_pre=n_pre)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    card = {name: (name, *case) for name, case in ffd_cases.card_cases().items()}
    assert not ffd_cuda.resident(card["global_branch"][2], 10)
    for name, case in sorted({**CASES, **card}.items()):
        launches = ffd_cuda.LAUNCHES
        got = _port(case, ffd_cuda.ffd_solve, device="cuda")
        torch.cuda.synchronize()
        assert ffd_cuda.LAUNCHES == launches + 1, name
        want = _port(case, tffd.ffd_solve, device="cuda")
        assert int(want.placed.sum()) > 0, name
        for field in ("placed", "unplaced", "n_open", "node_type", "node_window"):
            assert torch.equal(getattr(got, field), getattr(want, field)), (name, field)
        torch.testing.assert_close(got.node_price, want.node_price, rtol=1e-6, atol=1e-3)
        torch.testing.assert_close(got.used, want.used, rtol=1e-6, atol=1e-3)

    # the lane launch: 8 lanes in ONE launch against 8 plain solves, on each
    # branch of the kernel
    lanes = 8
    for name in ("random0", "exhaustion_boundary", "open_span", "global_branch"):
        _name, args, N, _init, _n_pre, _Z, _C = {**CASES, **card}[name]
        (requests, counts, compat, capacity, price, gw, tw), mpn = _torch_args(args, "cuda")
        inp = dict(requests=requests, counts=counts, compat=compat, capacity=capacity,
                   price=price, group_window=gw, type_window=tw, max_per_node=mpn)
        *targs, mpn = optimizer.first_round(inp, lanes, seed=1)
        launches = ffd_cuda.LAUNCHES
        got = ffd_cuda.ffd_solve_lanes(*targs, mpn, max_nodes=N)
        torch.cuda.synchronize()
        assert ffd_cuda.LAUNCHES == launches + 1, name
        for lane in range(lanes):
            want = tffd.ffd_solve(*(a[lane] for a in targs), max_per_node=mpn[lane],
                                  max_nodes=N)
            assert int(want.placed.sum()) > 0, (name, lane)
            for field in ("placed", "unplaced", "n_open", "node_type", "node_window"):
                assert torch.equal(getattr(got, field)[lane], getattr(want, field)), \
                    (name, lane, field)
            torch.testing.assert_close(got.node_price[lane], want.node_price,
                                       rtol=1e-6, atol=1e-3)
            torch.testing.assert_close(got.used[lane], want.used, rtol=1e-6, atol=1e-3)
