"""The torch FFD op against the JAX package's XLA scan and Pallas kernel.

The same numpy inputs go to ``ops.ffd.ffd_solve`` (XLA scan on the CPU),
``ops.ffd_pallas.ffd_solve_pallas(interpret=True)`` and the torch package's
plain ``ffd_solve``. All three are the same deterministic algorithm, so
integer outputs (placements, unplaced, committed types, windows, open count)
must be equal exactly. ``node_price`` and ``used`` use the tolerance of
``tests/test_ffd_pallas.py`` (f32 accumulation order may differ).
``rank_launch_options`` and ``compact_plan`` are exact, tie order included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.ops import ffd as jffd
from karpenter_provider_aws_tpu.ops.ffd_pallas import ffd_solve_pallas
from karpenter_provider_aws_tpu_torch.interop import state_from_reference
from karpenter_provider_aws_tpu_torch.ops import ffd as tffd
from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
from karpenter_provider_aws_tpu_torch.ops.ffd_cases import random_problem
from test_torch_ffd_cuda import CASES, _port, _torch_args


def _assert_same(ref, got, Z, C):
    """``ref``: a JAX-package FFDResult; ``got``: a torch FFDResult."""
    np.testing.assert_array_equal(np.asarray(ref.placed), got.placed.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(ref.unplaced), got.unplaced.cpu().numpy())
    n = int(ref.n_open)
    assert int(got.n_open) == n
    np.testing.assert_array_equal(np.asarray(ref.node_type)[:n], got.node_type.cpu().numpy()[:n])
    np.testing.assert_allclose(
        np.asarray(ref.node_price)[:n], got.node_price.cpu().numpy()[:n], rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(ref.used)[:n], got.used.cpu().numpy()[:n], rtol=1e-5, atol=1e-3
    )
    np.testing.assert_array_equal(
        np.asarray(ref.node_window)[:n],
        tffd.unpack_window_bits(got.node_window.cpu().numpy(), Z, C)[:n],
    )


def _reference(case, pallas=False):
    _name, args, N, init, n_pre, Z, C = case
    requests, counts, compat, capacity, price, gw, tw, mpn = args
    kw = dict(max_per_node=mpn, max_nodes=N, n_pre=n_pre)
    if init is not None:
        nt, npr, us, cp, win = init
        kw["init_state"] = jffd._State(
            node_type=jnp.asarray(nt), node_price=jnp.asarray(npr), used=jnp.asarray(us),
            node_cap=jnp.asarray(cp), node_window=jnp.asarray(win),
            n_open=jnp.asarray(n_pre, dtype=jnp.int32),
        )
    if pallas:
        return ffd_solve_pallas(requests, counts, compat, capacity, price, gw, tw,
                                interpret=True, **kw)
    return jffd.ffd_solve(requests, counts, compat, capacity, price, gw, tw, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_xla_scan_and_pallas(name):
    case = CASES[name]
    got = _port(case, tffd.ffd_solve)
    ref = _reference(case)
    Z, C = case[5], case[6]
    _assert_same(ref, got, Z, C)
    _assert_same(_reference(case, pallas=True), got, Z, C)
    assert int(got.placed.sum()) > 0
    N, n_pre = case[2], case[4]
    slice_rows = -(-N // ffd_cuda.active_ctas(N, case[1][0].shape[1]))  # rows per CTA
    placed = got.placed.numpy()
    if name in ("row_exhaustion", "exhaustion_boundary"):
        assert int(got.unplaced.sum()) > 0 and int(got.n_open) == N
    if name == "exhaustion_boundary":  # the last trip crosses a slice edge
        edge = N // slice_rows * slice_rows
        assert slice_rows < N and 0 < edge < N
        assert ((placed[:, edge - 1] > 0) & (placed[:, edge] > 0)).any()
    if name in ("pre_opened", "pre_opened_capped"):
        assert int(got.placed[:, :n_pre].sum()) > 0
    if name == "pre_opened_capped":
        capped = case[1][7] < (1 << 30)
        assert capped.any() and int(placed[capped, :n_pre].sum()) == 0
    if name == "interleaved_zero_counts":
        zero = case[1][1] == 0
        assert zero[1:-1].any() and not placed[zero].any() and placed[~zero].any(1).all()
    if name == "open_span":  # an opened range and a first fit across slices
        assert len(set(np.nonzero(placed[0])[0] // slice_rows)) == 5
        assert len(set(np.nonzero(placed[1])[0] // slice_rows)) == 3
    if name == "r16":
        assert case[1][0].shape[1] == 16 and (case[1][0][:, 15] > 0).any()


def test_init_state_is_not_modified():
    case = CASES["pre_opened"]
    init = state_from_reference(*case[3], n_open=case[4], device="cpu")
    before = [t.clone() for t in init]
    targs, mpn = _torch_args(case[1])
    tffd.ffd_solve(*targs, max_per_node=mpn, max_nodes=case[2], init_state=init, n_pre=case[4])
    for a, b in zip(before, init):
        assert torch.equal(a, b)


def test_wrapper_takes_plain_version_on_cpu():
    case = CASES["random0"]
    launches = ffd_cuda.LAUNCHES
    got = _port(case, ffd_cuda.ffd_solve)
    want = _port(case, tffd.ffd_solve)
    assert ffd_cuda.LAUNCHES == launches
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def _rank_inputs(seed, ties: bool):
    rng = np.random.RandomState(seed)
    G, T, R, Z, C = 10, 70, 4, 3, 3
    args = random_problem(rng, G, T, R, Z, C)
    if ties:
        # many equal prices: tie order must keep the lowest type index first
        args = list(args)
        args[4] = np.where(np.isfinite(args[4]), np.float32(1.0), np.inf).astype(np.float32)
        args = tuple(args)
    requests, counts, compat, capacity, price, gw, tw, mpn = args
    res = jffd.ffd_solve(requests, counts, compat, capacity, price, gw, tw,
                         max_per_node=mpn, max_nodes=64)
    exotic = rng.rand(T) < 0.2
    return args, res, exotic


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_rank_launch_options_exact(seed, ties):
    args, res, exotic = _rank_inputs(seed, ties)
    requests, counts, compat, capacity, price, gw, tw, mpn = args
    k = 60
    want = jffd.rank_launch_options(
        res.placed, jnp.asarray(price), res.used, jnp.asarray(capacity),
        jnp.asarray(tw), res.node_window, res.node_type, jnp.asarray(exotic), k=k,
    )
    got = tffd.rank_launch_options(
        torch.from_numpy(np.array(res.placed)), torch.from_numpy(price),
        torch.from_numpy(np.array(res.used)), torch.from_numpy(capacity),
        torch.from_numpy(tffd.pack_window_bits(tw)),
        torch.from_numpy(tffd.pack_window_bits(np.asarray(res.node_window))),
        torch.from_numpy(np.array(res.node_type)), torch.from_numpy(exotic), k=k,
    )
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("max_entries", [8, 1024])
def test_compact_plan_exact(max_entries):
    _args, res, _exotic = _rank_inputs(0, False)
    want = jffd.compact_plan(res.placed, max_entries)
    got = tffd.compact_plan(torch.from_numpy(np.array(res.placed)), max_entries)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        assert np.asarray(w).dtype == g.numpy().dtype


def test_window_bits_roundtrip():
    rng = np.random.RandomState(3)
    win = rng.rand(17, 4, 3) < 0.5
    np.testing.assert_array_equal(
        tffd.unpack_window_bits(tffd.pack_window_bits(win), 4, 3), win
    )


def test_zero_request_group_places_its_count():
    """A group that requests nothing fits 2^30 per row. The prefix sum over
    rows is int64, so it cannot wrap and place more than the group has
    (an int32 running sum wraps past 2^31 on the fourth such row)."""
    N, R, T, n_pre = 8, 3, 2, 6
    cap = torch.full((N, R), 100.0)
    state = tffd._State(
        node_type=torch.zeros(N, dtype=torch.int32), node_price=torch.zeros(N),
        used=torch.zeros((N, R)), node_cap=cap, node_window=torch.ones(N, dtype=torch.int32),
        n_open=torch.tensor(n_pre, dtype=torch.int32),
    )
    res = tffd.ffd_solve(
        torch.zeros((1, R)), torch.tensor([10], dtype=torch.int32),
        torch.ones((1, T), dtype=torch.bool), torch.full((T, R), 100.0),
        torch.ones((1, T)), torch.ones(1, dtype=torch.int32),
        torch.ones(T, dtype=torch.int32), max_nodes=N, init_state=state, n_pre=n_pre,
    )
    assert res.placed.tolist() == [[10, 0, 0, 0, 0, 0, 0, 0]]
    assert int(res.unplaced.sum()) == 0 and int(res.n_open) == n_pre
