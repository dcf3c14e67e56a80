"""The repack kernel's table algorithm, mirrored in numpy, against the plain
``repack_check`` on the CPU.

``csrc/repack.cu`` does not walk every node for every candidate. It builds
one fit table per screen on the base free capacity (phase A: per group g
and node n the fit ``k_g[n]``, its sum over the nodes ``total_g``, and the
list of rows with room, ``k_g[n] > 0``, in index order), and then gives
each candidate its verdict from table arithmetic (phase B):

- a live slot places ``min(cnt, total_g - k_g[i] + D)`` pods, where ``D``
  sums, over the rows the candidate's earlier slots may have filled (each
  one's rows with room up to its stop row, a row once), the fit on the
  row's replayed free less the table's;
- an earlier live slot keeps only its stop row (where its running total of
  the fit reaches its count; every row before it takes its whole fit) and
  the remainder it places there. A row's free is replayed from the base
  free through those pairs, in slot order. A filled row never has more room
  than the table gives it (requests are not negative), so no row off a
  group's list takes a pod;
- once pods are left over and no later count is negative, the verdict is no.

``mirror`` below is that algorithm step for step, in float32 with the
kernel's order of operations, and must give the plain version's ``ok``
exactly: on every case of ``ops/repack_cases.py`` and on a seeded
``hypothesis`` family. It lives here and not in the package: the package
has the kernel and the plain version, and this is the proof that the
kernel's algorithm is the plain version's function.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from karpenter_provider_aws_tpu_torch.ops import consolidate, repack_cases

jnp = pytest.importorskip("jax.numpy")

from karpenter_provider_aws_tpu.ops import consolidate as jcons  # noqa: E402

EPS = np.float32(1e-4)
BIG = np.float32(2.0 ** 30)
WARP = 32


def _cap_f32(cap):
    if cap.dtype == bool:
        return np.where(cap, BIG, np.float32(0)).astype(np.float32)
    return cap.astype(np.float32)


def _fit(f, req, capv):
    """The fit of one row in float32: min over the requested axes of
    floor((f + 1e-4) / req), clamped to [0, 2^30], min with the cap, then
    truncated."""
    kf = np.float32(np.inf)
    for r in np.nonzero(req > 0)[0]:
        kf = min(kf, np.floor(np.float32(f[r] + EPS) / req[r]))
    kf = min(max(kf, np.float32(0)), BIG)
    return int(min(np.float32(kf), capv))


def table(free, requests, capf):
    """Phase A: k[g, n] on the base free, its inclusive prefix P[g, n]
    (the kernel keeps only its last column, the total), and per group the
    rows with room in index order."""
    G, N = capf.shape
    k = np.array([[_fit(free[n], requests[g], capf[g, n]) for n in range(N)]
                  for g in range(G)], dtype=np.int64).reshape(G, N)
    return k, np.cumsum(k, axis=1), [np.nonzero(row > 0)[0].tolist() for row in k]


class _Candidate:
    """Phase B for one candidate: its slots, their history of (stop row,
    remainder) pairs, and the replay of a row's free through them."""

    def __init__(self, free, requests, capf, k, P, targets, i, gids, counts, stats, strict):
        self.strict = strict
        self.free, self.requests, self.capf = free, requests, capf
        self.k, self.P, self.targets, self.i = k, P, targets, i
        self.gids, self.counts, self.stats = gids, counts, stats
        self.hist = {}

    def live(self, s):
        g = int(self.gids[s])
        return int(self.counts[s]) > 0 and 0 <= g < self.requests.shape[0]

    def may_fill(self, sp, n):
        return n <= self.hist[sp][0] and self.k[self.gids[sp]][n] > 0

    def fit_before(self, s, g, n):
        """g's fit on row n before slot s: replayed where an earlier slot
        may have filled the row, the table's where none did."""
        if n == self.i:
            return 0
        f, fills = None, 0
        for sp in range(s):
            if not self.live(sp) or not self.may_fill(sp, n):
                continue
            if f is None:
                f = self.free[n].copy()
                self.stats["replays"] += 1
            gp = int(self.gids[sp])
            stop, rem = self.hist[sp]
            kp = _fit(f, self.requests[gp], self.capf[gp, n])
            p = kp if n < stop else rem
            if p > 0:
                f = f - np.float32(p) * self.requests[gp]
                fills += 1
        self.stats["refilled"] += fills > 1
        if f is None:
            return int(self.k[g][n])
        kp = _fit(f, self.requests[g], self.capf[g, n])
        if self.strict:
            assert kp <= self.k[g][n], "more room than the table's"
        return kp

    def filled_delta(self, s, g):
        """D: over the rows the slots before s may have filled, each once."""
        d, rows = 0, 0
        for sp in range(s):
            if not self.live(sp) or self.hist[sp][0] < 0:
                continue
            for n in self.targets[self.gids[sp]]:
                if n > self.hist[sp][0]:
                    break
                if n == self.i or any(self.live(q) and self.may_fill(q, n) for q in range(sp)):
                    continue
                rows += 1
                d += self.fit_before(s, g, n) - int(self.k[g][n])
        self.stats["max_filled"] = max(self.stats["max_filled"], rows)
        return d

    def stop_row(self, s, g, cnt):
        """The first of g's rows with room where the running total of the
        fit reaches cnt, a warp's window of 32 at a time, and the remainder
        placed there."""
        carry, rows = 0, self.targets[g]
        for q in range(0, len(rows), WARP):
            self.stats["windows"] += 1
            for n in rows[q:q + WARP]:
                kn = self.fit_before(s, g, n)
                if carry + kn >= cnt:
                    self.stats["deepest_row"] = max(self.stats["deepest_row"], n)
                    return n, cnt - carry
                carry += kn
        return self.free.shape[0], 0

    def verdict(self):
        N = self.free.shape[0]
        live = [s for s in range(len(self.counts)) if self.counts[s] > 0]
        neg = [s for s in range(len(self.counts)) if self.counts[s] < 0]
        last, last_neg = (live[-1] if live else -1), (neg[-1] if neg else -1)
        leftover = 0
        for s in range(len(self.counts)):
            if leftover > 0 and s > last_neg:
                self.stats["stopped_early"] += 1
                break
            cnt, g = int(self.counts[s]), int(self.gids[s])
            if not self.live(s):
                leftover += cnt
                continue
            avail = int(self.P[g][N - 1]) - int(self.k[g][self.i]) + self.filled_delta(s, g)
            placed = min(cnt, avail)
            leftover += cnt - placed
            if s == last:
                continue
            if placed == cnt:
                self.hist[s] = self.stop_row(s, g, cnt)
            else:
                self.hist[s] = (N if placed > 0 else -1, 0)
        return leftover == 0


def mirror(free, requests, gids, gcounts, cap, cand, strict=True):
    """ok[C] by the kernel's algorithm, and ``stats``: stop-row windows,
    replayed rows, rows filled by two slots or more, the most rows one
    slot's D went over, the deepest stop row and the candidates stopped
    early. ``strict`` asserts the premise: a replayed row never has more
    room than the table gives it."""
    capf = _cap_f32(cap)
    k, P, targets = table(free, requests, capf)
    N = free.shape[0]
    ok = np.zeros(len(cand), bool)
    stats = {"windows": 0, "replays": 0, "refilled": 0, "max_filled": 0, "deepest_row": 0,
             "stopped_early": 0}
    for c, i in enumerate(cand):
        if 0 <= i < N:
            ok[c] = _Candidate(free, requests, capf, k, P, targets, int(i), gids[i],
                               gcounts[i], stats, strict).verdict()
    return ok, stats


def _plain(free, requests, gids, gcounts, cap, cand):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (free, requests, gids, gcounts, cap, cand)]
    return consolidate.repack_check(*t).numpy()


CASES = {**repack_cases.small_cases(seeds=8), **repack_cases.path_cases()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mirror_matches_plain(name):
    args = CASES[name]
    ok, _ = mirror(*args)
    np.testing.assert_array_equal(ok, _plain(*args))


def test_mirror_matches_plain_on_the_mirror_padded_case():
    """An encoded cluster's screen inputs padded as the device-resident
    mirror pads them (zero free and cap rows, zero-request groups, count-0
    slots, a float32 cap)."""
    from test_torch_consolidate import TORCHPKG, mixed

    args = repack_cases.mirror_cases(consolidate.encode_cluster(*mixed(TORCHPKG)))[
        "mirror_padded"]
    ok, _ = mirror(*args)
    np.testing.assert_array_equal(ok, _plain(*args))
    assert ok.any()


def test_uint16_wire_gives_the_float_caps_verdicts():
    args = CASES["float_cap"]
    wire = args[:4] + (args[4].astype(np.uint16),) + args[5:]
    np.testing.assert_array_equal(mirror(*wire)[0], _plain(*args))


def test_long_touch_fills_hundreds_of_rows():
    """Past any fixed list of rows: a later slot's D goes over the 129
    rows an earlier slot filled, one pod a row; 300 pods on 299 rows stop
    early."""
    ok, stats = mirror(*CASES["long_touch"])
    assert ok[0] and not ok[1]
    assert stats["max_filled"] >= 129 and stats["stopped_early"] > 0


def test_repeat_group_touches_rows_twice_and_splits():
    ok, stats = mirror(*CASES["repeat_group"])
    assert stats["refilled"] > 0
    assert 0 < ok.sum() < ok.size


def test_negative_counts_cancel_unplaced_pods():
    ok, _ = mirror(*CASES["negative_count"])
    assert ok.tolist() == [True, False, True, False, False, False]


def test_nodes_without_pods_all_pass():
    ok, stats = mirror(*CASES["no_groups"])
    assert ok.all() and stats["replays"] == 0


def test_random_family_replays_filled_rows():
    """At GMAX 32 later slots see rows the earlier ones filled."""
    _, stats = mirror(*CASES["random2_64x5x32"])
    assert stats["replays"] > 0 and stats["max_filled"] > 0


def test_a_negative_request_breaks_the_premise():
    """The kernels take no negative request, and this is why: group 0
    gives back capacity on axis 0, so the row it fills gains room for
    group 1, which the table listed nowhere. The plain version places
    slot 1 there and refuses slot 2; the table algorithm, without its
    premise, passes the candidate. The strict mirror stops at the premise,
    as the kernels trap on such a request."""
    free = np.array([[0, 0], [0, 5], [0, 0]], np.float32)
    requests = np.array([[-1, 1], [1, 0]], np.float32)
    gids = np.array([[0, 1, 1]] * 3, np.int32)
    gcounts = np.array([[1, 1, 1], [0, 0, 0], [0, 0, 0]], np.int32)
    args = (free, requests, gids, gcounts, np.ones((2, 3), bool), np.array([0], np.int32))
    assert _plain(*args).tolist() == [False]
    assert mirror(*args, strict=False)[0].tolist() == [True]
    with pytest.raises(AssertionError, match="more room than the table"):
        mirror(*args)


@pytest.mark.parametrize("name", sorted(repack_cases.large_cases()))
def test_mirror_matches_plain_on_large_cases_with_sparse_targets(name):
    """The widest cases, on 40 candidates each: the rows an earlier slot
    fills lie thousands of rows apart and far in."""
    args = repack_cases.large_cases()[name]
    args = args[:5] + (np.arange(40, dtype=np.int32),)
    ok, stats = mirror(*args)
    np.testing.assert_array_equal(ok, _plain(*args))
    assert stats["windows"] > 10 and stats["deepest_row"] > 4000


def test_mirror_matches_plain_on_a_dense_cluster():
    """``dense_cases`` at 600 nodes: 150-230 pods a node in 8 live slots,
    so each candidate's earlier slots fill rows its later ones see."""
    args = repack_cases.dense_cases(n_nodes=600)["dense_600"]
    ok, stats = mirror(*args)
    np.testing.assert_array_equal(ok, _plain(*args))
    assert stats["replays"] > 600 and 0 < ok.sum()


def test_dense_case_holds_150_to_230_pods_on_large_nodes():
    (free, requests, gids, gcounts, cap, cand), = repack_cases.dense_cases().values()
    assert free.shape == (5000, 10) and gids.shape == (5000, 8)
    pods = gcounts.sum(axis=1)
    assert pods.min() >= 150 and pods.max() <= 230 and (gcounts > 0).all()
    assert (free >= 0).all() and (requests[:, 2] == 1).all()
    alloc_pods = free[:, 2] + pods  # the pods axis: ENI-limited counts
    assert set(np.unique(alloc_pods).tolist()) <= {234.0, 737.0}
    assert all(len(set(row)) == 8 for row in gids.tolist())
    assert cap.dtype == np.uint16 and 0.05 < (cap == 0).mean() < 0.15


@pytest.mark.parametrize("name", sorted(set(repack_cases.path_cases()) - {"no_groups"}))
def test_path_cases_plain_matches_reference(name):
    """The new cases hold the plain version to the JAX package's XLA
    ``repack_check`` too, so the mirror is held to the reference. Not
    ``no_groups``: with no slot column the reference's scan indexes an
    axis of size 0 while it traces, and raises."""
    args = CASES[name]
    want = np.asarray(jcons.repack_check(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(_plain(*args), want.astype(bool))


def test_large_cases_have_sparse_targets_far_in():
    """The two widest cases: compatibility under 0.2%, so the first rows a
    group can take lie far in, and at 12,000 the first 8,192 rows hold
    about a third as many targets as the 3,808 past them."""
    large = repack_cases.large_cases()
    assert sorted((a[0].shape[0], a[0].shape[1]) for a in large.values()) == [
        (8192, 10), (12000, 10)]
    for name, (free, _req, _gids, gcounts, cap, cand) in large.items():
        assert cap.dtype == bool and cap.mean() < 0.002, name
        assert cand.tolist() == list(range(free.shape[0]))
        assert (gcounts > 0).any(axis=1).mean() > 0.5
        first = [int(np.argmax(row)) for row in cap if row.any()]
        assert np.median(first) > 16 * WARP, name  # far past one window
    cap = large["two_tiles_12000"][4]
    assert 0 < cap[:, :8192].sum() < cap[:, 8192:].sum()


@st.composite
def problems(draw):
    seed = draw(st.integers(0, 2**31 - 1))
    N = draw(st.integers(1, 40))
    G = draw(st.integers(1, 6))
    S = draw(st.integers(1, 8))
    cap_kind = draw(st.sampled_from(["bool", "uint16", "float"]))
    rng = np.random.RandomState(seed)
    R = 9
    free = (rng.rand(N, R) * rng.choice([2.0, 6.0])).astype(np.float32)
    requests = (rng.rand(G, R) * 2).astype(np.float32)
    requests[rng.rand(G, R) < 0.6] = 0.0
    gids = rng.randint(0, min(G, 2) if rng.rand() < 0.5 else G, (N, S)).astype(np.int32)
    gcounts = rng.randint(-1, 6, (N, S)).astype(np.int32)
    if cap_kind == "bool":
        cap = rng.rand(G, N) < rng.rand()
    elif cap_kind == "uint16":
        cap = np.where(rng.rand(G, N) < 0.7, rng.randint(0, 5, (G, N)), 60000).astype(np.uint16)
    else:
        cap = (rng.randint(0, 4, (G, N)) * (rng.rand(G, N) < 0.8)).astype(np.float32)
    cand = rng.permutation(N)[: rng.randint(1, N + 1)].astype(np.int32)
    return free, requests, gids, gcounts, cap, cand


@settings(max_examples=100, deadline=None, derandomize=True)
@given(problems())
def test_mirror_matches_plain_on_random_problems(args):
    ok, _ = mirror(*args)
    np.testing.assert_array_equal(ok, _plain(*args))
