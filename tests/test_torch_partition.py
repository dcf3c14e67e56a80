"""The port's scale tier against the JAX package's, on the CPU.

The (nodepool, zone) partition router of ``state/cluster.py``, the
partitioned encoder (``ops/encode_partition.py``), the per-partition screen
and its device mirrors (``ops/consolidate.py``, ``ops/device_state.py``),
partition lanes (``parallel/mesh.py``, ``TorchSolver.dispatch_encoded_batch``)
and the cross-partition merge, each held to the reference (the cases of
``tests/test_partition.py``) on twin stores built by the same helpers with
the same names:

- router: routing and per-partition changes, a claim without a node
  reaching every partition, a node's partition hop dirtying both sides,
  the journal ladder, overflow answering None;
- encode: under seeded churn (seeds 0-3, forced on or through ``auto``
  with a lowered threshold) the merged emission is canonical-equal to a
  global encode and equal field by field to the reference's partitioned
  emission; an unchanged pass returns the same object; a store reset drops
  every chain;
- screen: the partitioned mask equals the reference's (``vmap``), and on
  the cramped cross-partition case both give True globally and False
  partitioned on the same nodes;
- mirrors: one per partition, and after one partition loses its mirror
  the uploads, patches and hits count as the reference's;
- one disruption pass at 120 nodes in 4 partitions: the same disruptions
  and audit trail;
- lanes: a two-pool solve through one lane launch equals the pools solved
  one by one and ``TPUSolver``'s plan (config5 too); K = 3 lanes with
  distinct pre-opened rows equal the reference's lanes;
- merge: the reference's ``cost_lanes`` / ``cost_merged`` on config9's
  per-zone burst at 12,000 nodes, every pod kept;
- the multi-device paths raise ``NotImplementedError``.
Exact everywhere: host numpy and the plain FFD.
"""

import importlib
import os

import numpy as np
import pytest

from test_torch_controlplane import PACKAGES, package
from test_torch_encode_delta import (
    JAXPKG, TORCHPKG, _add_node, _cm_types, assert_same, mutate, portable,
)

from karpenter_provider_aws_tpu_torch.ops import cluster_cases


@pytest.fixture(autouse=True)
def _partitioned(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_PARTITION_ENCODE", "1")
    monkeypatch.setenv("KARPENTER_TPU_CHAINED_SCREEN", "1")
    monkeypatch.setenv("KARPENTER_TPU_SERIAL_LAUNCH", "1")
    for var in ("KARPENTER_TPU_PARTITION_SCREEN", "KARPENTER_TPU_PARTITION_SOLVE",
                "KARPENTER_TPU_PARTITION_MIN_NODES", "KARPENTER_TPU_DEVICE_STATE",
                "KARPENTER_TPU_OPTIMIZER", "KARPENTER_TPU_MARKET"):
        monkeypatch.delenv(var, raising=False)
    for root in PACKAGES:
        importlib.import_module(f"{root}.ops.device_state").reset_device_state()
    importlib.import_module("karpenter_provider_aws_tpu.ops.device_state").reset_chained_costs()
    yield


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def names_of(root):
    return cluster_cases.names(lambda n: mod(root, n))


def store(root, n_nodes=60, pods_per_node=4):
    """config4's builder in a bare journaled store of ``root``'s package:
    ``n_nodes`` c/m nodes over the catalog's four zones, node ``i``'s claim
    named ``default-{i:x}`` in both packages."""
    catalog = mod(root, "catalog").CatalogProvider()
    cluster = mod(root, "state.cluster").Cluster()
    cluster_cases.synth_cluster(names_of(root), cluster, catalog, n_nodes, pods_per_node,
                                name=lambda i: f"default-{i:x}")
    return cluster, catalog


def screen(root, ct):
    cons = mod(root, "ops.consolidate")
    if root.endswith("_torch"):
        return cons.consolidatable(ct, device="cpu")
    with cons.force_repack_backend("vmap"):
        return cons.consolidatable(ct)


def by_name(ct, mask):
    return dict(zip(ct.node_names, mask.tolist()))


# -- the router ---------------------------------------------------------------

def _routing(root, cl, catalog):
    keys = cl.partition_keys()
    node = next(iter(cl.nodes.values()))
    pkey = cl.partition_of(node.name)
    revs = {k: cl.partition_rev(k) for k in keys}
    p = mod(root, "models.pod").make_pods(1, "route", {"cpu": "100m"})[0]
    cl.apply(p)          # pending pod: name "" -> global only
    cl.bind_pod(p.uid, node.name)
    seen = {}
    for k in keys:
        ch = cl.partition_changes_since(k, revs[k])
        if k == pkey:
            assert ch and node.name in ch.get("pod", [])
        else:
            assert node.name not in ch.get("pod", []) and "node" not in ch
        seen[k] = ch
    return len(keys), pkey, seen


def _claim_broadcast(root, cl, catalog):
    keys = cl.partition_keys()
    revs = {k: cl.partition_rev(k) for k in keys}
    claim = mod(root, "models.nodeclaim").NodeClaim(
        name="unbound", nodepool_name="default", nodeclass_name="default")
    cl.apply(claim)
    seen = {k: cl.partition_changes_since(k, revs[k]) for k in keys}
    assert all(ch and "unbound" in ch.get("claim", []) for ch in seen.values())
    return seen


def _hop(root, cl, catalog):
    lbl = mod(root, "models.labels")
    node = next(iter(cl.nodes.values()))
    old = cl.partition_of(node.name)
    other = next(z for (_pool, z) in cl.partition_keys() if z != old[1])
    revs = {k: cl.partition_rev(k) for k in cl.partition_keys()}
    node.labels = {**node.labels, lbl.TOPOLOGY_ZONE: other}
    cl.note_node_update(node)
    new = cl.partition_of(node.name)
    assert new == (node.nodepool_name, other) != old
    seen = {k: cl.partition_changes_since(k, revs[k]) for k in (old, new)}
    assert all(ch and node.name in ch.get("node", []) for ch in seen.values())
    return old, new, seen, sorted(map(sorted, cl.partition_nodes().values()))


def _ladder(root, cl, catalog):
    st = mod(root, "state.cluster")
    caps = [st.journal_cap_for(n) for n in (10, 2000, 100_000, 10**9)]
    assert caps == [st.JOURNAL_CAP, 8192, 1 << 19, 1 << 22]
    big = st.Cluster()
    for i in range(1500):
        big.apply(st.Node(name=f"n{i}", nodepool_name="p",
                          labels={mod(root, "models.labels").TOPOLOGY_ZONE: "z"}))
    rev0 = big.rev
    for i in range(5000):
        big._record("pod", f"n{i % 1500}")
    assert big.changes_since(rev0) is not None  # the ladder held the window
    return caps, big._journal.maxlen, big.partition_rev(("p", "z"))


def _overflow(root, cl, catalog):
    node = next(iter(cl.nodes.values()))
    key = cl.partition_of(node.name)
    rev0 = cl.partition_rev(key)
    for _ in range(1500):
        cl._record("pod", node.name)  # a small partition's cap stays at 1024
    assert cl.partition_changes_since(key, rev0) is None
    return key


ROUTER = {"routing": _routing, "claim_without_node_broadcasts": _claim_broadcast,
          "node_hop_dirties_both_sides": _hop, "journal_ladder": _ladder,
          "journal_overflow_returns_none": _overflow}


@pytest.mark.parametrize("case", sorted(ROUTER))
def test_router_equals_reference(case):
    seen = []
    for root in PACKAGES:
        cl, catalog = store(root, n_nodes=24)
        seen.append(ROUTER[case](root, cl, catalog))
    assert seen[0] == seen[1]


# -- the partitioned encode -----------------------------------------------------

def twin_stores(n=48):
    """Twin stores of ``n`` c/m nodes round-robin over four zones, 1-3 pods
    each, for ``test_torch_encode_delta.mutate``'s churn."""
    tw = {}
    for pkg in (JAXPKG, TORCHPKG):
        catalog = pkg.CatalogProvider()
        cluster = pkg.Cluster()
        types = _cm_types(catalog)
        names = []
        for i in range(n):
            node = _add_node(pkg, cluster, catalog, i, types[i % len(types)],
                             ("zone-a", "zone-b", "zone-c", "zone-d")[i % 4])
            names.append(node.name)
            for p in pkg.make_pods(1 + i % 3, f"seed{i}", {"cpu": "250m", "memory": "512Mi"}):
                cluster.apply(p)
                cluster.bind_pod(p.uid, node.name)
        tw[pkg.root] = (cluster, catalog, {"names": names, "next_node": n, "pods": 0})
    return tw


def assert_exact(tw, tag):
    """The port's merged emission: partitioned, canonical-equal to its
    global encode, and field by field the reference's merged emission."""
    tcl, tcat, _ = tw[TORCHPKG.root]
    jcl, jcat, _ = tw[JAXPKG.root]
    inc = TORCHPKG.cons.encode_cluster(tcl, tcat)
    assert len(inc.__dict__["_partitions"]) > 1, tag
    fresh = TORCHPKG.cons._encode_cluster(tcl, tcat, 32)
    diffs = TORCHPKG.delta.canonical_equal(TORCHPKG.delta.canonical_form(inc),
                                           TORCHPKG.delta.canonical_form(fresh))
    assert not diffs, f"{tag}: the merged emission diverges from a global encode: {diffs}"
    ref = JAXPKG.cons.encode_cluster(jcl, jcat)
    assert len(ref.__dict__["_partitions"]) == len(inc.__dict__["_partitions"]), tag
    assert_same(portable(inc), portable(ref), tag)
    return inc


@pytest.mark.parametrize("seed,knob", [(0, "1"), (1, "1"), (2, "auto"), (3, "auto")])
def test_merged_emission_equals_reference_under_churn(seed, knob, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_PARTITION_ENCODE", knob)
    monkeypatch.setenv("KARPENTER_TPU_PARTITION_MIN_NODES", "32")
    from karpenter_provider_aws_tpu_torch.ops import encode_delta

    tw = twin_stores()
    assert_exact(tw, "cold")
    encode_delta.reset_encode_counts()
    for step in range(12):
        for pkg in (JAXPKG, TORCHPKG):
            cl, cat, state = tw[pkg.root]
            mutate(pkg, cl, cat, state, np.random.RandomState(100 * seed + step),
                   tag=f"p{seed}_{step}")
        assert_exact(tw, f"seed{seed} step{step}")
        assert set(encode_delta.LAST_ENCODE["partitions"]) >= {"default/zone-a"}
    assert encode_delta.ENCODE_COUNTS["patch"] > 0


def test_encoder_contracts():
    """An unchanged pass returns the same object; the auto switch stays off
    below the threshold; a reset store drops every partition's chain."""
    cl, catalog = store(PACKAGES[1], n_nodes=30)
    cons = mod(PACKAGES[1], "ops.consolidate")
    ct = cons.encode_cluster(cl, catalog)
    assert cons.encode_cluster(cl, catalog) is ct
    assert len(ct.__dict__["_partitions"]) == 4
    part = mod(PACKAGES[1], "ops.encode_partition")
    os.environ["KARPENTER_TPU_PARTITION_ENCODE"] = "auto"
    assert not part.partition_encode_active(cl)  # 30 nodes < 8,192
    os.environ["KARPENTER_TPU_PARTITION_ENCODE"] = "1"
    cl.__init__()
    assert cons.encode_cluster(cl, catalog) is None


def test_overflow_rebuild_and_warning_event_equal_reference():
    """A partition whose journal rolls twice in a row rebuilds with cause
    ``journal_overflow`` each time and publishes an
    ``EncodeJournalOverflow`` Warning for that partition, as the
    reference's does."""
    seen = []
    for root in PACKAGES:
        cl, catalog = store(root, n_nodes=8)
        cons, metrics = mod(root, "ops.consolidate"), mod(root, "metrics")
        cons.encode_cluster(cl, catalog)
        node = next(iter(cl.nodes.values()))
        key = cl.partition_of(node.name)
        c0 = metrics.ENCODE_CACHE.sum(path="cluster_part", outcome="full",
                                      cause="journal_overflow")
        for _ in range(2):
            with cl._lock:
                for _ in range(1500):  # roll ONE partition's journal
                    cl._record("pod", node.name)
            cons.encode_cluster(cl, catalog)
        events = [(e.reason, e.name, e.type) for e in mod(root, "events").default_recorder().query()
                  if e.reason == "EncodeJournalOverflow" and e.name == f"{key[0]}/{key[1]}"]
        assert events and events[-1][2] == "Warning"
        seen.append((metrics.ENCODE_CACHE.sum(path="cluster_part", outcome="full",
                                              cause="journal_overflow") - c0, events[-1]))
    assert seen[0] == seen[1] and seen[1][0] == 2


# -- the partitioned screen and its mirrors -------------------------------------

def _synth_screen(root):
    cl, catalog = store(root, n_nodes=80)
    return cl, catalog, None


def _cramped(root):
    catalog = mod(root, "catalog").CatalogProvider()
    cl = mod(root, "state.cluster").Cluster()
    return cl, catalog, cluster_cases.cramped_cross_partition(names_of(root), cl, catalog)


@pytest.mark.parametrize("case", ["synth80", "cramped"])
def test_partitioned_screen_equals_reference(case, monkeypatch):
    seen = []
    for root in PACKAGES:
        cl, catalog, cramped = (_cramped if case == "cramped" else _synth_screen)(root)
        ct = mod(root, "ops.consolidate").encode_cluster(cl, catalog)
        part = by_name(ct, screen(root, ct))
        monkeypatch.setenv("KARPENTER_TPU_PARTITION_SCREEN", "0")
        ct.__dict__.pop("_screen_mask_memo", None)
        whole = by_name(ct, screen(root, ct))
        monkeypatch.delenv("KARPENTER_TPU_PARTITION_SCREEN")
        # a partition-local repack tightens the global screen
        assert not any(part[n] and not whole[n] for n in part)
        if cramped:
            assert all(whole[n] and not part[n] for n in cramped)
        seen.append((part, whole))
    assert seen[0] == seen[1]
    if case == "cramped":
        from karpenter_provider_aws_tpu_torch.ops import consolidate

        # the merged tensors keep their mask memo under the backend that
        # ran: the whole screen's does not answer a partitioned one
        assert consolidate.LAST_SCREEN["backend"] == "torch-plain"
        for hit in (False, True):
            assert by_name(ct, screen(PACKAGES[1], ct)) == seen[1][0]
            assert consolidate.LAST_SCREEN["backend"] == "partitioned(torch-plain)"
            assert consolidate.LAST_SCREEN["memo_hit"] is hit


def test_one_partition_mirror_loss_counts_as_reference():
    """Churn, then one partition loses its device mirror: that partition
    uploads again, the others are patched, and the uploads, patches and
    hits count as the reference's; the masks stay equal."""
    deltas, masks = [], []
    for root in PACKAGES:
        cl, catalog = store(root, n_nodes=80)
        ds = mod(root, "ops.device_state")
        metric = mod(root, "metrics").DEVICE_STATE
        ct = mod(root, "ops.consolidate").encode_cluster(cl, catalog)
        screen(root, ct)
        for _key, pct, _off, _n in ct.__dict__["_partitions"]:
            assert ds.mirror_for(pct) is not None
        rng = np.random.RandomState(5)
        names = [n.name for n in cl.snapshot_nodes()]
        make_pods = mod(root, "models.pod").make_pods
        for i in range(10):
            if rng.rand() < 0.6:
                p = make_pods(1, f"storm{i}", {"cpu": "250m", "memory": "512Mi"})[0]
                cl.apply(p)
                cl.bind_pod(p.uid, names[rng.randint(len(names))])
            else:
                bound = [pp for pp in list(cl.pods.values())[:256] if pp.node_name]
                cl.unbind_pod(bound[rng.randint(len(bound))].uid)
        ds.drop_mirror(ct.__dict__["_partitions"][0][1])
        ct2 = mod(root, "ops.consolidate").encode_cluster(cl, catalog)
        before = {k: metric.value(path="screen", outcome=k) for k in ("upload", "patch", "hit")}
        masks.append(by_name(ct2, screen(root, ct2)))
        deltas.append({k: metric.value(path="screen", outcome=k) - v
                       for k, v in before.items()})
    assert deltas[0] == deltas[1]
    assert deltas[1]["upload"] == 1 and deltas[1]["patch"] >= 1
    assert masks[0] == masks[1]


# -- one disruption pass in four partitions --------------------------------------

def test_disruption_pass_in_four_partitions_equals_reference(monkeypatch):
    """120 config4 nodes over four zones in ``new_environment()``, through
    the ``auto`` switch with its threshold lowered: one consolidating
    disruption pass under a 10% budget disrupts the same claims and leaves
    the same audit trail as the reference's, and the port's screen went
    partition by partition."""
    monkeypatch.setenv("KARPENTER_TPU_PARTITION_ENCODE", "auto")
    monkeypatch.setenv("KARPENTER_TPU_PARTITION_MIN_NODES", "64")
    from karpenter_provider_aws_tpu_torch.ops import consolidate

    seen = []
    for root in PACKAGES:
        P = package(root)
        env = P.new_environment()
        try:
            env.apply_defaults(P.NodePool(
                name="default",
                requirements=[P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN,
                                            ("c", "m", "r"))],
                disruption=P.Disruption(consolidate_after_s=60, budgets=["10%"])))
            cluster_cases.synth_cluster(P, env.cluster, env.catalog, n_nodes=120,
                                        pods_per_node=8)
            cluster_cases.seed_launched(P, env)
            env.clock.advance(120)
            consolidate.LAST_SCREEN.clear()
            env.disruption.reconcile()
            assert env.manager.errors == []
            assert env.disruption.disrupted
            seen.append(cluster_cases.observe_lifecycle(env))
        finally:
            env.close()
    assert consolidate.LAST_SCREEN["backend"] == "partitioned(torch-plain)"
    assert consolidate.LAST_SCREEN["partitions"] == 4
    for key in seen[0]:
        assert seen[1][key] == seen[0][key], key


# -- partition lanes --------------------------------------------------------------

def _pools_ab(pkg):
    lbl = pkg.lbl
    pools = [
        pkg.NodePool(name="a", weight=10, requirements=[
            pkg.Requirement(lbl.INSTANCE_CATEGORY, pkg.Operator.IN, ("c",))]),
        pkg.NodePool(name="b", weight=5, requirements=[
            pkg.Requirement(lbl.INSTANCE_CATEGORY, pkg.Operator.IN, ("m",))]),
    ]
    pods = pkg.make_pods(24, "x", {"cpu": "500m", "memory": "1Gi"}) + \
        pkg.make_pods(18, "y", {"cpu": "2000m", "memory": "2Gi"},
                      node_selector={lbl.INSTANCE_CATEGORY: "m"})
    return pods, pools, pkg.CatalogProvider()


def _config5(pkg):
    from test_torch_encode import config5, config5_reservations

    pods, pools = config5(pkg)
    catalog = pkg.CatalogProvider()
    config5_reservations(pkg, catalog)
    return pods, pools, catalog


def _sig(res):
    return sorted((s.nodepool_name, tuple(s.instance_type_options), len(s.pods),
                   round(s.estimated_price, 6)) for s in res.node_specs)


@pytest.mark.parametrize("case", ["pools_ab", "config5"])
def test_lane_plan_equals_per_pool_and_reference(case, monkeypatch):
    from test_torch_encode import JAXPKG as JP, TORCHPKG as TP

    from karpenter_provider_aws_tpu.scheduling.solver import TPUSolver
    from karpenter_provider_aws_tpu_torch.metrics import PARTITION_SOLVE_LANES
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda
    from karpenter_provider_aws_tpu_torch.scheduling import TorchSolver

    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    monkeypatch.setenv("KARPENTER_TPU_MARKET", "0")
    build = _pools_ab if case == "pools_ab" else _config5
    c0 = PARTITION_SOLVE_LANES.sum(mode="vmap")
    solver = TorchSolver(device="cpu")
    lanes = solver.solve(*build(TP))
    assert PARTITION_SOLVE_LANES.sum(mode="vmap") == c0 + 2
    assert PARTITION_SOLVE_LANES.sum(mode="fallback") == 0
    assert solver.timings["lanes"] == 2
    ref = TPUSolver().solve(*build(JP))
    monkeypatch.setenv("KARPENTER_TPU_PARTITION_SOLVE", "0")
    solo = TorchSolver(device="cpu").solve(*build(TP))
    assert PARTITION_SOLVE_LANES.sum(mode="vmap") == c0 + 2
    assert _sig(lanes) == _sig(solo) == _sig(ref)
    assert len(lanes.unschedulable) == len(solo.unschedulable) == len(ref.unschedulable)
    assert ffd_cuda.LAUNCHES == 0  # the CPU never launches the kernel


def test_lanes_with_distinct_pre_opened_rows_equal_reference():
    """``ops/ffd_cases.py``'s K = 3 lanes (T = 40 / 64 / 25, n_pre 0 / 300
    / 2,000, 4,096 rows): the port's lanes, and each lane solved alone,
    equal the reference's vmapped lanes exactly."""
    import jax
    import torch

    from karpenter_provider_aws_tpu.ops.ffd import _State as JState
    from karpenter_provider_aws_tpu.parallel import mesh as jmesh
    from karpenter_provider_aws_tpu_torch.ops import ffd, ffd_cases
    from karpenter_provider_aws_tpu_torch.parallel import mesh

    problems, N, pre = ffd_cases.lanes_pre_opened()
    args, (_TB, ZB) = mesh.stack_lane_problems(problems)
    init, n_pres = mesh.stack_lane_states(pre, N, args["requests"].shape[2], ZB,
                                          args["group_window"].shape[3])
    assert n_pres == [0, 300, 2000]
    got, t = mesh.solve_partition_lanes(args, init, n_pres, N, device="cpu")
    want = jax.device_get(jmesh.solve_partition_lanes(args, JState(*init), n_pres, N,
                                                      mode="vmap")[0])
    for field in ("placed", "unplaced", "n_open", "node_type", "node_price", "used"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_array_equal(got.node_window.numpy(),
                                  ffd.pack_window_bits(np.asarray(want.node_window)))
    state = mesh.lane_state(init, "cpu")
    for k in range(3):
        alone = ffd.ffd_solve(*(t[f][k] for f in mesh.LANE_FIELDS[:7]),
                              max_per_node=t["max_per_node"][k], max_nodes=N,
                              init_state=ffd._State(*(f[k] for f in state)), n_pre=n_pres[k])
        assert torch.equal(alone.placed, got.placed[k]) and int(alone.n_open) > n_pres[k]


def test_merge_equals_reference_and_conserves_pods():
    """config9's per-zone burst at 12,000 nodes (120 pods, 30 a zone) as 4
    lanes of 256 rows on both packages: equal lane plans, the reference's
    ``cost_lanes`` and ``cost_merged``, and every pod placed on a kept
    node."""
    import jax

    from karpenter_provider_aws_tpu.ops.ffd import _State as JState
    from karpenter_provider_aws_tpu.parallel import mesh as jmesh
    from karpenter_provider_aws_tpu_torch.parallel import mesh

    merged = []
    for root in PACKAGES:
        P = names_of(root)
        catalog = mod(root, "catalog").CatalogProvider()
        pool = P.NodePool(name="default")
        problems = cluster_cases.zone_bursts(P, catalog, catalog.zones, pool, n_nodes=12_000)
        GB = max(p.requests.shape[0] for p in problems)
        padded = [P.encode.pad_problem(p, GB) for p in problems]
        lm = jmesh if root == PACKAGES[0] else mesh
        args, (_TB, ZB) = lm.stack_lane_problems(padded)
        K, N, R, C = len(padded), 256, args["requests"].shape[2], args["group_window"].shape[3]
        init, n_pres = mesh.stack_lane_states([None] * K, N, R, ZB, C)
        if root == PACKAGES[0]:
            res = jax.device_get(jmesh.solve_partition_lanes(args, JState(*init), n_pres, N,
                                                             mode="vmap")[0])
            plans = [{"node_type": np.asarray(res.node_type[k]),
                      "node_price": np.asarray(res.node_price[k]),
                      "used": np.asarray(res.used[k]),
                      "node_window": np.asarray(res.node_window[k])[:, :p.group_window.shape[1]],
                      "placed": np.asarray(res.placed[k]), "n_open": int(res.n_open[k])}
                     for k, p in enumerate(problems)]
        else:
            res, _t = mesh.solve_partition_lanes(args, init, n_pres, N, device="cpu")
            plans = mesh.lane_plans(problems, res)
        out = lm.merge_partition_plans(problems, plans)
        total = sum(int(p.counts[:len(p.group_pods)].sum()) for p in problems)
        assert total == 120
        assert int(out["placed"][:, ~out["dropped"]].sum()) == total
        assert out["cost_merged"] <= out["cost_lanes"] + 1e-6
        merged.append(out)
    for key in ("node_type", "placed", "dropped", "n_open", "cost_lanes", "cost_merged"):
        np.testing.assert_array_equal(np.asarray(merged[1][key]), np.asarray(merged[0][key]),
                                      err_msg=key)


# -- what one card does not carry -------------------------------------------------

@pytest.mark.parametrize("entry", ["make_mesh", "solve_sharded", "screen_sharded",
                                   "merge_sharded_plan", "shard_map_lanes"])
def test_multi_device_paths_raise(entry):
    from karpenter_provider_aws_tpu_torch import parallel

    assert parallel.lanes_mode() == "vmap"
    with pytest.raises(NotImplementedError, match="4-card"):
        if entry == "shard_map_lanes":
            parallel.solve_partition_lanes({}, None, [], 1, device="cpu", mode="shard_map")
        else:
            getattr(parallel, entry)()
