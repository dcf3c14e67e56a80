"""The torch package's consolidation screen against the JAX package's.

1. The plain ``repack_check`` against the reference's XLA ``repack_check``
   and its Pallas kernel in interpret mode, on the random family and the
   edge cases of ``tests/test_repack_pallas.py``: ``ok`` equal exactly.
2. The encode, the screen and the delete decision on small clusters built
   by ONE generator, given each package's classes: a config4 cluster
   (``benchmarks/solve_configs.py::_synth_cluster`` at 40 and 200 nodes)
   and a mixed cluster (several pod shapes per node, a hostname-spread
   group, a tainted node class, a zone-spread group, a do-not-disrupt pod).
   Every ``ClusterTensors`` array must be equal, the screen masks equal
   (the reference pinned to its vmap backend: its native backend screens
   compat only and may legitimately differ), and the delete prefix equal.
   Group ids come from process-wide counters in each package, so groups
   are matched by the sorted names of their pods, not by index.
3. Tensors handed over with ``interop.cluster_tensors_from_reference``
   give the reference's mask and validator verdicts.
4. The incremental encode equals the full one; what the slice does not
   carry raises.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu_torch import interop
from karpenter_provider_aws_tpu_torch.ops import consolidate as tcons
from karpenter_provider_aws_tpu_torch.ops import repack_cases, repack_cuda

jnp = pytest.importorskip("jax.numpy")

from karpenter_provider_aws_tpu.ops import consolidate as jcons  # noqa: E402
from karpenter_provider_aws_tpu.ops.repack_pallas import repack_check_pallas  # noqa: E402


# -- 1. the plain repack_check ------------------------------------------------

#: name -> (free, requests, gids, gcounts, cap, candidates)
REPACK_CASES = repack_cases.small_cases()


def _reference_xla(free, requests, gids, gcounts, cap, cand):
    return np.asarray(jcons.repack_check(
        jnp.asarray(free), jnp.asarray(requests), jnp.asarray(gids),
        jnp.asarray(gcounts), jnp.asarray(cap), jnp.asarray(cand),
    ))


def _reference_pallas(free, requests, gids, gcounts, cap, cand):
    return repack_check_pallas(free, requests, gids[cand], gcounts[cand], cap, cand,
                               interpret=True)


def _port(free, requests, gids, gcounts, cap, cand, cap_form="as_is", chunk=512):
    if cap_form == "uint16":
        cap = np.minimum(cap, 60000).astype(np.uint16)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (free, requests, gids, gcounts, cap, cand)]
    return tcons.repack_check(*t, chunk=chunk).numpy()


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(REPACK_CASES))
def test_plain_repack_matches_reference(name, reference):
    args = REPACK_CASES[name]
    want = (_reference_xla if reference == "xla" else _reference_pallas)(*args)
    got = _port(*args)
    assert got.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(bool))


def test_plain_repack_edge_verdicts():
    assert not _port(*REPACK_CASES["nothing_fits"]).any()
    assert _port(*REPACK_CASES["empty_node"])[7]
    np.testing.assert_array_equal(_port(*REPACK_CASES["self_exclusion"]), [False, True])


@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_plain_repack_uint16_wire_and_chunking(chunk):
    """The uint16 cap wire gives the float cap's answer, whatever the
    candidate batch size."""
    args = REPACK_CASES["float_cap"]
    want = _reference_xla(*args)
    np.testing.assert_array_equal(_port(*args, cap_form="uint16", chunk=chunk), want)


def _mirror_padded_slots():
    """Eight slots as the device mirror pads them: slots 1, 2, 4, 6 and 7
    hold nothing on any node, slot 5 only from node 20 on, and axes 3-8 are
    requested by no group."""
    free, requests, gids, gcounts, compat, cand = repack_cases.random_problem(
        np.random.RandomState(6), 40, 8, 8, fill=0.7)
    gcounts[:, [1, 2, 4, 6, 7]] = 0
    gcounts[:20, 5] = 0
    free *= 0.5  # tight enough that verdicts split
    return free, requests, gids, gcounts, compat, cand


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_plain_repack_skipped_slots_and_axes_match_reference(chunk, reference):
    """The plain version passes over slots that are empty for a whole
    candidate chunk and axes no group requests; the verdicts stay the
    reference's, at every chunk size."""
    args = _mirror_padded_slots()
    want = (_reference_xla if reference == "xla" else _reference_pallas)(*args)
    got = _port(*args, chunk=chunk)
    np.testing.assert_array_equal(got, want.astype(bool))
    assert 0 < got.sum() < len(got)


def test_zero_request_group_is_repackable():
    """A group that requests nothing fits 2^30 pods on every compatible
    node; the int64 prefix sum places its count, as the Pallas kernel's f32
    sum does. (The reference's XLA scan sums in int32 and wraps from five
    nodes on: see ROADMAP Queue C.)"""
    N, R = 5, 9
    args = (np.ones((N, R), np.float32), np.zeros((1, R), np.float32),
            np.zeros((N, 1), np.int32), np.full((N, 1), 3, np.int32),
            np.ones((1, N), bool), np.arange(N, dtype=np.int32))
    got = _port(*args)
    assert got.all()
    np.testing.assert_array_equal(got, _reference_pallas(*args))


# -- 2. encode, screen and delete decision on small clusters ------------------

def _package(root: str) -> SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    pod = m("models.pod")
    return SimpleNamespace(
        root=root,
        lbl=m("models.labels"),
        make_pods=pod.make_pods,
        Toleration=pod.Toleration,
        TopologySpreadConstraint=pod.TopologySpreadConstraint,
        Taint=m("models.nodepool").Taint,
        NodeClaim=m("models.nodeclaim").NodeClaim,
        Node=m("state.cluster").Node,
        Cluster=m("state.cluster").Cluster,
        CatalogProvider=m("catalog").CatalogProvider,
        cons=m("ops.consolidate"),
    )


JAXPKG = _package("karpenter_provider_aws_tpu")
TORCHPKG = _package("karpenter_provider_aws_tpu_torch")


def _add_node(pkg, cluster, catalog, i, it, zone, taints=()):
    """One launched, registered node with its claim; names come from ``i``
    (never from a process-wide counter)."""
    lbl = pkg.lbl
    claim = pkg.NodeClaim(name=f"default-{i:x}", nodepool_name="default",
                          nodeclass_name="default", instance_type_options=[it.name],
                          zone_options=[zone], capacity_type_options=["spot"])
    claim.status.provider_id = f"cloud:///{zone}/i-bench{i}"
    claim.status.capacity = it.capacity()
    claim.status.allocatable = catalog.allocatable(it)
    claim.labels.update(it.labels())
    claim.labels[lbl.TOPOLOGY_ZONE] = zone
    claim.labels[lbl.CAPACITY_TYPE] = "spot"
    claim.labels[lbl.NODEPOOL] = "default"
    for cond in ("Launched", "Registered", "Initialized"):
        claim.status.set_condition(cond, True)
    cluster.apply(claim)
    node = pkg.Node(name=f"node-{claim.name}", provider_id=claim.status.provider_id,
                    nodepool_name="default", nodeclaim_name=claim.name,
                    labels=dict(claim.labels), taints=list(taints),
                    capacity=claim.status.capacity, allocatable=claim.status.allocatable,
                    ready=True)
    node.labels[lbl.HOSTNAME] = node.name
    claim.status.node_name = node.name
    cluster.apply(node)
    return node


def _bind(cluster, node, pods):
    for p in pods:
        cluster.apply(p)
        cluster.bind_pod(p.uid, node.name)


def config4(pkg, n_nodes, pods_per_node=8):
    """``_synth_cluster`` (config #4): RandomState(1), c/m types of 4–16
    vCPUs, spot, 1..8 pods of 250m/512Mi per node."""
    catalog = pkg.CatalogProvider()
    cluster = pkg.Cluster()
    rng = np.random.RandomState(1)
    types = [t for t in catalog.list() if t.category in ("c", "m") and 4 <= t.vcpus <= 16]
    for i in range(n_nodes):
        it = types[rng.randint(len(types))]
        zone = catalog.zones[rng.randint(len(catalog.zones))]
        node = _add_node(pkg, cluster, catalog, i, it, zone)
        fill = rng.randint(1, pods_per_node + 1)
        _bind(cluster, node, pkg.make_pods(fill, f"p{i}", {"cpu": "250m", "memory": "512Mi"}))
    return cluster, catalog


def mixed(pkg, n_nodes=36):
    """Several pod shapes per node, a hostname-spread group (cap below
    uncapped), a tainted node class with its tolerating group, a
    zone-spread group and one do-not-disrupt pod."""
    lbl = pkg.lbl
    catalog = pkg.CatalogProvider()
    cluster = pkg.Cluster()
    rng = np.random.RandomState(7)
    types = [t for t in catalog.list() if t.category in ("c", "m") and 2 <= t.vcpus <= 8]
    taint = pkg.Taint(key="team", value="ml", effect="NoSchedule")
    shapes = [("web", {"cpu": "250m", "memory": "512Mi"}),
              ("api", {"cpu": "500m", "memory": "1Gi"}),
              ("batch", {"cpu": "1", "memory": "2Gi"})]
    for i in range(n_nodes):
        it = types[rng.randint(len(types))]
        zone = catalog.zones[rng.randint(len(catalog.zones))]
        tainted = i % 6 == 5
        node = _add_node(pkg, cluster, catalog, i, it, zone, taints=[taint] if tainted else ())
        if tainted:
            _bind(cluster, node, pkg.make_pods(
                1 + rng.randint(3), f"ml{i}", {"cpu": "500m", "memory": "1Gi"},
                labels={"app": "ml"},
                tolerations=[pkg.Toleration(key="team", value="ml", effect="NoSchedule")]))
            continue
        for name, req in shapes:
            n = rng.randint(0, 3)
            if n:
                _bind(cluster, node, pkg.make_pods(n, f"{name}{i}", req, labels={"app": name}))
        if i % 3 == 0:
            _bind(cluster, node, pkg.make_pods(
                1 + rng.randint(2), f"hs{i}", {"cpu": "100m", "memory": "128Mi"},
                labels={"app": "hs"},
                topology_spread=[pkg.TopologySpreadConstraint(
                    topology_key=lbl.HOSTNAME, max_skew=2, label_selector={"app": "hs"})]))
        if i % 4 == 1:
            _bind(cluster, node, pkg.make_pods(
                1, f"zs{i}", {"cpu": "200m", "memory": "256Mi"}, labels={"app": "zs"},
                topology_spread=[pkg.TopologySpreadConstraint(
                    topology_key=lbl.TOPOLOGY_ZONE, max_skew=1, label_selector={"app": "zs"})]))
        if i == 4:
            _bind(cluster, node, pkg.make_pods(
                1, "pinned", {"cpu": "100m", "memory": "64Mi"}, labels={"app": "pinned"},
                annotations={lbl.ANNOTATION_DO_NOT_DISRUPT: "true"}))
    return cluster, catalog


CLUSTERS = {
    "config4_40": lambda pkg: config4(pkg, 40),
    "config4_200": lambda pkg: config4(pkg, 200),
    "mixed": mixed,
}

_ARRAYS_NODE_ONLY = ("free", "price", "disruption_cost", "blocked", "used_total",
                     "node_zone_idx", "node_gang")
_LISTS = ("node_names", "nodepool_names", "node_zone", "zones", "node_captype")


def _canonical(ct):
    """Group-indexed fields in an order fixed by the groups' sorted pod
    names, and each node's slots re-sorted to that order."""
    keys = [tuple(sorted(p.name for p in pods)) for pods in ct.group_pods]
    order = sorted(range(len(keys)), key=lambda g: keys[g])
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    live = ct.group_counts > 0
    slots = []
    for n in range(ct.group_ids.shape[0]):
        pairs = sorted((int(rank[g]), int(c)) for g, c, lv in
                       zip(ct.group_ids[n], ct.group_counts[n], live[n]) if lv)
        slots.append(pairs)
    out = {
        "group_keys": [keys[g] for g in order],
        "requests": ct.requests[order], "compat": ct.compat[:, :][order],
        "cap": ct.cap[order], "group_node_count": ct.group_node_count[order],
        "mpn": ct.mpn[order], "hn_match": ct.hn_match[order][:, order],
        "slots": slots, "slot_shape": ct.group_ids.shape,
        "zone_constraints": [
            [(c.kind, c.skew, c.match[order].tolist(), c.selector)
             for c in ct.zone_constraints[g]] for g in order
        ],
    }
    for f in _ARRAYS_NODE_ONLY:
        out[f] = getattr(ct, f)
    for f in _LISTS:
        out[f] = list(getattr(ct, f))
    return out


def _reference_prefix(ct, mask):
    rows = np.argsort(ct.disruption_cost, kind="stable")
    cands = [int(r) for r in rows if mask[r]]
    lo, hi = 0, len(cands)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid == 0 or jcons.repack_set_feasible(ct, cands[:mid]):
            lo = mid
        else:
            hi = mid - 1
    return cands[:lo]


def _encode_both(name):
    jct = JAXPKG.cons.encode_cluster(*CLUSTERS[name](JAXPKG), incremental=False)
    tct = TORCHPKG.cons.encode_cluster(*CLUSTERS[name](TORCHPKG), incremental=False)
    return jct, tct


@pytest.fixture(scope="module")
def encoded():
    return {name: _encode_both(name) for name in CLUSTERS}


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_cluster_tensors_equal(encoded, name):
    jct, tct = encoded[name]
    want, got = _canonical(jct), _canonical(tct)
    assert set(want) == set(got)
    for field in sorted(want):
        w, g = want[field], got[field]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, field
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            assert g == w, field


def test_mixed_cluster_exercises_every_feature(encoded):
    jct, tct = encoded["mixed"]
    assert (tct.mpn < tcons._UNCAPPED).any()              # hostname-spread group
    assert ((tct.cap > 0) & (tct.cap < tcons._UNCAPPED)).any()
    assert any(c.kind == "spread" for cons in tct.zone_constraints for c in cons)
    assert not tct.compat.all()                            # the tainted class
    assert tct.blocked.sum() == 1                          # the do-not-disrupt pod
    assert (tct.group_counts > 0).sum(axis=1).max() >= 3   # several shapes a node


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_screen_and_delete_prefix_equal(encoded, name, monkeypatch):
    jct, tct = encoded[name]
    monkeypatch.setenv("KARPENTER_TPU_REPACK", "vmap")
    want = jcons.consolidatable(jct)
    got = tcons.consolidatable(tct, device="cpu")
    assert tcons.LAST_SCREEN["backend"] == "torch-plain"
    np.testing.assert_array_equal(got, want)
    assert got.any()
    prefix = tcons.delete_prefix(tct, got)
    assert prefix == _reference_prefix(jct, want)
    assert 0 < len(prefix) <= int(got.sum())


def test_screen_mask_memo_is_per_object(encoded):
    _jct, tct = encoded["config4_40"]
    first = tcons.consolidatable(tct, device="cpu")
    again = tcons.consolidatable(tct, device="cpu")
    assert tcons.LAST_SCREEN["memo_hit"] is True
    np.testing.assert_array_equal(first, again)
    again[:] = False  # the caller's copy, not the memo
    np.testing.assert_array_equal(tcons.consolidatable(tct, device="cpu"), first)


# -- 3. the interop handover ---------------------------------------------------

def _handover(jct):
    fields = {f: getattr(jct, f) for f in
              interop.CLUSTER_ARRAY_FIELDS + interop.CLUSTER_LIST_FIELDS}
    fields["zone_constraints"] = [
        [(c.kind, c.skew, c.match, c.selector) for c in cons] for cons in jct.zone_constraints
    ]
    return interop.cluster_tensors_from_reference(fields)


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_interop_screen_and_validator(encoded, name, monkeypatch):
    jct, _tct = encoded[name]
    ct = _handover(jct)
    assert ct.group_pods == []
    monkeypatch.setenv("KARPENTER_TPU_REPACK", "vmap")
    want = jcons.consolidatable(jct)
    np.testing.assert_array_equal(tcons.consolidatable(ct, device="cpu"), want)
    rows = [int(r) for r in np.argsort(jct.disruption_cost, kind="stable") if want[r]]
    for size in sorted({1, 2, len(rows) // 3, len(rows) // 2, len(rows) - 1, len(rows)}):
        if size < 1:
            continue
        prefix = rows[:size]
        assert tcons.repack_set_feasible(ct, prefix) == jcons.repack_set_feasible(jct, prefix)


def test_interop_missing_field_raises():
    with pytest.raises(KeyError):
        interop.cluster_tensors_from_reference({"free": np.zeros((1, 1))})


# -- 4. the incremental encode; what the slice does not carry -----------------

def test_incremental_encode_raises():
    """The journaled store's incremental encode (its full build) describes
    the same cluster as the full encode; the default is incremental."""
    from karpenter_provider_aws_tpu_torch.ops.encode_delta import (
        canonical_equal,
        canonical_form,
    )

    cluster, catalog = config4(TORCHPKG, 3)
    inc = tcons.encode_cluster(cluster, catalog, incremental=True)
    full = tcons.encode_cluster(cluster, catalog, incremental=False)
    assert inc is not None and full is not None and inc is not full
    assert canonical_equal(canonical_form(inc), canonical_form(full)) == []
    assert tcons.encode_cluster(cluster, catalog) is inc


def test_partitioned_tensors_raise(encoded):
    """Partitions that do not tile the node axis raise before any screen
    (one partition of the whole axis screens the tensors whole)."""
    ct = _handover(encoded["config4_40"][0])
    ct.__dict__["_partitions"] = [("p", ct, 0, 40)]
    assert tcons.consolidatable(ct, device="cpu").shape == (40,)
    ct.__dict__.pop("_screen_mask_memo", None)
    ct.__dict__["_partitions"] = [("p", ct, 0, 40), ("q", ct, 40, 40)]
    with pytest.raises(ValueError, match="partitions"):
        tcons.consolidatable(ct, device="cpu")


def test_default_device_is_cuda_and_raises_without_it(encoded, monkeypatch):
    ct = _handover(encoded["config4_40"][0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcons.consolidatable(ct)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcons.dispatch_screen(ct, device="cuda")
    assert "_screen_mask_memo" not in ct.__dict__


def test_backend_is_a_function_of_the_device():
    assert tcons._repack_backend(torch.device("cuda")) == "cuda-repack"
    assert tcons._repack_backend(torch.device("cpu")) == "torch-plain"
    with pytest.raises(ValueError):
        tcons._repack_backend(torch.device("meta"))


def test_wrapper_runs_the_plain_version_on_cpu_tensors_only():
    args = [torch.from_numpy(a) for a in REPACK_CASES["float_cap"]]
    launches = repack_cuda.LAUNCHES
    got = repack_cuda.repack_check(*args, chunk=7)
    assert repack_cuda.LAUNCHES == launches
    assert torch.equal(got, tcons.repack_check(*args))
    with pytest.raises(ValueError, match="no repack kernel"):
        repack_cuda.repack_check(*(a.to("meta") for a in args))


def test_live_slot_width_matches_reference():
    rng = np.random.RandomState(0)
    for _ in range(20):
        counts = (rng.rand(30, 32) < rng.rand()).astype(np.int32)
        counts[:, rng.randint(32):] = 0
        assert tcons.live_slot_width(counts) == jcons.live_slot_width(counts)
        np.testing.assert_array_equal(tcons.live_slots(counts), jcons.live_slots(counts))
