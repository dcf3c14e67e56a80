"""The torch package's incremental cluster encoder against its own full
encode and against the JAX package's incremental encoder.

Twin clusters (one per package, built by the same helpers with the same
names) take the same seeded mutations: binds of fresh pods (some with zone
spread, hostname anti-affinity or an arm64 selector), unbinds, pod deletes,
direct cordon flips, claim deletes, node adds and node deletes — the
property of ``tests/test_encode_incremental.py``. After every step the
port's incremental ``ClusterTensors`` must be ``canonical_equal`` to the
port's full encode, and equal field by field to the JAX package's
incremental emission. Group tokens and pod uids come from per-package
counters, so the cross-package form keys groups by their pods' sorted names.
Exact everywhere: this is deterministic host numpy.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_consolidate import _add_node, _bind

from karpenter_provider_aws_tpu_torch.ops import consolidate as tcons
from karpenter_provider_aws_tpu_torch.ops import encode_delta as tdelta

from karpenter_provider_aws_tpu.ops import consolidate as jcons  # noqa: E402


def _package(root: str) -> SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    pod = m("models.pod")
    return SimpleNamespace(
        root=root,
        lbl=m("models.labels"),
        make_pods=pod.make_pods,
        Toleration=pod.Toleration,
        TopologySpreadConstraint=pod.TopologySpreadConstraint,
        PodAffinityTerm=pod.PodAffinityTerm,
        Taint=m("models.nodepool").Taint,
        NodePool=m("models").NodePool,
        Requirement=m("models").Requirement,
        Operator=m("models").Operator,
        NodeClaim=m("models.nodeclaim").NodeClaim,
        Node=m("state.cluster").Node,
        Cluster=m("state.cluster").Cluster,
        CatalogProvider=m("catalog").CatalogProvider,
        cons=m("ops.consolidate"),
        delta=m("ops.encode_delta"),
    )


JAXPKG = _package("karpenter_provider_aws_tpu")
TORCHPKG = _package("karpenter_provider_aws_tpu_torch")


def _cm_types(catalog):
    return [t for t in catalog.list() if t.category in ("c", "m")]


def small_cluster(pkg, n=12):
    """``tests/test_encode_incremental.py``'s ``_small_cluster`` with names
    from the node index: n c/m nodes over three zones, 1-3 pods each.
    Returns (cluster, catalog, state) where ``state`` carries the live node
    names and the counters ``mutate`` draws fresh names from."""
    catalog = pkg.CatalogProvider()
    cluster = pkg.Cluster()
    types = _cm_types(catalog)
    names = []
    for i in range(n):
        zone = ("zone-a", "zone-b", "zone-c")[i % 3]
        node = _add_node(pkg, cluster, catalog, i, types[i % len(types)], zone)
        names.append(node.name)
        _bind(cluster, node, pkg.make_pods(1 + i % 3, f"seed{i}",
                                           {"cpu": "250m", "memory": "512Mi"}))
    return cluster, catalog, {"names": names, "next_node": n, "pods": 0}


def mutate(pkg, cluster, catalog, state, rng, tag, ops=range(7), label_tag=""):
    """One step of 1-4 mutations drawn from ``ops`` (the reference
    property's seven: 0 bind a fresh pod, 1 unbind, 2 delete a bound pod,
    3 flip a node's cordon directly, 4 mark a claim deleted, 5 add a node,
    6 delete a node). The same ``rng`` stream on twin clusters makes the
    same mutations. Labels the fresh pods carry start with ``label_tag``."""
    lbl = pkg.lbl
    names = state["names"]
    ops = list(ops)
    for _ in range(rng.randint(1, 5)):
        op = ops[rng.randint(len(ops))]
        if op == 0:
            kwargs = {}
            r = rng.rand()
            if r < 0.2:
                kwargs = dict(
                    labels={"app": f"{label_tag}s{rng.randint(3)}"},
                    topology_spread=[pkg.TopologySpreadConstraint(
                        topology_key=lbl.TOPOLOGY_ZONE, max_skew=1,
                        label_selector={"app": f"{label_tag}s{rng.randint(3)}"})],
                )
            elif r < 0.35:
                kwargs = dict(
                    labels={"app": f"{label_tag}a{rng.randint(3)}"},
                    anti_affinity=[pkg.PodAffinityTerm(
                        topology_key=lbl.HOSTNAME,
                        label_selector={"app": f"{label_tag}a{rng.randint(3)}"})],
                )
            elif r < 0.45:
                kwargs = dict(node_selector={lbl.ARCH: "arm64"})
            state["pods"] += 1
            p = pkg.make_pods(1, f"{tag}-{state['pods']}", {
                "cpu": f"{int(rng.choice([100, 250, 500]))}m", "memory": "256Mi",
            }, **kwargs)[0]
            cluster.apply(p)
            cluster.bind_pod(p.uid, names[rng.randint(len(names))])
        elif op == 1:
            bound = [p for p in cluster.pods.values() if p.node_name]
            if bound:
                cluster.unbind_pod(bound[rng.randint(len(bound))].uid)
        elif op == 2:
            bound = [p for p in cluster.pods.values() if p.node_name]
            if bound:
                cluster.delete(bound[rng.randint(len(bound))])
        elif op == 3:
            n = cluster.nodes.get(names[rng.randint(len(names))])
            if n is not None:
                n.cordoned = not n.cordoned
        elif op == 4:
            live = [c for c in cluster.nodeclaims.values() if not c.deleted]
            if len(live) > 3:
                c = live[rng.randint(len(live))]
                c.finalizers = ["karpenter"]
                cluster.delete(c)
        elif op == 5:
            zone = ("zone-a", "zone-b", "zone-c", "zone-d")[rng.randint(4)]
            types = _cm_types(catalog)
            i = state["next_node"]
            node = _add_node(pkg, cluster, catalog, i, types[i % len(types)], zone)
            names.append(node.name)
            state["next_node"] += 1
        else:
            n = cluster.nodes.get(names[rng.randint(len(names))])
            if n is not None:
                cluster.delete(n)


def portable(ct):
    """A package-independent content view of a ``ClusterTensors``: nodes in
    name order, groups keyed and ordered by their pods' sorted names, slot
    tables as {group: count}, zone constraints over group keys."""
    if ct is None:
        return None
    N = len(ct.node_names)
    node = sorted(range(N), key=lambda i: ct.node_names[i])
    gkeys = [tuple(sorted(p.name for p in pods)) for pods in ct.group_pods]
    G = len(gkeys)
    grp = sorted(range(G), key=lambda g: gkeys[g])
    out = {
        "nodes": [ct.node_names[i] for i in node],
        "pools": [ct.nodepool_names[i] for i in node],
        "captype": [ct.node_captype[i] for i in node],
        "zone": [ct.node_zone[i] for i in node],
        "free": ct.free[node], "price": ct.price[node], "used": ct.used_total[node],
        "dcost": ct.disruption_cost[node], "blocked": ct.blocked[node],
        "gang": ct.node_gang[node],
        "groups": [gkeys[g] for g in grp],
    }
    if not G:  # the podless dummy group
        for k, a in (("requests", ct.requests), ("mpn", ct.mpn)):
            out[k] = a
        for k, a in (("gnc", ct.group_node_count), ("compat", ct.compat), ("cap", ct.cap)):
            out[k] = a[:, node]
        return out
    out.update({
        "requests": ct.requests[grp], "mpn": ct.mpn[grp],
        "gnc": ct.group_node_count[np.ix_(grp, node)],
        "compat": ct.compat[np.ix_(grp, node)],
        "cap": ct.cap[np.ix_(grp, node)],
        "hn": ct.hn_match[np.ix_(grp, grp)],
        "slots": [
            "overflow" if int((ct.group_node_count[:, i] > 0).sum()) > ct.group_ids.shape[1]
            else {gkeys[int(g)]: int(c)
                  for g, c in zip(ct.group_ids[i], ct.group_counts[i]) if c > 0}
            for i in node
        ],
        "zcons": [
            sorted((c.kind, c.skew, tuple(sorted((c.selector or {}).items())),
                    tuple(sorted(gkeys[int(j)] for j in np.flatnonzero(c.match))))
                   for c in ct.zone_constraints[g])
            for g in grp
        ],
    })
    return out


def assert_same(got, want, tag=""):
    """Field by field: arrays equal in dtype, shape and values."""
    if want is None or got is None:
        assert got is None and want is None, tag
        return
    assert set(got) == set(want), tag
    for k in sorted(want):
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f"{tag}: {k}"
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {k}")
        else:
            assert a == b, f"{tag}: {k}"


def assert_patched_equal(tcl, tcat, jcl, jcat, tag=""):
    """The port's incremental emission equals its full encode (canonical
    form) and the JAX package's incremental emission (portable form)."""
    inc = tcons.encode_cluster(tcl, tcat)
    fresh = tcons._encode_cluster(tcl, tcat, tcons.GMAX_DEFAULT)
    diffs = tdelta.canonical_equal(tdelta.canonical_form(inc), tdelta.canonical_form(fresh))
    assert not diffs, f"{tag}: patched tensors diverge from the full encode: {diffs}"
    ref = jcons.encode_cluster(jcl, jcat)
    assert_same(portable(inc), portable(ref), tag)
    return inc, ref


def twins(build=small_cluster):
    return {pkg.root: build(pkg) for pkg in (JAXPKG, TORCHPKG)}


def _pair(tw):
    (jcl, jcat, _), (tcl, tcat, _) = tw[JAXPKG.root], tw[TORCHPKG.root]
    return tcl, tcat, jcl, jcat


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_property_random_mutation_sequences(seed):
    tw = twins()
    tcl, tcat, jcl, jcat = _pair(tw)
    assert_patched_equal(tcl, tcat, jcl, jcat, "cold")
    tdelta.reset_encode_counts()
    for step in range(25):
        for pkg in (JAXPKG, TORCHPKG):
            cl, cat, state = tw[pkg.root]
            mutate(pkg, cl, cat, state, np.random.RandomState(1000 * seed + step),
                   tag=f"m{seed}_{step}")
        assert_patched_equal(tcl, tcat, jcl, jcat, f"seed{seed} step{step}")
    assert tdelta.ENCODE_COUNTS["patch"] > 0


def test_unchanged_cluster_returns_same_object():
    cl, cat, _ = small_cluster(TORCHPKG)
    ct1 = tcons.encode_cluster(cl, cat)
    ct2 = tcons.encode_cluster(cl, cat)
    assert ct1 is ct2
    assert tdelta.LAST_ENCODE["mode"] == "hit"


def _catalog(tcl, tcat, jcl, jcat):
    for cat in (tcat, jcat):
        cat.unavailable.mark_unavailable("c7g.4xlarge", "zone-a", "on-demand")


def _overflow(tcl, tcat, jcl, jcat):
    for cl in (tcl, jcl):
        for i in range(4096 + 5):  # the journal floor: a 12-node store keeps it
            cl._record("pool", f"noise{i}")


def _epoch(tcl, tcat, jcl, jcat):
    for cl in (tcl, jcl):
        cl.__init__()  # an environment reset re-runs __init__ in place


def _heavy(tcl, tcat, jcl, jcat):
    for pkg, cl in ((TORCHPKG, tcl), (JAXPKG, jcl)):
        for name in list(cl.nodes)[:8]:  # 8 of 12 rows dirty > PATCH_FRAC
            p = pkg.make_pods(1, f"hc{name}", {"cpu": "100m"})[0]
            cl.apply(p)
            cl.bind_pod(p.uid, name)


def _refresh(tcl, tcat, jcl, jcat):
    for pkg, cl in ((TORCHPKG, tcl), (JAXPKG, jcl)):
        name = next(iter(cl.nodes))
        for k in range(2):
            p = pkg.make_pods(1, f"rf{k}", {"cpu": "100m"})[0]
            cl.apply(p)
            cl.bind_pod(p.uid, name)
            # a pass between the two binds
            pkg.cons.encode_cluster(cl, tcat if pkg is TORCHPKG else jcat)


@pytest.mark.parametrize("trigger,cause", [
    (_catalog, "catalog"), (_overflow, "journal_overflow"), (_epoch, "epoch"),
    (_heavy, "dirty_ratio"), (_refresh, "refresh_interval"),
])
def test_full_rebuild_triggers_match(trigger, cause, monkeypatch):
    """Each cause forces a full build, which still matches the full encode
    and the reference's emission."""
    monkeypatch.setenv("KARPENTER_TPU_ENCODE_REFRESH_EVERY", "2")
    tcl, tcat, jcl, jcat = _pair(twins())
    ct1, _ = assert_patched_equal(tcl, tcat, jcl, jcat, "cold")
    trigger(tcl, tcat, jcl, jcat)
    tdelta.reset_encode_counts()
    ct2, _ = assert_patched_equal(tcl, tcat, jcl, jcat, cause)
    assert tdelta.LAST_ENCODE == {"mode": "full", "cause": cause, "dirty": 0}
    assert tdelta.ENCODE_COUNTS["full"] == 1
    if cause == "epoch":
        assert ct2 is None
    else:
        assert ct2 is not ct1


def test_kill_switch(monkeypatch):
    cl, cat, _ = small_cluster(TORCHPKG)
    monkeypatch.setenv("KARPENTER_TPU_INCREMENTAL_ENCODE", "0")
    ct1 = tcons.encode_cluster(cl, cat)
    ct2 = tcons.encode_cluster(cl, cat)
    assert ct1 is not ct2  # full encode every call
    assert "_device_chain" not in ct1.__dict__
    monkeypatch.setenv("KARPENTER_TPU_INCREMENTAL_ENCODE", "1")
    assert "_device_chain" in tcons.encode_cluster(cl, cat).__dict__


def test_invalidate_drops_the_encoder():
    cl, cat, _ = small_cluster(TORCHPKG)
    ct1 = tcons.encode_cluster(cl, cat)
    tdelta.invalidate_cluster_encoders(cl)
    ct2 = tcons.encode_cluster(cl, cat)
    assert ct2 is not ct1 and tdelta.LAST_ENCODE["cause"] == "epoch"
    assert not tdelta.canonical_equal(tdelta.canonical_form(ct1), tdelta.canonical_form(ct2))


def test_patch_counts_rows():
    tcl, tcat, _ = small_cluster(TORCHPKG)
    tcons.encode_cluster(tcl, tcat)
    tdelta.reset_encode_counts()
    name = tcl.snapshot_nodes()[3].name
    p = TORCHPKG.make_pods(1, "pc", {"cpu": "250m", "memory": "512Mi"})[0]
    tcl.apply(p)
    tcl.bind_pod(p.uid, name)
    ct = tcons.encode_cluster(tcl, tcat)
    assert tdelta.ENCODE_COUNTS == {"hit": 0, "patch": 1, "full": 0, "patch_rows": 1}
    assert ct.__dict__["_patch_positions"].tolist() == [ct.node_names.index(name)]
