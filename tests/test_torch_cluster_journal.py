"""The torch package's journaled store against the JAX package's.

The journal tests of ``tests/test_encode_incremental.py`` (``rev`` is
monotonic, pod entries carry node names, an overflow returns None, unbind
goes through the store), run on the port's ``Cluster``; and one seeded
sequence of mutations, applied to twin stores, after which every
``changes_since`` answer and every view the encoder reads must be the same
in both packages. Exact: the journal is deterministic host code.
"""

import numpy as np
import pytest

from test_torch_consolidate import _add_node
from test_torch_encode_delta import JAXPKG, TORCHPKG, mutate, small_cluster

from karpenter_provider_aws_tpu_torch.state import cluster as tstate


def _one_node(pkg):
    catalog = pkg.CatalogProvider()
    cluster = pkg.Cluster()
    it = catalog.get("m5.large")
    node = _add_node(pkg, cluster, catalog, 0, it, "zone-a")
    return cluster, node


def test_rev_monotonic_and_changes():
    cluster = TORCHPKG.Cluster()
    r0 = cluster.rev
    cluster2, node = _one_node(TORCHPKG)
    assert cluster2.rev > r0
    ch = cluster2.changes_since(0)
    assert node.name in ch["node"]
    assert node.nodeclaim_name in ch["claim"]
    assert cluster2.changes_since(cluster2.rev) == {}
    revs = []
    for p in TORCHPKG.make_pods(3, "mono", {"cpu": "100m"}):
        cluster2.apply(p)
        revs.append(cluster2.rev)
        cluster2.bind_pod(p.uid, node.name)
        revs.append(cluster2.rev)
    assert revs == sorted(set(revs))


def test_pod_entries_carry_node_names():
    cluster, node = _one_node(TORCHPKG)
    p = TORCHPKG.make_pods(1, "w", {"cpu": "100m"})[0]
    cluster.apply(p)
    assert cluster.changes_since(cluster.rev - 1) == {"pod": [""]}
    r = cluster.rev
    cluster.bind_pod(p.uid, node.name)
    assert node.name in cluster.changes_since(r)["pod"]
    r = cluster.rev
    cluster.unbind_pod(p.uid)
    assert node.name in cluster.changes_since(r)["pod"]


def test_overflow_returns_none():
    cluster = TORCHPKG.Cluster()
    r0 = cluster.rev
    for i in range(tstate.JOURNAL_CAP + 5):
        cluster._record("pool", f"x{i}")
    assert cluster.changes_since(r0) is None
    # a recent revision is still covered
    r1 = cluster.rev
    cluster._record("pool", "y")
    assert cluster.changes_since(r1) == {"pool": ["y"]}


def test_journal_cap_ladders_with_the_population():
    assert tstate.journal_cap_for(10) == tstate.JOURNAL_CAP
    assert tstate.journal_cap_for(5000 + 22791) == 131072
    cluster, node = _one_node(TORCHPKG)
    pods = TORCHPKG.make_pods(1100, "lad", {"cpu": "10m"})
    r0 = cluster.rev
    for p in pods:  # 1,100 pods: the cap climbs to 8,192 before an entry drops
        cluster.apply(p)
        cluster.bind_pod(p.uid, node.name)
        cluster.unbind_pod(p.uid)
        cluster.bind_pod(p.uid, node.name)
    assert cluster._journal.maxlen == 8192
    assert cluster.changes_since(r0) is not None


def test_unbind_pod_through_store():
    cluster, node = _one_node(TORCHPKG)
    p = TORCHPKG.make_pods(1, "w", {"cpu": "100m"})[0]
    cluster.apply(p)
    cluster.bind_pod(p.uid, node.name)
    assert cluster.pods_on_nodes([node.name])[node.name] == [p]
    assert cluster.pods_on_node(node.name) == [p]
    cluster.unbind_pod(p.uid)
    assert p.is_pending()
    assert cluster.pods_on_nodes([node.name]) == {}
    cluster.bind_pod(p.uid, node.name)
    cluster.delete(p)
    assert cluster.pods_on_nodes([node.name]) == {} and p.uid not in cluster.pods


def test_epoch_is_per_incarnation():
    cluster, _ = _one_node(TORCHPKG)
    e0 = cluster.epoch
    cluster.__init__()
    assert cluster.epoch is not e0 and cluster.rev == 0 and not cluster.nodes


def test_nodeclass_by_pool():
    cluster = TORCHPKG.Cluster()
    pool = TORCHPKG.NodePool(name="default")
    cluster.apply(pool)
    assert cluster.nodeclass_by_pool({"default": pool}) == {"default": None}
    cluster.nodeclasses["default"] = "nc"
    assert cluster.nodeclass_by_pool([pool]) == {"default": "nc"}
    assert cluster.changes_since(0) == {"pool": ["default"]}


def _views(cluster):
    """What the encoders read, by name (pod uids differ between packages)."""
    return {
        "pods_by_node": {n: sorted(p.name for p in ps)
                         for n, ps in cluster.pods_by_node().items()},
        "indexed": {n: sorted(p.name for p in ps) for n, ps in
                    cluster.pods_on_nodes(list(cluster.nodes)).items()},
        "nodes": [(n.name, n.ready, n.cordoned) for n in cluster.snapshot_nodes()],
        "claims": [(c.name, c.deleted) for c in cluster.snapshot_claims()],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_changes_since_equal_under_one_seeded_sequence(seed):
    """The same mutations through both stores journal the same entries in
    the same order: every cursor taken along the way reads the same
    ``changes_since`` in both packages, and the views the encoders read
    agree."""
    twins = {pkg.root: small_cluster(pkg) for pkg in (JAXPKG, TORCHPKG)}
    cursors = {root: [0] for root in twins}
    for step in range(25):
        for pkg in (JAXPKG, TORCHPKG):
            cluster, catalog, state = twins[pkg.root]
            mutate(pkg, cluster, catalog, state, np.random.RandomState(1000 * seed + step),
                   tag=f"j{seed}_{step}")
            cursors[pkg.root].append(cluster.rev)
        jc, tc = twins[JAXPKG.root][0], twins[TORCHPKG.root][0]
        assert cursors[JAXPKG.root] == cursors[TORCHPKG.root]
        for r in cursors[TORCHPKG.root]:
            assert tc.changes_since(r) == jc.changes_since(r), (step, r)
        assert _views(tc) == _views(jc), step
