"""The repository's live-cluster workloads for the disruption side, and
how a run on them is settled and observed.

Each builder takes ``pkg``, the names of one package that :func:`names`
gathers, and fills a store (or an environment) that package built, so the
same cluster can stand in the JAX package's store and in this one. The
tests (both packages, on the CPU) and ``chip_smoke.py`` (this package, on
the card) share them, and :func:`settle` and :func:`observe_lifecycle`,
which hold two runs equal.

- ``synth_cluster``: ``benchmarks/solve_configs.py``'s ``_synth_cluster``,
  the config4 cluster (spot c/m nodes of 4-16 vCPUs, 1..``pods_per_node``
  pods of 250m/512Mi bound to each, ``RandomState(seed)``);
- ``seed_launched``: instances and finalizers behind such claims;
- ``blocked_prefix_cluster`` and ``chooser_savings``:
  ``benchmarks/optimizer_bench.py``'s ``config6_multi_replace_optimizer``
  family and its chooser comparison.
"""

from __future__ import annotations

import re
from types import SimpleNamespace

import numpy as np


def names(module) -> SimpleNamespace:
    """The names the builders and harnesses read from one package:
    ``module(dotted)`` returns that package's module of the dotted name
    under its root (``module("models.labels")``), so the caller picks the
    package."""
    models = module("models")
    cp = module("cloudprovider.cloudprovider")
    return SimpleNamespace(
        lbl=module("models.labels"), make_pods=module("models.pod").make_pods,
        NodeClaim=models.NodeClaim, Node=module("state.cluster").Node,
        NodePool=models.NodePool, Requirement=models.Requirement, Operator=models.Operator,
        Disruption=models.Disruption, TopologySpreadConstraint=models.TopologySpreadConstraint,
        consolidate=module("ops.consolidate"), seed_instance=module("testenv").seed_instance,
        MANAGED_TAG=cp.MANAGED_TAG, NODEPOOL_TAG=cp.NODEPOOL_TAG,
        NODECLAIM_TAG=cp.NODECLAIM_TAG,
        FINALIZER=module("controllers.nodeclass_status").FINALIZER,
    )


def add_node(pkg, cluster, catalog, i, it, zone, pods=(), captype="spot", name="",
             provider="i-bench"):
    """One launched, registered, ready node of the default pool and its
    claim, with ``pods`` bound to it. The claim is named by the package's
    claim sequence unless ``name`` is given; its instance id is
    ``{provider}{i}``, which the fake cloud does not hold."""
    lbl = pkg.lbl
    kw = dict(nodepool_name="default", nodeclass_name="default",
              instance_type_options=[it.name], zone_options=[zone],
              capacity_type_options=[captype])
    claim = pkg.NodeClaim(name=name, **kw) if name else pkg.NodeClaim.fresh(**kw)
    claim.status.provider_id = f"cloud:///{zone}/{provider}{i}"
    claim.status.capacity = it.capacity()
    claim.status.allocatable = catalog.allocatable(it)
    claim.labels.update(it.labels())
    claim.labels[lbl.TOPOLOGY_ZONE] = zone
    claim.labels[lbl.CAPACITY_TYPE] = captype
    claim.labels[lbl.NODEPOOL] = "default"
    for cond in ("Launched", "Registered", "Initialized"):
        claim.status.set_condition(cond, True)
    cluster.apply(claim)
    node = pkg.Node(name=f"node-{claim.name}", provider_id=claim.status.provider_id,
                    nodepool_name="default", nodeclaim_name=claim.name,
                    labels=dict(claim.labels), capacity=claim.status.capacity,
                    allocatable=claim.status.allocatable, ready=True)
    node.labels[lbl.HOSTNAME] = node.name
    claim.status.node_name = node.name
    cluster.apply(node)
    for p in pods:
        cluster.apply(p)
        cluster.bind_pod(p.uid, node.name)
    return node


def config4_types(catalog) -> list:
    return [t for t in catalog.list() if t.category in ("c", "m") and 4 <= t.vcpus <= 16]


def synth_cluster(pkg, cluster, catalog, n_nodes: int = 5000, pods_per_node: int = 8,
                  seed: int = 1, name=None) -> None:
    """``_synth_cluster``'s nodes in ``cluster`` (its default pool applied
    already, where a controller reads it): node ``i`` draws its type, zone
    and fill from ``RandomState(seed)`` in the reference's order.
    ``name(i)``, when given, names the claims instead of the claim
    sequence. With ``pods_per_node=6`` it is ``config7_steady_state``'s
    cluster."""
    rng = np.random.RandomState(seed)
    types = config4_types(catalog)
    for i in range(n_nodes):
        it = types[rng.randint(len(types))]
        zone = catalog.zones[rng.randint(len(catalog.zones))]
        fill = rng.randint(1, pods_per_node + 1)
        add_node(pkg, cluster, catalog, i, it, zone,
                 pkg.make_pods(fill, f"p{i}", {"cpu": "250m", "memory": "512Mi"}),
                 name=name(i) if name else "")


def seed_launched(pkg, env) -> None:
    """Give every claim in ``env``'s store what a launch gives it: a running
    instance in the fake cloud (``pkg.seed_instance``), tagged as the cloud
    provider tags a launch and on the default nodeclass's image for its
    architecture, and the termination finalizer (the nodeclass's, the
    same name). Deleting such a claim
    then drains its node and terminates the instance through the
    termination controller, as for a claim the provisioner launched; a
    claim built without them leaves the store at once and its node
    stays."""
    lbl = pkg.lbl
    for claim in env.cluster.nodeclaims.values():
        pkg.seed_instance(
            env.cloud, instance_id=claim.status.provider_id.rsplit("/", 1)[-1],
            instance_type=claim.labels[lbl.INSTANCE_TYPE_LABEL],
            zone=claim.labels[lbl.TOPOLOGY_ZONE],
            capacity_type=claim.labels[lbl.CAPACITY_TYPE],
            image_id="img-std-arm-2" if claim.labels.get(lbl.ARCH) == "arm64" else "img-std-2",
            tags={pkg.MANAGED_TAG: "true", pkg.NODEPOOL_TAG: claim.nodepool_name,
                  pkg.NODECLAIM_TAG: claim.name})
        claim.finalizers.add(pkg.FINALIZER)


def blocked_prefix_cluster(pkg, env, seed: int) -> None:
    """``_blocked_prefix_cluster``: a cluster where the multi-replace
    prefix walk is blocked. The cheapest candidate (one pod of 24-27Gi with
    a zone spread, on a 4-vCPU r node) is in every cost-ordered prefix and
    makes each an infeasible replace set, while the 4 other nodes (8-vCPU c
    nodes, 2 pods of 500m/1Gi each) replace onto one cheap node. ``env``
    is fresh; the default pool is on-demand only, consolidating after 60 s
    under a 100% budget."""
    lbl = pkg.lbl
    rng = np.random.RandomState(seed)
    pool = pkg.NodePool(
        name="default",
        requirements=[pkg.Requirement(lbl.INSTANCE_CATEGORY, pkg.Operator.IN, ("c", "m", "r")),
                      pkg.Requirement(lbl.CAPACITY_TYPE, pkg.Operator.IN, ("on-demand",))],
        disruption=pkg.Disruption(consolidate_after_s=60, budgets=["100%"]),
    )
    env.apply_defaults(pool)
    catalog = env.catalog

    def add(i, type_filter, pods):
        cands = [t for t in catalog.list() if type_filter(t)]
        it = cands[rng.randint(len(cands))]
        zone = catalog.zones[rng.randint(len(catalog.zones))]
        add_node(pkg, env.cluster, catalog, i, it, zone, pods, captype="on-demand",
                 provider=f"i-opt{seed}-")

    add(0, lambda t: t.category == "r" and t.vcpus == 4,
        pkg.make_pods(1, f"blk{seed}",
                      {"cpu": "500m", "memory": f"{24 + int(rng.randint(4))}Gi"},
                      labels={"app": f"blk{seed}"},
                      topology_spread=[pkg.TopologySpreadConstraint(
                          topology_key=lbl.TOPOLOGY_ZONE, max_skew=1,
                          label_selector={"app": f"blk{seed}"})]))
    for i in range(1, 5):
        add(i, lambda t: t.category == "c" and t.vcpus == 8,
            pkg.make_pods(2, f"sm{seed}_{i}", {"cpu": "500m", "memory": "1Gi"}))


def chooser_savings(pkg, env, optimizer_on: bool) -> tuple[float, float]:
    """One multi-replace chooser decision, no launch: ``(candidate set
    price, net saving)``. Both choosers score sets through the controller's
    ``_eval_replace_set``; the optimizer's also tries the seeded subset
    proposals (``optimizer_replace_sets``) and keeps the best saving, the
    prefix walk commits the largest feasible prefix."""
    ct = pkg.consolidate.encode_cluster(env.cluster, env.catalog)
    cand = [int(i) for i in np.argsort(ct.disruption_cost, kind="stable")]
    dc = env.disruption
    top = min(len(cand), dc.MAX_REPLACE_SET)
    pools = env.cluster.nodepools
    ncmap = env.cluster.nodeclass_by_pool(pools)
    prefixes = [cand[:m] for m in range(top, 1, -1)]
    total = float(ct.price.sum())
    if optimizer_on:
        seen = {frozenset(p) for p in prefixes}
        proposed = [s for s in pkg.consolidate.optimizer_replace_sets(ct, cand[:top])
                    if frozenset(s) not in seen]
        best = 0.0
        for subset in proposed + prefixes:
            ev = dc._eval_replace_set(ct, subset, "default", pools, ncmap)
            if ev is not None:
                best = max(best, ev[0])
        return total, best
    for subset in prefixes:
        ev = dc._eval_replace_set(ct, subset, "default", pools, ncmap)
        if ev is not None:
            return total, ev[0]
    return total, 0.0


def multi_replace_row(pkg, new_environment, seeds: int = 12) -> dict:
    """``bench_multi_replace``: the optimizer's chooser against the prefix
    walk on ``blocked_prefix_cluster`` seeds ``0..seeds-1``, each in a fresh
    ``new_environment()``: cost over the prefix walk's (p50, p95, max) and
    how many seeds each chooser committed."""
    ratios, committed_opt, committed_base = [], 0, 0
    for seed in range(seeds):
        env = new_environment()
        try:
            blocked_prefix_cluster(pkg, env, seed)
            total, base_net = chooser_savings(pkg, env, False)
            _, opt_net = chooser_savings(pkg, env, True)
        finally:
            env.close()
        committed_opt += opt_net > 0
        committed_base += base_net > 0
        if total - base_net > 0:
            ratios.append((total - opt_net) / (total - base_net))
    return {"seeds": seeds, "ratios": ratios,
            "cost_vs_oracle_p50": round(float(np.percentile(ratios, 50)), 4),
            "cost_vs_oracle_p95": round(float(np.percentile(ratios, 95)), 4),
            "cost_vs_oracle_max": round(float(np.max(ratios)), 4),
            "committed_optimizer": int(committed_opt), "committed_prefix": int(committed_base)}


# -- settling and observing a run ---------------------------------------------

def _step(env) -> None:
    env.step()
    if env.manager.errors:
        raise AssertionError(f"reconcile errors: {env.manager.errors}")


def settle(env, step=_step, max_passes: int = 40) -> int:
    """Manager passes, one ``step(env)`` each (by default ``env.step()``,
    raising on a reconcile error), until no pod is pending and no claim is
    deleting. Returns how many it took; raises after ``max_passes``."""
    for n in range(max_passes):
        if not env.cluster.pending_pods() and not any(
                c.deleted for c in env.cluster.nodeclaims.values()):
            return n
        step(env)
    raise AssertionError(f"the cluster did not settle in {max_passes} passes")


#: a claim named by a package's claim sequence (pool "default") and an
#: instance id of a package's fake cloud: both counters are per package and
#: per process, so runs are compared with them in order of creation
_CLAIM = re.compile(r"\bdefault-[0-9a-f]+\b")
_INSTANCE = re.compile(r"\bi-[0-9a-f]{8}\b")


def _by_creation(pattern, texts, prefix):
    """Rewrite every match of ``pattern`` in a string as ``prefix`` and its
    rank among all matches in ``texts`` by the sequence number it ends in."""
    found = {m for t in texts for m in pattern.findall(t)}
    rank = {n: f"{prefix}{i}" for i, n in
            enumerate(sorted(found, key=lambda n: int(n.rsplit("-", 1)[1], 16)))}
    return lambda t: pattern.sub(lambda m: rank[m.group(0)], t)


def observe_lifecycle(env, placed=None) -> dict:
    """What two runs where claims come and go are held equal on: the
    launches (with each instance's state), which pods share a node, the
    pending pods, the whole audit trail, the disruption log, the handled
    interruptions, the reaped lists and the claims, with every claim and
    instance name standing as its order of creation, finalized claims
    included. With ``placed`` (pod uid -> node before the run), also how
    many pods that moved went onto a node of that cluster and how many
    onto one launched since. Raises if the audit ring has dropped records:
    size it for the run (``new_environment(audit_capacity=...)``)."""
    audit = env.obs.audit
    records = [(r.kind, r.subject_kind, r.subject, r.decision) for r in audit.query()]
    if len(records) >= audit._ring.maxlen:  # full: the oldest may be gone
        raise AssertionError(f"the audit ring holds {len(records)} records, its capacity; "
                             "the trail is not whole")
    handled = [(e.kind, tuple(e.instance_ids), e.action_drain, e.reason, e.severity)
               for e in env.interruption.handled]
    texts = ([t for r in records for t in r[2:]] + [c for c, _ in env.disruption.disrupted]
             + [r for _, r in env.disruption.disrupted] + list(env.cluster.nodeclaims)
             + [i for e in handled for i in e[1]] + list(env.garbagecollection.reaped)
             + list(env.liveness.reaped) + list(env.cloud.instances))
    claim = _by_creation(_CLAIM, texts, "claim")
    inst = _by_creation(_INSTANCE, texts, "inst")

    def norm(t: str) -> str:
        return inst(claim(t))

    by_node: dict = {}
    for pod in env.cluster.pods.values():
        if pod.node_name:
            by_node.setdefault(pod.node_name, []).append(pod.name)
    out = {
        "launched": sorted((i.instance_type, i.zone, i.capacity_type, i.state)
                           for i in env.cloud.instances.values()),
        "pods_by_node": sorted(sorted(v) for v in by_node.values()),
        "pending": sorted(p.name for p in env.cluster.pending_pods()),
        "decisions": [(k, sk, norm(sub), norm(d)) for k, sk, sub, d in records],
        "disrupted": [(norm(c), norm(r)) for c, r in env.disruption.disrupted],
        "handled": [e[:1] + (tuple(norm(i) for i in e[1]),) + e[2:] for e in handled],
        "gc_reaped": [norm(i) for i in env.garbagecollection.reaped],
        "liveness_reaped": [norm(c) for c in env.liveness.reaped],
        "claims": sorted(norm(c) for c in env.cluster.nodeclaims),
    }
    if placed is not None:
        live = set(placed.values())
        moved = [p.node_name for p in env.cluster.pods.values()
                 if p.node_name and placed.get(p.uid) not in (None, p.node_name)]
        out["bound_live"] = sum(1 for n in moved if n in live)
        out["bound_fresh"] = len(moved) - out["bound_live"]
    return out
