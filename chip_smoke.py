"""Drive the torch package on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

It drives the package's paths: the provisioning solve (the FFD kernel), with
the market on in phase 11, the consolidation screen (the repack kernel), the
consolidation pass under churn (phase 10), the provisioning control plane
(phase 13), its disruption half (phases 14-15) and the scale tier (phases
16-17: the partition router, the partitioned encode, one repack launch a
partition, partition lanes of the FFD kernel). Phases, each printing one
JSON line (any failure exits non-zero):
  1. probe   — device name, compute capability (must be 9.0), nvidia-smi;
  2. build   — compile every kernel under karpenter_provider_aws_tpu_torch/csrc
               (one nvcc per source, all started together); ptxas's
               registers, shared memory and spills, each source's full
               sha256, and the FFD kernel's cluster occupancy on both
               branches;
  3. parity  — the FFD kernel against its plain PyTorch version on the same
               CUDA tensors: ``ops/ffd_cases.py``'s cases (a random family,
               row exhaustion, pre-opened rows, count-0 groups between real
               ones, an opened range and a row exhaustion across the
               kernel's per-CTA slices, R = 16, hostname-capped groups
               beside pre-opened rows, the global-memory branch at 20,480
               rows, T = 2,048, a zero-request group), the headline at
               8,192 rows and config8's encoded problem (integers exact,
               floats to rtol 1e-6 / atol 1e-3); and partition lanes
               (``ffd_cases.lanes_pre_opened``: 3 lanes of T = 40 / 64 / 25
               types from 0 / 300 / 2,000 pre-opened rows, 4,096 rows, in
               one launch) against each lane's plain solve, its solo launch
               and the CPU's lanes;
  4. main    — TorchSolver().solve on the headline problem (50,000 pods in
               64 shapes, seed 0, one pool of c/m/r, the real catalog), which
               must launch the kernel, place every pod, and give the same plan
               as the same solve with every tensor on the CPU;
  5. timing  — config8 (``benchmarks/solve_configs.py``'s 300-deployment
               fleet, seed 3) solved on the card and on the CPU (same plan),
               then the FFD wrapper's time per call (``kernel_ms``: CUDA events
               around the whole call, its zero fills included), the
               kernel's device time (``device_ms``: the profiler's CUDA
               records, with how many it kept), the plain version and the
               bound at the rows the main path used (held to the plain
               version there too), at 8,192 rows, at config8's rows and on
               the global-memory branch, with real groups and microseconds
               of device time per real group;
  6. profile — device time by kernel over one warm solve, and the idle share;
  7. repack_parity — the repack kernels against their plain PyTorch version
               on the same CUDA tensors: ``ops/repack_cases.py``'s random
               family (seeds 0-7), candidate subset, empty node,
               nothing-fits, self-exclusion and float hostname cap, its
               table-design cases (``long_touch``: hundreds of rows filled
               by one candidate, ``repeat_group``, ``negative_count``,
               ``no_groups``), its wide cases at N = 8,192 and N = 12,000
               (sparse targets, thousands of rows apart), its dense cluster
               (5,000 large nodes, 150-230 pods in 8 live slots each),
               config4, and config4 padded as the device-resident mirror
               holds it (``mirror_padded``) (``ok`` exact);
  8. consolidation — the screen's main path on config4 (the 5,000-node
               ``_synth_cluster`` of the repo's benchmarks): encode_cluster,
               consolidatable (must launch the repack kernels, pass 5,000
               nodes and equal the CPU mask), the delete prefix (must be
               4,306), warm screen times, and one screen under the profiler;
  9. repack_timing — at config4's shapes, at ``mirror_padded``'s, N = 8,192,
               N = 12,000 and the dense cluster: the wrapper's time per
               call (``kernel_ms``: CUDA events around the whole call), the
               three kernels' device time per call (``device_ms``, from the profiler's
               CUDA records, with how many it kept) and each one's
               (``table_ms``, ``carry_ms``, ``verdict_ms``), the plain
               version, the bound (the inputs read and ``ok`` written once;
               the table's own traffic beside it as ``table_bytes``) and
               the old per-node walk's count (``walk_ops``, ``walk_ms``);
  10. churn — the consolidation pass under churn on a fresh config4 cluster
               in the journaled store: the full encode, an unchanged pass
               (a hit), 30 passes of 1% churn (RandomState(7), 50 binds or
               unbinds each) and 10 of membership churn (RandomState(8), 25
               cordon flips, claim deletes, node adds or node deletes each),
               each through the incremental encode_cluster, consolidatable
               on the card through the device-resident mirror, delete_prefix
               and cheaper_replacement; every pass canonically equal to a
               fresh full encode, the mirror equal to a fresh upload, the
               mask equal by node name to the CPU screen of the fresh
               encode, one screen launched; at least 28 light passes
               patched and one upload among the first 32; encode, patch
               call, screen, prefix and replace times and bytes moved;
               then, in a child process (``--churn-profile``), 5 light
               passes with the screen stage under the profiler: the patch's
               device time from its CUDA records, the repack kernels', and
               the device's idle share of a light pass;
  11. market — config5 (two reservations, a MarketModel(seed=0), the
               market on) through TorchSolver() on the card: the plan equals
               the CPU solve's, one FFD launch of 2 lanes (a lane a pool),
               reserved nodes used;
  12. optimizer — the optimizer lane, the default solve (phases 3-11 run
               with KARPENTER_TPU_OPTIMIZER=0, so their checks stay what
               they were): ``optimizer_solves``, TorchSolver() lane on
               against TorchSolver(device="cpu") with the same seed on the
               headline's first solve (1 + 3 launches, 1 + 24 lanes),
               config8 and frag seeds 0-11 (equal plans and outcomes), and
               the count of the noise's float32 Gumbel values that differ
               between the CPU and the card over all 2^23 mantissas (must
               be 0);
               ``optimizer_headline``, the headline's warm solve wall with
               the lane off and on and the reference's gate (opt p99 <= 12 x
               ffd p50); ``optimizer_lanes``, the lane launch
               (``ffd_solve_lanes``, 8 lanes in one launch, round 0 of the
               lane program) exact against 8 plain solves on the kernel's
               one-CTA layout (config8, 768 rows), its 8-CTA shared-memory
               layout (the headline at 4,096 rows and at the rows its
               lane-on solve gave the lanes) and its global-memory branch
               (20,480 rows), with the clusters the card holds at once and
               the 8 lanes' device time beside lane 0's alone;
               ``optimizer``, the reference's config6_frag_optimizer row on
               the port (cost over the greedy oracle's, p50 / p95 / max,
               adopted and rejected; solve wall with the lane off and on, 3
               warm-ups and 10 timed; the lane's device time from the
               profiler, its stages and its input bytes);
  13. controlplane — the provisioning control plane through
               ``testenv.new_environment()`` and its reconcile loop, the
               lane on: ``controlplane_config7``, 2,000 live spot c/m nodes
               (``config7_steady_state``'s cluster) and a burst of 500 pods
               of 500m/1Gi, the provisioner's reconcile first (the host
               binder runs before it in a manager pass and would take a
               burst of 512 pods or fewer itself), then manager passes until
               no pod is pending, 10 bursts on fresh copies: the reconcile's
               p50 / p99 and its split (prepare, snapshot, solve = encode +
               device + decode, audit, bind, launch, oracle), binds onto
               live nodes and fresh ones, the lane outcome (skipped_existing),
               the FFD launches and the rows offered; ``controlplane_config8``,
               config8's 1,201 pods into an empty cluster, stepped until none
               is pending: passes, walls, the lane outcome, claims launched
               and their $/hr, FFD launches and lanes. The first config7
               burst and the config8 run are repeated with
               ``new_environment(device="cpu")`` and must match (launched
               types, zones and capacity types; pods sharing a node; pending
               pods; audit decisions); every pass must leave
               ``manager.errors`` empty;
  14. controlplane_config4 — the disruption half of the control plane on
               config4 (``config4_consolidation``'s controller pass, nothing
               cut): 5,000 spot c/m nodes and 22,791 pods in
               ``new_environment()``, each claim backed by a seeded instance
               and the termination finalizer; the pool consolidating after
               60 s under a 10% budget, the clock 120 s on, one
               ``env.disruption.reconcile()`` timed as ``controller_pass_ms``
               with its split (scan, phases, encode, screen dispatch and
               wait, candidate walk, feasible-prefix search, commits,
               replacements; the screen's ``LAST_SCREEN``), which must launch
               the repack kernel; then manager passes until no pod is
               pending and no claim is deleting (termination drains, the host
               binder and the provisioner re-place the pods onto the
               survivors, the FFD kernel at least once, and the disruption
               controller consolidates on in every pass); then 5 warm
               disruption passes (50 pods finish before each, the clock
               past consolidate-after) with p50 / p99, and one ``ct``
               screened on the card and the CPU in turns; the first pass
               and the settle repeat on ``new_environment(device="cpu")``
               and must match (``cluster_cases.observe_lifecycle``:
               disruptions and reasons, launches, pods sharing a node,
               pending pods, the whole audit trail, its ring sized to keep
               every record, the reaped lists and the claims);
  15. controlplane_interruption — config7's 2,000 live spot nodes as
               launched claims, a spot-interruption warning for 200 of them
               (RandomState(2)) through the fake queue, manager passes until
               nothing is pending and no claim is deleting: the FFD kernel at
               least once, the offerings masked, binds onto live nodes
               against fresh claims; repeated on the CPU and equal;
               ``disruption_multi_replace`` — the multi-replace chooser on
               ``config6_multi_replace_optimizer``'s seeds 0-11 (host work):
               cost over the prefix walk's, p95 must be the reference's
               0.3321;
  16. scale_config9 — config9 (``benchmarks/scale_bench.py``: 100,000 c/m
               nodes of 1-4 pods, RandomState(1), four (default, zone)
               partitions) in ``new_environment()``'s store, the partitioned
               encode reached through the ``auto`` switch: the cold encode,
               a hit, 10 passes of 1% node churn (RandomState(23), every one
               incremental: p50 / p99), the merged emission canonical-equal
               to a fresh global encode; the partitioned screen (4 repack
               launches, each partition's mask held to the plain version on
               its mirror's CUDA tensors, the merged mask to the CPU's; one
               partition's sweep and all four's, the kernels' times at the
               largest partition); the per-zone burst (1,000 pods, 250 a
               zone) as ONE FFD launch of 4 lanes of 256 rows, each lane held
               to its plain solve, its solo launch and the CPU, and
               ``merge_partition_plans``' cost_lanes / cost_merged with every
               pod kept; peak device memory (three lines: ``scale_config9``,
               ``scale_config9_screen``, ``scale_config9_lanes``);
  17. controlplane_partitioned — one disruption pass over 12,000 of
               config4's nodes in four partitions (the pool consolidating
               under a 10% budget): one repack launch a partition, and the
               card's pass equal to the CPU's (claims disrupted, the whole
               audit trail); config5 (market on) through TorchSolver(): ONE
               FFD launch of 2 lanes, its plan the CPU's and the one-by-one
               solve's (2 launches); the cramped cross-partition case:
               every zone-a node passes the whole screen and fails the
               partitioned one;
then the kernels line, the card's name and power limit, and the result line.
It needs the repository's package beside it and a CUDA device; without
either it prints no result and exits 2.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
RTOL, ATOL = 1e-6, 1e-3
HEADLINE_PODS = 50_000
CONFIG8_ROWS = 768  # the rows TorchSolver gives config8's kernel launch


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


FFD_FIELDS = ("requests", "counts", "compat", "capacity", "price", "group_window",
              "type_window", "max_per_node")


def problem_arrays(problem) -> dict:
    """An encoded (padded) problem's FFD inputs as host arrays."""
    arrays = {k: getattr(problem, k) for k in FFD_FIELDS}
    arrays["max_per_node"] = np.minimum(arrays["max_per_node"], 1 << 30).astype(np.int32)
    return arrays


def to_device(arrays, ffd, device):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()
         if k not in ("group_window", "type_window")}
    t["group_window"] = torch.from_numpy(ffd.pack_window_bits(arrays["group_window"])).to(device)
    t["type_window"] = torch.from_numpy(ffd.pack_window_bits(arrays["type_window"])).to(device)
    return t


def device_ms(fn, keys: tuple, runs: int) -> tuple[dict, int]:
    """Mean device time (ms) per call of each kernel whose name holds one of
    ``keys``, over ``runs`` calls of ``fn``, from the profiler's CUDA
    activity records (the kernels alone, without the wrapper's host work or
    its other launches), and the fewest records the profiler kept of any of
    them: each mean is over its own records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    means, kept = {}, runs
    for key in keys:
        us, count = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and key in evt.key:
                t = getattr(evt, "self_device_time_total", None)
                us += evt.self_cuda_time_total if t is None else t
                count += evt.count
        if not 1 <= count <= runs:
            raise AssertionError(f"the profiler saw {count} launches of {key}, expected {runs}")
        means[key] = us / count / 1e3
        kept = min(kept, count)
    return means, kept


def ffd_times(ffd_cuda, t, N, init=None, n_pre=0, runs: int = 30) -> dict:
    """The FFD wrapper's times on one problem: ``kernel_ms``, the median
    per-call CUDA-event time of the whole wrapper call (its zero fills and
    host work included), and ``device_ms``, the kernel's own device time,
    with the profiler's records kept of ``runs``."""
    def kernel():
        return call(ffd_cuda.ffd_solve, t, N, init, n_pre)

    dev_ms, records = device_ms(kernel, ("ffd_kernel",), runs)
    return {"kernel_ms": time_cuda(kernel, runs=runs), "device_ms": dev_ms["ffd_kernel"],
            "device_records": records, "runs": runs}


#: the repack screen's kernels (``csrc/repack.cu``): the table, its carry
#: pass, the verdicts
REPACK_KERNELS = ("repack_table_kernel", "repack_carry_kernel", "repack_verdict_kernel")


def repack_times(repack_cuda, rt, keys=REPACK_KERNELS, runs: int = 30) -> dict:
    """The repack wrapper's times on one screen: ``kernel_ms``, the median
    per-call CUDA-event time of the whole wrapper call (its allocations and
    host work included), and ``device_ms``, its kernels' device time per
    call summed, with the profiler's records kept of ``runs`` and each
    kernel's own time under its name."""
    def kernel():
        return repack_cuda.repack_check(*rt)

    per, records = device_ms(kernel, keys, runs)
    return {"kernel_ms": time_cuda(kernel, runs=runs), "device_ms": sum(per.values()),
            "device_records": records, "runs": runs, "per_kernel_ms": per}


def call(solve, t, N, init=None, n_pre=0):
    return solve(t["requests"], t["counts"], t["compat"], t["capacity"], t["price"],
                 t["group_window"], t["type_window"], max_per_node=t["max_per_node"],
                 max_nodes=N, init_state=init, n_pre=n_pre)


def compare(name, got, want) -> float:
    """Integers exact, floats to the stated tolerance; returns the largest
    absolute float difference."""
    for field in ("placed", "unplaced", "n_open", "node_type", "node_window"):
        if not torch.equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"{name}: kernel and plain version differ in {field}")
    err = 0.0
    for field in ("node_price", "used"):
        a, b = getattr(got, field), getattr(want, field)
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=f"{name}: {field}")
        err = max(err, float((a - b).abs().max()))
    return err


def kernel_bytes_and_ops(t, N, res, n_pre=0) -> tuple[int, int]:
    """Bytes the solve must move (each input read once, each output written
    once) and the f32 operations this run's data needs: per group, the fit
    over the rows open at its start (the ``n_pre`` pre-opened ones and those
    opened before; sub, add, div, min per resource) and the per-type fit of
    the open phase."""
    G, R = t["requests"].shape
    T = t["capacity"].shape[0]
    state = N * (4 + 4 + 4) + 2 * N * R * 4 + 4
    inputs = (G * R * 4 + G * 4 + G * T + T * R * 4 + G * T * 4 + G * 4 + T * 4 + G * 4 + 4
              + state)
    outputs = state + G * N * 4 + G * 4
    placed = (res.placed > 0).cpu().numpy()
    last_row = np.where(placed.any(axis=0))[0]
    opened = np.zeros(G, dtype=np.int64)  # rows open at each group's start
    high = n_pre - 1
    for g in range(G):
        opened[g] = high + 1
        rows = np.nonzero(placed[g])[0]
        if rows.size:
            high = max(high, int(rows.max()))
    assert last_row.size == 0 or high >= int(last_row.max())
    ops = int(opened.sum()) * R * 4 + G * T * R * 3
    return inputs + outputs, ops


def same_plan(got, want, what: str) -> None:
    """The CUDA solve's plan (types, pods per node, binds, cost) equals the
    CPU solve's."""
    def plan(r):
        return ([(s.instance_type_options[0], [p.name for p in s.pods]) for s in r.node_specs],
                [(p.name, n) for p, n in r.binds])

    if plan(got) != plan(want):
        raise AssertionError(f"{what}: the CUDA plan differs from the CPU plan")
    if abs(got.total_cost - want.total_cost) > 1e-6 * max(1.0, want.total_cost):
        raise AssertionError(f"{what}: cost {got.total_cost} vs CPU {want.total_cost}")


def time_cuda(fn, runs: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def repack_bytes_and_ops(t) -> dict:
    """The screen's work, and the old walk's beside it. ``bytes``: each
    input read once and the ``ok`` mask written once (what the function
    needs; the kernels' own [G, N] tables, the int32 fit and the int64 list
    of rows with room, each written once and read once, are printed beside
    it as ``table_bytes`` and not counted). ``ops``: the
    f32 operations this run's data needs: per group and node the fit over
    the resources the group requests (add, divide, min: 3 per such axis;
    the others are skipped), then the clamp, the cap and the scan (6); then
    per live slot (count > 0) of each candidate, 4 (the self term, the sum,
    the min with the count, the leftover). ``walk_ops``: the old walk's
    count, the fit, scan and placement over every node for every
    candidate's live slot."""
    free, requests, gids, gcounts, cap, cand = t
    N = free.shape[0]
    G = requests.shape[0]
    nbytes = sum(x.numel() * x.element_size() for x in t) + cand.numel()  # ok: 1 byte each
    rows = cand.long()
    live = gcounts[rows] > 0
    axes = (requests > 0).sum(dim=1)  # [G] resources each group requests
    per_node = 3 * axes + 6
    ops = int(per_node.sum()) * N + 4 * int(live.sum())
    walk_ops = int(per_node[gids[rows][live].long()].sum()) * N
    return {"bytes": nbytes, "table_bytes": 2 * G * N * (4 + 8), "ops": ops,
            "walk_ops": walk_ops,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / F32_FLOPS * 1e3,
            "walk_ms": walk_ops / F32_FLOPS * 1e3}


def config4_cluster(n_nodes=5000, pods_per_node=8):
    """The repo's config4 cluster (``benchmarks/solve_configs.py``
    ``_synth_cluster``): RandomState(1), c/m types of 4-16 vCPUs, spot, one
    claim and one ready node each, 1..8 pods of 250m/512Mi bound to it, in
    the port's journaled store."""
    from karpenter_provider_aws_tpu_torch.catalog import CatalogProvider
    from karpenter_provider_aws_tpu_torch.ops import cluster_cases
    from karpenter_provider_aws_tpu_torch.state import Cluster

    catalog = CatalogProvider()
    cluster = Cluster()
    cluster_cases.synth_cluster(port_pkg(), cluster, catalog, n_nodes, pods_per_node,
                                name=lambda i: f"default-{i:x}")
    return cluster, catalog


def _profiled(fn) -> tuple:
    """``fn()``'s result, its wall ms (synchronised) and the profiler that
    traced it, CPU and CUDA."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, prof


def _trace_counts(prof) -> dict:
    """The device records the trace kept, and the CUDA runtime's launch and
    copy calls it saw on the host: fewer records than calls means records
    were lost."""
    from torch.autograd import DeviceType

    kept = calls = 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kept += evt.count
        elif evt.key.startswith(("cudaLaunchKernel", "cudaMemcpy")):
            calls += evt.count
    return {"device_records": kept, "runtime_calls": calls}


def profile_solve(solve) -> dict:
    """Device time by kernel over one call, and the device's idle share of
    its wall time (the profiler's own cost is inside the wall)."""
    from torch.autograd import DeviceType

    _, wall_ms, prof = _profiled(solve)
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((evt.key[:80], us / 1e3, evt.count))
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    return {"phase": "profile", "wall_ms": wall_ms, **_trace_counts(prof),
            "device_busy_ms": busy_ms if kernels else "not measured",
            "idle_share": 1.0 - busy_ms / wall_ms if kernels else "not measured",
            "kernels": kernels[:15]}


#: device records of one row patch of the mirror: five host-to-device copies
#: (the row index and the free, gids, gcounts and cap blocks) and four
#: index_copy_ writes
PATCH_RECORDS = 9


def profile_stage(fn) -> tuple:
    """``fn()``'s result, and its device activity from the profiler's CUDA
    records: the busy total; the repack kernels', the device-to-host copies'
    and the rest's (the mirror patch: its host-to-device copies and
    index_copy_ writes) time and records kept; and every record as (key, ms,
    count). The stage's wall time includes the profiler's own cost."""
    from torch.autograd import DeviceType

    out, wall_ms, prof = _profiled(fn)
    rec = {"stage_wall_ms": wall_ms, **_trace_counts(prof), "busy_ms": 0.0, "records": []}
    for kind in ("repack", "d2h", "patch"):
        rec[f"{kind}_ms"], rec[f"{kind}_records"] = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        ms = (evt.self_cuda_time_total if us is None else us) / 1e3
        kind = "repack" if "repack_" in evt.key else "d2h" if "DtoH" in evt.key else "patch"
        rec[f"{kind}_ms"] += ms
        rec[f"{kind}_records"] += evt.count
        rec["busy_ms"] += ms
        rec["records"].append((evt.key[:120], ms, evt.count))
    return out, rec


def screen_phases(dev, name: str, smi: str) -> dict:
    """Phases 7-9: the repack kernels against their plain version, the
    consolidation screen's main path on config4, and the kernels' timing.
    Returns the repack kernels' entry of the kernels line."""
    from karpenter_provider_aws_tpu_torch.ops import consolidate, repack_cases, repack_cuda

    # 7. repack parity: kernels vs plain version on the same CUDA tensors (the
    # config4 case from its own encode, so the main path below uploads anew)
    t_build = time.perf_counter()
    cluster4, catalog4 = config4_cluster()
    cluster_build_s = time.perf_counter() - t_build
    ct4 = consolidate.encode_cluster(cluster4, catalog4, incremental=False)
    config4_arrays = consolidate.screen_arrays(ct4)
    cases = {**repack_cases.small_cases(seeds=8), **repack_cases.path_cases(),
             **repack_cases.large_cases(), **repack_cases.dense_cases(),
             **repack_cases.mirror_cases(ct4)}
    cases["config4"] = tuple(config4_arrays[k] for k in (
        "free", "requests", "group_ids", "group_counts", "cap", "candidates"))
    rcases, rtensors, repack_err = {}, {}, 0.0
    for cname, arrays in cases.items():
        rt = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        got = repack_cuda.repack_check(*rt)
        torch.cuda.synchronize()
        want = consolidate.repack_check(*rt)
        err = float((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        repack_err = max(repack_err, err)
        if err != 0.0 or not torch.equal(got, want):
            raise AssertionError(f"{cname}: repack kernel and plain version differ on "
                                 f"{int((got != want).sum())} of {got.numel()} candidates")
        N_c, R_c = arrays[0].shape
        rcases[cname] = {"N": N_c, "R": R_c, "C": int(arrays[5].shape[0]),
                         "S": int(arrays[2].shape[1]), "ok": int(got.sum()),
                         "max_abs_err": err,
                         "compat_density": float((arrays[4] > 0).mean()) if arrays[4].size
                         else 0.0}
        rtensors[cname] = rt
    for cname in ("global_scratch_8192", "two_tiles_12000"):
        c = rcases[cname]  # sparse targets, thousands of rows apart; verdicts split
        if c["N"] < 8192 or not 0 < c["compat_density"] < 0.002 or not 0 < c["ok"] < c["C"]:
            raise AssertionError(f"{cname}: expected sparse targets and split verdicts, got {c}")
    emit({"phase": "repack_parity", "parity": "exact", "max_abs_err": repack_err,
          "cases": rcases})

    # 8. consolidation: the screen's main path on config4, through the kernel
    # (the full encode, uploaded per ct: the churn phase takes the
    # incremental encode and the mirror)
    t_enc = time.perf_counter()
    ct = consolidate.encode_cluster(cluster4, catalog4, incremental=False)
    encode4_ms = (time.perf_counter() - t_enc) * 1e3
    repack_cuda.LAUNCHES = 0
    mask = consolidate.consolidatable(ct)
    repack_launches = repack_cuda.LAUNCHES
    first_screen = dict(consolidate.LAST_SCREEN)
    if repack_launches < 1:
        raise AssertionError("the consolidation screen never launched the repack kernel")
    n_nodes, n_groups = len(ct.node_names), int(ct.requests.shape[0])
    n_pods = int(ct.group_counts.sum())
    if (n_nodes, n_groups, n_pods) != (5000, 1, 22791):
        raise AssertionError(f"config4 encoded to N={n_nodes}, G={n_groups}, {n_pods} pods")
    if int(mask.sum()) != 5000:
        raise AssertionError(f"{int(mask.sum())} of 5000 nodes passed the screen")
    t_pre = time.perf_counter()
    prefix = consolidate.delete_prefix(ct, mask)
    prefix_ms = (time.perf_counter() - t_pre) * 1e3
    if len(prefix) != 4306:
        raise AssertionError(f"delete prefix {len(prefix)}, expected 4306")
    t_cpu = time.perf_counter()
    cpu_mask = consolidate.consolidatable(ct, device="cpu")
    cpu_screen_ms = (time.perf_counter() - t_cpu) * 1e3
    if not np.array_equal(mask, cpu_mask):
        raise AssertionError("the CUDA screen mask differs from the CPU mask")
    warm = {"wall_ms": [], "upload_ms": [], "launch_ms": [], "fetch_ms": []}
    for _ in range(7):
        ct.__dict__.pop("_screen_mask_memo", None)
        t_w = time.perf_counter()
        if not np.array_equal(consolidate.consolidatable(ct), mask):
            raise AssertionError("a warm screen gave another mask")
        warm["wall_ms"].append((time.perf_counter() - t_w) * 1e3)
        for k in ("upload_ms", "launch_ms", "fetch_ms"):
            warm[k].append(consolidate.LAST_SCREEN[k])
    ct.__dict__.pop("_screen_mask_memo", None)
    prof = profile_solve(lambda: consolidate.consolidatable(ct))
    prof["phase"] = "profile_screen"
    emit({"phase": "consolidation", "nodes": n_nodes, "groups": n_groups, "pods": n_pods,
          "slot_width": int(config4_arrays["group_ids"].shape[1]),
          "blocked": int(ct.blocked.sum()), "passed": int(mask.sum()),
          "delete_prefix": len(prefix), "cpu_mask_equal": True,
          "launches": repack_launches, "cluster_build_s": cluster_build_s,
          "encode_ms": encode4_ms, "first_screen": first_screen, "prefix_ms": prefix_ms,
          "cpu_screen_ms": cpu_screen_ms,
          "warm_median_ms": {k: statistics.median(v) for k, v in warm.items()},
          "backend": first_screen["backend"], "device": name, "card": smi})
    emit(prof)

    # 9. repack timing at config4's shapes (the main path's own tensors), at
    # config4 padded as the mirror holds it (the churn passes' shapes), at
    # N = 8,192, at N = 12,000 and on the dense cluster
    main4 = ct.__dict__["_screen_device"][dev]
    main4 = [main4[k] for k in ("free", "requests", "group_ids", "group_counts", "cap",
                                "candidates")]
    rtiming = {}
    for cname, rt in (("config4", main4),
                      ("mirror_padded", rtensors["mirror_padded"]),
                      ("global_scratch_8192", rtensors["global_scratch_8192"]),
                      ("two_tiles_12000", rtensors["two_tiles_12000"]),
                      ("dense_5000", rtensors["dense_5000"])):
        work = repack_bytes_and_ops(rt)
        times = repack_times(repack_cuda, rt)
        per = times.pop("per_kernel_ms")
        rtiming[cname] = {
            "N": int(rt[0].shape[0]), "C": int(rt[5].shape[0]), "S": int(rt[2].shape[1]),
            **times, "table_ms": per["repack_table_kernel"],
            "carry_ms": per["repack_carry_kernel"], "verdict_ms": per["repack_verdict_kernel"],
            "plain_ms": time_cuda(lambda: consolidate.repack_check(*rt), runs=5, warmup=1),
            **work, "bound_ms": max(work["bytes_ms"], work["ops_ms"]),
            "bound_by": "bytes" if work["bytes_ms"] >= work["ops_ms"] else "operations",
        }
    emit({"phase": "repack_timing", "shapes": rtiming, "launches_per_screen": repack_launches,
          "library_ms": None, "card": smi})

    r4 = rtiming["config4"]  # the repack kernels' line is at config4's shapes
    return {
        "name": "repack", "route": "cuda",
        "source": "karpenter_provider_aws_tpu_torch/csrc/repack.cu",
        "replaces": "karpenter_provider_aws_tpu/ops/repack_pallas.py:49",
        "tpu_kernel": "ops/repack_pallas.py::_kernel",
        "launches": repack_launches, "parity": "exact", "max_abs_err": repack_err,
        "nodes": r4["N"], "ms": r4["kernel_ms"], "device_ms": r4["device_ms"],
        "device_records": r4["device_records"], "plain_ms": r4["plain_ms"],
        "bound_ms": r4["bound_ms"], "bound_by": r4["bound_by"],
        "walk_ms": r4["walk_ms"],
        "library_ms": None,
    }


def _light_churn(cluster, names, rng, n, tag) -> None:
    """``benchmarks/encode_bench.py``'s 1% churn: ``n`` mutations, each a
    new 250m/512Mi pod bound to a random node or an unbind of one of the
    first 256 stored pods that is bound."""
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods

    for _ in range(n):
        if rng.rand() < 0.5:
            p = make_pods(1, tag, {"cpu": "250m", "memory": "512Mi"})[0]
            cluster.apply(p)
            cluster.bind_pod(p.uid, names[rng.randint(len(names))])
        else:
            bound = [pp for pp in list(cluster.pods.values())[:256] if pp.node_name]
            if bound:
                cluster.unbind_pod(bound[rng.randint(len(bound))].uid)


def _membership_churn(cluster, catalog, names, rng, n, next_node) -> int:
    """``n`` mutations drawn from ops 3-6 of the reference's incremental
    property (``tests/test_encode_incremental.py``): a direct cordon flip, a
    claim marked deleted, a node added, a node deleted. Returns the next
    free node index."""
    from karpenter_provider_aws_tpu_torch.ops import cluster_cases

    types = cluster_cases.config4_types(catalog)
    for _ in range(n):
        op = 3 + rng.randint(4)
        if op == 3:
            node = cluster.nodes.get(names[rng.randint(len(names))])
            if node is not None:
                node.cordoned = not node.cordoned
        elif op == 4:
            live = [c for c in cluster.nodeclaims.values() if not c.deleted]
            if len(live) > 3:
                claim = live[rng.randint(len(live))]
                claim.finalizers = {"karpenter"}
                cluster.delete(claim)
        elif op == 5:
            it = types[rng.randint(len(types))]
            zone = catalog.zones[rng.randint(len(catalog.zones))]
            names.append(cluster_cases.add_node(port_pkg(), cluster, catalog, next_node, it,
                                                zone, name=f"default-{next_node:x}").name)
            next_node += 1
        else:
            node = cluster.nodes.get(names[rng.randint(len(names))])
            if node is not None:
                cluster.delete(node)
    return next_node


def _pct(values, q) -> float:
    return float(np.percentile(values, q)) if values else float("nan")


def _decide(ct, mask, cluster, catalog, pools) -> tuple:
    """The pass's decisions after the screen, on the host: the delete
    prefix, then ``cheaper_replacement`` over the screened candidates
    outside it. Returns (prefix, replacements, prefix ms, replace ms)."""
    from karpenter_provider_aws_tpu_torch.ops import consolidate

    t0 = time.perf_counter()
    prefix = consolidate.delete_prefix(ct, mask)
    prefix_ms = (time.perf_counter() - t0) * 1e3
    in_prefix = set(prefix)
    rest = [i for i in range(len(ct.node_names)) if mask[i] and i not in in_prefix]
    t1 = time.perf_counter()
    reps = consolidate.cheaper_replacement(
        ct, catalog, nodepools=pools,
        nodeclass_by_pool=cluster.nodeclass_by_pool(pools), candidates=rest)
    return prefix, reps, prefix_ms, (time.perf_counter() - t1) * 1e3


def _config4_pools() -> dict:
    from karpenter_provider_aws_tpu_torch.models import NodePool, Operator, Requirement
    from karpenter_provider_aws_tpu_torch.models import labels as lbl

    return {"default": NodePool(name="default", requirements=[
        Requirement(lbl.INSTANCE_CATEGORY, Operator.IN, ("c", "m"))])}


def churn_profile(dev: str = "cuda", n_nodes: int = 5000, warm_passes: int = 3,
                  profiled_passes: int = 5, mutations: int = 50) -> dict:
    """The light pass's device work, from the profiler's CUDA records, run
    as ``chip_smoke.py --churn-profile`` in a process of its own: late in
    the main run, traces of the patched screen kept only its last few
    device records, while a fresh process keeps every one. A fresh config4
    cluster, ``warm_passes`` light passes of 1% churn (RandomState(7), as
    the churn phase's first ones), then ``profiled_passes`` more whose
    screen stage runs under the profiler. Each profiled pass must patch the
    mirror, leave it equal to a fresh upload and launch the repack kernels
    once. The patch's device time is the sum of its records (its
    host-to-device copies and ``index_copy_`` writes), counted only when the
    trace kept all ``PATCH_RECORDS`` of them; the card's busy time is every
    record of the stage: the pass's other stages are host numpy."""
    import gc

    from karpenter_provider_aws_tpu_torch.ops import consolidate, device_state, repack_cuda

    dev = torch.device(dev)
    cluster, catalog = config4_cluster(n_nodes)
    names = [n.name for n in cluster.snapshot_nodes()]
    pools = _config4_pools()
    rng = np.random.RandomState(7)
    consolidate.consolidatable(consolidate.encode_cluster(cluster, catalog), device=dev)
    passes, records = [], []
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        for it in range(warm_passes + profiled_passes):
            _light_churn(cluster, names, rng, mutations, f"prof{it}")
            t0 = time.perf_counter()
            ct = consolidate.encode_cluster(cluster, catalog)
            encode_ms = (time.perf_counter() - t0) * 1e3
            patches = device_state.COUNTS["patch"]
            repack_cuda.LAUNCHES = 0
            if it < warm_passes:
                consolidate.consolidatable(ct, device=dev)
                continue
            mask, rec = profile_stage(lambda: consolidate.consolidatable(ct, device=dev))
            _, _, prefix_ms, replace_ms = _decide(ct, mask, cluster, catalog, pools)
            what = f"churn profile pass {it}"
            if device_state.COUNTS["patch"] != patches + 1 or repack_cuda.LAUNCHES != 1:
                raise AssertionError(f"{what}: the screen did not patch the mirror and "
                                     f"launch the repack kernels once")
            diffs = device_state.verify_mirror(device_state.mirror_for(ct, dev), ct)
            if diffs:
                raise AssertionError(f"{what}: the mirror differs from a fresh upload in {diffs}")
            records.append(rec.pop("records"))
            rec["pass_ms"] = encode_ms + rec["stage_wall_ms"] + prefix_ms + replace_ms
            rec["idle_share"] = 1.0 - rec["busy_ms"] / rec["pass_ms"]
            passes.append(rec)
    finally:
        gc.enable()
        gc.unfreeze()
    whole = [p for p in passes if p["patch_records"] >= PATCH_RECORDS
             and p["repack_records"] >= len(REPACK_KERNELS)]

    def summary(key):
        vals = [p[key] for p in whole]
        return {"p50": _pct(vals, 50), "max": max(vals), "n": len(vals)} if vals else \
            "not measured"

    return {"phase": "churn_profile", "passes": passes, "records": records,
            "patch_ms": summary("patch_ms"), "busy_ms": summary("busy_ms")}


def churn_profile_child() -> dict:
    """Run ``churn_profile`` in a child process and return its result."""
    out = subprocess.run([sys.executable, __file__, "--churn-profile"], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"churn profile exited {out.returncode}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def churn_phase(dev, smi: str, n_nodes: int = 5000, light_passes: int = 30,
                light_mutations: int = 50, member_passes: int = 10,
                member_mutations: int = 25) -> dict:
    """Phase 10: the consolidation pass under churn on a fresh config4
    cluster, through the user's entry points: the incremental
    ``encode_cluster``, ``consolidatable`` on the card through the
    device-resident mirror, ``delete_prefix``, and ``cheaper_replacement``
    over the screened candidates outside the prefix. Passes: the full encode,
    one unchanged pass (a hit; its mask memo is dropped so the screen runs
    on the mirror's hit path), ``light_passes`` of 1% churn (RandomState(7)),
    ``member_passes`` of membership churn (RandomState(8)); then
    ``churn_profile`` in a child process. The patch's call time is read on
    the host clock, with no synchronisation added to the timed passes. Every
    pass must encode canonically equal to a fresh full encode, leave the
    mirror equal to a fresh upload, give the CPU screen's mask of the fresh
    encode (by node name) and launch the repack kernels once. GC is frozen
    and off around the passes, as the reference's config4 benchmark does."""
    import gc

    from karpenter_provider_aws_tpu_torch.ops import (
        consolidate,
        device_state,
        encode_delta,
        repack_cuda,
    )

    t_build = time.perf_counter()
    cluster, catalog = config4_cluster(n_nodes)
    build_s = time.perf_counter() - t_build
    names = [n.name for n in cluster.snapshot_nodes()]
    n_pods = len(cluster.pods)
    pools = _config4_pools()
    device_state.reset_device_state()
    device_state.reset_counts()
    encode_delta.reset_encode_counts()
    consolidate.reset_screen_buckets()

    patch_call_ms: list = []
    apply_patch = device_state._apply_patch

    def timed_patch(holder, ct, rows):
        # the patch's call time on the host clock: the host packing, the
        # pageable copies and the index_copy_ launches; nothing synchronises
        t0 = time.perf_counter()
        apply_patch(holder, ct, rows)
        patch_call_ms.append((time.perf_counter() - t0) * 1e3)

    passes: list = []
    launches_total = 0

    def one_pass(kind: str, drop_memo: bool = False) -> None:
        nonlocal launches_total
        enc0 = dict(encode_delta.ENCODE_COUNTS)
        ds0 = dict(device_state.COUNTS)
        t0 = time.perf_counter()
        ct = consolidate.encode_cluster(cluster, catalog)
        encode_ms = (time.perf_counter() - t0) * 1e3
        mode = encode_delta.LAST_ENCODE["mode"]
        if drop_memo:
            ct.__dict__.pop("_screen_mask_memo", None)
        repack_cuda.LAUNCHES = 0
        t1 = time.perf_counter()
        mask = consolidate.consolidatable(ct, device=dev)
        screen_ms = (time.perf_counter() - t1) * 1e3
        launches = repack_cuda.LAUNCHES
        residency = consolidate.LAST_SCREEN.get("residency")
        prefix, reps, prefix_ms, replace_ms = _decide(ct, mask, cluster, catalog, pools)
        # the checks, outside the timed stages
        fresh = consolidate._encode_cluster(cluster, catalog, consolidate.GMAX_DEFAULT)
        diffs = encode_delta.canonical_equal(encode_delta.canonical_form(ct),
                                             encode_delta.canonical_form(fresh))
        mirror_diffs = device_state.verify_mirror(device_state.mirror_for(ct, dev), ct)
        cpu = consolidate.consolidatable(fresh, device="cpu")
        mask_equal = (dict(zip(ct.node_names, mask.tolist()))
                      == dict(zip(fresh.node_names, cpu.tolist())))
        what = f"churn {kind} pass {len(passes)}"
        if diffs:
            raise AssertionError(f"{what}: incremental encode differs from the full one in {diffs}")
        if mirror_diffs:
            raise AssertionError(f"{what}: the mirror differs from a fresh upload in {mirror_diffs}")
        if not mask_equal:
            raise AssertionError(f"{what}: the mask differs from the CPU screen of a fresh encode")
        if launches != 1:
            raise AssertionError(f"{what}: the repack kernels launched {launches} times")
        launches_total += launches
        passes.append({
            "kind": kind, "encode": mode, "residency": residency,
            "upload": device_state.COUNTS["upload"] - ds0["upload"],
            "patch": device_state.COUNTS["patch"] - ds0["patch"],
            "patch_rows": device_state.COUNTS["patch_rows"] - ds0["patch_rows"],
            "patch_bytes": device_state.COUNTS["patch_bytes"] - ds0["patch_bytes"],
            "upload_bytes": device_state.COUNTS["upload_bytes"] - ds0["upload_bytes"],
            "dirty": encode_delta.ENCODE_COUNTS["patch_rows"] - enc0["patch_rows"],
            "nodes": len(ct.node_names), "passed": int(mask.sum()), "prefix": len(prefix),
            "replacements": len(reps), "encode_ms": encode_ms, "screen_ms": screen_ms,
            "prefix_ms": prefix_ms, "replace_ms": replace_ms,
        })

    rng7, rng8 = np.random.RandomState(7), np.random.RandomState(8)
    next_node = n_nodes
    gc.collect()
    gc.freeze()
    gc.disable()
    device_state._apply_patch = timed_patch
    try:
        one_pass("full")
        one_pass("hit", drop_memo=True)
        for it in range(light_passes):
            _light_churn(cluster, names, rng7, light_mutations, f"churn{it}")
            one_pass("light")
        for _ in range(member_passes):
            next_node = _membership_churn(cluster, catalog, names, rng8, member_mutations,
                                          next_node)
            one_pass("membership")
    finally:
        device_state._apply_patch = apply_patch
        gc.enable()
        gc.unfreeze()

    light = [p for p in passes if p["kind"] == "light"]
    member = [p for p in passes if p["kind"] == "membership"]
    first = passes[:2] + light
    if passes[0]["encode"] != "full" or passes[1]["encode"] != "hit":
        raise AssertionError(f"churn: first passes encoded {passes[0]['encode']}, "
                             f"{passes[1]['encode']}")
    n_patch = sum(p["encode"] == "patch" for p in light)
    if n_patch < light_passes - 2 or any(p["encode"] == "full" for p in light):
        raise AssertionError(f"churn: {n_patch} of {light_passes} light passes patched")
    uploads = sum(p["upload"] for p in first)
    if uploads != 1:
        raise AssertionError(f"churn: {uploads} uploads in the full, hit and light passes")

    def stats(rows, key):
        vals = [p[key] for p in rows]
        return {"p50": _pct(vals, 50), "p99": _pct(vals, 99)}

    pass_light = stats([dict(t=p["encode_ms"] + p["screen_ms"] + p["prefix_ms"]
                             + p["replace_ms"]) for p in light], "t")
    prof = churn_profile_child()
    # the card's busy time in a light pass, from the child's traces, over
    # this run's light-pass p50 wall (the profiled passes' own walls hold
    # the profiler's cost)
    idle_light = (1.0 - prof["busy_ms"]["p50"] / pass_light["p50"]
                  if isinstance(prof["busy_ms"], dict) else "not measured")

    out = {
        "phase": "churn", "nodes": n_nodes, "pods": n_pods,
        "passes": len(passes), "cluster_build_s": build_s,
        "checks": {"canonical_equal": True, "verify_mirror_empty": True,
                   "cpu_mask_equal": True, "launches_per_pass": 1},
        "outcomes": {
            "hit": sum(p["encode"] == "hit" for p in passes),
            "patch": sum(p["encode"] == "patch" for p in passes),
            "full": sum(p["encode"] == "full" for p in passes),
            "upload": sum(p["upload"] for p in passes),
            "light_patched": n_patch, "uploads_full_hit_light": uploads,
            "mirror_patch": sum(p["patch"] for p in passes),
            "mirror_hit_pass_residency": passes[1]["residency"],
        },
        "encode_ms": {"full": passes[0]["encode_ms"], "hit": passes[1]["encode_ms"],
                      "patch_light": stats(light, "encode_ms"),
                      "patch_membership": stats(member, "encode_ms")},
        "upload_bytes": passes[0]["upload_bytes"],
        "patch_bytes_light": stats(light, "patch_bytes"),
        "patch_rows_light": stats(light, "patch_rows"),
        "patch_call_ms": {"p50": _pct(patch_call_ms, 50), "p99": _pct(patch_call_ms, 99),
                          "n": len(patch_call_ms)},
        "patch_device_ms": prof["patch_ms"],
        "profiled_passes": prof["passes"],
        "idle_share_light_p50": idle_light,
        "screen_ms": {"full": passes[0]["screen_ms"], "hit": passes[1]["screen_ms"],
                      "light": stats(light, "screen_ms"),
                      "membership": stats(member, "screen_ms")},
        "prefix_ms": stats(passes, "prefix_ms"), "replace_ms": stats(passes, "replace_ms"),
        "replacements": {"min": min(p["replacements"] for p in passes),
                         "max": max(p["replacements"] for p in passes)},
        "prefix": {"min": min(p["prefix"] for p in passes),
                   "max": max(p["prefix"] for p in passes)},
        "pass_ms_light": pass_light,
        "pass_ms_full": (passes[0]["encode_ms"] + passes[0]["screen_ms"]
                         + passes[0]["prefix_ms"] + passes[0]["replace_ms"]),
        "launches": launches_total, "gc": "frozen and disabled around the passes",
        "card": smi,
    }
    emit(out)
    emit({"phase": "churn_passes", "passes": passes})
    emit({"phase": "churn_profiled_records", "records": prof["records"]})
    return out


class _FixedClock:
    """A clock that stands still: the market model and the reservation
    windows read one time in both solves."""

    def __init__(self, t: float):
        self.t = t

    def now(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def market_catalog(t: float = 3600.0):
    """A catalog at time ``t`` with config5's two reservations and a
    ``MarketModel(seed=0)`` on its pricing, applied once."""
    from karpenter_provider_aws_tpu_torch.catalog import (
        CatalogProvider,
        MarketModel,
        PricingProvider,
    )
    from karpenter_provider_aws_tpu_torch.catalog.reservations import Reservation
    from karpenter_provider_aws_tpu_torch.ops import solve_cases

    clock = _FixedClock(t)
    catalog = CatalogProvider(clock=clock, pricing=PricingProvider(clock=clock))
    model = MarketModel(seed=0, clock=clock)
    catalog.pricing.market = model
    if model.apply(catalog) == 0:
        raise AssertionError("the market model walked no price: is KARPENTER_TPU_MARKET off?")
    catalog.reservations.update([Reservation(**r) for r in solve_cases.CONFIG5_RESERVATIONS])
    return catalog


def market_phase(smi: str, n_pods: int = 4000) -> int:
    """Phase 11: config5 (``benchmarks/solve_configs.py``
    ``config5_accelerators``: GPU, Neuron and cpu pods, two pools, two
    reservations) solved through ``TorchSolver()`` on the card with the
    market on and a ``MarketModel(seed=0)``, its two pools as partition
    lanes (ONE FFD launch of 2 lanes); the plan must equal the CPU solve's
    on the same market. Returns the FFD kernel's launches."""
    from karpenter_provider_aws_tpu_torch.models import NodePool, Operator, Requirement
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda, solve_cases
    from karpenter_provider_aws_tpu_torch.scheduling import TorchSolver

    os.environ.pop("KARPENTER_TPU_MARKET", None)  # on
    pkg = SimpleNamespace(lbl=lbl, make_pods=make_pods)
    pools = [NodePool(name=name, requirements=[
        Requirement(lbl.INSTANCE_CATEGORY, Operator.IN, cats)])
        for name, cats in (("default", ("c", "m", "r")), ("accel", ("g", "p", "inf", "trn")))]
    pods = solve_cases.config5_pods(pkg, n_pods)
    catalog = market_catalog()
    frag = catalog._market_fragment()
    ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
    t0 = time.perf_counter()
    res = TorchSolver().solve(pods, pools, catalog)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches, lanes = ffd_cuda.LAUNCHES, ffd_cuda.LANES
    if (launches, lanes) != (1, 2):
        raise AssertionError(f"the config5 market solve ran {launches} FFD launches of "
                             f"{lanes} lanes, not one launch of a lane a pool")
    same_plan(res, TorchSolver(device="cpu").solve(pods, pools, market_catalog()),
              "config5 with the market on")
    reserved = [s for s in res.node_specs if lbl.CAPACITY_TYPE_RESERVED in s.capacity_type_options]
    if res.pods_placed() != len(pods) or res.unschedulable:
        raise AssertionError(f"config5: placed {res.pods_placed()} of {len(pods)} pods")
    if not frag or not reserved:
        raise AssertionError(f"config5: market fragment {frag}, {len(reserved)} reserved nodes")
    emit({"phase": "market", "pods": len(pods), "placed": res.pods_placed(),
          "nodes": len(res.node_specs), "reserved_option_nodes": len(reserved),
          "cost": res.total_cost, "cpu_plan_equal": True, "launches": launches,
          "lanes": lanes, "market_fragment": [list(map(str, f)) for f in frag], "wall_ms": wall_ms,
          "card": smi})
    return launches


#: the reference's ``config6_frag_optimizer`` row: seeds of ``frag_workload``,
#: warm-ups and timed solves (``benchmarks/optimizer_bench.py:96-124``), and
#: the lanes of the default lane program
FRAG_SEEDS, FRAG_WARMUP, FRAG_ITERS, LANES = 12, 3, 10, 8
HEADLINE_ITERS = 5
LANE_STAGES = ("encode_ms", "device_ms", "decode_ms", "opt_dispatch_ms", "opt_fetch_ms",
               "opt_refine_ms")


def lane_check(ffd, ffd_cuda, args, N) -> dict:
    """The lane launch (``ffd_solve_lanes``: LANES solves in one launch)
    against LANES plain solves on the same CUDA tensors, then its times: the
    whole call (CUDA events), the kernel's device time (profiler), lane 0
    alone through ``ffd_solve`` on the same shape, and the bound for all
    lanes' bytes and operations."""
    got = ffd_cuda.ffd_solve_lanes(*args, max_nodes=N)
    torch.cuda.synchronize()
    err, nbytes, ops, n_open = 0.0, 0, 0, []
    for lane in range(LANES):
        one = dict(zip(FFD_FIELDS, (a[lane] for a in args)))
        want = call(ffd.ffd_solve, one, N)
        mine = type(got)(*(f[lane] for f in got))
        err = max(err, compare(f"lane {lane}", mine, want))
        b, o = kernel_bytes_and_ops(one, N, mine)
        nbytes, ops, n_open = nbytes + b, ops + o, n_open + [int(mine.n_open)]
    lanes_dev, lanes_kept = device_ms(lambda: ffd_cuda.ffd_solve_lanes(*args, max_nodes=N),
                                      ("ffd_kernel",), 20)
    lane0 = dict(zip(FFD_FIELDS, (a[0] for a in args)))
    one_dev, one_kept = device_ms(lambda: call(ffd_cuda.ffd_solve, lane0, N), ("ffd_kernel",), 20)
    (L, G, R), T = args[0].shape, args[3].shape[1]
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {
        "N": N, "G": G, "T": T, "R": R, "lanes": L, "resident": ffd_cuda.resident(N, R),
        "active_ctas": ffd_cuda.active_ctas(N, R),
        "clusters_at_once": ffd_cuda.cluster_occupancy(N, R), "n_open": n_open,
        "parity": "exact", "max_abs_err": err,
        "lanes_call_ms": time_cuda(lambda: ffd_cuda.ffd_solve_lanes(*args, max_nodes=N), runs=20),
        "lanes_device_ms": lanes_dev["ffd_kernel"], "lanes_records": lanes_kept,
        "single_lane_device_ms": one_dev["ffd_kernel"], "single_lane_records": one_kept,
        "input_bytes": sum(a.numel() * a.element_size() for a in args),
        "table_bytes": 2 * L * G * (-(-T // 4) * 4) * 4,
        "bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def optimizer_phase(dev, smi: str, pool, catalog, headline, pods8) -> dict:
    """Phase 12: the optimizer lane, the default solve. The lane-on solve on
    the card against the CPU (the headline's first solve, config8, frag
    seeds 0-11: equal plans and outcomes); the headline warm, lane off and
    on, against the reference's gate; the lane launch exact against plain
    solves on the kernel's three branches; the reference's
    ``config6_frag_optimizer`` row on the port. Returns the FFD kernel's
    launches on the lane-on headline solve and the lane shapes' times."""
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.ops import ffd, ffd_cases, ffd_cuda, solve_cases
    from karpenter_provider_aws_tpu_torch.ops.encode import bucket, encode_problem, pad_problem
    from karpenter_provider_aws_tpu_torch.scheduling import TorchSolver
    from karpenter_provider_aws_tpu_torch.scheduling import optimizer
    from karpenter_provider_aws_tpu_torch.scheduling.oracle import ffd_oracle, oracle_cost
    from karpenter_provider_aws_tpu_torch.scheduling.solver import MAX_INSTANCE_TYPE_OPTIONS

    os.environ.pop("KARPENTER_TPU_OPTIMIZER", None)  # the default: the lane on
    pkg = SimpleNamespace(lbl=lbl, make_pods=make_pods)

    def timed(pods, iters):
        """Warm solves of ``pods`` (FRAG_WARMUP untimed, then ``iters``
        timed), the lane off then on: ([off walls, on walls], [off stages,
        on stages]); every lane-on solve must have run the lane."""
        walls, stages = [], []
        for lane in ("0", "1"):
            os.environ["KARPENTER_TPU_OPTIMIZER"] = lane
            solver = TorchSolver()
            for _ in range(FRAG_WARMUP):
                solver.solve(pods, [pool], catalog)
            walls.append([]), stages.append([])
            for _ in range(iters):
                t0 = time.perf_counter()
                solver.solve(pods, [pool], catalog)
                walls[-1].append((time.perf_counter() - t0) * 1e3)
                stages[-1].append(dict(solver.timings))
        os.environ.pop("KARPENTER_TPU_OPTIMIZER")
        if any(st.get("opt_lane") in (None, "disabled") or "opt_fetch_ms" not in st
               for st in stages[1]):
            raise AssertionError("a timed lane-on solve did not run the lane")
        return walls, stages

    # 12a. the lane-on solve on the card against the CPU, same seed: the
    # headline's first solve (its launches counted), config8, frag 0-11
    def solve_both(pods, cuda_solver, cpu_solver, what):
        ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
        t0 = time.perf_counter()
        res = cuda_solver.solve(pods, [pool], catalog)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches, lanes_run = ffd_cuda.LAUNCHES, ffd_cuda.LANES
        cpu = cpu_solver.solve(pods, [pool], catalog)
        same_plan(res, cpu, what)
        lane, cpu_lane = cuda_solver.timings.get("opt_lane"), cpu_solver.timings.get("opt_lane")
        if lane != cpu_lane:
            raise AssertionError(f"{what}: lane outcome {lane} on the card, {cpu_lane} on the CPU")
        t = cuda_solver.timings
        return {"outcome": lane, "ffd_cost": t.get("opt_ffd_cost", res.total_cost),
                "served_cost": res.total_cost, "pods": len(pods), "placed": res.pods_placed(),
                "lp_gap": t.get("lp_gap"), "rows": t.get("n_rows"), "lane_rows": t.get("opt_rows"),
                "backend": res.provenance["backend"], "wall_ms": wall_ms,
                "stages_ms": {k: t.get(k) for k in LANE_STAGES},
                "launches": launches, "lanes": lanes_run}, res

    solved = {}
    solved["headline"], _ = solve_both(headline, TorchSolver(), TorchSolver(device="cpu"),
                                       "the lane-on headline")
    launches, lanes_run = solved["headline"]["launches"], solved["headline"]["lanes"]
    if solved["headline"]["outcome"] in (None, "disabled") or launches != 1 + optimizer._ROUNDS \
            or lanes_run != 1 + optimizer._ROUNDS * LANES:
        raise AssertionError(f"the lane-on headline ran {launches} launches of {lanes_run} lanes, "
                             f"outcome {solved['headline']['outcome']}")
    solved["config8"], _ = solve_both(pods8, TorchSolver(), TorchSolver(device="cpu"), "config8")
    cuda_solver, cpu_solver = TorchSolver(), TorchSolver(device="cpu")
    ratios, frag_pods = [], []
    for seed in range(FRAG_SEEDS):
        pods = solve_cases.frag_workload(pkg, seed)
        frag_pods.append(len(pods))
        row, res = solve_both(pods, cuda_solver, cpu_solver, f"frag seed {seed}")
        base = oracle_cost(ffd_oracle(encode_problem(pods, catalog, nodepool=pool))[0])
        row["oracle_cost"], row["cost_vs_oracle"] = base, res.total_cost / base
        ratios.append(row["cost_vs_oracle"])
        solved[f"frag{seed}"] = row
    # the noise's float32 values of every 23-bit mantissa (the uniform reads
    # only bits >> 9 of a draw), on the CPU and the card: the threefry bits
    # are the same by construction, the logs are each device's libm
    mant = torch.arange(1 << 23, dtype=torch.int64)
    differ = int((optimizer.gumbel_of_mantissa(mant).view(torch.int32)
                  != optimizer.gumbel_of_mantissa(mant.to(dev)).cpu().view(torch.int32)).sum())
    if differ:
        raise AssertionError(f"{differ} float32 Gumbel values differ between the CPU and the card")
    emit({"phase": "optimizer_solves", "solves": solved, "cpu_plan_equal": True,
          "headline_launches": launches, "headline_lanes": lanes_run,
          "gumbel_float32_differ": differ, "gumbel_inputs": 1 << 23, "card": smi})

    # 12b. the headline warm, the lane off then on (the reference's gate,
    # opt_p99 <= 12 x ffd_p50, on the port's main path)
    hwalls, hstages = timed(headline, HEADLINE_ITERS)
    emit({"phase": "optimizer_headline", "pods": len(headline), "iters": HEADLINE_ITERS,
          "ffd_p50_ms": _pct(hwalls[0], 50), "ffd_p99_ms": _pct(hwalls[0], 99),
          "opt_p50_ms": _pct(hwalls[1], 50), "opt_p99_ms": _pct(hwalls[1], 99),
          "gate_opt_p99_le_12x_ffd_p50": _pct(hwalls[1], 99) <= 12 * _pct(hwalls[0], 50),
          "outcomes": sorted({st["opt_lane"] for st in hstages[1]}),
          "median_ms": {k: statistics.median(st[k] for st in hstages[1]) for k in LANE_STAGES},
          "lane_rows": hstages[1][-1]["opt_rows"], "card": smi})

    # 12c. the lane launch against plain solves: round 0 of the lane program
    # on config8 (one CTA holds the rows), the headline at 4,096 rows and at
    # the rows its lane-on solve gave the lanes (eight CTAs), and seeded
    # lanes of the global-memory branch
    def program_lanes(pods):
        problem = encode_problem(pods, catalog, nodepool=pool)
        inp = TorchSolver()._device_inputs(pad_problem(problem, bucket(len(problem.group_pods))))
        return optimizer.first_round(inp, LANES)

    gb = ffd_cases.card_cases()["global_branch"]
    gargs = optimizer.first_round(to_device(dict(zip(FFD_FIELDS, gb[0])), ffd, dev), LANES,
                                  seed=1)
    head_args = program_lanes(headline)
    lane_rows = int(solved["headline"]["lane_rows"])
    lane_shapes = {}
    for key, args, N in ((f"config8_{CONFIG8_ROWS}", program_lanes(pods8), CONFIG8_ROWS),
                         ("headline_4096", head_args, 4096),
                         (f"headline_{lane_rows}", head_args, lane_rows),
                         ("global_branch", gargs, gb[1])):
        lane_shapes[key] = lane_check(ffd, ffd_cuda, args, N)
    if [s["active_ctas"] for s in lane_shapes.values()][0] != 1 \
            or any(s["active_ctas"] != ffd_cuda.CLUSTER for s in list(lane_shapes.values())[1:]) \
            or lane_shapes["global_branch"]["resident"]:
        raise AssertionError("the lane shapes did not cover the kernel's three layouts")
    emit({"phase": "optimizer_lanes", "shapes": lane_shapes, "card": smi})

    # 12d. the reference's config6_frag_optimizer row on the port: the lane
    # off, then on, on frag seed 0 (3 warm-ups, 10 timed solves each), and
    # the lane's device time from the profiler
    pods0 = solve_cases.frag_workload(pkg, 0)
    (ffd_walls, opt_walls), (_, stages) = timed(pods0, FRAG_ITERS)
    solver = TorchSolver()
    solver.solve(pods0, [pool], catalog)
    problem = encode_problem(pods0, catalog, nodepool=pool)
    inp = solver._device_inputs(pad_problem(problem, bucket(len(problem.group_pods))))
    rows0 = int(stages[-1]["opt_rows"])
    rank_k = min(MAX_INSTANCE_TYPE_OPTIONS, problem.capacity.shape[0])

    def lane_only():
        return optimizer.fetch(optimizer.dispatch_optimizer(inp, rows0, rank_k))

    lane_only()
    _, lane_wall_ms, prof = _profiled(lane_only)
    from torch.autograd import DeviceType

    lane_kernel_ms = lane_other_ms = 0.0
    kernel_records = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        ms = (evt.self_cuda_time_total if us is None else us) / 1e3
        if "ffd_kernel" in evt.key:
            lane_kernel_ms += ms
            kernel_records += evt.count
        else:
            lane_other_ms += ms
    if kernel_records != optimizer._ROUNDS:
        raise AssertionError(f"the lane's trace kept {kernel_records} kernel records, "
                             f"expected {optimizer._ROUNDS}")
    prof_solve = profile_solve(lambda: solver.solve(pods0, [pool], catalog))
    prof_solve["phase"] = "profile_lane_solve"

    def med(key):
        return statistics.median(st[key] for st in stages)

    adopted = sum(1 for k, r in solved.items() if k.startswith("frag") and r["outcome"] == "adopted")
    p95 = _pct(ratios, 95)
    emit({"phase": "optimizer", "benchmark": "config6_frag_optimizer", "seeds": FRAG_SEEDS,
          "pods_per_seed": frag_pods,
          "cost_vs_oracle_p50": _pct(ratios, 50), "cost_vs_oracle_p95": p95,
          "cost_vs_oracle_max": max(ratios), "gate_cost_vs_oracle_p95_lt_0_97": p95 < 0.97,
          "lane_adopted": adopted, "lane_rejected": FRAG_SEEDS - adopted,
          "ffd_p50_ms": _pct(ffd_walls, 50), "ffd_p99_ms": _pct(ffd_walls, 99),
          "opt_p50_ms": _pct(opt_walls, 50), "opt_p99_ms": _pct(opt_walls, 99),
          "gate_opt_p99_le_12x_ffd_p50": _pct(opt_walls, 99) <= 12 * _pct(ffd_walls, 50),
          "lane_rows": rows0, "lane_kernel_device_ms": lane_kernel_ms,
          "lane_kernel_records": kernel_records, "lane_other_device_ms": lane_other_ms,
          "lane_device_ms": lane_kernel_ms + lane_other_ms, "lane_only_wall_ms": lane_wall_ms,
          "median_ms": {"opt_dispatch": med("opt_dispatch_ms"),
                        "opt_fetch_and_validate": med("opt_fetch_ms"),
                        "opt_refine_and_decode": med("opt_refine_ms"),
                        "ffd_refine_and_decode": med("decode_ms"),
                        "ffd_device": med("device_ms"), "encode": med("encode_ms")},
          "lane_input_bytes": stages[-1]["opt_input_bytes"],
          "backend": solved["frag0"]["backend"], "card": smi})
    emit(prof_solve)
    return {"launches": launches, "lanes": lanes_run, "shapes": lane_shapes}


#: the control-plane cells: config7 (benchmarks/solve_configs.py
#: config7_steady_state) at full size, and config8's cold burst
CONFIG7_NODES, CONFIG7_BURST, CONFIG7_BURSTS = 2000, 500, 10
CONTROLPLANE_MAX_PASSES = 8
PROVISIONING_SPLIT = ("prepare_ms", "snapshot_ms", "solve_ms", "audit_ms", "bind_ms",
                      "launch_ms", "oracle_ms", "wall_ms")
SOLVE_SPLIT = ("encode_ms", "device_ms", "decode_ms")


def cmr_pool():
    from karpenter_provider_aws_tpu_torch.models import Disruption, NodePool, Operator, Requirement
    from karpenter_provider_aws_tpu_torch.models import labels as lbl

    return NodePool(name="default",
                    requirements=[Requirement(lbl.INSTANCE_CATEGORY, Operator.IN, ("c", "m", "r"))],
                    disruption=Disruption(consolidate_after_s=None))


def config7_env(device=None, audit_capacity=None):
    """``config7_steady_state``'s live cluster in a fresh environment: 2,000
    spot c/m nodes of 4-16 vCPUs (RandomState(1), ``_synth_cluster``), each
    with 1-6 bound pods of 250m/512Mi, in the default c/m/r pool."""
    from karpenter_provider_aws_tpu_torch.ops import cluster_cases
    from karpenter_provider_aws_tpu_torch.testenv import new_environment

    env = new_environment(device=device, audit_capacity=audit_capacity)
    env.apply_defaults(cmr_pool())
    # "live-" names: the claims the provisioner launches are "default-"
    cluster_cases.synth_cluster(port_pkg(), env.cluster, env.catalog, CONFIG7_NODES, 6,
                                name=lambda i: f"live-{i:x}")
    return env


@contextlib.contextmanager
def gc_pauses():
    """Milliseconds the Python garbage collector ran inside the block, as
    a one-element list filled on exit."""
    import gc

    out, start = [0.0], {}

    def callback(phase, _info):
        if phase == "start":
            start["t"] = time.perf_counter()
        elif "t" in start:
            out[0] += (time.perf_counter() - start.pop("t")) * 1e3

    gc.callbacks.append(callback)
    try:
        yield out
    finally:
        gc.callbacks.remove(callback)


def drive(env) -> list:
    """Manager passes until no pod is pending; every pass must leave
    ``manager.errors`` empty. Returns each pass's wall (ms), provisioning
    split (empty when the provisioner had nothing to solve) and lane
    outcome."""
    passes = []
    for _ in range(CONTROLPLANE_MAX_PASSES):
        if not env.cluster.pending_pods():
            return passes
        env.provisioning.timings = {}
        t0 = time.perf_counter()
        env.step()
        if env.manager.errors:
            raise AssertionError(f"reconcile errors: {env.manager.errors}")
        solved = dict(env.provisioning.timings)
        passes.append({"pass_ms": (time.perf_counter() - t0) * 1e3, "provisioning": solved,
                       "lane": env.solver.timings.get("opt_lane") if solved else None})
    if env.cluster.pending_pods():
        raise AssertionError(f"{len(env.cluster.pending_pods())} pods still pending after "
                             f"{CONTROLPLANE_MAX_PASSES} passes")
    return passes


def observe_env(env, live: set) -> dict:
    """What the card's and the CPU's runs are held equal on: the launched
    (type, zone, capacity type) multiset, which pods share a node, the
    pending pods, and the audit decisions with claim names replaced by
    their order of creation; plus the binds onto live nodes and onto fresh
    ones."""
    import re

    names = {c: f"claim{i}" for i, c in enumerate(env.cluster.nodeclaims)}
    pattern = re.compile("|".join(re.escape(c) for c in sorted(names, key=len, reverse=True)))
    by_node: dict = {}
    for pod in env.cluster.pods.values():
        if pod.node_name:
            by_node.setdefault(pod.node_name, []).append(pod.name)
    burst = [p for p in env.cluster.pods.values() if p.name.startswith("burst")]
    return {
        "launched": sorted((i.instance_type, i.zone, i.capacity_type)
                           for i in env.cloud.instances.values()),
        "pods_by_node": sorted(sorted(v) for v in by_node.values()),
        "pending": sorted(p.name for p in env.cluster.pending_pods()),
        "decisions": [(r.kind, r.subject_kind, pattern.sub(lambda m: names[m.group(0)], r.decision))
                      for r in env.obs.audit.tail(1_000_000)],
        "bound_live": sum(1 for p in burst if p.node_name in live),
        "bound_fresh": sum(1 for p in burst if p.node_name and p.node_name not in live),
    }


def launched_cost(env) -> float:
    """$/hr of the instances the fake cloud launched, at the catalog's list
    prices (spot in the instance's zone, or on-demand): what the fleet
    requests bought, beside the plan's own estimate."""
    total = 0.0
    for inst in env.cloud.instances.values():
        it = env.catalog.get(inst.instance_type)
        total += float(env.catalog.pricing.spot_price(it, inst.zone) if inst.capacity_type == "spot"
                       else env.catalog.pricing.on_demand_price(it))
    return total


def same_run(card: dict, cpu: dict, what: str) -> None:
    for key in ("launched", "pods_by_node", "pending", "decisions"):
        if card[key] != cpu[key]:
            raise AssertionError(f"{what}: {key} differ between the card and the CPU")


def controlplane_phase(smi: str) -> dict:
    """Phase 13: the provisioning control plane on the card, through
    ``new_environment()`` and its reconcile loop. config7 at full size:
    2,000 live nodes, a burst of 500 pods of 500m/1Gi; the provisioner
    reconciles first (in a manager pass the host binder, which runs before
    it, takes a burst of 512 pods or fewer itself), then the manager steps
    until no pod is pending; 10 bursts on fresh copies. config8's cold
    burst: 1,201 pods into an empty cluster, stepped until none is pending.
    The first config7 burst and the config8 run are repeated on
    ``new_environment(device="cpu")``, launches serialized on both sides,
    and must match. Returns the FFD kernel's launches on each path."""
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda, solve_cases
    from karpenter_provider_aws_tpu_torch.testenv import new_environment

    os.environ.pop("KARPENTER_TPU_OPTIMIZER", None)  # the default: the lane on

    def config7_burst(device=None) -> tuple:
        env = config7_env(device)
        live = set(env.cluster.nodes)
        for p in make_pods(CONFIG7_BURST, "burst", {"cpu": "500m", "memory": "1Gi"}):
            env.cluster.apply(p)
        t0 = time.perf_counter()
        with gc_pauses() as paused:
            env.provisioning.reconcile()
        first = dict(env.provisioning.timings, gc_ms=paused[0])
        solve = {k: env.solver.timings.get(k) for k in SOLVE_SPLIT + ("n_rows", "opt_lane")}
        walls = [first["wall_ms"]] + [p["provisioning"]["wall_ms"] for p in drive(env)
                                      if p["provisioning"]]
        total_ms = (time.perf_counter() - t0) * 1e3
        out = observe_env(env, live)
        env.close()
        return out, {"provisioning": first, "solve": solve, "passes_walls_ms": walls,
                     "total_ms": total_ms}

    # config7: the first burst launches serialized, for the CPU equality
    os.environ["KARPENTER_TPU_SERIAL_LAUNCH"] = "1"
    ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
    obs0, run0 = config7_burst()
    launches7 = ffd_cuda.LAUNCHES
    obs_cpu, _ = config7_burst("cpu")
    same_run(obs0, obs_cpu, "config7")
    os.environ.pop("KARPENTER_TPU_SERIAL_LAUNCH")
    runs = [run0]
    ffd_cuda.LAUNCHES = 0
    for _ in range(CONFIG7_BURSTS - 1):
        runs.append(config7_burst()[1])
    launches7 += ffd_cuda.LAUNCHES
    if launches7 < CONFIG7_BURSTS:
        raise AssertionError(f"config7 launched the FFD kernel {launches7} times "
                             f"in {CONFIG7_BURSTS} bursts")
    lanes = {r["solve"]["opt_lane"] for r in runs}
    if lanes != {"skipped_existing"}:
        raise AssertionError(f"config7's lane outcomes {lanes}, expected skipped_existing")
    walls = [r["provisioning"]["wall_ms"] for r in runs]
    emit({"phase": "controlplane_config7", "nodes": CONFIG7_NODES, "burst": CONFIG7_BURST,
          "bursts": CONFIG7_BURSTS, "reconcile_p50_ms": _pct(walls, 50),
          "reconcile_p99_ms": _pct(walls, 99), "reconcile_walls_ms": walls,
          "reconcile_gc_ms": [r["provisioning"]["gc_ms"] for r in runs],
          "split_median_ms": {
              **{k: statistics.median(r["provisioning"][k] for r in runs)
                 for k in PROVISIONING_SPLIT},
              **{k: statistics.median(r["solve"][k] for r in runs) for k in SOLVE_SPLIT}},
          "n_pre": run0["provisioning"]["n_pre"], "rows": run0["solve"]["n_rows"],
          "lane": sorted(lanes), "ffd_launches": launches7,
          "bound_live": obs0["bound_live"], "bound_fresh": obs0["bound_fresh"],
          "launched_claims": len(obs0["launched"]),
          "passes_walls_ms": run0["passes_walls_ms"], "total_ms_first": run0["total_ms"],
          "manager_errors": [], "cpu_run_equal": True, "card": smi})

    # config8's cold burst: 1,201 pods into an empty cluster
    pkg = SimpleNamespace(lbl=lbl, make_pods=make_pods)

    def config8_burst(device=None) -> tuple:
        env = new_environment(device=device)
        env.apply_defaults(cmr_pool())
        pods = solve_cases.config8_pods(pkg)
        for p in pods:
            env.cluster.apply(p)
        t0 = time.perf_counter()
        passes = drive(env)
        total_ms = (time.perf_counter() - t0) * 1e3
        out = observe_env(env, set())
        cost = launched_cost(env)
        env.close()
        return out, {"pods": len(pods), "passes": passes, "total_ms": total_ms, "cost": cost}

    os.environ["KARPENTER_TPU_SERIAL_LAUNCH"] = "1"
    ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
    obs8, run8 = config8_burst()
    launches8, lanes8 = ffd_cuda.LAUNCHES, ffd_cuda.LANES
    obs8_cpu, run8_cpu = config8_burst("cpu")
    same_run(obs8, obs8_cpu, "config8")
    os.environ.pop("KARPENTER_TPU_SERIAL_LAUNCH")
    if launches8 < 1:
        raise AssertionError("config8's cold burst never launched the FFD kernel")
    emit({"phase": "controlplane_config8", "pods": run8["pods"], "passes": len(run8["passes"]),
          "total_ms": run8["total_ms"],
          "provisioning_walls_ms": [p["provisioning"].get("wall_ms") for p in run8["passes"]],
          "pass_walls_ms": [p["pass_ms"] for p in run8["passes"]],
          "splits_ms": [{k: p["provisioning"].get(k) for k in PROVISIONING_SPLIT}
                        for p in run8["passes"] if p["provisioning"]],
          "lanes": [p["lane"] for p in run8["passes"]],
          "launched_claims": len(obs8["launched"]),
          "plan_cost_per_hr": sum(p["provisioning"].get("cost", 0.0) for p in run8["passes"]),
          "launched_cost_per_hr": run8["cost"],
          "ffd_launches": launches8, "ffd_lanes": lanes8, "manager_errors": [],
          "cpu_run_equal": True, "cpu_total_ms": run8_cpu["total_ms"], "card": smi})
    return {"config7": launches7, "config8": launches8, "config8_lanes": lanes8}



#: the disruption half's cells: config4's controller pass
#: (benchmarks/solve_configs.py config4_consolidation, nothing cut) and 200
#: spot interruptions on config7's cluster
CONFIG4_NODES, CONFIG4_PODS_PER_NODE, CONFIG4_PODS = 5000, 8, 22791
SETTLE_MAX_PASSES = 80
#: the audit ring of phases 14-15, whose whole trail the card's and the
#: CPU's runs are held equal on (config4's settle writes tens of thousands)
AUDIT_CAPACITY = 1 << 20
WARM_DISRUPTION_PASSES = 5
INTERRUPTED_NODES = 200
DISRUPTION_SPLIT = ("scan_ms", "phases_ms", "encode_ms", "screen_dispatch_ms", "candidates_ms",
                    "screen_wait_ms", "search_ms", "commit_ms", "multi_replace_ms",
                    "replace_ms", "wall_ms")
#: the reference's CPU row of config6_multi_replace_optimizer
MULTI_REPLACE_P95 = 0.3321


def port_pkg():
    """This package's names that ``ops/cluster_cases.py`` builds with."""
    import importlib

    from karpenter_provider_aws_tpu_torch.ops import cluster_cases

    return cluster_cases.names(
        lambda name: importlib.import_module(f"karpenter_provider_aws_tpu_torch.{name}"))


def config4_env(device=None):
    """config4's cluster (``_synth_cluster``: 5,000 spot c/m nodes of 4-16
    vCPUs, RandomState(1), 22,791 pods of 250m/512Mi) in a fresh
    environment's store, in the default c/m/r pool, each claim backed by a
    running instance and the termination finalizer as a launch leaves it."""
    from karpenter_provider_aws_tpu_torch.ops import cluster_cases
    from karpenter_provider_aws_tpu_torch.testenv import new_environment

    pkg = port_pkg()
    env = new_environment(device=device, audit_capacity=AUDIT_CAPACITY)
    env.apply_defaults(cmr_pool())
    # "c4-" names: the claims that launches name by the sequence are "default-"
    cluster_cases.synth_cluster(pkg, env.cluster, env.catalog, CONFIG4_NODES,
                                CONFIG4_PODS_PER_NODE, name=lambda i: f"c4-{i:x}")
    cluster_cases.seed_launched(pkg, env)
    return env


def settle(env) -> list:
    """Manager passes until one leaves no pod pending and no claim deleting
    (``cluster_cases.settle``; the disruption controller runs in every
    pass, so a consolidating pool keeps disrupting while it finds
    candidates); every pass must leave ``manager.errors`` empty. Returns
    each pass's wall and the garbage collector's share of it, the pods it
    found pending and the claims deleting, the provisioner's split when it
    solved and the disruption controller's."""
    from karpenter_provider_aws_tpu_torch.ops import cluster_cases

    passes = []

    def timed_step(env):
        pending = len(env.cluster.pending_pods())
        deleting = sum(1 for c in env.cluster.nodeclaims.values() if c.deleted)
        env.provisioning.timings = {}
        before = len(env.disruption.disrupted)
        t0 = time.perf_counter()
        with gc_pauses() as paused:
            env.step()
        wall = (time.perf_counter() - t0) * 1e3
        if env.manager.errors:
            raise AssertionError(f"reconcile errors: {env.manager.errors}")
        solved = dict(env.provisioning.timings)
        passes.append({"pass_ms": wall, "gc_ms": paused[0], "pending": pending,
                       "deleting": deleting,
                       "provisioning": {k: solved.get(k) for k in (
                           "pods", "n_pre", "binds", "specs", "wall_ms", "prepare_ms",
                           "snapshot_ms", "solve_ms", "bind_ms", "oracle_ms")}
                       if solved else {},
                       "rows": env.solver.timings.get("n_rows") if solved else None,
                       "disruption_ms": env.disruption.timings.get("wall_ms"),
                       "disrupted": len(env.disruption.disrupted) - before})

    cluster_cases.settle(env, timed_step, SETTLE_MAX_PASSES)
    return passes


def same_lifecycle(card: dict, cpu: dict, what: str) -> None:
    """Every key of ``cluster_cases.observe_lifecycle`` equal."""
    differ = [key for key in card if card[key] != cpu[key]]
    if differ:
        raise AssertionError(f"{what}: {differ} differ between the card and the CPU")


def controlplane_config4(device=None) -> tuple:
    """One controller pass on config4 (the pool consolidating after 60 s
    under a 10% budget, the clock 120 s on), then manager passes until the
    cluster settles. Returns the observation, the run's numbers and the
    environment (open)."""
    from karpenter_provider_aws_tpu_torch.ops import (
        cluster_cases, consolidate, ffd_cuda, repack_cuda,
    )

    t_build = time.perf_counter()
    env = config4_env(device)
    build_s = time.perf_counter() - t_build
    if len(env.cluster.pods) != CONFIG4_PODS:
        raise AssertionError(f"config4 built {len(env.cluster.pods)} pods, expected {CONFIG4_PODS}")
    placed = {p.uid: p.node_name for p in env.cluster.pods.values()}
    pool = env.cluster.nodepools["default"]
    pool.disruption.consolidate_after_s = 60
    pool.disruption.budgets = ["10%"]
    env.clock.advance(120)
    repack_cuda.LAUNCHES = 0
    consolidate.LAST_SCREEN.clear()
    t0 = time.perf_counter()
    with gc_pauses() as paused:
        env.disruption.reconcile()
    pass_ms = (time.perf_counter() - t0) * 1e3
    if env.manager.errors:
        raise AssertionError(f"reconcile errors: {env.manager.errors}")
    first = {"controller_pass_ms": pass_ms, "gc_ms": paused[0],
             "split_ms": dict(env.disruption.timings),
             "screen": dict(consolidate.LAST_SCREEN),
             "disrupted": len(env.disruption.disrupted),
             "reasons": sorted({r.split(":")[0] for _, r in env.disruption.disrupted}),
             "repack_launches": repack_cuda.LAUNCHES}
    ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
    repack_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    passes = settle(env)
    settle_ms = (time.perf_counter() - t0) * 1e3
    run = {"build_s": build_s, "pods": CONFIG4_PODS, "first": first, "passes": passes,
           "settle_ms": settle_ms,
           "ffd_launches": ffd_cuda.LAUNCHES, "ffd_lanes": ffd_cuda.LANES,
           "repack_launches_settle": repack_cuda.LAUNCHES,
           "nodes_after": len(env.cluster.nodes)}
    return cluster_cases.observe_lifecycle(env, placed), run, env


def warm_disruption_passes(env, n: int) -> dict:
    """``n`` disruption passes on the settled cluster: before each, 50 bound
    pods finish (RandomState(3), the churn phase's light pass) and the clock
    moves past consolidate-after, so each pass encodes a patch and screens
    through the mirror (patched, or uploaded anew where the previous pass's
    disruptions changed the node set). Returns the walls, their split, what
    each screened and the repack kernel's launches."""
    from karpenter_provider_aws_tpu_torch.ops import consolidate, repack_cuda

    rng = np.random.RandomState(3)
    walls, splits, screens, disrupted = [], [], [], []
    repack_cuda.LAUNCHES = 0
    for _ in range(n):
        bound = sorted((p for p in env.cluster.pods.values() if p.node_name),
                       key=lambda p: p.name)
        for i in rng.choice(len(bound), size=min(50, len(bound)), replace=False):
            env.cluster.delete(bound[int(i)])
        env.clock.advance(61)
        before = len(env.disruption.disrupted)
        consolidate.LAST_SCREEN.clear()
        t0 = time.perf_counter()
        env.disruption.reconcile()
        walls.append((time.perf_counter() - t0) * 1e3)
        if env.manager.errors:
            raise AssertionError(f"reconcile errors: {env.manager.errors}")
        splits.append(dict(env.disruption.timings))
        screens.append({k: consolidate.LAST_SCREEN.get(k) for k in (
            "backend", "residency", "memo_hit", "wall_ms")})
        disrupted.append(len(env.disruption.disrupted) - before)
    return {"walls_ms": walls, "p50_ms": _pct(walls, 50), "p99_ms": _pct(walls, 99),
            "splits_ms": splits, "screens": screens, "disrupted": disrupted,
            "repack_launches": repack_cuda.LAUNCHES}


def cross_device_screens(env) -> dict:
    """The card's and the CPU's screens of one ``ct`` in one process, in
    turns: each backend answers from its own mirror and its own memo (the
    mirror's holders are keyed by encoder chain and device, the mask memo by
    backend), never from the other's, and the masks agree."""
    from karpenter_provider_aws_tpu_torch.ops import consolidate

    ct = consolidate.encode_cluster(env.cluster, env.catalog)
    seen = []
    masks = {}
    for device in ("cuda", "cpu", "cuda", "cpu"):
        mask = consolidate.dispatch_screen(ct, device=device).wait()
        screen = consolidate.LAST_SCREEN
        backend = "cuda-repack" if device == "cuda" else "torch-plain"
        if screen["backend"] != backend or screen["memo_hit"]:
            raise AssertionError(f"a {device} screen after the other device's answered "
                                 f"{screen['backend']}, memo_hit={screen['memo_hit']}")
        masks.setdefault(device, mask)
        seen.append({k: screen.get(k) for k in ("backend", "residency", "memo_hit")})
    if not np.array_equal(masks["cuda"], masks["cpu"]):
        raise AssertionError("the card's and the CPU's masks differ on one ct")
    return {"screens": seen, "nodes": len(ct.node_names), "passed": int(masks["cuda"].sum())}


def controlplane_interruption(device=None) -> tuple:
    """config7's 2,000 live spot nodes (launched claims), a spot-interruption
    warning for each of 200 nodes picked with RandomState(2), then manager
    passes until no pod is pending and no claim is deleting. The
    interruption controller first works the queue empty (10 messages a
    receive, 20 receives: at its 2 s cadence, well inside one spot warning's
    2 minutes), so that termination drains the 200 nodes in one pass and
    the provisioner meets the burst, as it does when the warnings land
    between two of its 10 s passes."""
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.ops import cluster_cases, ffd_cuda

    env = config7_env(device, AUDIT_CAPACITY)
    cluster_cases.seed_launched(port_pkg(), env)
    placed = {p.uid: p.node_name for p in env.cluster.pods.values()}
    claims = list(env.cluster.nodeclaims.values())
    picked = np.random.RandomState(2).choice(len(claims), size=INTERRUPTED_NODES, replace=False)
    victims = [claims[int(i)] for i in picked]
    drained = sum(len(env.cluster.pods_on_node(c.status.node_name)) for c in victims)
    for c in victims:
        env.queue.send({"source": "aws.ec2",
                        "detail-type": "EC2 Spot Instance Interruption Warning",
                        "detail": {"instance-id": c.status.provider_id.rsplit("/", 1)[-1]}})
    ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
    t0 = time.perf_counter()
    receives = 0
    while len(env.queue):
        env.interruption.reconcile()
        receives += 1
    handle_ms = (time.perf_counter() - t0) * 1e3
    passes = settle(env)
    total_ms = (time.perf_counter() - t0) * 1e3
    gone = sum(1 for c in victims if c.name not in env.cluster.nodeclaims)
    if gone != INTERRUPTED_NODES:
        raise AssertionError(f"{gone} of {INTERRUPTED_NODES} interrupted claims are gone")
    masked = sorted(env.catalog.unavailable.entries())
    if not masked or any(ct != lbl.CAPACITY_TYPE_SPOT for ct, _, _ in masked):
        raise AssertionError(f"masked offerings {masked[:5]}")
    run = {"drained_pods": drained, "receives": receives, "handle_ms": handle_ms,
           "passes": passes, "total_ms": total_ms,
           "ffd_launches": ffd_cuda.LAUNCHES, "ffd_lanes": ffd_cuda.LANES,
           "masked_offerings": len(masked), "interrupted": INTERRUPTED_NODES,
           "launched_claims": sum(1 for c in env.cluster.nodeclaims.values()
                                  if c.name.startswith("default-"))}
    out = cluster_cases.observe_lifecycle(env, placed)
    env.close()
    return out, run


def disruption_phase(smi: str) -> dict:
    """Phases 14-15 and the multi-replace chooser: the disruption half of the
    control plane through ``new_environment()``. Returns the kernels'
    launches on each path."""
    from karpenter_provider_aws_tpu_torch.ops import cluster_cases
    from karpenter_provider_aws_tpu_torch.testenv import new_environment

    os.environ["KARPENTER_TPU_SERIAL_LAUNCH"] = "1"  # the CPU runs must name claims alike

    # 14. config4's controller pass on the card, the settle, warm passes
    obs4, run4, env4 = controlplane_config4()
    if run4["first"]["repack_launches"] < 1:
        raise AssertionError("the disruption controller never launched the repack kernel")
    if run4["first"]["screen"].get("backend") != "cuda-repack":
        raise AssertionError(f"screened on {run4['first']['screen'].get('backend')}")
    if run4["ffd_launches"] < 1:
        raise AssertionError("the drained pods never reached the FFD kernel")
    warm = warm_disruption_passes(env4, WARM_DISRUPTION_PASSES)
    cross = cross_device_screens(env4)
    env4.close()
    obs4_cpu, run4_cpu, env4_cpu = controlplane_config4("cpu")
    env4_cpu.close()
    if run4_cpu["first"]["screen"].get("backend") != "torch-plain":
        raise AssertionError("the CPU environment did not screen with the plain version")
    same_lifecycle(obs4, obs4_cpu, "controlplane_config4")
    solved = [p for p in run4["passes"] if p["provisioning"]]
    emit({"phase": "controlplane_config4", "nodes": CONFIG4_NODES,
          "pods": run4["pods"],
          "build_s": run4["build_s"], **run4["first"],
          "settle_passes": len(run4["passes"]), "settle_ms": run4["settle_ms"],
          "settle_pass_walls_ms": [p["pass_ms"] for p in run4["passes"]],
          "settle_gc_ms": [p["gc_ms"] for p in run4["passes"]],
          "settle_passes_detail": run4["passes"],
          "disrupted_total": len(obs4["disrupted"]), "nodes_after": run4["nodes_after"],
          "ffd_launches": run4["ffd_launches"], "ffd_lanes": run4["ffd_lanes"],
          "repack_launches_settle": run4["repack_launches_settle"],
          "n_pre": [p["provisioning"]["n_pre"] for p in solved],
          "rows": [p["rows"] for p in solved],
          "bound_live": obs4["bound_live"], "bound_fresh": obs4["bound_fresh"],
          "warm": warm, "cross_device": cross,
          "cpu_controller_pass_ms": run4_cpu["first"]["controller_pass_ms"],
          "cpu_split_ms": run4_cpu["first"]["split_ms"], "cpu_settle_ms": run4_cpu["settle_ms"],
          "manager_errors": [], "cpu_run_equal": True, "card": smi})

    # 15. 200 spot interruptions on config7's cluster, on the card and the CPU
    obs15, run15 = controlplane_interruption()
    if run15["ffd_launches"] < 1:
        raise AssertionError("the interrupted nodes' pods never reached the FFD kernel")
    obs15_cpu, run15_cpu = controlplane_interruption("cpu")
    same_lifecycle(obs15, obs15_cpu, "controlplane_interruption")
    emit({"phase": "controlplane_interruption", "nodes": CONFIG7_NODES, **run15,
          "pass_walls_ms": [p["pass_ms"] for p in run15["passes"]],
          "handled": len(obs15["handled"]),
          "bound_live": obs15["bound_live"], "bound_fresh": obs15["bound_fresh"],
          "cpu_total_ms": run15_cpu["total_ms"], "manager_errors": [], "cpu_run_equal": True,
          "card": smi})

    # the multi-replace chooser, config6_multi_replace_optimizer (host work)
    t0 = time.perf_counter()
    row = cluster_cases.multi_replace_row(port_pkg(), new_environment)
    if row["cost_vs_oracle_p95"] != MULTI_REPLACE_P95:
        raise AssertionError(f"multi-replace p95 {row['cost_vs_oracle_p95']}, "
                             f"the reference's {MULTI_REPLACE_P95}")
    emit({"phase": "disruption_multi_replace", **row, "wall_ms": (time.perf_counter() - t0) * 1e3,
          "reference_p95": MULTI_REPLACE_P95, "backend": "host", "card": smi})
    os.environ.pop("KARPENTER_TPU_SERIAL_LAUNCH")
    return {"config4_repack": run4["first"]["repack_launches"],
            "config4_ffd": run4["ffd_launches"], "interruption_ffd": run15["ffd_launches"]}


#: the scale tier's cells: config9 (``benchmarks/scale_bench.py``
#: ``bench_scale``: 100,000 nodes, 1% node churn a pass, 10 passes, the burst
#: as lanes of 256 rows) and the disruption pass over four partitions
CONFIG9_CHURN_PASSES, CONFIG9_LANE_ROWS = 10, 256
PARTITIONED_NODES = 12_000


def partition_lane_check(args, init, n_pres, N, what: str) -> dict:
    """Partition lanes (``parallel.mesh.solve_partition_lanes``: the lanes
    of ``stack_lane_problems``, each from its own pre-opened rows, in ONE
    launch) against each lane's plain solve and its solo kernel launch on
    the same CUDA tensors and against the CPU's lanes; then the launch's
    times (the whole ``ffd_solve_lanes`` call by CUDA events, the kernel's
    device time from the profiler, lane 0 alone) and the bound for all
    lanes' bytes and operations."""
    from karpenter_provider_aws_tpu_torch.ops import ffd, ffd_cuda
    from karpenter_provider_aws_tpu_torch.parallel import mesh

    K = len(n_pres)
    ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
    got, t = mesh.solve_partition_lanes(args, init, n_pres, N)
    torch.cuda.synchronize()
    if (ffd_cuda.LAUNCHES, ffd_cuda.LANES) != (1, K):
        raise AssertionError(f"{what}: {ffd_cuda.LAUNCHES} launches of {ffd_cuda.LANES} lanes")
    cpu, _ = mesh.solve_partition_lanes(args, init, n_pres, N, device="cpu")
    state = mesh.lane_state(init, "cuda")
    err, nbytes, ops, n_open = 0.0, 0, 0, []
    for k in range(K):
        one = {f: t[f][k] for f in FFD_FIELDS}
        st = ffd._State(*(f[k] for f in state))
        mine = type(got)(*(f[k] for f in got))
        err = max(err, compare(f"{what} lane {k}", mine, call(ffd.ffd_solve, one, N, st,
                                                              n_pres[k])))
        compare(f"{what} lane {k} solo", mine, call(ffd_cuda.ffd_solve, one, N, st, n_pres[k]))
        compare(f"{what} lane {k} CPU", mine, type(cpu)(*(f[k].to(got.used.device) for f in cpu)))
        b, o = kernel_bytes_and_ops(one, N, mine, n_pres[k])
        nbytes, ops, n_open = nbytes + b, ops + o, n_open + [int(mine.n_open)]
    n_pre_t = torch.tensor(n_pres, dtype=torch.int32, device="cuda")

    def lanes():
        return ffd_cuda.ffd_solve_lanes(*(t[f] for f in mesh.LANE_FIELDS), max_nodes=N,
                                        init_state=state, n_pre=n_pre_t)

    lanes_dev, lanes_kept = device_ms(lanes, ("ffd_kernel",), 20)
    lane0 = {f: t[f][0] for f in FFD_FIELDS}
    st0 = ffd._State(*(f[0] for f in state))
    one_dev, one_kept = device_ms(lambda: call(ffd_cuda.ffd_solve, lane0, N, st0, n_pres[0]),
                                  ("ffd_kernel",), 20)
    (G, R), T = t["requests"].shape[1:], t["capacity"].shape[1]
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {
        "N": N, "G": G, "T": T, "R": R, "lanes": K, "n_pre": list(n_pres),
        "resident": ffd_cuda.resident(N, R), "active_ctas": ffd_cuda.active_ctas(N, R),
        "clusters_at_once": ffd_cuda.cluster_occupancy(N, R), "n_open": n_open,
        "placed": int(got.placed.sum()), "unplaced": int(got.unplaced.sum()),
        "parity": "exact", "max_abs_err": err, "cpu_equal": True, "solo_equal": True,
        "lanes_call_ms": time_cuda(lanes, runs=20),
        "plain_ms": time_cuda(lambda: ffd.ffd_solve_lanes(
            *(t[f] for f in mesh.LANE_FIELDS), max_nodes=N, init_state=state, n_pre=n_pre_t),
            runs=3, warmup=1),
        "lanes_device_ms": lanes_dev["ffd_kernel"], "lanes_records": lanes_kept,
        "single_lane_device_ms": one_dev["ffd_kernel"], "single_lane_records": one_kept,
        "bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def _sweep_ms(ct, parts=()) -> float:
    """One screen of ``ct`` with its mask memo (and its partitions') dropped:
    the wall of dispatch and wait."""
    from karpenter_provider_aws_tpu_torch.ops import consolidate

    for c in (ct, *parts):
        c.__dict__.pop("_screen_mask_memo", None)
    t0 = time.perf_counter()
    consolidate.dispatch_screen(ct).wait()
    return (time.perf_counter() - t0) * 1e3


def scale_phase(smi: str) -> dict:
    """Phase 16, ``scale_config9``: config9's 100,000 nodes in a
    ``new_environment()`` store, the partitioned encode reached through the
    ``auto`` switch; the cold encode, a hit, 10 passes of 1% node churn
    (every one incremental), the merged emission against a fresh global
    encode; the partitioned screen (one repack launch a partition, each
    partition's mask held to the plain version on its mirror's CUDA
    tensors, the merged mask to the CPU's); the per-zone burst as ONE FFD
    launch of 4 lanes and the cross-partition merge. Returns the launches
    and the shapes' times for the kernels line."""
    import gc

    from karpenter_provider_aws_tpu_torch.ops import (
        cluster_cases, consolidate, device_state, encode_delta, ffd_cuda, repack_cuda,
    )
    from karpenter_provider_aws_tpu_torch.ops.encode import pad_problem
    from karpenter_provider_aws_tpu_torch.parallel import mesh
    from karpenter_provider_aws_tpu_torch.testenv import new_environment

    for var in ("KARPENTER_TPU_PARTITION_ENCODE", "KARPENTER_TPU_PARTITION_MIN_NODES",
                "KARPENTER_TPU_PARTITION_SCREEN", "KARPENTER_TPU_PARTITION_SOLVE"):
        os.environ.pop(var, None)  # the defaults: "auto" at 8,192 nodes
    torch.cuda.reset_peak_memory_stats()
    pkg = port_pkg()
    t0 = time.perf_counter()
    env = new_environment()
    env.apply_defaults(cmr_pool())
    cluster_cases.config9_cluster(pkg, env.cluster, env.catalog, name=lambda i: f"c9-{i:x}")
    build_s = time.perf_counter() - t0
    cl, catalog = env.cluster, env.catalog
    keys = cl.partition_keys()
    churn = len(cl.nodes) // 100
    rng = np.random.RandomState(23)
    names = [n.name for n in cl.snapshot_nodes()]
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        t0 = time.perf_counter()
        ct = consolidate.encode_cluster(cl, catalog)
        full_ms = (time.perf_counter() - t0) * 1e3
        cold = dict(encode_delta.LAST_ENCODE)
        parts = ct.__dict__.get("_partitions") or []
        if len(parts) != len(keys) or len(keys) < 2 or "partitions" not in cold:
            raise AssertionError(f"config9 did not encode by partition: {len(parts)} parts "
                                 f"of {len(keys)} keys, {cold}")
        t0 = time.perf_counter()
        if consolidate.encode_cluster(cl, catalog) is not ct:
            raise AssertionError("an unchanged pass did not return the same tensors")
        hit_ms = (time.perf_counter() - t0) * 1e3
        patch_ms, outcomes = [], []
        for it in range(CONFIG9_CHURN_PASSES):
            for _ in range(churn):
                if rng.rand() < 0.5:
                    p = pkg.make_pods(1, f"sc{it}", {"cpu": "250m", "memory": "512Mi"})[0]
                    cl.apply(p)
                    cl.bind_pod(p.uid, names[rng.randint(len(names))])
                else:
                    bound = [pp for pp in list(cl.pods.values())[:512] if pp.node_name]
                    if bound:
                        cl.unbind_pod(bound[rng.randint(len(bound))].uid)
            t0 = time.perf_counter()
            ct = consolidate.encode_cluster(cl, catalog)
            patch_ms.append((time.perf_counter() - t0) * 1e3)
            outcomes.append(dict(encode_delta.LAST_ENCODE))
        if any(o["mode"] != "patch" or "full" in o["partitions"].values() for o in outcomes):
            raise AssertionError(f"a churn pass was not incremental: {outcomes}")
        t0 = time.perf_counter()
        fresh = consolidate._encode_cluster(cl, catalog, consolidate.GMAX_DEFAULT)
        global_ms = (time.perf_counter() - t0) * 1e3
        diffs = encode_delta.canonical_equal(encode_delta.canonical_form(ct),
                                             encode_delta.canonical_form(fresh))
        if diffs:
            raise AssertionError(f"the merged emission differs from a global encode: {diffs}")
        fresh = None
    finally:
        gc.enable()
        gc.unfreeze()
    parts = ct.__dict__["_partitions"]
    emit({"phase": "scale_config9", "benchmark": "config9_100k_nodes", "nodes": len(cl.nodes),
          "pods": len(cl.pods), "partitions": len(parts),
          "per_partition": {"/".join(k): n for k, _c, _o, n in parts},
          "build_s": build_s, "full_encode_ms": full_ms, "cold_outcome": cold,
          "hit_ms": hit_ms, "churn_nodes_per_pass": churn, "passes": CONFIG9_CHURN_PASSES,
          "patch_p50_ms": _pct(patch_ms, 50), "patch_p99_ms": _pct(patch_ms, 99),
          "patch_ms": patch_ms, "pass_outcomes": [o["partitions"] for o in outcomes],
          "steady_state_incremental": True, "global_encode_ms": global_ms,
          "canonical_equal": True, "card": smi})

    # the partitioned screen on the card: one repack launch a partition
    repack_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    mask = consolidate.dispatch_screen(ct).wait()
    screen_first_ms = (time.perf_counter() - t0) * 1e3
    repack_launches = repack_cuda.LAUNCHES
    screen = dict(consolidate.LAST_SCREEN)
    if repack_launches != len(parts) or screen["backend"] != "partitioned(cuda-repack)":
        raise AssertionError(f"{repack_launches} repack launches for {len(parts)} partitions, "
                             f"{screen['backend']}")
    per_part, repack_err = [], 0.0
    for key, pct, off, n in parts:
        free, req, gids, gcnt, cap, cand, n_live = \
            device_state.mirror_for(pct, "cuda").arrays()
        got = repack_cuda.repack_check(free, req, gids, gcnt, cap, cand)
        want = consolidate.repack_check(free, req, gids, gcnt, cap, cand)
        repack_err = max(repack_err, float((got.to(torch.int32) - want.to(torch.int32))
                                           .abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"{key}: the repack kernel and the plain version differ on "
                                 f"{int((got != want).sum())} of {n} nodes")
        if not np.array_equal(got.cpu().numpy() & ~pct.blocked, mask[off:off + n]):
            raise AssertionError(f"{key}: the partition's mask is not the kernel's")
        per_part.append({"partition": "/".join(key), "nodes": n, "mirror_rows": int(free.shape[0]),
                         "S": int(gids.shape[1]), "passed": int(mask[off:off + n].sum())})
    t0 = time.perf_counter()
    cpu_mask = consolidate.consolidatable(ct, device="cpu")
    cpu_screen_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(mask, cpu_mask):
        raise AssertionError("the card's partitioned mask differs from the CPU's")
    biggest = max(parts, key=lambda p: p[3])
    one_ms = statistics.median(_sweep_ms(biggest[1]) for _ in range(5))
    all_ms = statistics.median(_sweep_ms(ct, [p[1] for p in parts]) for _ in range(3))
    rt = list(device_state.mirror_for(biggest[1], "cuda").arrays()[:6])
    work = repack_bytes_and_ops(rt)
    rtimes = repack_times(repack_cuda, rt)
    partition_timing = {
        "partition": "/".join(biggest[0]), "N": int(rt[0].shape[0]), "C": int(rt[5].shape[0]),
        "S": int(rt[2].shape[1]), **rtimes,
        "plain_ms": time_cuda(lambda: consolidate.repack_check(*rt), runs=3, warmup=1),
        **work, "bound_ms": max(work["bytes_ms"], work["ops_ms"]),
        "bound_by": "bytes" if work["bytes_ms"] >= work["ops_ms"] else "operations"}
    emit({"phase": "scale_config9_screen", "launches": repack_launches,
          "first_ms": screen_first_ms, "partitions": per_part,
          "residency": [s.get("residency") for s in screen["part_screens"]],
          "passed": int(mask.sum()), "parity": "exact", "max_abs_err": repack_err,
          "cpu_mask_equal": True, "cpu_screen_ms": cpu_screen_ms,
          "screen_partition_ms": one_ms, "screen_all_partitions_ms": all_ms,
          "partition_timing": partition_timing, "card": smi})

    # the per-zone burst: ONE launch of one lane a zone, then the merge
    zones = sorted({z for _p, z in keys})
    problems = cluster_cases.zone_bursts(pkg, catalog, zones, cl.nodepools["default"])
    GB = max(p.requests.shape[0] for p in problems)
    args, (_TB, ZB) = mesh.stack_lane_problems([pad_problem(p, GB) for p in problems])
    init, n_pres = mesh.stack_lane_states([None] * len(problems), CONFIG9_LANE_ROWS,
                                          args["requests"].shape[2], ZB,
                                          args["group_window"].shape[3])
    burst = partition_lane_check(args, init, n_pres, CONFIG9_LANE_ROWS, "config9 burst")
    walls = []
    for _ in range(5):
        ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
        t0 = time.perf_counter()
        res, _t = mesh.solve_partition_lanes(args, init, n_pres, CONFIG9_LANE_ROWS)
        plans = mesh.lane_plans(problems, res)
        walls.append((time.perf_counter() - t0) * 1e3)
        ffd_launches, ffd_lanes = ffd_cuda.LAUNCHES, ffd_cuda.LANES
    t0 = time.perf_counter()
    merged = mesh.merge_partition_plans(problems, plans)
    merge_ms = (time.perf_counter() - t0) * 1e3
    total = sum(int(p.counts[:len(p.group_pods)].sum()) for p in problems)
    kept = int(merged["placed"][:, ~merged["dropped"]].sum())
    if kept != total or merged["cost_merged"] > merged["cost_lanes"] + 1e-6:
        raise AssertionError(f"the merge kept {kept} of {total} pods, cost "
                             f"{merged['cost_merged']} over {merged['cost_lanes']}")
    emit({"phase": "scale_config9_lanes",
          "burst": {"pods": total, "lanes": len(problems), "launches": ffd_launches,
                    "solve_lanes_ms": statistics.median(walls), **burst},
          "merge": {"merge_ms": merge_ms, "cost_lanes": merged["cost_lanes"],
                    "cost_merged": merged["cost_merged"], "nodes_lanes": int(merged["n_open"]),
                    "nodes_dropped": int(merged["dropped"].sum()), "pods_kept": kept},
          "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
          "lanes_mode": mesh.lanes_mode(), "card": smi})
    env.close()
    return {"repack_launches": repack_launches, "ffd_launches": ffd_launches,
            "ffd_lanes": ffd_lanes, "burst": burst, "partition_timing": partition_timing}


def partitioned_env(device=None):
    """config4's builder at 12,000 nodes over the catalog's four zones (one
    (default, zone) partition each, above the 8,192-node threshold) in a
    fresh environment, each claim launched as ``config4_env``'s are."""
    from karpenter_provider_aws_tpu_torch.ops import cluster_cases
    from karpenter_provider_aws_tpu_torch.testenv import new_environment

    pkg = port_pkg()
    env = new_environment(device=device, audit_capacity=AUDIT_CAPACITY)
    env.apply_defaults(cmr_pool())
    cluster_cases.synth_cluster(pkg, env.cluster, env.catalog, PARTITIONED_NODES,
                                CONFIG4_PODS_PER_NODE, name=lambda i: f"c4p-{i:x}")
    cluster_cases.seed_launched(pkg, env)
    return env


def controlplane_partitioned(device=None) -> tuple:
    """One disruption-controller pass over ``partitioned_env``'s 12,000
    nodes (the pool consolidating after 60 s under a 10% budget, the clock
    120 s on): the partitioned encode and one repack launch a partition.
    Returns the observation and the pass's numbers."""
    from karpenter_provider_aws_tpu_torch.ops import (
        cluster_cases, consolidate, encode_delta, repack_cuda,
    )

    t0 = time.perf_counter()
    env = partitioned_env(device)
    build_s = time.perf_counter() - t0
    pool = env.cluster.nodepools["default"]
    pool.disruption.consolidate_after_s = 60
    pool.disruption.budgets = ["10%"]
    env.clock.advance(120)
    repack_cuda.LAUNCHES = 0
    consolidate.LAST_SCREEN.clear()
    t0 = time.perf_counter()
    with gc_pauses() as paused:
        env.disruption.reconcile()
    pass_ms = (time.perf_counter() - t0) * 1e3
    if env.manager.errors:
        raise AssertionError(f"reconcile errors: {env.manager.errors}")
    screen = dict(consolidate.LAST_SCREEN)
    run = {"build_s": build_s, "nodes": len(env.cluster.nodes), "pods": len(env.cluster.pods),
           "partitions": len(env.cluster.partition_keys()),
           "controller_pass_ms": pass_ms, "gc_ms": paused[0],
           "split_ms": dict(env.disruption.timings),
           "encode": {k: v for k, v in encode_delta.LAST_ENCODE.items()},
           "screen": {k: v for k, v in screen.items() if k != "part_screens"},
           "part_screens": screen.get("part_screens"),
           "disrupted": len(env.disruption.disrupted),
           "reasons": sorted({r.split(":")[0] for _, r in env.disruption.disrupted}),
           "repack_launches": repack_cuda.LAUNCHES}
    out = cluster_cases.observe_lifecycle(env)
    env.close()
    return out, run


def partitioned_phase(smi: str) -> dict:
    """Phase 17, ``controlplane_partitioned``: one disruption pass over
    12,000 of config4's nodes in four partitions on the card and the CPU
    (the same claims disrupted and the whole audit trail; one repack launch
    a partition); config5 (two pools, the market on) through
    ``TorchSolver()``: ONE FFD launch of 2 lanes, the plan the CPU's and the
    one-by-one solve's (``KARPENTER_TPU_PARTITION_SOLVE=0``, 2 launches);
    the cramped cross-partition case on the card: every zone-a node passes
    the whole screen and fails the partitioned one. Returns the launches."""
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.ops import (
        cluster_cases, consolidate, ffd_cuda, repack_cuda, solve_cases,
    )
    from karpenter_provider_aws_tpu_torch.catalog import CatalogProvider
    from karpenter_provider_aws_tpu_torch.models import NodePool, Operator, Requirement
    from karpenter_provider_aws_tpu_torch.scheduling import TorchSolver
    from karpenter_provider_aws_tpu_torch.state import Cluster

    os.environ["KARPENTER_TPU_SERIAL_LAUNCH"] = "1"  # the CPU run must name claims alike
    obs, run = controlplane_partitioned()
    if run["repack_launches"] != run["partitions"] or run["partitions"] != 4 \
            or run["screen"].get("backend") != "partitioned(cuda-repack)":
        raise AssertionError(f"{run['repack_launches']} repack launches over "
                             f"{run['partitions']} partitions, {run['screen'].get('backend')}")
    obs_cpu, run_cpu = controlplane_partitioned("cpu")
    if run_cpu["screen"].get("backend") != "partitioned(torch-plain)":
        raise AssertionError("the CPU environment did not screen by partition")
    same_lifecycle(obs, obs_cpu, "controlplane_partitioned")
    os.environ.pop("KARPENTER_TPU_SERIAL_LAUNCH")

    # config5: the two pools as partition lanes, against the CPU and the
    # pools solved one by one
    os.environ["KARPENTER_TPU_OPTIMIZER"] = "0"
    pkg = SimpleNamespace(lbl=lbl, make_pods=make_pods)
    pools = [NodePool(name=name, requirements=[
        Requirement(lbl.INSTANCE_CATEGORY, Operator.IN, cats)])
        for name, cats in (("default", ("c", "m", "r")), ("accel", ("g", "p", "inf", "trn")))]
    pods = solve_cases.config5_pods(pkg, 4000)
    ffd_cuda.LAUNCHES = ffd_cuda.LANES = 0
    t0 = time.perf_counter()
    res = TorchSolver().solve(pods, pools, market_catalog())
    lanes_ms = (time.perf_counter() - t0) * 1e3
    launches, lanes = ffd_cuda.LAUNCHES, ffd_cuda.LANES
    if (launches, lanes) != (1, 2):
        raise AssertionError(f"config5 ran {launches} FFD launches of {lanes} lanes")
    same_plan(res, TorchSolver(device="cpu").solve(pods, pools, market_catalog()),
              "config5 lanes, card vs CPU")
    os.environ["KARPENTER_TPU_PARTITION_SOLVE"] = "0"
    ffd_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    solo = TorchSolver().solve(pods, pools, market_catalog())
    solo_ms = (time.perf_counter() - t0) * 1e3
    solo_launches = ffd_cuda.LAUNCHES
    os.environ.pop("KARPENTER_TPU_PARTITION_SOLVE")
    os.environ.pop("KARPENTER_TPU_OPTIMIZER")
    same_plan(res, solo, "config5 lanes vs one by one")

    # the cramped case: a partition-local screen is a tightening
    os.environ["KARPENTER_TPU_PARTITION_ENCODE"] = "1"
    cramped_cl, cramped_cat = Cluster(), CatalogProvider()
    cramped = cluster_cases.cramped_cross_partition(port_pkg(), cramped_cl, cramped_cat)
    cct = consolidate.encode_cluster(cramped_cl, cramped_cat)
    repack_cuda.LAUNCHES = 0
    part = dict(zip(cct.node_names, consolidate.consolidatable(cct).tolist()))
    cramped_launches = repack_cuda.LAUNCHES
    os.environ["KARPENTER_TPU_PARTITION_SCREEN"] = "0"
    whole = dict(zip(cct.node_names, consolidate.consolidatable(cct).tolist()))
    for var in ("KARPENTER_TPU_PARTITION_SCREEN", "KARPENTER_TPU_PARTITION_ENCODE"):
        os.environ.pop(var)
    if not all(whole[n] and not part[n] for n in cramped) or cramped_launches != 2:
        raise AssertionError(f"cramped: whole {whole}, partitioned {part}, "
                             f"{cramped_launches} launches")
    emit({"phase": "controlplane_partitioned", **run, "cpu_controller_pass_ms":
          run_cpu["controller_pass_ms"], "cpu_split_ms": run_cpu["split_ms"],
          "cpu_run_equal": True, "audit_records": len(obs["decisions"]),
          "config5": {"pods": len(pods), "placed": res.pods_placed(),
                      "nodes": len(res.node_specs), "cost": res.total_cost,
                      "launches": launches, "lanes": lanes, "wall_ms": lanes_ms,
                      "one_by_one_launches": solo_launches, "one_by_one_wall_ms": solo_ms,
                      "cpu_plan_equal": True, "one_by_one_plan_equal": True},
          "cramped": {"nodes": len(cct.node_names), "zone_a": cramped,
                      "whole_passed": sum(whole.values()), "partitioned_passed":
                      sum(part.values()), "launches": cramped_launches},
          "manager_errors": [], "card": smi})
    return {"repack_launches": run["repack_launches"], "ffd_launches": launches,
            "ffd_lanes": lanes}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import karpenter_provider_aws_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the package karpenter_provider_aws_tpu_torch is not beside this "
              "script; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from karpenter_provider_aws_tpu_torch.catalog import CatalogProvider
    from karpenter_provider_aws_tpu_torch.models import NodePool, Operator, Requirement
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.interop import state_from_reference
    from karpenter_provider_aws_tpu_torch.ops import _build, ffd, ffd_cases, ffd_cuda, solve_cases
    from karpenter_provider_aws_tpu_torch.ops.encode import encode_problem, pad_problem
    from karpenter_provider_aws_tpu_torch.parallel import mesh
    from karpenter_provider_aws_tpu_torch.scheduling import TorchSolver

    dev = torch.device("cuda")
    # 1. probe
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    emit({"phase": "probe", "device": name, "capability": list(cap), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if tuple(cap) != (9, 0):
        raise SystemExit(f"compute capability {cap}, need (9, 0) for sm_90a")

    # 2. build
    t0 = time.perf_counter()
    seconds = _build.build_all()
    ptxas = {k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in _build.BUILD_LOGS.items()}
    emit({"phase": "build", "seconds": seconds, "wall_s": time.perf_counter() - t0,
          "ptxas": ptxas,
          "sha256": {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                     for p in sorted(_build.CSRC.glob("*.cu"))},
          # clusters of the FFD kernel the card holds at once, on each branch
          "ffd_clusters": {"resident_8192x10": ffd_cuda.cluster_occupancy(8192, 10),
                           "global_20480x10": ffd_cuda.cluster_occupancy(20480, 10)}})

    # phases 3-11 keep their checks with the optimizer lane off (the default
    # since the lane's slice); phase 12 turns it back on
    os.environ["KARPENTER_TPU_OPTIMIZER"] = "0"

    # 3. parity: kernel vs plain version on the same CUDA tensors, on
    # ops/ffd_cases.py's cases (both branches), the headline and config8
    pkg = SimpleNamespace(lbl=lbl, make_pods=make_pods)
    pool = NodePool(name="default",
                    requirements=[Requirement(lbl.INSTANCE_CATEGORY, Operator.IN, ("c", "m", "r"))])
    catalog = CatalogProvider()
    pods = solve_cases.headline_pods(pkg)
    t_enc = time.perf_counter()
    problem = pad_problem(encode_problem(pods, catalog, nodepool=pool))
    encode_cold_ms = (time.perf_counter() - t_enc) * 1e3
    pods8 = solve_cases.config8_pods(pkg)
    cases = {cname: (dict(zip(FFD_FIELDS, args)), N, init, npre)
             for cname, (args, N, init, npre, _z, _c) in
             {**ffd_cases.small_cases(seeds=8), **ffd_cases.card_cases()}.items()}
    cases["headline"] = (problem_arrays(problem), 8192, None, 0)
    cases["config8"] = (problem_arrays(pad_problem(encode_problem(pods8, catalog, nodepool=pool))),
                        CONFIG8_ROWS, None, 0)
    max_err, parity, tensors = 0.0, {}, {}
    for cname, (arrays, N, init_np, npre) in cases.items():
        t = to_device(arrays, ffd, dev)
        init_state = (None if init_np is None
                      else state_from_reference(*init_np, n_open=npre, device=dev))
        got = call(ffd_cuda.ffd_solve, t, N, init_state, npre)
        torch.cuda.synchronize()
        want = call(ffd.ffd_solve, t, N, init_state, npre)
        err = compare(cname, got, want)
        max_err = max(max_err, err)
        (G, R), T = t["requests"].shape, t["capacity"].shape[0]
        parity[cname] = {"N": N, "G": G, "real_groups": int((arrays["counts"] > 0).sum()),
                         "T": T, "R": R, "n_pre": npre, "resident": ffd_cuda.resident(N, R),
                         "n_open": int(got.n_open), "placed": int(got.placed.sum()),
                         "unplaced": int(got.unplaced.sum()), "max_abs_err": err}
        tensors[cname] = (t, N, init_state, npre)
    if parity["global_branch"]["resident"] or not parity["headline"]["resident"]:
        raise AssertionError("the cases did not cover both branches of the kernel")
    # partition lanes of distinct problems, each from its own pre-opened rows
    lproblems, lrows, lpre = ffd_cases.lanes_pre_opened()
    largs, (_TB, lZB) = mesh.stack_lane_problems(lproblems)
    linit, ln_pres = mesh.stack_lane_states(lpre, lrows, largs["requests"].shape[2], lZB,
                                            largs["group_window"].shape[3])
    pre_lanes = partition_lane_check(largs, linit, ln_pres, lrows, "lanes_pre_opened")
    parity["lanes_pre_opened"] = {k: pre_lanes[k] for k in (
        "N", "G", "T", "R", "lanes", "n_pre", "n_open", "placed", "unplaced", "max_abs_err")}
    max_err = max(max_err, pre_lanes["max_abs_err"])
    emit({"phase": "parity", "cases": parity, "max_abs_err": max_err, "rtol": RTOL, "atol": ATOL})

    # 4. main path: the user's entry point, through the kernel
    solver = TorchSolver()
    ffd_cuda.LAUNCHES = 0
    res = solver.solve(pods, [pool], catalog)
    torch.cuda.synchronize()
    launches = ffd_cuda.LAUNCHES
    if launches < 1:
        raise AssertionError("the main path never launched the FFD kernel")
    if res.pods_placed() != len(pods) or res.unschedulable:
        raise AssertionError(f"placed {res.pods_placed()} of {len(pods)} pods")
    same_plan(res, TorchSolver(device="cpu").solve(pods, [pool], catalog), "headline")
    warm = {"encode_ms": [], "device_ms": [], "decode_ms": [], "wall_ms": []}
    for _ in range(5):
        r = solver.solve(pods, [pool], catalog)
        for k in ("encode_ms", "device_ms", "decode_ms"):
            warm[k].append(solver.timings[k])
        warm["wall_ms"].append(r.solve_seconds * 1e3)
    emit({"phase": "main", "pods": len(pods), "placed": res.pods_placed(),
          "nodes": len(res.node_specs), "cost": res.total_cost,
          "cpu_plan_equal": True, "launches": launches, "encode_cold_ms": encode_cold_ms,
          "rows": solver.timings.get("n_rows"), "n_open": solver.timings.get("n_open"),
          "warm_median_ms": {k: statistics.median(v) for k, v in warm.items()},
          "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
          "backend": res.provenance["backend"], "device": name, "card": smi})

    # 5. kernel timing: the rows the main path gave the kernel (held to the
    # plain version there too), the 8,192-row cap, config8 (solved through
    # the entry point too, at the rows it gave the kernel) and the global
    # branch: the whole wrapper call, the kernel's device time, and the
    # latter per real group
    t = tensors["headline"][0]
    N_main = int(solver.timings["n_rows"])
    main_res = call(ffd_cuda.ffd_solve, t, N_main)
    torch.cuda.synchronize()
    if int(main_res.n_open) != solver.timings["n_open"]:
        raise AssertionError("the main path gave the kernel other inputs than the headline's")
    max_err = max(max_err, compare("headline_main_rows", main_res, call(ffd.ffd_solve, t, N_main)))
    solver8 = TorchSolver()
    res8 = solver8.solve(pods8, [pool], catalog)
    same_plan(res8, TorchSolver(device="cpu").solve(pods8, [pool], catalog), "config8")
    if solver8.timings["n_rows"] != CONFIG8_ROWS:
        raise AssertionError(f"config8 solved on {solver8.timings['n_rows']} rows, "
                             f"timed on {CONFIG8_ROWS}")
    shapes = {f"headline_{N_main}": (t, N_main, None, 0), "headline_8192": tensors["headline"],
              f"config8_{CONFIG8_ROWS}": tensors["config8"],
              "global_branch": tensors["global_branch"]}
    timing = {}
    for key, (tt, N, init_state, npre) in shapes.items():
        res_n = call(ffd_cuda.ffd_solve, tt, N, init_state, npre)
        nbytes, ops = kernel_bytes_and_ops(tt, N, res_n, npre)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        (G, R), real = tt["requests"].shape, int((tt["counts"] > 0).sum())
        times = ffd_times(ffd_cuda, tt, N, init_state, npre)
        timing[key] = {
            "N": N, "G": G, "real_groups": real, "n_pre": npre,
            "resident": ffd_cuda.resident(N, R), "clusters": ffd_cuda.cluster_occupancy(N, R),
            **times, "us_per_real_group": times["device_ms"] * 1e3 / real,
            "plain_ms": time_cuda(lambda: call(ffd.ffd_solve, tt, N, init_state, npre),
                                  runs=3, warmup=1),
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
    emit({"phase": "timing", "shapes": timing, "main_rows": N_main,
          "main_rows_parity": "exact", "launches_per_solve": launches,
          "config8": {"pods": len(pods8), "placed": res8.pods_placed(),
                      "nodes": len(res8.node_specs), "cost": res8.total_cost,
                      "cpu_plan_equal": True},
          "card": smi})

    # 6. profile: device time of one warm solve, by kernel
    emit(profile_solve(lambda: solver.solve(pods, [pool], catalog)))

    repack_line = screen_phases(dev, name, smi)
    churn = churn_phase(dev, smi)
    repack_line["launches_by_path"] = {"consolidation": repack_line["launches"],
                                       "churn": churn["launches"]}
    market_launches = market_phase(smi)
    lanes = optimizer_phase(dev, smi, pool, catalog, pods, pods8)
    cp = controlplane_phase(smi)
    dp = disruption_phase(smi)
    sp = scale_phase(smi)
    pp = partitioned_phase(smi)
    repack_line["launches_by_path"].update(controlplane_config4=dp["config4_repack"],
                                           scale_config9=sp["repack_launches"],
                                           controlplane_partitioned=pp["repack_launches"])
    pt = sp["partition_timing"]  # config9's largest partition, as its mirror holds it
    repack_line["partition_timing"] = {k: pt[k] for k in (
        "partition", "N", "C", "S", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
        "bound_by")}

    main = timing[f"headline_{N_main}"]  # the FFD kernel's line: the main path's shapes
    emit({"kernels": [{
        "name": "ffd", "route": "cuda",
        "source": "karpenter_provider_aws_tpu_torch/csrc/ffd.cu",
        "replaces": "karpenter_provider_aws_tpu/ops/ffd_pallas.py:66",
        "tpu_kernel": "ops/ffd_pallas.py::_kernel",
        "launches": launches, "parity": "exact", "max_abs_err": max_err,
        "launches_by_path": {"headline": launches, "market": market_launches,
                             "headline_lane_on": lanes["launches"],
                             "controlplane_config7": cp["config7"],
                             "controlplane_config8": cp["config8"],
                             "controlplane_config4": dp["config4_ffd"],
                             "controlplane_interruption": dp["interruption_ffd"],
                             "scale_config9": sp["ffd_launches"],
                             "controlplane_partitioned": pp["ffd_launches"]},
        "lanes_by_path": {"headline_lane_on": lanes["lanes"],
                          "controlplane_config8": cp["config8_lanes"],
                          "scale_config9": sp["ffd_lanes"],
                          "controlplane_partitioned": pp["ffd_lanes"]},
        "lane_launch": {k: {f: v[f] for f in ("N", "lanes", "lanes_device_ms",
                                               "single_lane_device_ms", "bound_ms",
                                               "clusters_at_once")}
                        for k, v in {**lanes["shapes"], "config9_burst": sp["burst"],
                                     "lanes_pre_opened": pre_lanes}.items()},
        "rows": N_main, "ms": main["kernel_ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
    }, repack_line]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--churn-profile"]:
        if not torch.cuda.is_available():
            sys.exit(2)
        emit(churn_profile())
        sys.exit(0)
    sys.exit(main())
