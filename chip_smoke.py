"""Drive the torch package on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

It drives the package's paths: the provisioning solve (the FFD kernel), with
the market on in phase 11, the consolidation screen (the repack kernel) and
the consolidation pass under churn (phase 10). Phases, each printing one
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
               floats to rtol 1e-6 / atol 1e-3);
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
               the CPU solve's, the FFD kernel launched, reserved nodes used;
then the kernels line, the card's name and power limit, and the result line.
It needs the repository's package beside it and a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
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


def add_config4_node(cluster, catalog, i, it, zone):
    """One launched, registered, ready spot node of the default pool and its
    claim, as ``_synth_cluster`` makes them; names come from ``i``."""
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.nodeclaim import NodeClaim
    from karpenter_provider_aws_tpu_torch.state import Node

    claim = NodeClaim(name=f"default-{i:x}", nodepool_name="default",
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
    node = Node(name=f"node-{claim.name}", provider_id=claim.status.provider_id,
                nodepool_name="default", nodeclaim_name=claim.name,
                labels=dict(claim.labels), capacity=claim.status.capacity,
                allocatable=claim.status.allocatable, ready=True)
    node.labels[lbl.HOSTNAME] = node.name
    claim.status.node_name = node.name
    cluster.apply(node)
    return node


def config4_types(catalog) -> list:
    return [t for t in catalog.list() if t.category in ("c", "m") and 4 <= t.vcpus <= 16]


def config4_cluster(n_nodes=5000, pods_per_node=8):
    """The repo's config4 cluster (``benchmarks/solve_configs.py``
    ``_synth_cluster``): RandomState(1), c/m types of 4-16 vCPUs, spot, one
    claim and one ready node each, 1..8 pods of 250m/512Mi bound to it, in
    the port's journaled store."""
    from karpenter_provider_aws_tpu_torch.catalog import CatalogProvider
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.state import Cluster

    catalog = CatalogProvider()
    cluster = Cluster()
    rng = np.random.RandomState(1)
    types = config4_types(catalog)
    for i in range(n_nodes):
        it = types[rng.randint(len(types))]
        zone = catalog.zones[rng.randint(len(catalog.zones))]
        node = add_config4_node(cluster, catalog, i, it, zone)
        fill = rng.randint(1, pods_per_node + 1)
        for p in make_pods(fill, f"p{i}", {"cpu": "250m", "memory": "512Mi"}):
            cluster.apply(p)
            cluster.bind_pod(p.uid, node.name)
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
    types = config4_types(catalog)
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
            names.append(add_config4_node(cluster, catalog, next_node, it, zone).name)
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
    market on and a ``MarketModel(seed=0)``; the plan must equal the CPU
    solve's on the same market. Returns the FFD kernel's launches."""
    import os

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
    ffd_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    res = TorchSolver().solve(pods, pools, catalog)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ffd_cuda.LAUNCHES
    if launches < 1:
        raise AssertionError("the config5 market solve never launched the FFD kernel")
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
          "market_fragment": [list(map(str, f)) for f in frag], "wall_ms": wall_ms,
          "card": smi})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from karpenter_provider_aws_tpu_torch.catalog import CatalogProvider
    from karpenter_provider_aws_tpu_torch.models import NodePool, Operator, Requirement
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.interop import state_from_reference
    from karpenter_provider_aws_tpu_torch.ops import _build, ffd, ffd_cases, ffd_cuda, solve_cases
    from karpenter_provider_aws_tpu_torch.ops.encode import encode_problem, pad_problem
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

    main = timing[f"headline_{N_main}"]  # the FFD kernel's line: the main path's shapes
    emit({"kernels": [{
        "name": "ffd", "route": "cuda",
        "source": "karpenter_provider_aws_tpu_torch/csrc/ffd.cu",
        "replaces": "karpenter_provider_aws_tpu/ops/ffd_pallas.py:66",
        "tpu_kernel": "ops/ffd_pallas.py::_kernel",
        "launches": launches, "parity": "exact", "max_abs_err": max_err,
        "launches_by_path": {"headline": launches, "market": market_launches},
        "rows": N_main, "ms": main["kernel_ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
    }, repack_line]})
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
