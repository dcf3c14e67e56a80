"""Drive the torch package on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

It drives both paths of the package: the provisioning solve (the FFD kernel)
and the consolidation screen (the repack kernel). Phases, each printing one
JSON line (any failure exits non-zero):
  1. probe   — device name, compute capability (must be 9.0), nvidia-smi;
  2. build   — compile every kernel under karpenter_provider_aws_tpu_torch/csrc
               (one nvcc per source, all started together);
  3. parity  — the FFD kernel against its plain PyTorch version on the same
               CUDA tensors: a random family, row exhaustion, pre-opened rows
               and the headline shapes (integers exact, floats to
               rtol 1e-6 / atol 1e-3);
  4. main    — TorchSolver().solve on the headline problem (50,000 pods in
               64 shapes, seed 0, one pool of c/m/r, the real catalog), which
               must launch the kernel, place every pod, and give the same plan
               as the same solve with every tensor on the CPU;
  5. timing  — the kernel and the plain version at the headline shapes, at
               the 8,192-row cap and at the rows the main path used (where
               the kernel is held to the plain version once more);
  6. profile — device time by kernel over one warm solve, and the idle share;
  7. repack_parity — the repack kernel against its plain PyTorch version on
               the same CUDA tensors: ``ops/repack_cases.py``'s random family
               (seeds 0-7), candidate subset, empty node, nothing-fits,
               self-exclusion and float hostname cap, its global-scratch
               cases at N = 8,192 (one pass of the kernel's node loop) and
               N = 12,000 (two passes), and config4 (``ok`` exact);
  8. consolidation — the screen's main path on config4 (the 5,000-node
               ``_synth_cluster`` of the repo's benchmarks): encode_cluster,
               consolidatable (must launch the kernel, pass 5,000 nodes and
               equal the CPU mask), the delete prefix (must be 4,306), warm
               screen times, and one screen under the profiler;
  9. repack_timing — the kernel, the same launch with no live slot (its
               private copies alone) and the plain version at config4's
               shapes and at N = 8,192, beside the bound;
then the kernels line, the card's name and power limit, and the result line.
It needs the repository's package beside it and a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
RTOL, ATOL = 1e-6, 1e-3
HEADLINE_PODS = 50_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def random_problem(rng, G, T, R, Z, C):
    requests = np.zeros((G, R), dtype=np.float32)
    requests[:, 0] = rng.choice([100, 250, 500, 1000, 2000], G)
    requests[:, 1] = rng.choice([256, 512, 1024, 4096], G)
    requests[:, 2] = 1.0
    counts = rng.randint(1, 40, G).astype(np.int32)
    compat = rng.rand(G, T) < 0.7
    compat[:, 0] = True
    capacity = np.zeros((T, R), dtype=np.float32)
    capacity[:, 0] = rng.choice([4000, 8000, 16000, 32000], T)
    capacity[:, 1] = rng.choice([8192, 16384, 65536], T)
    capacity[:, 2] = rng.choice([29, 58, 110, 250], T)
    price = np.where(compat, rng.uniform(0.05, 3.0, (G, T)).astype(np.float32), np.inf)
    group_window = rng.rand(G, Z, C) < 0.8
    group_window[:, 0, 0] = True
    type_window = rng.rand(T, Z, C) < 0.8
    type_window[:, 0, 0] = True
    mpn = np.where(rng.rand(G) < 0.2, rng.randint(1, 5, G), 1 << 30).astype(np.int32)
    return dict(requests=requests, counts=counts, compat=compat, capacity=capacity,
                price=price.astype(np.float32), group_window=group_window,
                type_window=type_window, max_per_node=mpn)


def headline_pods(pkg, n=HEADLINE_PODS):
    """The repository's headline problem generator (64 shapes, seed 0)."""
    lbl = pkg["lbl"]
    rng = np.random.RandomState(0)
    pods = []
    per = max(1, n // 64)
    for i in range(64):
        cpu_m = int(rng.choice([100, 250, 500, 1000, 2000, 4000, 8000]))
        mem_mi = cpu_m * int(rng.choice([1, 2, 4, 8]))
        kwargs = {}
        r = rng.rand()
        if r < 0.15:
            kwargs["node_selector"] = {lbl.ARCH: "arm64"}
        elif r < 0.25:
            kwargs["node_selector"] = {lbl.TOPOLOGY_ZONE: str(rng.choice(["zone-a", "zone-b"]))}
        pods += pkg["make_pods"](per, f"shape{i}", {"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}, **kwargs)
    return pods


def to_device(arrays, ffd, device):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()
         if k not in ("group_window", "type_window")}
    t["group_window"] = torch.from_numpy(ffd.pack_window_bits(arrays["group_window"])).to(device)
    t["type_window"] = torch.from_numpy(ffd.pack_window_bits(arrays["type_window"])).to(device)
    return t


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


def kernel_bytes_and_ops(t, N, res) -> tuple[int, int]:
    """Bytes the solve must move (each input read once, each output written
    once) and the f32 operations this run's data needs: per group, the fit
    over the rows open at its start (sub, add, div, min per resource) and
    the per-type fit of the open phase."""
    G, R = t["requests"].shape
    T = t["capacity"].shape[0]
    state = N * (4 + 4 + 4) + 2 * N * R * 4 + 4
    inputs = (G * R * 4 + G * 4 + G * T + T * R * 4 + G * T * 4 + G * 4 + T * 4 + G * 4 + 4
              + state)
    outputs = state + G * N * 4 + G * 4
    placed = (res.placed > 0).cpu().numpy()
    last_row = np.where(placed.any(axis=0))[0]
    opened = np.zeros(G, dtype=np.int64)  # rows open at each group's start
    high = -1
    for g in range(G):
        opened[g] = high + 1
        rows = np.nonzero(placed[g])[0]
        if rows.size:
            high = max(high, int(rows.max()))
    assert last_row.size == 0 or high == int(last_row.max())
    ops = int(opened.sum()) * R * 4 + G * T * R * 3
    return inputs + outputs, ops


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


def repack_bytes_and_ops(t) -> tuple[int, int]:
    """Bytes the screen must move (each input read once, the ``ok`` mask
    written once) and the f32 operations this run's data needs: for every
    candidate's live slot (count > 0) of group g, per node the fit over the
    resources g requests (add, divide, min: 3 per such axis; the others are
    skipped), then the clamp, the cap, the self mask, the scan and the
    placement (6). The update touches only the rows that take pods (at most
    the slot's count) and is left out."""
    free, requests, gids, gcounts, cap, cand = t
    N = free.shape[0]
    nbytes = sum(x.numel() * x.element_size() for x in t) + cand.numel()  # ok: 1 byte each
    rows = cand.long()
    live = gcounts[rows] > 0
    axes = (requests > 0).sum(dim=1)  # [G] resources each group requests
    per_node = 3 * axes[gids[rows][live].long()] + 6
    return nbytes, int(per_node.sum()) * N


def config4_cluster(n_nodes=5000, pods_per_node=8):
    """The repo's config4 cluster (``benchmarks/solve_configs.py``
    ``_synth_cluster``): RandomState(1), c/m types of 4-16 vCPUs, spot, one
    claim and one ready node each, 1..8 pods of 250m/512Mi bound to it."""
    from karpenter_provider_aws_tpu_torch.catalog import CatalogProvider
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.nodeclaim import NodeClaim
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.state import Cluster, Node

    catalog = CatalogProvider()
    cluster = Cluster()
    rng = np.random.RandomState(1)
    types = [t for t in catalog.list() if t.category in ("c", "m") and 4 <= t.vcpus <= 16]
    for i in range(n_nodes):
        it = types[rng.randint(len(types))]
        zone = catalog.zones[rng.randint(len(catalog.zones))]
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
        fill = rng.randint(1, pods_per_node + 1)
        for p in make_pods(fill, f"p{i}", {"cpu": "250m", "memory": "512Mi"}):
            cluster.apply(p)
            cluster.bind_pod(p.uid, node.name)
    return cluster, catalog


def profile_solve(solve) -> dict:
    """Device time by kernel over one call, and the device's idle share of
    its wall time (the profiler's own cost is inside the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    return {"phase": "profile", "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if kernels else "not measured",
            "idle_share": 1.0 - busy_ms / wall_ms if kernels else "not measured",
            "kernels": kernels[:15]}


def screen_phases(dev, name: str, smi: str) -> dict:
    """Phases 7-9: the repack kernel against its plain version, the
    consolidation screen's main path on config4, and the kernel's timing.
    Returns the repack kernel's entry of the kernels line."""
    from karpenter_provider_aws_tpu_torch.ops import consolidate, repack_cases, repack_cuda

    # 7. repack parity: kernel vs plain version on the same CUDA tensors (the
    # config4 case from its own encode, so the main path below uploads anew)
    t_build = time.perf_counter()
    cluster4, catalog4 = config4_cluster()
    cluster_build_s = time.perf_counter() - t_build
    config4_arrays = consolidate.screen_arrays(consolidate.encode_cluster(cluster4, catalog4))
    cases = {**repack_cases.small_cases(seeds=8), **repack_cases.large_cases()}
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
                         "ok": int(got.sum()), "max_abs_err": err,
                         "tiles": -(-N_c // repack_cuda.TILE_NODES),
                         "global_scratch": repack_cuda.repack_smem_bytes(N_c, R_c)
                         > repack_cuda.SMEM_LIMIT_BYTES}
        rtensors[cname] = rt
    for cname, tiles in (("global_scratch_8192", 1), ("two_tiles_12000", 2)):
        c = rcases[cname]
        if not c["global_scratch"] or c["tiles"] != tiles or not 0 < c["ok"] < c["C"]:
            raise AssertionError(f"{cname}: expected the global scratch over {tiles} "
                                 f"tile(s) and split verdicts, got {c}")
    emit({"phase": "repack_parity", "parity": "exact", "max_abs_err": repack_err,
          "cases": rcases})

    # 8. consolidation: the screen's main path on config4, through the kernel
    t_enc = time.perf_counter()
    ct = consolidate.encode_cluster(cluster4, catalog4)
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

    # 9. repack timing at config4's shapes (the main path's own tensors) and
    # at N = 8,192 (the global scratch)
    main4 = ct.__dict__["_screen_device"][dev]
    main4 = [main4[k] for k in ("free", "requests", "group_ids", "group_counts", "cap",
                                "candidates")]
    rtiming = {}
    for cname, rt in (("config4", main4),
                      ("global_scratch_8192", rtensors["global_scratch_8192"])):
        nbytes, ops = repack_bytes_and_ops(rt)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        no_slots = rt[:3] + [torch.zeros_like(rt[3])] + rt[4:]  # every slot skipped
        rtiming[cname] = {
            "N": int(rt[0].shape[0]), "C": int(rt[5].shape[0]), "S": int(rt[2].shape[1]),
            "kernel_ms": time_cuda(lambda: repack_cuda.repack_check(*rt), runs=30),
            # the same launch with no live slot: the per-candidate private
            # copy of free and the grid-stride loop alone
            "copy_only_ms": time_cuda(lambda: repack_cuda.repack_check(*no_slots), runs=30),
            "plain_ms": time_cuda(lambda: consolidate.repack_check(*rt), runs=5, warmup=1),
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "global_scratch": repack_cuda.repack_smem_bytes(*rt[0].shape)
            > repack_cuda.SMEM_LIMIT_BYTES,
        }
    emit({"phase": "repack_timing", "shapes": rtiming, "launches_per_screen": repack_launches,
          "library_ms": None, "card": smi})

    r4 = rtiming["config4"]  # the repack kernel's line is at config4's shapes
    return {
        "name": "repack", "route": "cuda",
        "source": "karpenter_provider_aws_tpu_torch/csrc/repack.cu",
        "replaces": "karpenter_provider_aws_tpu/ops/repack_pallas.py:49",
        "tpu_kernel": "ops/repack_pallas.py::_kernel",
        "launches": repack_launches, "parity": "exact", "max_abs_err": repack_err,
        "nodes": r4["N"], "ms": r4["kernel_ms"], "plain_ms": r4["plain_ms"],
        "bound_ms": r4["bound_ms"], "bound_by": r4["bound_by"],
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from karpenter_provider_aws_tpu_torch.catalog import CatalogProvider
    from karpenter_provider_aws_tpu_torch.models import NodePool, Operator, Requirement
    from karpenter_provider_aws_tpu_torch.models import labels as lbl
    from karpenter_provider_aws_tpu_torch.models.pod import make_pods
    from karpenter_provider_aws_tpu_torch.ops import _build, ffd, ffd_cuda
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
          "ptxas": ptxas})

    # 3. parity: kernel vs plain version on the same CUDA tensors
    max_err = 0.0
    cases = []
    for seed in range(8):
        cases.append((f"random{seed}", random_problem(np.random.RandomState(seed), 12, 40, 4, 3, 3),
                      256, None, 0))
    rows = random_problem(np.random.RandomState(7), 8, 10, 4, 2, 3)
    rows["counts"] = (rows["counts"] * 50).astype(np.int32)
    cases.append(("row_exhaustion", rows, 16, None, 0))
    rng = np.random.RandomState(11)
    pre = random_problem(rng, 6, 20, 4, 3, 3)
    pre["max_per_node"][:] = 1 << 30
    N_pre, n_pre = 128, 5
    init = [np.zeros(N_pre, np.int32), np.zeros(N_pre, np.float32), np.zeros((N_pre, 4), np.float32),
            np.zeros((N_pre, 4), np.float32), np.zeros(N_pre, np.int32)]
    tw_bits = ffd.pack_window_bits(pre["type_window"])
    for i in range(n_pre):
        ty = rng.randint(20)
        init[0][i] = ty
        init[3][i] = pre["capacity"][ty]
        init[2][i] = pre["capacity"][ty] * rng.uniform(0.2, 0.6)
        init[4][i] = tw_bits[ty]
    cases.append(("pre_opened", pre, N_pre, init, n_pre))
    pkg = {"lbl": lbl, "make_pods": make_pods}
    pool = NodePool(name="default",
                    requirements=[Requirement(lbl.INSTANCE_CATEGORY, Operator.IN, ("c", "m", "r"))])
    catalog = CatalogProvider()
    pods = headline_pods(pkg)
    t_enc = time.perf_counter()
    problem = pad_problem(encode_problem(pods, catalog, nodepool=pool))
    encode_cold_ms = (time.perf_counter() - t_enc) * 1e3
    head_arrays = {k: getattr(problem, k) for k in (
        "requests", "counts", "compat", "capacity", "price", "group_window", "type_window",
        "max_per_node")}
    head_arrays["max_per_node"] = np.minimum(head_arrays["max_per_node"], 1 << 30).astype(np.int32)
    N_head = 8192
    cases.append(("headline", head_arrays, N_head, None, 0))
    parity = {}
    for cname, arrays, N, init_np, npre in cases:
        t = to_device(arrays, ffd, dev)
        init_state = None
        if init_np is not None:
            init_state = ffd._State(
                *(torch.from_numpy(a).to(dev) for a in init_np),
                n_open=torch.tensor(npre, dtype=torch.int32, device=dev))
        got = call(ffd_cuda.ffd_solve, t, N, init_state, npre)
        torch.cuda.synchronize()
        want = call(ffd.ffd_solve, t, N, init_state, npre)
        err = compare(cname, got, want)
        max_err = max(max_err, err)
        parity[cname] = {"n_open": int(got.n_open), "placed": int(got.placed.sum()),
                         "unplaced": int(got.unplaced.sum()), "max_abs_err": err}
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
    cpu = TorchSolver(device="cpu").solve(pods, [pool], catalog)

    def plan(r):
        return [(s.instance_type_options[0], [p.name for p in s.pods]) for s in r.node_specs]

    if plan(res) != plan(cpu) or [(p.name, n) for p, n in res.binds] != [
            (p.name, n) for p, n in cpu.binds]:
        raise AssertionError("the CUDA plan differs from the CPU plan")
    if abs(res.total_cost - cpu.total_cost) > 1e-6 * max(1.0, cpu.total_cost):
        raise AssertionError(f"cost {res.total_cost} vs CPU {cpu.total_cost}")
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

    # 5. kernel timing at the headline shapes: the 8,192-row cap, and the
    # rows the main path gave the kernel (held to the plain version there too)
    t = to_device(head_arrays, ffd, dev)
    N_main = int(solver.timings["n_rows"])
    main_res = call(ffd_cuda.ffd_solve, t, N_main)
    torch.cuda.synchronize()
    if int(main_res.n_open) != solver.timings["n_open"]:
        raise AssertionError("the main path gave the kernel other inputs than the headline's")
    max_err = max(max_err, compare("headline_main_rows", main_res, call(ffd.ffd_solve, t, N_main)))
    timing = {}
    for N in (N_head, N_main):
        res_n = call(ffd_cuda.ffd_solve, t, N)
        nbytes, ops = kernel_bytes_and_ops(t, N, res_n)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        timing[N] = {
            "kernel_ms": time_cuda(lambda: call(ffd_cuda.ffd_solve, t, N), runs=30),
            "plain_ms": time_cuda(lambda: call(ffd.ffd_solve, t, N), runs=5, warmup=1),
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
    emit({"phase": "timing", "shapes": {"G": int(t["requests"].shape[0]),
                                        "T": int(t["capacity"].shape[0]),
                                        "R": int(t["requests"].shape[1])},
          "rows": {str(N): v for N, v in timing.items()}, "main_rows": N_main,
          "main_rows_parity": "exact", "launches_per_solve": launches, "card": smi})

    # 6. profile: device time of one warm solve, by kernel
    emit(profile_solve(lambda: solver.solve(pods, [pool], catalog)))

    repack_line = screen_phases(dev, name, smi)

    main = timing[N_main]  # the FFD kernel's line is at the main path's shapes
    emit({"kernels": [{
        "name": "ffd", "route": "cuda",
        "source": "karpenter_provider_aws_tpu_torch/csrc/ffd.cu",
        "replaces": "karpenter_provider_aws_tpu/ops/ffd_pallas.py:66",
        "tpu_kernel": "ops/ffd_pallas.py::_kernel",
        "launches": launches, "parity": "exact", "max_abs_err": max_err,
        "rows": N_main, "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
    }, repack_line]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
