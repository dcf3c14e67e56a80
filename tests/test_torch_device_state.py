"""The torch package's device-resident screen mirror, on the CPU, against
the JAX package's resident buffers.

- upload, hit and patch outcomes; a membership change re-uploads; a patch
  chain across screens the caller skipped is walked;
- twin config4 clusters under three seeds of churn: after every step the
  port's mirror buffers equal the JAX package's resident buffers
  (``jax.device_get``) byte for byte, ``verify_mirror`` is empty, and the
  screen mask read through the mirror equals the reference's
  ``consolidatable`` (pinned to its XLA screen) by node name;
- a patch at the last live row and into the bucket's headroom writes
  exactly its rows; a row past the buffer raises;
- an error in the upload or the patch raises to the screen's caller.
Exact everywhere: the mirror must hold the same bytes as a fresh upload.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_consolidate import _add_node, config4
from test_torch_encode_delta import JAXPKG, TORCHPKG, mutate

from karpenter_provider_aws_tpu_torch.ops import consolidate as tcons
from karpenter_provider_aws_tpu_torch.ops import device_state as tds

jax = pytest.importorskip("jax")

from karpenter_provider_aws_tpu.ops import consolidate as jcons  # noqa: E402
from karpenter_provider_aws_tpu.ops import device_state as jds  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_mirrors(monkeypatch):
    for reset in (tds.reset_device_state, tds.reset_counts, tcons.reset_screen_buckets,
                  jds.reset_device_state, jds.reset_chained_costs, jcons.reset_screen_buckets):
        reset()
    # the reference: its mirror on every screen, its XLA screen
    monkeypatch.setenv("KARPENTER_TPU_CHAINED_SCREEN", "1")
    monkeypatch.setenv("KARPENTER_TPU_REPACK", "vmap")
    yield
    tds.reset_device_state()
    jds.reset_device_state()


def _by_name(ct, mask):
    return dict(zip(ct.node_names, mask.tolist()))


def _fresh_cpu_mask(cluster, catalog):
    """The CPU screen of a fresh full encode (no encoder chain: no mirror)."""
    fresh = tcons._encode_cluster(cluster, catalog, tcons.GMAX_DEFAULT)
    return _by_name(fresh, tcons.consolidatable(fresh, device="cpu"))


def _bind_one(pkg, cluster, node_name, tag):
    p = pkg.make_pods(1, tag, {"cpu": "250m", "memory": "512Mi"})[0]
    cluster.apply(p)
    cluster.bind_pod(p.uid, node_name)


def test_upload_hit_patch_sequence():
    cl, cat = config4(TORCHPKG, 60)
    ct = tcons.encode_cluster(cl, cat)
    m1 = tcons.consolidatable(ct, device="cpu")
    assert tcons.LAST_SCREEN["residency"] == "upload"
    assert tds.COUNTS["upload"] == 1 and tds.COUNTS["upload_bytes"] > 0
    # unchanged pass: the same emission object, the mask memo, a mirror hit
    ct2 = tcons.encode_cluster(cl, cat)
    assert ct2 is ct
    np.testing.assert_array_equal(tcons.consolidatable(ct2, device="cpu"), m1)
    assert tds.COUNTS["hit"] == 1
    bufs, residency = tds.acquire_screen_tensors(ct2, CPU)
    assert residency == "resident" and tds.COUNTS["hit"] == 2
    # one bind -> a journal patch -> a row patch of the mirror
    _bind_one(TORCHPKG, cl, ct.node_names[3], "ds")
    ct3 = tcons.encode_cluster(cl, cat)
    m3 = tcons.consolidatable(ct3, device="cpu")
    assert tcons.LAST_SCREEN["residency"] == "resident"
    assert (tds.COUNTS["patch"], tds.COUNTS["patch_rows"], tds.COUNTS["upload"]) == (1, 1, 1)
    assert 0 < tds.COUNTS["patch_bytes"] < tds.COUNTS["upload_bytes"]
    assert tds.verify_mirror(tds.mirror_for(ct3, CPU), ct3) == []
    assert _by_name(ct3, m3) == _fresh_cpu_mask(cl, cat)


def test_membership_change_forces_upload():
    cl, cat = config4(TORCHPKG, 60)
    tcons.consolidatable(tcons.encode_cluster(cl, cat), device="cpu")
    _add_node(TORCHPKG, cl, cat, 60, cat.get("m5.large"), "zone-a")
    ct = tcons.encode_cluster(cl, cat)
    assert len(ct.node_names) == 61
    mask = tcons.consolidatable(ct, device="cpu")
    assert tds.COUNTS["upload"] == 2 and tds.COUNTS["patch"] == 0
    assert tds.verify_mirror(tds.mirror_for(ct, CPU), ct) == []
    assert _by_name(ct, mask) == _fresh_cpu_mask(cl, cat)


def test_chain_walk_patches_across_skipped_screens():
    """Two journal deltas land between screens: the mirror walks the
    ``_patch_base`` chain and writes the merged rows once."""
    cl, cat = config4(TORCHPKG, 60)
    ct = tcons.encode_cluster(cl, cat)
    tcons.consolidatable(ct, device="cpu")
    for k in (1, 2):
        _bind_one(TORCHPKG, cl, ct.node_names[k], f"cw{k}")
        ct2 = tcons.encode_cluster(cl, cat)  # no screen between
    tcons.consolidatable(ct2, device="cpu")
    assert (tds.COUNTS["patch"], tds.COUNTS["patch_rows"]) == (1, 2)
    assert tds.verify_mirror(tds.mirror_for(ct2, CPU), ct2) == []


def _buffers_equal(tbufs, jbufs, tag):
    names = ("free", "requests", "group_ids", "group_counts", "cap")
    got = [t.numpy() for t in tbufs[:5]]
    want = jax.device_get(tuple(jbufs[:5]))
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{tag}: {name}"
        assert a.tobytes() == b.tobytes(), f"{tag}: {name}"
    assert tbufs[6] == jbufs[5], f"{tag}: n_live"


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_mirror_equals_reference_buffers_under_churn(seed):
    tw = {}
    for pkg in (JAXPKG, TORCHPKG):
        cl, cat = config4(pkg, 60)
        tw[pkg.root] = (cl, cat, {"names": [n.name for n in cl.snapshot_nodes()],
                                  "next_node": 60, "pods": 0})
    (jcl, jcat, _), (tcl, tcat, _) = tw[JAXPKG.root], tw[TORCHPKG.root]
    outcomes = []
    for step in range(10):
        if step:
            for pkg in (JAXPKG, TORCHPKG):
                cl, cat, state = tw[pkg.root]
                mutate(pkg, cl, cat, state, np.random.RandomState(1000 * seed + step),
                       tag=f"dm{seed}_{step}", label_tag=f"dm{seed}")
        tct, jct = tcons.encode_cluster(tcl, tcat), jcons.encode_cluster(jcl, jcat)
        jbufs, jres = jds.acquire_screen_tensors(jct)
        tbufs, tres = tds.acquire_screen_tensors(tct, CPU)
        assert tres == jres != "fallback", step
        _buffers_equal(tbufs, jbufs, f"seed{seed} step{step}")
        assert tds.verify_mirror(tds.mirror_for(tct, CPU), tct) == []
        got = _by_name(tct, tcons.consolidatable(tct, device="cpu"))
        assert got == _by_name(jct, jcons.consolidatable(jct)), step
        assert got == _fresh_cpu_mask(tcl, tcat), step
        outcomes.append(tres)
    assert "upload" in outcomes and "resident" in outcomes


def _padded(ct, NB):
    """``ct`` with its node axis grown to ``NB`` rows of distinct values."""
    N = len(ct.node_names)
    rng = np.random.RandomState(0)
    pad = lambda a, axis, fill: np.concatenate(  # noqa: E731
        [a, np.broadcast_to(fill, a.shape[:axis] + (NB - N,) + a.shape[axis + 1:])], axis=axis)
    free_rows = (rng.rand(NB - N, ct.free.shape[1]) * 100).astype(np.float32)
    return dataclasses.replace(
        ct,
        node_names=list(ct.node_names) + [f"pad{i}" for i in range(NB - N)],
        free=np.concatenate([ct.free, free_rows]),
        group_ids=pad(ct.group_ids, 0, np.int32(0)),
        group_counts=pad(ct.group_counts, 0, np.int32(7)),
        cap=pad(ct.cap, 1, np.float32(3.0)),
    )


def test_patch_at_last_row_and_into_headroom():
    cl, cat = config4(TORCHPKG, 40)
    ct = tcons.encode_cluster(cl, cat)
    tcons.consolidatable(ct, device="cpu")
    h = tds.mirror_for(ct, CPU)
    N = len(ct.node_names)
    assert (N, h.NB) == (40, 48)  # 8 rows of headroom on the ladder
    # the last live row, through the encoder
    _bind_one(TORCHPKG, cl, ct.node_names[N - 1], "last")
    ct2 = tcons.encode_cluster(cl, cat)
    assert ct2.__dict__["_patch_positions"].tolist() == [N - 1]
    tcons.consolidatable(ct2, device="cpu")
    assert tds.COUNTS["patch"] == 1
    assert tds.verify_mirror(h, ct2) == []
    # into the headroom (N < row < NB): exactly that row moves
    big = _padded(ct2, h.NB)
    before = [t.clone() for t in (h.free, h.gids, h.gcounts, h.cap)]
    row = N + 3
    tds._apply_patch(h, big, np.array([row], dtype=np.int32))
    assert torch.equal(h.free[row], torch.from_numpy(big.free[row]))
    assert h.gcounts[row, 0] == 7 and (h.cap[: h.G, row] == 3.0).all()
    for t, b in zip((h.free, h.gids, h.gcounts), before[:3]):
        keep = torch.arange(h.NB) != row
        assert torch.equal(t[keep], b[keep])
    assert torch.equal(h.cap[:, torch.arange(h.NB) != row], before[3][:, torch.arange(h.NB) != row])
    # a row past the buffer raises: there is no dropped out-of-range sentinel
    with pytest.raises((IndexError, RuntimeError)):
        tds._apply_patch(h, _padded(ct2, h.NB + 1), np.array([h.NB], dtype=np.int32))


@pytest.mark.parametrize("stage", ["_apply_patch", "_upload"])
def test_an_error_in_the_mirror_raises(stage, monkeypatch):
    cl, cat = config4(TORCHPKG, 40)
    ct = tcons.encode_cluster(cl, cat)
    if stage == "_apply_patch":
        tcons.consolidatable(ct, device="cpu")
        _bind_one(TORCHPKG, cl, ct.node_names[5], "err")
        ct = tcons.encode_cluster(cl, cat)

    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(tds, stage, boom)
    with pytest.raises(RuntimeError, match="boom"):
        tcons.consolidatable(ct, device="cpu")
    assert tds.COUNTS["fallback"] == 0
    assert "_screen_mask_memo" not in ct.__dict__


def test_verify_mirror_reports_a_divergence():
    """``verify_mirror`` names each buffer that no longer equals a fresh
    upload, the inert padding included."""
    cl, cat = config4(TORCHPKG, 40)
    ct = tcons.encode_cluster(cl, cat)
    tcons.consolidatable(ct, device="cpu")
    h = tds.mirror_for(ct, CPU)
    h.free[0, 0] += 1.0  # a row no patch rewrites
    _bind_one(TORCHPKG, cl, ct.node_names[5], "vk")
    ct2 = tcons.encode_cluster(cl, cat)
    tcons.consolidatable(ct2, device="cpu")
    assert tds.verify_mirror(h, ct2) == ["free"]
    h.free[0, 0] -= 1.0
    h.cap[0, h.NB - 1] = 1.0  # a headroom column
    assert tds.verify_mirror(h, ct2) == ["padding"]


def test_kill_switch_and_full_encode_take_the_per_ct_upload(monkeypatch):
    cl, cat = config4(TORCHPKG, 40)
    ct = tcons.encode_cluster(cl, cat)
    on = tcons.consolidatable(ct, device="cpu")
    monkeypatch.setenv("KARPENTER_TPU_DEVICE_STATE", "0")
    ct.__dict__.pop("_screen_mask_memo")
    off = tcons.consolidatable(ct, device="cpu")
    assert tcons.LAST_SCREEN["residency"] == "fallback" and tds.COUNTS["fallback"] == 1
    np.testing.assert_array_equal(on, off)
    monkeypatch.delenv("KARPENTER_TPU_DEVICE_STATE")
    full = tcons.encode_cluster(cl, cat, incremental=False)
    np.testing.assert_array_equal(tcons.consolidatable(full, device="cpu"), on)
    assert tcons.LAST_SCREEN["residency"] == "fallback" and tds.COUNTS["fallback"] == 2
    assert tds.mirror_for(full) is None and not tds.drop_mirror(full)
    assert tds.drop_mirror(ct) and tds.mirror_for(ct) is None


@pytest.mark.parametrize("name", ["config4", "mixed"])
def test_mirror_padded_case_screens_like_the_unpadded_inputs(name):
    """``repack_cases.mirror_cases``: the inputs padded as the mirror pads
    them give the unpadded inputs' verdicts, and the padding is what the
    upload writes."""
    from test_torch_consolidate import mixed

    from karpenter_provider_aws_tpu_torch.ops import repack_cases

    cl, cat = config4(TORCHPKG, 40) if name == "config4" else mixed(TORCHPKG)
    ct = tcons.encode_cluster(cl, cat)
    case = repack_cases.mirror_cases(ct)["mirror_padded"]
    free, requests, gids, gcounts, cap, cand = case
    N, G = len(ct.node_names), ct.requests.shape[0]
    assert free.shape[0] > N and requests.shape[0] >= 8 and gids.shape[1] == 8
    assert cap.dtype == np.float32 and not cap[:, N:].any() and not requests[G:].any()
    plain = tcons.repack_check(*(torch.from_numpy(a) for a in case)).numpy()
    unpadded = tcons.screen_arrays(ct)
    want = tcons.repack_check(*(torch.from_numpy(unpadded[k]) for k in (
        "free", "requests", "group_ids", "group_counts", "cap", "candidates"))).numpy()
    np.testing.assert_array_equal(plain, want)
    assert 0 < plain.sum()
    bufs, _ = tds.acquire_screen_tensors(ct, CPU)
    for a, t in zip(case, bufs[:5]):
        assert a.tobytes() == t.numpy().tobytes()
