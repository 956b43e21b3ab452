"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to run on the CPU unless asked, and its wrappers
launch a kernel or raise — they never fall back."""

from __future__ import annotations

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu_torch.ops import build as kbuild
from raft_tpu_torch.ops import kernels as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "raft_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        raft_tpu_torch.__path__, "raft_tpu_torch."))


def test_port_imports_neither_jax_nor_raft_tpu():
    mods = _modules()
    assert "raft_tpu_torch.neighbors.ivf_pq" in mods and len(mods) >= 20
    assert {"raft_tpu_torch.parallel.mesh", "raft_tpu_torch.parallel.comms",
            "raft_tpu_torch.parallel.merge", "raft_tpu_torch.parallel.knn",
            "raft_tpu_torch.parallel.ivf", "raft_tpu_torch.parallel.build",
            "raft_tpu_torch.cluster.distributed",
            "raft_tpu_torch.obs.spans"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flax', 'raft_tpu.')) or m == 'raft_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax_module():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|raft_tpu)(\.|\s|$)")
    hits = []
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    hits += [f"{path}:{i}" for i, line in enumerate(f, 1)
                             if pat.match(line)]
    assert hits == []


def test_entry_points_refuse_cpu_by_default(monkeypatch):
    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, refine
    from raft_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros((64, 8))
    cand = torch.zeros((4, 8), dtype=torch.int32)
    calls = [
        lambda: ivf_pq.build(x, ivf_pq.IndexParams(n_lists=2)),
        lambda: ivf_flat.build(x, ivf_flat.IndexParams(n_lists=2)),
        lambda: refine.refine(x, x[:4], cand, 2),
        lambda: brute_force.knn(x, x[:4], 2),
        lambda: DeviceSynthetic(10, 4, n_centers=2),
        lambda: make_mesh(4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    index = ivf_pq.build(torch.randn(600, 8), ivf_pq.IndexParams(
        n_lists=4, pq_dim=4, cache_reconstruction="never"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ivf_pq.search(index, x[:4], 2)
    flat = ivf_flat.build(torch.randn(600, 8), ivf_flat.IndexParams(
        n_lists=4, kmeans_n_iters=2), device="cpu")
    for arrays in (ivf_flat.to_numpy(flat),):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ivf_flat.from_numpy(*arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ivf_flat.search(flat, x[:4], 2)


def test_wrappers_take_no_other_device():
    x = torch.zeros((8, 4), device="meta")
    with pytest.raises(Exception, match="unsupported device"):
        K.fused_l2_argmin(x, x)
    with pytest.raises(Exception, match="several devices"):
        K.gather_refine_topk(torch.zeros((8, 4)), x,
                             torch.zeros((8, 300), dtype=torch.int32,
                                         device="meta"), 2)


def test_wrappers_check_their_operands():
    s = torch.zeros((4, 100))
    with pytest.raises(Exception, match="float32"):
        K.select_k_cuda(s.double(), 3)
    with pytest.raises(Exception, match="contiguous"):
        K.select_k_cuda(s.T, 3)
    with pytest.raises(Exception, match="outside"):
        K.select_k_cuda(s, 65)
    with pytest.raises(Exception, match="outside"):
        K.gather_refine_topk(torch.zeros((9, 4)), torch.zeros((2, 4)),
                             torch.zeros((2, 300), dtype=torch.int32), 65)


def test_cpu_runs_count_no_launch():
    K.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((50, 8)).astype(np.float32))
    K.fused_l2_argmin(x, x[:5])
    K.select_k_cuda(x, 4)
    seg_list = torch.zeros(1, dtype=torch.int32)
    seg_q = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    ids = torch.arange(20, dtype=torch.int32).view(2, 10)
    K.segmented_scan_topk(seg_list, seg_q, x[:2], x[:20].view(2, 10, 8), ids)
    K.grouped_scan_topk(seg_list, seg_q, x[:2], x[:20].view(2, 10, 8), ids, 4)
    tables = [x[:9, :4].contiguous() for _ in range(2)]
    K.ring_topk_merge(tables, [ids[0, :4].repeat(9, 1).contiguous()] * 2, 3)
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


def test_precision_policy_turns_tf32_off():
    from raft_tpu_torch.utils import precision

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    precision.enforce()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_sources_carry_their_notes():
    """Every kernel source names the TPU kernel it replaces and its bound
    on the card, and the build targets sm_90a."""
    for name in kbuild.SOURCES:
        with open(os.path.join(kbuild.CSRC, f"{name}.cu")) as f:
            src = f.read()
        assert "raft_tpu/ops/pallas_kernels.py" in src, name
        assert "Bound on the H100" in src, name
        assert 'extern "C"' in src, name
    assert "arch=compute_90a,code=sm_90a" in kbuild.ARCH_FLAGS


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(kbuild.shutil, "which", lambda _: None)
    monkeypatch.setattr(kbuild.os.path, "exists", lambda _: False)
    with pytest.raises(kbuild.KernelBuildError, match="nvcc"):
        kbuild._find_nvcc()


def test_register_report_reads_ptxas(monkeypatch):
    """The smoke's register lines: each kernel entry's name (template
    arguments still mangled), registers and spill bytes from ptxas -v."""
    log = (
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__a1f5fcff_15"
        "_grouped_scan_cu_4eb6c0c519grouped_scan_kernelIfLb1EEEvPKiS2_PKfPKT_"
        "S2_PfPiiiiiiiii' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 44 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 4528 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z15select_k_kernelPf' for "
        "'sm_90a'\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n")
    monkeypatch.setattr(kbuild.LIBRARIES, "build_logs", {"x": log})
    assert kbuild.register_report() == {"x": [
        ("grouped_scan_kernelIfLb1EE", 128, 4, 44),
        ("select_k_kernel", 40, 0, 0)]}
    # a hash whose digits make another length that also ends on "_kernel"
    name = ("_ZN49_GLOBAL__N__8cdbf2dd_16_gather_refine_cu_39c925a020gather_"
            "refine_kernelILi1EEEvPKfliS2_PKiiiiPfPi")
    for h in ("8cdbf2dd", "cdbf2d51"):
        assert kbuild._kernel_name(name.replace("8cdbf2dd", h)) == \
            "gather_refine_kernelILi1EE"


def test_build_dir_is_ignored_by_git():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        lines = f.read().split()
    assert "raft_tpu_torch/_build/" in lines
    assert os.path.relpath(kbuild.BUILD_DIR, ROOT) == os.path.join(
        "raft_tpu_torch", "_build")


def test_ring_wrappers_refuse_mixed_devices():
    """A ring's ranks must all lie on CUDA devices or all on the CPU; a
    rank whose operands straddle devices raises."""
    t = torch.zeros((8, 4))
    i = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(Exception, match="several devices"):
        K.ring_topk_merge([t, t], [i, i.to("meta")], 2)
    with pytest.raises(Exception, match="all on the CPU"):
        K.ring_topk_merge([t, t.to("meta")], [i, i.to("meta")], 2)
    with pytest.raises(ValueError, match="k=65"):
        K.ring_topk_merge([torch.zeros((8, 70))] * 2,
                          [torch.zeros((8, 70), dtype=torch.int32)] * 2, 65)


def test_unported_sharded_paths_name_their_roadmap_item():
    from raft_tpu_torch.parallel import build as pbuild
    from raft_tpu_torch.parallel import comms, ivf, make_mesh, merge, mesh

    m = make_mesh(2, device="cpu")
    for call in (lambda: mesh.hier_mesh(2, 2), lambda: mesh.submesh(m, 1),
                 lambda: ivf.build_ivf_flat(None, None, m),
                 lambda: ivf.search_ivf_flat(None, None, None, 1, m),
                 lambda: pbuild.build_ivf_pq_distributed(),
                 lambda: merge.merge_tier(2, 8, 4, explicit="hier"),
                 lambda: merge.resolve_exchange(m, ("dcn", "ici")),
                 lambda: comms.Comms(m).alltoall([])):
        with pytest.raises(NotImplementedError, match="A15"):
            call()


def test_ring_kernel_tiers_decline_meshes_on_several_cards(monkeypatch):
    """The ring kernels serve ranks on one card only (ROADMAP A15). With a
    card present, a mesh over several cards takes the plain ring schedule
    (merge="ring") or the allgather (auto) instead of the ring kernel, and
    never the fused scan-in-ring tier; a one-card mesh keeps both."""
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.parallel import Mesh, make_mesh, merge
    from raft_tpu_torch.parallel import ivf as pivf

    one = Mesh(devices=(torch.device("cuda", 0),) * 4)
    several = Mesh(devices=tuple(torch.device("cuda", r % 2)
                                 for r in range(4)))
    assert (one.n_cards, several.n_cards) == (1, 2)
    assert make_mesh(4, device="cpu").n_cards == 0
    monkeypatch.setattr(K, "_on_cuda", lambda: True)
    assert merge.merge_tier(4, 500, 10, n_cards=1) == ("ring", "ring_kernel")
    assert merge.merge_tier(4, 500, 10, explicit="ring", n_cards=2) == (
        "ring", "ring_ppermute")
    assert merge.merge_tier(4, 500, 10, n_cards=2) == ("allgather",
                                                       "allgather")
    x = np.random.default_rng(0).standard_normal((2000, 16)).astype(
        np.float32)
    cpu = make_mesh(2, device="cpu")
    index = pivf.build_ivf_pq(ivf_pq.IndexParams(n_lists=8, pq_dim=8,
                                                 kmeans_n_iters=2), x, cpu)
    wanted = [pivf._ring_fused_wanted(
        index, 32, 10, 8, 2, True, "auto", DistanceType.L2Expanded,
        "float32", "pallas", n_cards=c) for c in (1, 2)]
    assert wanted == [(True, ""), (False, "kernel_ineligible")]
