"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card: the kernels
build and run only there. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: select_k exact; fused_l2_argmin distances rtol 1e-5, atol
1e-4; LUT scan keys rtol 1e-4, atol 1e-3 with ids equal away from key
ties; gather-refine keys rtol 1e-5 with ids equal away from key ties.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import kernels as K

from torch_parity import (SCAN_OPERANDS, assert_bins_match, cuda_device,
                          refine_case, scan_case, scan_reference_keys,
                          tied_scores)

pytestmark = pytest.mark.cuda


def test_cuda_select_k_matches_plain():
    dev = cuda_device()
    s = torch.tensor(tied_scores(64, 9000, seed=5)).to(dev)
    for k in (1, 33, 64):
        for select_min in (True, False):
            v, i = K.select_k_cuda(s, k, select_min)
            pv, pi = K.select_k_plain(s, k, select_min)
            assert torch.equal(v, pv) and torch.equal(i, pi)


def test_cuda_fused_l2_argmin_matches_plain():
    dev = cuda_device()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((5000, 96)).astype(np.float32))
    y = torch.tensor(rng.standard_normal((700, 96)).astype(np.float32))
    y[9] = y[4]
    x[:3] = y[4]
    d, i = K.fused_l2_argmin(x.to(dev), y.to(dev))
    pd, pi = K.fused_l2_argmin_plain(x, y)
    torch.testing.assert_close(d.cpu(), pd, rtol=1e-5, atol=1e-4)
    assert (i.cpu()[:3] == 4).all()
    d2 = torch.cdist(x.double(), y.double()) ** 2
    best2 = d2.topk(2, largest=False).values
    close = best2[:, 1] - best2[:, 0] <= 1e-5 * best2[:, 1]
    assert bool(((i.cpu() == pi) | close).all())


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 8])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
def test_cuda_lut_scan_matches_plain(pq_bits, lut_dtype):
    dev = cuda_device()
    c = scan_case(pq_bits)
    args = [torch.tensor(c[n]).to(dev) for n in SCAN_OPERANDS]
    cb_used = K.lut_codebook(args[-1], lut_dtype)
    live = torch.tensor(c["seg_q"] >= 0)
    for metric in ("l2", "ip"):
        tk, ti = K.ivfpq_lut_scan_topk(*args, metric, pq_bits=pq_bits,
                                       pq_dim=c["S"], L=c["L"],
                                       lut_dtype=lut_dtype)
        pk, pi = K.ivfpq_lut_scan_topk_plain(*args[:7], cb_used, metric,
                                             pq_bits)
        tk, ti = tk.cpu(), ti.cpu()
        assert bool(torch.isinf(tk[~live]).all() and (ti[~live] == -1).all())
        ref = scan_reference_keys(c, cb_used.cpu().numpy(), metric)
        assert_bins_match(tk.numpy(), ti.numpy(), pk.cpu().numpy(),
                          pi.cpu().numpy(), ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("k", [10, 64])
def test_cuda_gather_refine_matches_plain(metric, k):
    dev = cuda_device()
    data, q, cand = (torch.tensor(a).to(dev)
                     for a in refine_case(seed=1, C=400))
    v, i = K.gather_refine_topk(data, q, cand, k, metric)
    pv, pi = K.gather_refine_topk_plain(data, q, cand, k, metric)
    torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
    tol = 1e-5 * (1.0 + pv.abs())
    gap = (pv[:, 1:] - pv[:, :-1]).abs() <= tol[:, 1:]
    tie = torch.zeros_like(pv, dtype=torch.bool)
    tie[:, 1:] |= gap
    tie[:, :-1] |= gap
    tie[:, -1] = True
    assert bool(((i == pi) | tie).all())
    assert bool((i[0, 4:] == -1).all())


def test_cuda_launch_counts_move():
    dev = cuda_device()
    K.reset_launch_counts()
    s = torch.tensor(tied_scores(4, 9000, seed=1)).to(dev)
    K.select_k_cuda(s, 8)
    K.fused_l2_argmin(s[:, :64].contiguous(), s[:2, :64].contiguous())
    counts = K.launch_counts()
    assert counts["select_k"] == 1 and counts["fused_l2_argmin"] == 1
