"""Grouped fp32 products over the experts a MoE layer holds, segments
known only on the device (``csrc/moe_grouped.cu``).

The dropless route of ``models/moe.py`` sorts its routing slots by expert:
expert e of the held experts owns rows ``[seg[e], seg[e + 1])`` of the
sorted slots, and ``seg`` is a device tensor. Two products cover the
experts' forward and backward:

- :func:`rows_gemm`: ``out[r] (+)= a[rows[r]] @ b[e]`` for every row r of
  expert e (``rows`` None: ``a[r]``), ``b`` (E, K, N) or, with
  ``transpose_b``, ``b[e]^T`` of a (E, N, K) tensor; rows past ``seg[E]``
  are left as they were (the caller never reads them);
- :func:`wgrad_gemm`: ``out[e] = a[rows of e]^T @ b[rows of e]``, (E, K,
  N), zeros for an expert with no row.

On the card each is one launch, whatever the counts: the grid covers the
most rows a layer can route and its tiles past ``seg[E]`` return at once,
so the host never reads the counts. On the CPU the plain versions below
loop over the experts with the counts read on the host. No backward of
their own: ``models/moe.py``'s grouped SwiGLU calls them inside its
autograd function. ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

BM = 64        # the kernels' row tile (csrc/moe_grouped.cu)
launches = {"moe_rows_gemm": 0, "moe_wgrad_gemm": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: takes float32 operands, got {t.dtype}")


def rows_gemm(a: torch.Tensor, rows, b: torch.Tensor, seg: torch.Tensor, out: torch.Tensor,
              *, transpose_b: bool = False, accumulate: bool = False) -> torch.Tensor:
    """``out[r] (+)= a[rows[r]] @ B_e`` for the rows r of each expert e,
    B_e = ``b[e]`` or ``b[e].T`` (``transpose_b``); writes into ``out``
    (R, N) and returns it. ``seg`` (E + 1,) int64 holds the experts' row
    offsets, ``rows`` (R,) int64 or None."""
    _check("rows_gemm", a, b, out)
    if rows is not None:
        rows = rows.contiguous()
    a, seg = a.contiguous(), seg.contiguous()
    n_exp = b.shape[0]
    k_dim = b.shape[2] if transpose_b else b.shape[1]
    n_dim = b.shape[1] if transpose_b else b.shape[2]
    tensors = [a, b, seg, out] + ([] if rows is None else [rows])
    if not build.route("rows_gemm", *tensors):
        bounds = seg.tolist()
        for e in range(n_exp):
            lo, hi = bounds[e], bounds[e + 1]
            src = a[lo:hi] if rows is None else a[rows[lo:hi]]
            prod = src @ (b[e].T if transpose_b else b[e])
            out[lo:hi] = out[lo:hi] + prod if accumulate else prod
        return out
    if not out.is_contiguous() or a.shape[1] != k_dim or out.shape[1] != n_dim:
        raise ValueError(f"rows_gemm: a {tuple(a.shape)}, b {tuple(b.shape)} "
                         f"(transposed {transpose_b}), out {tuple(out.shape)}")
    sbe, s1, s2 = b.stride()
    sbk, sbn = (s2, s1) if transpose_b else (s1, s2)
    max_tiles = -(-out.shape[0] // BM) + n_exp
    lib = build.library("moe_grouped")
    dev = a.device
    err = lib.moe_rows_gemm(
        a.data_ptr(), None if rows is None else rows.data_ptr(), b.data_ptr(), seg.data_ptr(),
        out.data_ptr(), a.stride(0), sbe, sbk, sbn, out.stride(0), n_exp, k_dim, n_dim,
        int(accumulate), max_tiles, dev.index or 0, build.stream(dev))
    build.check("moe_grouped", "moe_rows_gemm", err)
    launches["moe_rows_gemm"] += 1
    return out


def wgrad_gemm(a: torch.Tensor, rows, b: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(E, K, N): ``a[rows of e]^T @ b[rows of e]`` for each expert e
    (``rows`` None: ``a``'s own rows), a (., K), b (R, N)."""
    _check("wgrad_gemm", a, b)
    if rows is not None:
        rows = rows.contiguous()
    a, b, seg = a.contiguous(), b.contiguous(), seg.contiguous()
    n_exp = seg.shape[0] - 1
    k_dim, n_dim = a.shape[1], b.shape[1]
    tensors = [a, b, seg] + ([] if rows is None else [rows])
    if not build.route("wgrad_gemm", *tensors):
        bounds = seg.tolist()
        outs = []
        for e in range(n_exp):
            lo, hi = bounds[e], bounds[e + 1]
            src = a[lo:hi] if rows is None else a[rows[lo:hi]]
            outs.append(src.T @ b[lo:hi])
        return torch.stack(outs)
    out = torch.empty((n_exp, k_dim, n_dim), dtype=torch.float32, device=a.device)
    lib = build.library("moe_grouped")
    dev = a.device
    err = lib.moe_wgrad_gemm(
        a.data_ptr(), None if rows is None else rows.data_ptr(), b.data_ptr(), seg.data_ptr(),
        out.data_ptr(), a.stride(0), b.stride(0), n_exp, k_dim, n_dim, dev.index or 0,
        build.stream(dev))
    build.check("moe_grouped", "moe_wgrad_gemm", err)
    launches["moe_wgrad_gemm"] += 1
    return out
