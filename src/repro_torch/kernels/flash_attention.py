"""Blockwise flash attention: the CUDA kernel and its plain torch version.

The port of ``repro.kernels.flash_attention``'s Pallas TPU kernel
(``flash_attention_pallas``). One function, in the JAX package's layouts:

  q   : (B, S, H, hd)     bf16 or fp32
  k, v: (B, T, KV, hd)    H a multiple of KV (GQA: query head h reads KV
                          head h // (H // KV); K/V are never expanded)
  out : (B, S, H, hd)     in q's dtype; with ``with_lse`` also
  lse : (B, S, H)         fp32 log-sum-exp of each row's scaled scores

with causal and/or sliding-window masking (a key k is visible to query q iff
``k <= q`` when causal and ``k > q - window`` when ``window > 0``), online
softmax in fp32 with the finite ``NEG_INF = -1e30`` and p-masking, so a
fully masked row writes 0 (and lse -1e30). Positions are global when the
Python ints ``q_offset`` and ``k_offset`` are given: query i sits at
``q_offset + i`` and key j at ``k_offset + j`` (a ring step's shards, as in
``flash_attention_xla(q_offset=, k_offset=)``); ``out_fp32`` writes ``out``
in fp32 (``acc / max(l, 1e-30)`` unrounded), the normalized partial a ring
merges before its one rounding.

``flash_attention_plain`` is the XLA twin's block schedule and math in
torch (``flash_attention_xla``: GQA by row folding, fully visible blocks
first without a mask, then the edge blocks with it), with s, m, l and the
accumulator in fp32; it also takes ragged S and T by masking the padded
keys. ``flash_attention`` is the wrapper: for CPU tensors it runs the
plain version at the default block; for CUDA tensors it launches one of two
kernels, chosen before the launch by ``_kernel_route`` (a pure function of
dtype, strides and data pointers), or raises:

  "wgmma": ``flash_fwd_wgmma_kernel`` (``csrc/flash_attention_wgmma.cu``),
           bf16 q, k, v that TMA can describe (16-byte aligned base pointers
           and byte strides): tensor cores fed by TMA, 128 query rows x
           64 keys per tile;
  "simt":  ``flash_fwd_kernel`` (``csrc/flash_attention.cu``), fp32, and
           bf16 that TMA cannot describe: fp32 FMAs, the g query heads of
           a KV head folded into 128 rows, 128-key tiles streamed through
           a 4-stage shared-memory ring; K/V come in by ``cp.async`` where
           ``_load_variant`` allows it (fp32 with 16-byte aligned pointers
           and strides), else through registers.

Both keep s, m, l and the accumulator in fp32; the wgmma kernel feeds p to
the tensor cores as two bf16 halves (``p_hi + p_lo``, 2^-16 relative), so
the two routes meet the same tolerances against the plain version.

``launches`` counts kernel launches only: ``"flash_attention"`` in total and
one counter per route. Neither kernel has a backward (nor has the Pallas
kernel): under grad the wrapper raises on every device
(``build.refuse_grad``), and training takes chunked attention. The ring
variant and ``merge_partials`` live in ``repro_torch.dist.ring``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.obs.profile import scope as _profile_scope

NEG_INF = -1e30  # finite, matching dense_attention (no inf - inf NaNs)
DEFAULT_BLOCK = 512
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_MAX_HEAD_DIM = 128
# the differentiable route a caller that needs gradients takes instead
FLASH_GRAD_ROUTE = ('attn_impl="chunked" (layers.chunked_attention, plain torch with '
                    'autograd) or dense attention')

# the wgmma kernel's tiles and its TMA boxes (csrc/flash_attention_wgmma.cu
# checks that the plans it is given match)
WGMMA_BLOCK_Q = 128
WGMMA_BLOCK_K = 64
TMA_BOX_COLS = 64          # bf16 columns of one box: a 128-byte swizzled row
TMA_ALIGN = 16             # bytes: base pointers and strides of a tensor map
TMA_MAX_STRIDE = 2**40     # bytes, exclusive

# kernel launches since the last reset_launches(); the CPU path never counts
launches = {"flash_attention": 0, "flash_attention_wgmma": 0, "flash_attention_simt": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------ block ranges

def kv_block_range(
    qi: int, *, block_q: int, block_k: int, nk: int,
    causal: bool, window: int, q_offset: int = 0, k_offset: int = 0,
) -> tuple[int, int]:
    """Half-open KV-block range ``[lo, hi)`` visible to q-block ``qi``.

    Static-offset form of the masking geometry shared by every
    implementation (and by ``layers.chunked_attention``'s skip path):
    a KV block is visited iff it contains ANY (q, k) pair with
    ``k <= q`` (causal) and ``k > q - window`` (window > 0). Also the
    unit under test for the masked-compute-count satellite.
    """
    q_first = q_offset + qi * block_q
    q_last = q_first + block_q - 1
    lo, hi = 0, nk
    if causal:
        # last visible k position is q_last
        hi = min(nk, (q_last - k_offset) // block_k + 1)
    if window:
        # first visible k position is q_first - window + 1
        lo = max(0, (q_first - window + 1 - k_offset) // block_k)
    return (lo, max(lo, hi))


def visited_block_counts(
    nq: int, *, block_q: int, block_k: int, nk: int,
    causal: bool, window: int,
) -> int:
    """Total KV blocks visited across all q blocks (test/bench helper)."""
    return sum(
        hi - lo
        for lo, hi in (
            kv_block_range(qi, block_q=block_q, block_k=block_k, nk=nk,
                           causal=causal, window=window)
            for qi in range(nq)
        )
    )


# ------------------------------------------------------------ plain version

def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            "flash_attention: q must be (B, S, H, hd) and k, v (B, T, KV, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"flash_attention: batch or head dim differ: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention: {q.shape[2]} query heads are not a multiple of "
            f"{k.shape[2]} KV heads")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")


# the kernels hold positions, offsets and the window's edge in int32
_POS_LIMIT = 2**31 - 4 * 128


def _check_offsets(q: torch.Tensor, k: torch.Tensor, window: int, q_offset, k_offset) -> None:
    """Offsets are Python ints (static, as the XLA twin's ring-free path
    takes them), and every position the kernels form fits int32."""
    for name, off in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not isinstance(off, int) or isinstance(off, bool):
            raise TypeError(f"flash_attention: {name} must be a Python int, got {type(off)}")
    if abs(q_offset - k_offset) + max(q.shape[1], k.shape[1]) + window >= _POS_LIMIT:
        raise ValueError(
            f"flash_attention: q_offset - k_offset = {q_offset - k_offset} with "
            f"{q.shape[1]} queries, {k.shape[1]} keys and window {window} overflows "
            "int32 positions")


def _pad_positions(x: torch.Tensor, n_blocks: int, block: int) -> torch.Tensor:
    """(B, L, ...) -> zero-padded to n_blocks * block positions."""
    pad = n_blocks * block - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))], dim=1)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    block_q: int = DEFAULT_BLOCK, block_k: int = DEFAULT_BLOCK,
    causal: bool = True, window: int = 0, with_lse: bool = False,
    q_offset: int = 0, k_offset: int = 0, out_fp32: bool = False,
):
    """Plain torch flash attention on any device: the XLA twin's schedule.

    GQA by row folding: the g query heads sharing a KV head become
    ``g * block_q`` rows of one (B, KV)-batched matmul against the
    un-expanded K/V block. For each q block the fully visible KV blocks of
    ``kv_block_range`` run first without a mask, then the edge blocks with
    the element mask and p-masking, in fp32 (bf16 operands widen exactly).
    S and T need not divide the blocks: padded keys are masked, padded
    queries dropped. ``q_offset``/``k_offset`` place the queries and keys
    at global positions (static ints, as the XLA twin's static offsets);
    ``out_fp32`` returns ``out`` in fp32.
    """
    _check_shapes(q, k, v, window)
    _check_offsets(q, k, window, q_offset, k_offset)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    nq, nk = math.ceil(s / block_q), math.ceil(t / block_k)
    scale = hd ** -0.5
    dev = q.device

    qf = (_pad_positions(q.float(), nq, block_q)
          .reshape(b, nq, block_q, kvh, g, hd)
          .permute(0, 1, 3, 4, 2, 5)
          .reshape(b, nq, kvh, g * block_q, hd))
    kt, vt = (_pad_positions(x.float(), nk, block_k)
              .reshape(b, nk, block_k, kvh, hd).permute(0, 3, 1, 2, 4) for x in (k, v))

    def step(q_blk, kj, carry, mask):
        m, l, acc = carry                              # (b, kvh, g*bq[, hd])
        sc = torch.matmul(q_blk, kt[:, :, kj].transpose(-1, -2)) * scale
        if mask is not None:
            sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        return (m_new, l * corr + p.sum(dim=-1),
                acc * corr[..., None] + torch.matmul(p, vt[:, :, kj]))

    parts = []
    for qi in range(nq):
        q_first = q_offset + qi * block_q
        q_last = q_first + block_q - 1
        q_pos = torch.arange(q_first, q_first + block_q, device=dev)

        def is_full(kj):
            k_first = k_offset + kj * block_k
            k_last = k_first + block_k - 1
            return ((kj + 1) * block_k <= t and (not causal or k_last <= q_first)
                    and (not window or k_first > q_last - window))

        lo, hi = kv_block_range(qi, block_q=block_q, block_k=block_k, nk=nk,
                                causal=causal, window=window,
                                q_offset=q_offset, k_offset=k_offset)
        carry = (torch.full((b, kvh, g * block_q), NEG_INF, device=dev),
                 torch.zeros((b, kvh, g * block_q), device=dev),
                 torch.zeros((b, kvh, g * block_q, hd), device=dev))
        for kj in range(lo, hi):
            if is_full(kj):
                carry = step(qf[:, qi], kj, carry, None)
        for kj in range(lo, hi):
            if not is_full(kj):
                k_idx = torch.arange(kj * block_k, (kj + 1) * block_k, device=dev)
                k_pos = k_offset + k_idx
                mask = k_idx[None, :] < t
                if causal:
                    mask = mask & (k_pos[None, :] <= q_pos[:, None])
                if window:
                    mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
                carry = step(qf[:, qi], kj, carry, mask.expand(block_q, block_k).repeat(g, 1))
        parts.append(carry)

    def stitch(xs):
        # nq x (b, kvh, g*bq[, hd]) -> (b, s, h[, hd]); row r of the folded
        # axis is head r // bq of the group at position r % bq
        y = torch.stack(xs, dim=1)                   # (b, nq, kvh, g*bq[, hd])
        tail = tuple(y.shape[4:])
        y = y.reshape((b, nq, kvh, g, block_q) + tail)
        y = y.permute((0, 1, 4, 2, 3) + tuple(5 + i for i in range(len(tail))))
        return y.reshape((b, nq * block_q, h) + tail)[:, :s]

    m = stitch([p[0] for p in parts])
    l = torch.clamp(stitch([p[1] for p in parts]), min=1e-30)
    acc = stitch([p[2] for p in parts])
    out = acc / l[..., None]
    if not out_fp32:
        out = out.to(q.dtype)
    if with_lse:
        return out, m + torch.log(l)
    return out


# ------------------------------------------------------------ the kernel

def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.dtype not in KERNEL_DTYPES:
            raise TypeError(
                f"flash_attention: the kernel takes fp32 or bf16 q, k, v of one dtype, got "
                f"{q.dtype}, {k.dtype}, {v.dtype}")
        if x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride on the head dim")
    if q.shape[3] > KERNEL_MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: the kernel takes head dims up to {KERNEL_MAX_HEAD_DIM}, "
            f"got {q.shape[3]}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(
            f"flash_attention: batch * heads = {q.shape[0] * q.shape[2]} exceeds the grid's 65535")
    if max(q.shape[1], k.shape[1]) >= 2**31 - 64:
        raise ValueError("flash_attention: sequence lengths must fit int32 positions")


def tma_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """Byte strides of (B, L, heads, hd) ``x``'s head, position and batch
    dims, innermost first, as a tensor map takes them. A dim of size 1 never
    moves an address, so its stride is replaced by the span of the dims
    inside it, rounded up to ``TMA_ALIGN`` (torch may give such a dim any
    stride)."""
    es = x.element_size()
    out, span = [], x.shape[3] * es
    for d in (2, 1, 0):
        stride = x.stride(d) * es if x.shape[d] != 1 else -(-span // TMA_ALIGN) * TMA_ALIGN
        out.append(stride)
        span = max(span, stride * x.shape[d])
    return tuple(out)


def tma_describable(x: torch.Tensor) -> bool:
    """Whether a tensor map can describe ``x`` as it lies: a 16-byte aligned
    base pointer, unit stride on hd, and head, position and batch strides
    that are positive multiples of 16 bytes below 2^40."""
    return (x.data_ptr() % TMA_ALIGN == 0 and x.stride(3) == 1
            and all(0 < st < TMA_MAX_STRIDE and st % TMA_ALIGN == 0 for st in tma_strides(x)))


def tma_plan(x: torch.Tensor, rows: int) -> tuple[int, ...]:
    """The 11 integers the wgmma kernel's tensor map of (B, L, heads, hd)
    ``x`` is encoded from: dims (hd, heads, L, B), byte strides (head,
    position, batch) and box (64 columns, 1 head, ``rows`` positions,
    1 batch). Out-of-bounds box elements (ragged L, hd < 64 or 128) read as
    zeros."""
    b, n, heads, hd = x.shape
    return (hd, heads, n, b, *tma_strides(x), TMA_BOX_COLS, 1, rows, 1)


def _kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"wgmma"`` for bf16 q, k, v that TMA can describe, else ``"simt"``
    (fp32, or bf16 with a misaligned pointer or stride). A pure function of
    dtype, shapes, strides and data pointers; it launches nothing."""
    if q.dtype == torch.bfloat16 and all(tma_describable(x) for x in (q, k, v)):
        return "wgmma"
    return "simt"


SIMT_ALIGN = 16   # bytes: one cp.async copy


def _load_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """How the SIMT kernel streams K and V: ``"async"`` (``cp.async``
    16-byte copies) for fp32 with hd a multiple of 4 and k, v whose data
    pointers, and strides of every dim holding more than one element, are
    multiples of 16 bytes; else ``"sync"`` (loads staged through registers:
    every bf16 input, odd fp32 strides). A pure function of dtype, shapes,
    strides and data pointers; it launches nothing."""
    if q.dtype != torch.float32 or q.shape[3] % 4:
        return "sync"
    for x in (k, v):
        es = x.element_size()
        if x.data_ptr() % SIMT_ALIGN or any(
                x.shape[d] > 1 and x.stride(d) * es % SIMT_ALIGN for d in range(3)):
            return "sync"
    return "async"


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, with_lse: bool = False,
    q_offset: int = 0, k_offset: int = 0, out_fp32: bool = False,
):
    """Flash attention (module docstring): a CUDA kernel for tensors on
    the card (fp32 or bf16, hd <= 128; anything else raises), the plain
    version for tensors on the CPU. ``q_offset``/``k_offset`` (Python ints)
    place queries and keys at global positions; the kernels take their
    difference (none for a non-causal call without a window, whose mask
    reads no position). ``out_fp32`` writes ``out`` in fp32. Forward only:
    under grad it raises (``build.refuse_grad``) on every device."""
    build.refuse_grad("flash_attention", FLASH_GRAD_ROUTE, q, k, v)
    _check_shapes(q, k, v, window)
    _check_offsets(q, k, window, q_offset, k_offset)
    if not build.route("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window, with_lse=with_lse,
                                     q_offset=q_offset, k_offset=k_offset, out_fp32=out_fp32)
    _check_kernel_inputs(q, k, v)
    # a non-causal, windowless mask reads no position: the instantiation
    # without the offset runs, as for offsets that cancel
    off = q_offset - k_offset if causal or window else 0
    return _launch(q, k, v, causal=causal, window=window, off=off, with_lse=with_lse,
                   out_fp32=out_fp32)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int,
            off: int, with_lse: bool, out_fp32: bool):
    """One kernel launch on checked CUDA tensors, query row 0 ``off``
    positions after key 0 (a nonzero ``off`` runs the kernels' ``OFFSET``
    instantiation), counted in :data:`launches`."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=torch.float32 if out_fp32 else q.dtype,
                      device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel():
        route = _kernel_route(q, k, v)
        scale = float(np.float32(hd ** -0.5))
        lse_ptr = None if lse is None else lse.data_ptr()
        with _profile_scope("cuda_flash_attention"):
            if route == "wgmma":
                lib_name = "flash_attention_wgmma"
                plans = (ctypes.c_int64 * 33)(*tma_plan(q, WGMMA_BLOCK_Q),
                                              *tma_plan(k, WGMMA_BLOCK_K),
                                              *tma_plan(v, WGMMA_BLOCK_K))
                err = build.library(lib_name).faw_forward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, plans,
                    b, s, t, h, kvh, hd, int(causal), int(window), off, int(out_fp32), scale,
                    q.device.index or 0, build.stream(q.device),
                )
            else:
                lib_name = "flash_attention"
                err = build.library(lib_name).fa_forward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                    q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2),
                    b, s, t, h, kvh, hd, int(causal), int(window), off, int(out_fp32), scale,
                    int(q.dtype == torch.bfloat16), int(_load_variant(q, k, v) == "async"),
                    q.device.index or 0, build.stream(q.device),
                )
        build.check(lib_name, f"flash_attention ({route})", err)
        launches["flash_attention"] += 1
        launches[f"flash_attention_{route}"] += 1
    if with_lse:
        return out, lse
    return out
