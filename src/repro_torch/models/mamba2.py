"""Mamba2 (SSD) blocks for the zamba2 hybrid (arXiv:2411.15242) in torch.

The port of ``repro.models.mamba2``. State-space duality form: per head h
(head dim P, state dim N)
  a_t = exp(-softplus(dt_t) * exp(A_log_h))            (scalar decay)
  S_t = a_t S_{t-1} + softplus(dt_t) * B_t (x) x_t     (S in R^{N x P})
  y_t = C_t . S_t + D_h * x_t

Executed chunk-parallel (the SSD algorithm, the served prefill's path):
intra-chunk a masked (C x C) decay-weighted matmul, inter-chunk a scan
over chunk states; ``ssd_sequential`` is the oracle and decode's T = 1
path. ``a_log``, ``d_skip`` and ``dt_bias`` are fp32 in every
configuration, as the JAX code reads them.

Tensor parallelism on ``model`` (``dist.parallel``'s rule): ``w_out``'s
rows hold the rank's heads (d_inner / m channels), followed by
``reduce_from_model``. ``w_in``'s columns concatenate z, x, B, C and dt,
so a contiguous block of them is not the rank's heads: the rank multiplies
by its columns and all-gathers the projection's output over ``model``
(``collectives.gather_fsdp``: a reduce-scatter backward, since the ranks
use different parts of it), runs the depthwise conv over every
channel (its replicated kernel behind ``copy_to_model``; the conv carry
stays whole), then keeps its own heads of z, x and dt and all of B and C.
``a_log``, ``d_skip``, ``dt_bias`` and the gated norm's scale are sliced
to the rank's heads behind ``copy_to_model``; the gated norm's sum of
squares over d_inner is a partial per rank, in fp32, all-reduced both
ways (``collectives.sum_over_model``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives, parallel
from repro_torch.dist import seq as dseq
from repro_torch.models import layers

CONV_K = 4  # depthwise causal conv width


def mamba2_params(gen: torch.Generator, d: int, d_inner: int, d_state: int, head_dim: int,
                  n_layers: int = 1, dtype: torch.dtype = torch.float32,
                  conv_bias: bool = False) -> dict:
    """``conv_bias`` adds the conv's bias ``conv_b`` (Granite-4.0-H's
    ``mamba_conv_bias``; Zamba2's conv has none), drawn after the rest."""
    n_heads = d_inner // head_dim
    f32 = dict(dtype=torch.float32, device=gen.device)
    p = {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": layers.dense_init((d, 2 * d_inner + 2 * d_state + n_heads), 0.02, gen, dtype),
        "conv": layers.dense_init((CONV_K, d_inner + 2 * d_state), 0.5, gen, dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "d_skip": torch.ones((n_heads,), **f32),
        "dt_bias": torch.full((n_heads,), -2.0, **f32),      # softplus ~ 0.12
        "w_out": layers.dense_init((d_inner, d), 0.02 / max(1.0, (2 * n_layers) ** 0.5), gen,
                                   dtype),
        "norm": layers.rmsnorm_params(d_inner, gen.device),
    }
    if conv_bias:
        p["conv_b"] = layers.dense_init((d_inner + 2 * d_state,), 0.1, gen, dtype)
    return p


def _split_proj(proj: torch.Tensor, d_inner: int, d_state: int):
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    b = proj[..., 2 * d_inner:2 * d_inner + d_state]
    c = proj[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, x, b, c, dt


def causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                carry: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,T,C); kernel: (K,C); carry: (B,K-1,C);
    bias (C,) or None. Returns (y, new carry). The K shifted products are
    summed in x's dtype in the JAX code's order (each product and partial
    sum rounded there), the bias added last, then SiLU: not ``conv1d``,
    which would accumulate in fp32."""
    k = kernel.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([carry, x], dim=1)
    ker = kernel.to(x.dtype)
    t = x.shape[1]
    y = sum(xp[:, i:i + t, :] * ker[i] for i in range(k))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return F.silu(y), xp[:, -(k - 1):, :]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), term for term (``F.softplus`` computes log1p(exp(x))
    below its threshold, other roundings)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b_in: torch.Tensor,
                c_in: torch.Tensor, s0: torch.Tensor,
                chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,P); dt: (B,T,H) softplus'd fp32; a_log: (H,); b_in, c_in:
    (B,T,N); s0: (B,H,N,P) fp32. Returns y (B,T,H,P) in x's dtype, S_T."""
    return ssd_finish(ssd_parts(x, dt, a_log, b_in, c_in, chunk), s0, x.dtype)


def ssd_parts(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b_in: torch.Tensor,
              c_in: torch.Tensor, chunk: int = 128) -> dict:
    """What :func:`ssd_chunked` computes before its state scan, none of it
    depending on the start state: the intra-chunk output, the state read
    factors, each chunk's state write and log decay."""
    bsz, t, h, p = x.shape
    n = b_in.shape[-1]
    if t % chunk:
        raise ValueError(f"ssd_chunked: T={t} is not a multiple of chunk={chunk}")
    nc = t // chunk
    loga = -dt * torch.exp(a_log)                                    # (B,T,H) <= 0
    resh = lambda z, last: z.float().reshape((bsz, nc, chunk) + last)  # noqa: E731
    xc = resh(x, (h, p))
    dtc = resh(dt, (h,))
    bc = resh(b_in, (n,))
    cc = resh(c_in, (n,))
    cum = torch.cumsum(resh(loga, (h,)), dim=2).transpose(2, 3)     # (B,NC,H,C)

    # intra-chunk: y[t] = sum_{j<=t} (C_t.B_j) e^{cum_t-cum_j} dt_j x_j, heads
    # ahead of (t, j) so the product with x is one batched matmul
    l_mat = cum[..., :, None] - cum[..., None, :]                    # (B,NC,H,t,j)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # mask inside the exponential: exp of the positive exponents above the
    # diagonal would overflow to inf, and inf * 0 is NaN
    l_mat = torch.where(tri, l_mat, -1e30).exp_()
    cb = torch.einsum("bctn,bcjn->bctj", cc, bc)
    scores = (cb[:, :, None] * l_mat).mul_(dtc.transpose(2, 3)[:, :, :, None, :])
    del l_mat
    y_intra = torch.matmul(scores, xc.transpose(2, 3)).transpose(2, 3)   # (B,NC,t,H,P)

    # chunk state writes: S_out = e^{cum_last} S_in + sum_j e^{cum_last-cum_j} dt_j B_j x_j
    dec_k = torch.exp(cum[..., -1:] - cum).transpose(2, 3)          # (B,NC,C,H)
    kv = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, dec_k * dtc, xc)
    return {"y_intra": y_intra, "cc": cc, "cum": cum, "kv": kv, "log_dec": cum[..., -1]}


def ssd_scan(parts: dict, s0: torch.Tensor) -> tuple[list, torch.Tensor]:
    """The state entering each chunk from ``s0``, and the final state."""
    full = torch.exp(parts["log_dec"])                               # (B,NC,H)
    kv = parts["kv"]
    s, s_in = s0, []
    for c in range(kv.shape[1]):
        s_in.append(s)
        s = full[:, c, :, None, None] * s + kv[:, c]
    return s_in, s


def ssd_finish(parts: dict, s0: torch.Tensor,
               dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunked`'s output from its parts and the start state."""
    s_in, s = ssd_scan(parts, s0)
    y_state = torch.einsum("bctn,bcth,bchnp->bcthp", parts["cc"],
                           torch.exp(parts["cum"]).transpose(2, 3), torch.stack(s_in, dim=1))
    bsz, nc, c, h, p = parts["y_intra"].shape
    return (parts["y_intra"] + y_state).reshape(bsz, nc * c, h, p).to(dtype), s


def ssd_pair(parts: dict, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A shard's state map S -> A ⊙ S + B (``dist.seq``): A (B, H) the
    product of its chunks' decays (a sum in log space), B the final state
    from zeros."""
    return torch.exp(parts["log_dec"].sum(1)), ssd_scan(parts, torch.zeros_like(s0))[1]


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b_in: torch.Tensor,
                   c_in: torch.Tensor, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The oracle: one step per position (decode's path at T = 1)."""
    loga = -dt * torch.exp(a_log)
    xf, bf, cf = x.float(), b_in.float(), c_in.float()
    s, ys = s0, []
    for t in range(x.shape[1]):
        a = torch.exp(loga[:, t])                                    # (B,H)
        kv = bf[:, t, None, :, None] * dt[:, t, :, None, None] * xf[:, t, :, None, :]
        s = a[..., None, None] * s + kv
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype), s


def mamba2_apply(params: dict, x: torch.Tensor, *, d_inner: int, d_state: int, head_dim: int,
                 state: Optional[dict] = None, chunk: int = 128, chunked: bool = True,
                 seq=None) -> tuple[torch.Tensor, dict]:
    """Full-sequence Mamba2 block; ``state`` carries (ssm, conv) for
    streaming. Returns (out, {"ssm": (B,H,N,P) fp32, "conv": (B,K-1,C)}).

    ``seq`` (a ``dist.seq`` transport) runs x as sequence shards: each
    shard's conv takes the previous shard's last K - 1 rows of its input
    (``state["conv"]`` the first's), its chunked scan starts from the fold
    of the earlier shards' state maps; the states returned are the last
    held shard's (as ``rwkv6.time_mix_apply``'s)."""
    dims = dict(d_inner=d_inner, d_state=d_state, head_dim=head_dim)
    if seq is not None:
        return _mamba2_seq(params, x, state, chunk, seq, **dims)
    t = x.shape[1]
    tp, z, conv_in, dt = _in_proj(params, x, **dims)
    conv_out, conv_carry = causal_conv(conv_in, _conv_kernel(params, tp),
                                       None if state is None else state["conv"],
                                       params.get("conv_b"))
    p, z, xh, b_in, c_in, dt = _heads(params, tp, z, conv_out, dt, **dims)
    s0 = (x.new_zeros(xh.shape[:1] + (xh.shape[2], d_state, head_dim), dtype=torch.float32)
          if state is None else state["ssm"])
    a_log = p["a_log"].float()
    if chunked and t % chunk == 0 and t > 1:
        y, s_final = ssd_chunked(xh, dt, a_log, b_in, c_in, s0, chunk)
    else:
        y, s_final = ssd_sequential(xh, dt, a_log, b_in, c_in, s0)
    return _out(p, tp, y, xh, z, d_inner), {"ssm": s_final, "conv": conv_carry}


def _in_proj(params: dict, x: torch.Tensor, *, d_inner: int, d_state: int, head_dim: int):
    """(tp, z, the conv's input x|B|C, dt) of x's in-projection; under
    tensor parallelism gathered over ``model`` (module docstring)."""
    inner = params["w_out"].shape[0]         # d_inner, or the rank's heads' channels
    tp = inner != d_inner
    if tp != (params["w_in"].shape[-1] != 2 * d_inner + 2 * d_state + d_inner // head_dim):
        raise ValueError("mamba2: w_in's columns and w_out's rows are not both on model")
    if tp:
        x = collectives.copy_to_model(x)
    proj = torch.matmul(x, params["w_in"].to(x.dtype))
    if tp:
        proj = collectives.gather_fsdp(proj, "model", proj.ndim - 1)
    z, xi, b_in, c_in, dt = _split_proj(proj, d_inner, d_state)
    return tp, z, torch.cat([xi, b_in, c_in], dim=-1), dt


def _conv_kernel(params: dict, tp: bool) -> torch.Tensor:
    return collectives.copy_to_model(params["conv"]) if tp else params["conv"]


def _heads(params: dict, tp: bool, z, conv_out, dt, *, d_inner: int, d_state: int,
           head_dim: int):
    """The rank's heads of the conv's output: (params as the rank reads
    them, z, x (B,T,H,P), B, C, softplus'd dt fp32)."""
    bsz, t = conv_out.shape[:2]
    inner = params["w_out"].shape[0]
    xi = conv_out[..., :d_inner]
    b_in = conv_out[..., d_inner:d_inner + d_state]
    c_in = conv_out[..., d_inner + d_state:]
    p = params
    h = inner // head_dim
    if tp:                                   # the rank's heads
        lo = parallel.model_index() * inner
        z, xi = z[..., lo:lo + inner], xi[..., lo:lo + inner]
        dt = dt[..., lo // head_dim:lo // head_dim + h]
        p = dict(params, norm={"scale": parallel.rank_part(params["norm"]["scale"], inner)},
                 **{n: parallel.rank_part(params[n], h) for n in ("a_log", "d_skip", "dt_bias")})
    dt = softplus(dt.float() + p["dt_bias"].float())
    return p, z, xi.reshape(bsz, t, h, head_dim), b_in, c_in, dt


def _out(p: dict, tp: bool, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
         d_inner: int) -> torch.Tensor:
    """The skip, the gated norm and the out-projection of the scan's y."""
    bsz, t = y.shape[:2]
    dtype = xh.dtype
    y = y + p["d_skip"].to(dtype)[:, None] * xh
    # the gated norm at rmsnorm's default eps, as in the JAX code (not cfg.norm_eps)
    gated = y.reshape(bsz, t, z.shape[-1]) * F.silu(z)
    y = _split_rmsnorm(p["norm"], gated, d_inner) if tp else layers.rmsnorm(p["norm"], gated)
    out = torch.matmul(y, p["w_out"].to(dtype))
    if tp:
        out = collectives.reduce_from_model(out)
    return out


def _mamba2_seq(params: dict, x: torch.Tensor, state: Optional[dict], chunk: int, seq, *,
                d_inner: int, d_state: int, head_dim: int) -> tuple[torch.Tensor, dict]:
    """:func:`mamba2_apply` over sequence shards (its docstring)."""
    dims = dict(d_inner=d_inner, d_state=d_state, head_dim=head_dim)
    xs = seq.split(x)
    projs = [_in_proj(params, xj, **dims) for xj in xs]
    k = params["conv"].shape[0]
    b = x.shape[0]
    first = (projs[0][2].new_zeros((b, k - 1, projs[0][2].shape[-1])) if state is None
             else state["conv"])
    carries = dseq.halo(seq, [conv_in for _, _, conv_in, _ in projs], k - 1, first)
    shards, convs = [], []
    for (tp, z, conv_in, dt), carry in zip(projs, carries):
        conv_out, conv_carry = causal_conv(conv_in, _conv_kernel(params, tp), carry,
                                           params.get("conv_b"))
        p, z, xh, b_in, c_in, dt = _heads(params, tp, z, conv_out, dt, **dims)
        shards.append((p, tp, z, xh, ssd_parts(xh, dt, p["a_log"].float(), b_in, c_in, chunk)))
        convs.append(conv_carry)
    h = shards[0][3].shape[2]
    s0 = (x.new_zeros((b, h, d_state, head_dim), dtype=torch.float32) if state is None
          else state["ssm"])
    s_ins = seq.exchange([ssd_pair(parts, s0) for *_, parts in shards],
                         dseq.fold(s0, lambda a: a[..., None, None]))
    outs, finals = [], []
    for (p, tp, z, xh, parts), s_in in zip(shards, s_ins):
        y, s_final = ssd_finish(parts, s_in, xh.dtype)
        outs.append(_out(p, tp, y, xh, z, d_inner))
        finals.append(s_final)
    return seq.join(outs), {"ssm": finals[-1], "conv": convs[-1]}


def _split_rmsnorm(params: dict, x: torch.Tensor, d: int, eps: float = 1e-5) -> torch.Tensor:
    """``layers.rmsnorm`` over ``d`` channels of which x holds the rank's:
    the fp32 sum of squares summed over ``model`` both ways."""
    xf = x.float()
    ss = collectives.sum_over_model(torch.sum(xf * xf, dim=-1, keepdim=True))
    out = xf * torch.rsqrt(ss / d + eps) * params["scale"]
    return out.to(x.dtype)


def mamba2_step(params: dict, x: torch.Tensor, state: dict, *, d_inner: int, d_state: int,
                head_dim: int) -> tuple[torch.Tensor, dict]:
    """Single-token decode step. x: (B, D)."""
    out, new_state = mamba2_apply(params, x[:, None, :], d_inner=d_inner, d_state=d_state,
                                  head_dim=head_dim, state=state, chunked=False)
    return out[:, 0, :], new_state
