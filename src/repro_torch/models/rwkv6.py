"""RWKV6 "Finch" blocks (arXiv:2404.05892) in torch: attention-free time
mix with data-dependent per-channel decay + squared-ReLU channel mix.

The port of ``repro.models.rwkv6``. State per layer: the WKV matrix S in
R^{H x K x V} (fp32) plus the previous token activations for the two
token shifts.

Time-mix recurrence per head (K = V = head_dim):
  w_t = exp(-exp(w0 + tanh(x_w A) B))          (data-dependent decay)
  S_t = diag(w_t) S_{t-1} + k_t^T v_t
  y_t = r_t (diag(u) k_t^T v_t + S_{t-1})

Two execution paths, as in the JAX package:
  * ``wkv_sequential`` — a loop over time (the exact oracle; decode runs
    it at T = 1);
  * ``wkv_chunked``    — the chunk-parallel form (intra-chunk masked
    (C x C) matmuls from the exp-cumsum factorization, a scan of chunk
    states between chunks): the served prefill's path.

The decay LoRA (``wa``, ``wb``), the bonus ``u``, ``w0``, the mixing
vectors and the group norm's affine are fp32 in every configuration: the
JAX code reads them fp32 (the double exponential of the decay would move
with a bf16 rounding of its inputs). The five projections are matrices in
the activation dtype.

Tensor parallelism on ``model`` (``dist.parallel``'s rule): the time
mix's ``wr``/``wk``/``wv``/``wg`` columns and ``u`` hold the rank's heads
(columns are H x hd, head-major) and ``wo`` their rows, followed by
``reduce_from_model``. The region's inputs (x, the shift carry) and the
replicated leaves it reads (the mixing vectors and ``wa`` whole; ``wb``'s
columns, ``w0`` and the group norm's affine at the rank's channels) enter
through ``copy_to_model``. The channel mix's ``wk`` columns and ``wv``
rows are the rank's; ``v`` is summed over ``model`` before it meets the
gate, whose ``wr`` branch is the same on every rank and takes no copy.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives, parallel
from repro_torch.dist import seq as dseq
from repro_torch.models import layers


def time_mix_params(gen: torch.Generator, d: int, n_heads: int, n_layers: int = 1,
                    dtype: torch.dtype = torch.float32) -> dict:
    hd = d // n_heads
    lora = max(32, d // 64)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        **{f"mu_{c}": torch.full((d,), 0.5, **f32) for c in "rkvwg"},
        "wr": layers.dense_init((d, d), 0.02, gen, dtype),
        "wk": layers.dense_init((d, d), 0.02, gen, dtype),
        "wv": layers.dense_init((d, d), 0.02, gen, dtype),
        "wg": layers.dense_init((d, d), 0.02, gen, dtype),
        "wo": layers.dense_init((d, d), 0.02 / max(1.0, (2 * n_layers) ** 0.5), gen, dtype),
        # data-dependent decay LoRA: w0 + tanh(x A) B, fp32
        "w0": torch.full((d,), -6.0, **f32),   # exp(-exp(-6)) ~ slow decay
        "wa": layers.dense_init((d, lora), 0.02, gen),
        "wb": layers.dense_init((lora, d), 0.1, gen),
        "u": layers.dense_init((n_heads, hd), 0.5, gen),     # bonus
        "ln": layers.layernorm_params(d, gen.device),
    }


def groupnorm_heads(params: dict, y: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head layernorm on (B, T, H, N) with (H*N,)-shaped affine."""
    h, n = y.shape[2], y.shape[3]
    yf = y.float()
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.mean((yf - mu) ** 2, dim=-1, keepdim=True)
    yn = (yf - mu) * torch.rsqrt(var + eps)
    return (yn * params["scale"].reshape(h, n) + params["bias"].reshape(h, n)).to(y.dtype)


def channel_mix_params(gen: torch.Generator, d: int, f: int, n_layers: int = 1,
                       dtype: torch.dtype = torch.float32) -> dict:
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "mu_k": torch.full((d,), 0.5, **f32),
        "mu_r": torch.full((d,), 0.5, **f32),
        "wk": layers.dense_init((d, f), 0.02, gen, dtype),
        "wv": layers.dense_init((f, d), 0.02 / max(1.0, (2 * n_layers) ** 0.5), gen, dtype),
        "wr": layers.dense_init((d, d), 0.02, gen, dtype),
    }


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: prepend the carried last token, drop the final one.
    x: (B, T, D); x_prev: (B, D) -> shifted (B, T, D)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x: torch.Tensor, x_shift: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (x_shift - x) * mu.to(x.dtype)


def _rkvwg(params: dict, x: torch.Tensor, x_prev: torch.Tensor, n_heads: int):
    """Project the five mixed streams. Returns per-head r, k, v (B,T,H,hd),
    decay w (B,T,H,hd) fp32 in (0,1), gate g (B,T,D), and the new shift
    carry."""
    b, t, d = x.shape
    dtype = x.dtype
    xs = _shift(x, x_prev)
    xr, xk, xv, xw, xg = (_mix(x, xs, params[f"mu_{c}"]) for c in "rkvwg")
    r = torch.matmul(xr, params["wr"].to(dtype))
    k = torch.matmul(xk, params["wk"].to(dtype))
    v = torch.matmul(xv, params["wv"].to(dtype))
    g = F.silu(torch.matmul(xg, params["wg"].to(dtype)))
    # data-dependent decay, fp32 for the double exponential
    lora = torch.matmul(xw.float(), params["wa"].float())
    dd = torch.matmul(torch.tanh(lora), params["wb"].float())
    w = torch.exp(-torch.exp(params["w0"].float() + dd))   # (B,T,D) in (0,1), fp32
    hsplit = lambda z: z.reshape(b, t, n_heads, -1)  # noqa: E731
    return hsplit(r), hsplit(k), hsplit(v), hsplit(w), g, x[:, -1, :]


def wkv_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token step. r,k,v: (B,H,N) activation dtype; w: (B,H,N) fp32;
    u: (H,N); s: (B,H,N,N) fp32. Returns y (B,H,N), the new state."""
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = kf[..., :, None] * vf[..., None, :]                        # (B,H,K,V)
    y = torch.einsum("bhk,bhkv->bhv", rf, s + u[None, :, :, None] * kv)
    return y.to(r.dtype), w[..., None] * s + kv


def wkv_sequential(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact recurrence, one step per position.

    r,k,v: (B,T,H,N) activation dtype; w: (B,T,H,N) fp32 decays;
    u: (H,N); s0: (B,H,N,N) fp32. Returns y (B,T,H,N), s_T."""
    s, ys = s0, []
    for t in range(r.shape[1]):
        yt, s = wkv_step(r[:, t].float(), k[:, t].float(), v[:, t].float(), w[:, t], u, s)
        ys.append(yt)
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, s0: torch.Tensor,
                chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV: inside a chunk of length C the contribution of
    key j to query t (j < t) carries the decay prod_{s=j+1}^{t-1} w_s,
    factorized as exp(cum_{t-1} - cum_j) with cum the per-channel
    log-decay cumsum (restarting at each chunk), so the intra-chunk part is
    a strictly lower-triangular (C x C) matmul and the ``u`` bonus its
    diagonal, added on its own. The carry between chunks is the state
    recurrence at chunk granularity. fp32 throughout.
    """
    parts = wkv_parts(r, k, v, w, u, chunk)
    return wkv_finish(parts, s0, r.dtype)


def wkv_parts(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, chunk: int = 64) -> dict:
    """What :func:`wkv_chunked` computes before its state scan, none of it
    depending on the start state: the intra-chunk output, the queries'
    state read factors, each chunk's state write and decay."""
    b, t, h, n = r.shape
    if t % chunk:
        raise ValueError(f"wkv_chunked: T={t} is not a multiple of chunk={chunk}")
    nc = t // chunk
    logw = torch.log(torch.clamp(w, 1e-38, 1.0))
    # overflow guard of exp(-cum): |cum| <= 80 nats within a chunk (at init
    # log w ~ -2.5e-3, three orders below the clamp)
    logw = torch.clamp_min(logw, -80.0 / chunk)
    resh = lambda z: z.float().reshape(b, nc, chunk, h, n)  # noqa: E731
    rc, kc, vc, lwc = resh(r), resh(k), resh(v), resh(logw)

    cum = torch.cumsum(lwc, dim=2)                        # (B,NC,C,H,N), inclusive
    dec_q = torch.exp(cum - lwc)                          # queries read the state through t-1
    dec_k = torch.exp(cum[:, :, -1:] - cum)               # keys decay to the chunk's end
    r_in = rc * dec_q                                     # pre-scaled for the state read
    k_out = kc * dec_k                                    # pre-scaled for the state write

    # r_in[t] . (k[j] exp(-cum[j])) = r.k * prod_{s=j+1}^{t-1} w_s, kept for j < t only
    scores = torch.einsum("bcthn,bcjhn->bchtj", r_in, kc * torch.exp(-cum))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    scores = scores * tri
    diag = torch.einsum("bcthn,bcthn->bcth", rc * u, kc)
    y_intra = torch.einsum("bchtj,bcjhn->bcthn", scores, vc) + diag[..., None] * vc

    # between chunks: each chunk's state write and decay
    kv_chunk = torch.einsum("bcjhk,bcjhv->bchkv", k_out, vc)        # (B,NC,H,N,N)
    return {"y_intra": y_intra, "r_in": r_in, "kv": kv_chunk, "log_dec": cum[:, :, -1]}


def wkv_scan(parts: dict, s0: torch.Tensor) -> tuple[list, torch.Tensor]:
    """The state entering each chunk from ``s0``, and the final state."""
    full_dec = torch.exp(parts["log_dec"])                          # (B,NC,H,N)
    kv_chunk = parts["kv"]
    s, s_in = s0, []
    for c in range(kv_chunk.shape[1]):
        s_in.append(s)
        s = full_dec[:, c, ..., None] * s + kv_chunk[:, c]
    return s_in, s


def wkv_finish(parts: dict, s0: torch.Tensor,
               dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`wkv_chunked`'s output from its parts and the start state."""
    s_in, s = wkv_scan(parts, s0)
    y_state = torch.einsum("bcthk,bchkv->bcthv", parts["r_in"], torch.stack(s_in, dim=1))
    b, nc, c, h, n = parts["r_in"].shape
    return (parts["y_intra"] + y_state).reshape(b, nc * c, h, n).to(dtype), s


def wkv_pair(parts: dict, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A shard's state map S -> A ⊙ S + B (``dist.seq``): A (B, H, N) the
    product of its chunks' decays (a sum in log space), B the final state
    from ``s0`` = zeros."""
    return torch.exp(parts["log_dec"].sum(1)), wkv_scan(parts, torch.zeros_like(s0))[1]


def _rank_region(params: dict, x: torch.Tensor, x_prev: torch.Tensor, n_heads: int):
    """The time mix as the rank runs it: ``(params, x, x_prev, heads)``,
    unchanged when ``wr`` holds every column, else the rank's heads with
    the region's inputs and replicated leaves behind ``copy_to_model``
    (module docstring)."""
    d = x.shape[-1]
    cols = params["wr"].shape[-1]
    if cols == d:
        return params, x, x_prev, n_heads
    heads = params["u"].shape[0]
    if heads * (d // n_heads) != cols:
        raise ValueError(f"time mix: {cols} of {d} columns on this rank do not hold whole "
                         f"heads ({n_heads} heads; u holds {heads})")
    copy = collectives.copy_to_model
    p = dict(params, wa=copy(params["wa"]), wb=parallel.rank_part(params["wb"], cols),
             w0=parallel.rank_part(params["w0"], cols),
             ln={n: parallel.rank_part(v, cols) for n, v in params["ln"].items()},
             **{f"mu_{c}": copy(params[f"mu_{c}"]) for c in "rkvwg"})
    return p, copy(x), copy(x_prev), heads


def time_mix_apply(params: dict, x: torch.Tensor, x_prev: torch.Tensor, s0: torch.Tensor,
                   n_heads: int, *, chunked: bool = True, chunk: int = 64,
                   seq=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time mix. Returns (out, new x_prev, new state); under
    tensor parallelism ``s0`` and the state hold the rank's heads.

    ``seq`` (a ``dist.seq`` transport) runs x as sequence shards: each
    shard's token shift takes the previous shard's last row (``x_prev``
    is the first shard's), its chunked WKV starts from the fold of the
    earlier shards' state maps (``s0`` the first's); the carry and state
    returned are the last held shard's: the sequence's under ``LocalSeq``,
    this rank's own under ``GroupSeq`` (a prefill takes the last rank's,
    ``models.model.from_last_shard``)."""
    if seq is not None:
        return _time_mix_seq(params, x, x_prev, s0, n_heads, chunk, seq)
    b, t, _ = x.shape
    p, xl, x_prev, heads = _rank_region(params, x, x_prev, n_heads)
    r, k, v, w, g, _ = _rkvwg(p, xl, x_prev, heads)
    u = p["u"].float()
    if chunked and t % chunk == 0 and t > 1:
        y, s_final = wkv_chunked(r, k, v, w, u, s0, chunk=chunk)
    else:
        y, s_final = wkv_sequential(r, k, v, w, u, s0)
    return _time_mix_out(p, y, g, heads, n_heads), x[:, -1, :], s_final


def _time_mix_out(p: dict, y: torch.Tensor, g: torch.Tensor, heads: int,
                  n_heads: int) -> torch.Tensor:
    b, t = y.shape[:2]
    y = groupnorm_heads(p["ln"], y).reshape(b, t, -1)        # head-local norm
    out = torch.matmul(y * g, p["wo"].to(g.dtype))
    if heads != n_heads:
        out = collectives.reduce_from_model(out)
    return out


def _time_mix_seq(params: dict, x: torch.Tensor, x_prev: torch.Tensor, s0: torch.Tensor,
                  n_heads: int, chunk: int, seq):
    """:func:`time_mix_apply` over sequence shards (its docstring)."""
    xs = seq.split(x)
    shards = []
    for xj, pj in zip(xs, dseq.halo(seq, xs, 1, x_prev)):
        p, xl, xp, heads = _rank_region(params, xj, pj, n_heads)
        r, k, v, w, g, _ = _rkvwg(p, xl, xp, heads)
        shards.append((p, heads, g, r.dtype, wkv_parts(r, k, v, w, p["u"].float(), chunk)))
    s_ins = seq.exchange([wkv_pair(parts, s0) for *_, parts in shards],
                         dseq.fold(s0, lambda a: a[..., None]))
    outs, finals = [], []
    for (p, heads, g, dtype, parts), s_in in zip(shards, s_ins):
        y, s_final = wkv_finish(parts, s_in, dtype)
        outs.append(_time_mix_out(p, y, g, heads, n_heads))
        finals.append(s_final)
    return seq.join(outs), xs[-1][:, -1, :], finals[-1]


def time_mix_step(params: dict, x: torch.Tensor, x_prev: torch.Tensor, s: torch.Tensor,
                  n_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode. x: (B, D)."""
    out, carry, s_new = time_mix_apply(params, x[:, None, :], x_prev, s, n_heads,
                                       chunked=False)
    return out[:, 0, :], carry, s_new


def channel_mix_apply(params: dict, x: torch.Tensor, x_prev: torch.Tensor,
                      d_ff: Optional[int] = None, seq=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The channel mix; when ``wk`` holds fewer than ``d_ff`` columns, the
    rank's (module docstring). ``seq`` runs x as sequence shards, each
    shift taking the previous shard's last row (:func:`time_mix_apply`)."""
    if seq is not None:
        xs = seq.split(x)
        outs = [channel_mix_apply(params, xj, pj, d_ff)[0]
                for xj, pj in zip(xs, dseq.halo(seq, xs, 1, x_prev))]
        return seq.join(outs), xs[-1][:, -1, :]
    dtype = x.dtype
    xs = _shift(x, x_prev)
    xk = _mix(x, xs, params["mu_k"])
    xr = _mix(x, xs, params["mu_r"])
    split = d_ff is not None and params["wk"].shape[-1] != d_ff
    if split:
        xk = collectives.copy_to_model(xk)
    k = torch.square(torch.relu(torch.matmul(xk, params["wk"].to(dtype))))
    v = torch.matmul(k, params["wv"].to(dtype))
    if split:
        v = collectives.reduce_from_model(v)
    r = torch.sigmoid(torch.matmul(xr, params["wr"].to(dtype)))
    return r * v, x[:, -1, :]
