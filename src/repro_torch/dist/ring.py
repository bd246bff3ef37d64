"""Sequence-parallel (ring) flash attention: the port of the JAX package's
``ring_flash_attention`` and ``merge_partials``
(``repro/kernels/flash_attention.py``), each ring step through the port's
flash kernels.

Each of n ranks holds one sequence shard (B, S_loc, H|KV, hd) of q, k, v;
shard d owns positions ``[d S_loc, (d + 1) S_loc)``. At step t the K/V a
rank holds came from ``src = (idx - t) mod n``; the step runs
``kernels.flash_attention.flash_attention`` with ``q_offset = idx S_loc``,
``k_offset = src S_loc``, ``with_lse`` and ``out_fp32``, and its partial
folds into the rank's state in the JAX package's order: its own shard
first, then ``idx - 1``, ``idx - 2``, ... . The result is ``acc /
max(l, 1e-30)`` cast to q's dtype once. A normalized kernel partial
``(out, lse)`` enters the merge as ``(out, lse, 1)``: exact, since
``acc / l = out`` and ``m + log l = lse``.

A step whose K/V shard is wholly invisible to the rank's queries (a causal
ring's future shards, a window's far past) is not launched: its partial
would be the identity ``(0, -1e30, 0)``. The K/V still rotate, so every
rank makes the same exchanges; a causal ring without a window launches
``idx + 1`` kernels on rank ``idx``.

Two transports run the one body:
  * :class:`GroupRing` over a ``torch.distributed`` process group (NCCL on
    the card, gloo on the CPU): K and V go to rank ``idx + 1`` and come
    from ``idx - 1`` by ``batch_isend_irecv`` into fresh buffers, and every
    request is waited on before a kernel reads them (the communication
    streams are not the compute stream);
  * :class:`LocalRing`: the n shards in one process on one device, each
    rank's schedule run in turn with the same offsets, skips and merge
    order: bit-equal to :class:`GroupRing` on the same device type, and the
    harness that runs a ring's kernel work at full width on one card.

Forward only: under grad it raises, as the kernel wrapper does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import collectives
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

Partial = tuple  # (acc (B, S, H, hd) fp32, m (B, S, H) fp32, l (B, S, H) fp32)


def merge_partials(a: Partial, b: Partial) -> Partial:
    """Log-sum-exp combine of two unnormalized flash partials ``(acc, m,
    l)`` over the same queries and disjoint keys (the JAX package's
    formula); ``(0, -1e30, 0)`` is the identity."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    return acc_a * ca[..., None] + acc_b * cb[..., None], m, l_a * ca + l_b * cb


def step_visible(s_loc: int, t_loc: int, *, causal: bool, window: int,
                 q_offset: int, k_offset: int) -> bool:
    """Whether any key of a K/V shard at ``k_offset`` is visible to any
    query of a shard at ``q_offset``: ``kv_block_range`` with one block per
    shard."""
    lo, hi = fa.kv_block_range(0, block_q=s_loc, block_k=t_loc, nk=1, causal=causal,
                               window=window, q_offset=q_offset, k_offset=k_offset)
    return hi > lo


class GroupRing:
    """The ring over a process group: this process is rank
    ``dist.get_rank(group)`` of ``n = dist.get_world_size(group)``; its
    exchanges are counted on the mesh axis ``axis``
    (``dist.collectives``)."""

    def __init__(self, group=None, axis: str = "seq"):
        self.group = group
        self.axis = axis
        self.n = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

    def split(self, x: torch.Tensor) -> list:
        return [x]

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def shift(self, ks: list, vs: list) -> tuple[list, list]:
        """Send this rank's K and V to rank idx + 1 and receive rank idx -
        1's, in one batch; every request is waited on before returning."""
        idx, n = self.ranks[0], self.n
        dst, src = self._global((idx + 1) % n), self._global((idx - 1) % n)
        k_in, v_in = (collectives.recv_buffer(x[0], x[0].shape, self.group) for x in (ks, vs))
        collectives.send_recv([ks[0].contiguous(), vs[0].contiguous()], [k_in, v_in], dst, src,
                              self.group, self.axis)
        return [k_in], [v_in]

    def join(self, outs: list) -> torch.Tensor:
        return outs[0]


class LocalRing:
    """The ring's n ranks emulated in one process: ``ring_flash_attention``
    takes the whole sequence, splits it into n shards along dim 1, runs each
    rank's schedule in turn and returns the whole output."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"LocalRing needs n >= 1, got {n}")
        self.n = n
        self.ranks = tuple(range(n))

    def split(self, x: torch.Tensor) -> list:
        if x.shape[1] % self.n:
            raise ValueError(f"LocalRing({self.n}): sequence length {x.shape[1]} does not "
                             "divide into its shards")
        return list(torch.chunk(x, self.n, dim=1))

    def shift(self, ks: list, vs: list) -> tuple[list, list]:
        """Rank i now holds what rank i - 1 held."""
        return ks[-1:] + ks[:-1], vs[-1:] + vs[:-1]

    def join(self, outs: list) -> torch.Tensor:
        return torch.cat(outs, dim=1)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, ring,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Ring attention over ``ring`` (module docstring): q (B, S_loc, H, hd),
    k, v (B, S_loc, KV, hd) the local shards (:class:`LocalRing`: the whole
    sequence). Returns the local output in q's dtype."""
    build.refuse_grad("ring_flash_attention", fa.FLASH_GRAD_ROUTE, q, k, v)
    qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
    s_loc, t_loc = qs[0].shape[1], ks[0].shape[1]
    if s_loc != t_loc:
        raise ValueError(f"ring_flash_attention: q and k/v shards differ in length "
                         f"({s_loc} vs {t_loc})")
    n = ring.n
    states = [None] * len(qs)
    for t in range(n):
        for j, idx in enumerate(ring.ranks):
            src = (idx - t) % n
            kw = dict(causal=causal, window=window, q_offset=idx * s_loc,
                      k_offset=src * s_loc)
            if not step_visible(s_loc, t_loc, **kw):
                continue
            out, lse = fa.flash_attention(qs[j], ks[j], vs[j], with_lse=True, out_fp32=True,
                                          **kw)
            part = (out, lse, torch.ones_like(lse))
            states[j] = part if states[j] is None else merge_partials(states[j], part)
        if t != n - 1:
            ks, vs = ring.shift(ks, vs)
    # step 0 (the own shard) is always visible: key i to query i
    return ring.join([(acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
                      for acc, _m, l in states])
