"""Model factory in torch: init, the training forward and the serving
forward for all families.

The port of ``repro.models.model``: dense (Llama, Yi, StarCoder2,
Phi-3), moe (Granite, Grok-1: ``models/moe.py`` in place of the SwiGLU),
vlm (InternVL2: projected patch embeddings prepended to the text), encdec
(SeamlessM4T: a non-causal encoder over frame embeddings, a decoder with
cross-attention), ssm (RWKV6: ``models/rwkv6.py`` time mix and channel
mix) and hybrid (Zamba2: ``models/mamba2.py`` blocks with one
weight-shared, window-bounded attention + MLP block applied every
``attn_every`` layers), and the port's own hybrid_moe (Granite-4.0-H,
:class:`~repro_torch.models.config.HybridMoeConfig`: each layer a Mamba-2
or NoPE GQA mixer with weights of its own, then the dropless MoE over the
experts the layer holds, ``moe.dropless_apply``, beside a shared SwiGLU
expert; its Mamba-2 and attention layers stacked apart, ``mamba_layers``
and ``attn_layers``, run in ``layer_types`` order). Layers are stacked on
a leading L axis, as in the
JAX package, so its parameter pytree carries over leaf for leaf
(:func:`params_from_numpy`); the layer loop is a Python loop over the
stacked tensors, each split once per forward (:func:`unstack`, one
``torch.unbind`` a leaf, so autograd writes one stacked gradient per leaf).
For serving, :func:`init_params` holds the matrices in
``cfg.activation_dtype``, cast once, where the JAX package keeps fp32
masters and casts them at every use: the same numbers. Training asks for
fp32 masters (``param_dtype=torch.float32``), as the JAX package keeps. The
vectors the JAX code reads in fp32 (norms, the RWKV decay LoRA, bonus and
mixing vectors, the Mamba2 ``a_log``, ``d_skip`` and ``dt_bias``) stay fp32.
The forward casts at use, so fp32 parameters run in every family.

:func:`forward_train` is the JAX package's: the loss of a batch through a
cross-entropy in sequence chunks (:func:`_chunked_ce`, no (B, S, V)
logits), each layer (the hybrid family: each super-block) recomputed in
backward when ``remat`` is on, as ``jax.checkpoint`` on the scan body does.
Training takes dense or chunked attention; the flash kernels have no
backward and refuse a call under grad.

Sequence parallelism: under ``dist.activations.activation_mesh(plan)``
whose ``seq`` axis resolves to n > 1 ranks for the context's length S,
:func:`forward_logits`, ``decode.prefill`` and :func:`forward_train` take
the whole batch on every rank and keep this rank's shard of S / n
positions (:func:`seq_shard`; the vlm family's patch prefix counts in S
and lands on the first ranks), with global RoPE positions. Attention runs
as the ring over the mesh's ``seq`` group (``dist.ring.
ring_flash_attention``, each step through the flash kernels) where the
JAX package's ring test holds (``attn_impl="flash"``, S above 2,048,
``S % (n chunk_size) == 0``) outside autograd; otherwise K and V are
all-gathered over ``seq`` with a reduce-scatter backward and the rank's
queries attend at their global positions. The moe family's routing
groups come from the whole sequence: where a shard holds whole groups it
routes them alone (its aux values averaged over the shards), and where a
group crosses a shard's edge its pieces route as one group, one queue and
one capacity, their dispatch summed over ``seq`` (``models/moe.py``);
RWKV6's token shifts and Mamba2's conv take the previous shard's
last rows, and their chunked scans start from the fold of the earlier
shards' state maps (``dist.seq``). The encdec family cuts its two
sequences each by its own length (:class:`EncDecShards`): the encoder
runs the source's shard (non-causal: the ring's every step, or K/V
gathered), its output is gathered over ``seq`` once a forward
(:func:`encode_memory`), and the decoder runs the target's shard with
cross-attention over the whole memory. In training the sequence's shards
sum every replicated leaf's gradient and the loss's two sums
(``parallel.holding_seq``); an encdec target that stays whole sums only
the encoder's. The last position's logits, a prefill's recurrent states
and its cache rows come from the shards that hold them: every rank
leaves with the same.

The hybrid_moe family runs on one device: under a plan, or with DTensor
parameters, its entry points raise (:func:`_one_device`). Its layers open
the profiler ranges ``mamba_mixer``, ``attention_mixer``, ``moe_route``,
``moe_experts`` and ``shared_expert`` in the forward, and again around
each region's backward (``obs.profile.ranged``), so a trace gives each layer's
backward its name too.

Model parallelism (``dist.parallel``): under a plan with parameters placed
as DTensors (``dist.placement``), every entry point takes the rank's local
shards (:func:`parallel.enter`), each layer gathers its FSDP-sharded
leaves inside its remat body (``parallel.layer``), and every family runs
its part of the ``model`` axis locally between ``copy_to_model`` and
``reduce_from_model``: attention heads (self- and cross-attention,
:func:`attention_mode`), SwiGLU columns (:func:`mlp`, every SwiGLU of
every family), experts (:func:`ffn`), RWKV6's heads and channel-mix
columns (``models/rwkv6.py``) and Mamba2's heads (``models/mamba2.py``);
the vocab tables and the vlm projection are gathered at use. The experts
take one of two routes by the JAX package's rule (``models/moe.py``):
where the plan puts each routing group's capacity on the experts' axis,
2 all-to-alls a group of a layer forward (dispatch, combine), 2 in the
backward and, under full remat, the forward's 2 again in the recompute;
elsewhere no all-to-all. Both routes sum the partial outputs with 1
all-reduce over ``model`` a layer. Heads go on
``model`` where H divides it (KV too, or each rank expands GQA for its
heads); under the ring only where both do, else the heads stay
replicated.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import threading
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import tree as tree_util
from repro_torch.device import resolve_device
from repro_torch.dist import collectives, parallel
from repro_torch.dist.activations import current_activation_plan
from repro_torch.dist.plan import mesh_coord
from repro_torch.dist.ring import GroupRing, ring_flash_attention
from repro_torch.dist.seq import GroupSeq
from repro_torch.models import layers, mamba2, moe, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.obs.profile import ranged

Params = dict
CE_CHUNK = 1024
DENSE_ATTN_MAX_SEQ = 2048  # above this, use the chunked online-softmax path
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
PORT_FAMILIES = ("hybrid_moe",)  # the port's own, beside the JAX package's six
HYBRID_MOE_DENSE_BYTES = 1 << 32   # the hybrid_moe family's dense attention scores, at most
RWKV_CHUNK = 64            # the chunked WKV's chunk and gate, fixed as in the JAX code


# =====================================================================
# init
# =====================================================================

def _dense_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> dict:
    p = {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln2": layers.rmsnorm_params(cfg.d_model, gen.device),
        "attn": layers.attention_params(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype),
    }
    if cfg.family == "moe":
        p["moe"] = moe.moe_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers, dtype)
    else:
        p["mlp"] = layers.swiglu_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype)
    return p


def _rwkv_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> dict:
    return {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln2": layers.rmsnorm_params(cfg.d_model, gen.device),
        "tm": rwkv6.time_mix_params(gen, cfg.d_model, cfg.rwkv_heads, cfg.n_layers, dtype),
        "cm": rwkv6.channel_mix_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype),
    }


def _mamba_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> dict:
    return {
        "ln": layers.rmsnorm_params(cfg.d_model, gen.device),
        "mamba": mamba2.mamba2_params(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                      cfg.ssm_head_dim, cfg.n_layers, dtype),
    }


def _hybrid_moe_ffn_params(cfg, gen: torch.Generator, dtype: torch.dtype) -> dict:
    return {
        "ln2": layers.rmsnorm_params(cfg.d_model, gen.device),
        "moe": moe.share_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.held,
                                cfg.n_layers, dtype),
        "shared": layers.swiglu_params(gen, cfg.d_model, cfg.shared_ff, cfg.n_layers, dtype),
    }


def _hybrid_moe_mamba_params(cfg, gen: torch.Generator, dtype: torch.dtype) -> dict:
    return {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "mamba": mamba2.mamba2_params(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                      cfg.ssm_head_dim, cfg.n_layers, dtype,
                                      conv_bias=cfg.conv_bias),
        **_hybrid_moe_ffn_params(cfg, gen, dtype),
    }


def _hybrid_moe_attn_params(cfg, gen: torch.Generator, dtype: torch.dtype) -> dict:
    return {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "attn": layers.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                        dtype),
        **_hybrid_moe_ffn_params(cfg, gen, dtype),
    }


def _encdec_dec_layer_params(cfg: ModelConfig, gen: torch.Generator,
                             dtype: torch.dtype) -> dict:
    def attn() -> dict:
        return layers.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                       dtype)

    return {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln_x": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln2": layers.rmsnorm_params(cfg.d_model, gen.device),
        "attn": attn(),
        "xattn": attn(),
        "mlp": layers.swiglu_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype),
    }


def _stack_layers(layer_fn, cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype,
                  n: int, cut=None, top: str = "layers") -> dict:
    """``n`` layers of ``layer_fn`` stacked on a leading axis, drawn one at a
    time into the stacked tensors, so a full-size model never has its fp32
    draws all at once; ``cut((top, *path), t)`` keeps a part of each
    layer's leaf (:func:`init_params`)."""
    stacked = None
    for i in range(n):
        layer = layer_fn(cfg, gen, dtype)
        key_paths, parts = tree_util.paths(layer), tree_util.leaves(layer)
        if cut is not None:
            parts = [cut((top,) + p, t) for p, t in zip(key_paths, parts)]
        if stacked is None:
            stacked = [t.new_empty((n,) + tuple(t.shape)) for t in parts]
        for dst, src in zip(stacked, parts):
            dst[i] = src
        del layer, parts
    return tree_util.from_leaves(key_paths, stacked)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                param_dtype: Optional[torch.dtype] = None, cut=None) -> Params:
    """Random parameters from ``seed``, made on ``device`` (``cuda`` unless
    asked otherwise) by a generator there, in the JAX package's tree,
    shapes and scales. Matrices are drawn in fp32 and stored in
    ``param_dtype``: ``cfg.activation_dtype`` by default (serving), fp32
    for training's masters (the same draws); norm scales and the vectors
    the recurrent families read in fp32 (RWKV6's decay LoRA, bonus, mixing
    vectors and group-norm affine; Mamba2's ``a_log``, ``d_skip``,
    ``dt_bias``) stay fp32.
    torch's generator cannot replay ``jax.random``: carry the JAX package's
    weights over with :func:`params_from_numpy`.
    ``cut(path, t)``, when given, takes each leaf as it is drawn (a stacked
    leaf one layer at a time, its path naming the stack) and returns the
    part to keep: ``dist.placement.init_params_local`` keeps a rank's
    shards, the draws unchanged."""
    if cfg.family not in FAMILIES + PORT_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    dev = resolve_device(device)
    dtype = cfg.activation_dtype if param_dtype is None else param_dtype
    gen = (_MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    def keep(top: str, sub: dict) -> dict:
        if cut is None:
            return sub
        key_paths = tree_util.paths(sub)
        return tree_util.from_leaves(key_paths, [cut((top,) + p, t) for p, t in
                                                 zip(key_paths, tree_util.leaves(sub))])

    params: Params = {
        "embed": keep("embed", layers.embedding_params(gen, cfg.vocab, cfg.d_model, dtype)),
        "final_norm": keep("final_norm", layers.rmsnorm_params(cfg.d_model, dev)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep("lm_head",
                                 layers.embedding_params(gen, cfg.vocab, cfg.d_model, dtype))
    fam = cfg.family
    if fam == "encdec":
        params["enc_layers"] = _stack_layers(_dense_layer_params, cfg, gen, dtype,
                                             cfg.n_enc_layers, cut, "enc_layers")
        params["layers"] = _stack_layers(_encdec_dec_layer_params, cfg, gen, dtype,
                                         cfg.n_layers, cut)
        params["enc_norm"] = keep("enc_norm", layers.rmsnorm_params(cfg.d_model, dev))
    elif fam == "ssm":
        params["layers"] = _stack_layers(_rwkv_layer_params, cfg, gen, dtype, cfg.n_layers, cut)
    elif fam == "hybrid":
        params["layers"] = _stack_layers(_mamba_layer_params, cfg, gen, dtype, cfg.n_layers,
                                         cut)
        params["shared_attn"] = keep("shared_attn", {
            "ln": layers.rmsnorm_params(cfg.d_model, dev),
            "ln2": layers.rmsnorm_params(cfg.d_model, dev),
            "attn": layers.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                            cfg.hd, dtype),
            "mlp": layers.swiglu_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype),
        })
    elif fam == "hybrid_moe":
        kinds = cfg.kinds
        for top, kind, fn in (("mamba_layers", "mamba", _hybrid_moe_mamba_params),
                              ("attn_layers", "attention", _hybrid_moe_attn_params)):
            if kind in kinds:
                params[top] = _stack_layers(fn, cfg, gen, dtype, kinds.count(kind), cut, top)
    else:
        params["layers"] = _stack_layers(_dense_layer_params, cfg, gen, dtype, cfg.n_layers, cut)
    if fam == "vlm":
        params["vis_proj"] = keep("vis_proj", {
            "w": layers.dense_init((cfg.d_model, cfg.d_model), 0.02, gen, dtype)})
    return params


def params_from_numpy(tree: dict,
                      device: Optional[Union[str, torch.device]] = None) -> Params:
    """The JAX package's parameter pytree (nested dicts of numpy arrays,
    e.g. ``jax.tree_util.tree_map(np.asarray, params)``) -> this module's
    parameters, same layouts (stacked L axis included), fp32 copies on
    ``device``."""
    dev = resolve_device(device)
    return tree_util.map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev), tree)


class _MetaGenerator:
    """Stands in for a generator on the ``meta`` device, which torch does
    not make: ``layers.dense_init`` draws nothing from it."""
    device = torch.device("meta")


def abstract_params(cfg: ModelConfig) -> Params:
    """The JAX package's parameter tree for ``cfg`` (fp32 masters, as its
    ``abstract_params`` gives them) as tensors on the ``meta`` device:
    shapes and dtypes, no storage."""
    return init_params(cfg, device="meta", param_dtype=torch.float32)


def layer_params(params: Params, i: int, stack: str = "layers") -> dict:
    """Layer ``i`` of the stacked ``params[stack]`` (views, no copy):
    ``"layers"``, or the encdec family's ``"enc_layers"``."""
    return tree_util.map(lambda t: t[i], params[stack])


def unstack(params: Params, stack: str = "layers") -> list[dict]:
    """Every layer of the stacked ``params[stack]``, each stacked leaf
    split once (``torch.unbind``: views). Under autograd the split's
    backward stacks the layers' gradients once, where ``t[i]`` views would
    each write a zero-filled gradient the size of the whole stack."""
    tree = params[stack]
    key_paths = tree_util.paths(tree)
    columns = [torch.unbind(t) for t in tree_util.leaves(tree)]
    return [tree_util.from_leaves(key_paths, [c[i] for c in columns])
            for i in range(len(columns[0]))]


# =====================================================================
# remat
# =====================================================================

class _MoeOutState(threading.local):
    """The ``save_moe_out`` policy's flags: ``naming`` inside a layer run
    under the policy, ``saving`` while its one saved op runs."""
    naming = False
    saving = False


_MOE_OUT = _MoeOutState()


def _save_moe_out_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing: save the output of the copy
    :func:`_name_moe_out` makes, recompute everything else (JAX's
    ``save_only_these_names("moe_out")``)."""
    if _MOE_OUT.saving:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _name_moe_out(m: torch.Tensor) -> torch.Tensor:
    """``checkpoint_name(m, "moe_out")``: inside a ``save_moe_out`` layer,
    an exact copy of the MoE output made under the tag, so the policy saves
    that tensor; elsewhere ``m`` itself."""
    if not _MOE_OUT.naming:
        return m
    _MOE_OUT.saving = True
    try:
        return m.clone()
    finally:
        _MOE_OUT.saving = False


def _remat(body, remat: bool, remat_policy: str = "full"):
    """``body`` recomputed in backward (``jax.checkpoint`` of a scan body):
    non-reentrant ``torch.utils.checkpoint``; ``remat_policy ==
    "save_moe_out"`` keeps the MoE output. ``remat=False``, or grad mode
    off (serving), runs ``body`` as it is; the numbers are the same."""
    if not remat or not torch.is_grad_enabled():
        return body
    body = parallel.bind(body)        # the recompute sees the forward's plan
    if remat_policy == "save_moe_out":
        def named(*args):
            _MOE_OUT.naming = True
            try:
                return body(*args)
            finally:
                _MOE_OUT.naming = False

        def contexts():
            return _ckpt.create_selective_checkpoint_contexts(_save_moe_out_policy)

        return lambda *args: _ckpt.checkpoint(named, *args, use_reentrant=False,
                                              context_fn=contexts)
    return lambda *args: _ckpt.checkpoint(body, *args, use_reentrant=False)


# =====================================================================
# attention block helpers
# =====================================================================

def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") as one matmul, in x's dtype."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul, in o's dtype."""
    h, k, d = w.shape
    return torch.matmul(o.reshape(o.shape[:-2] + (h * k,)), w.to(o.dtype).reshape(h * k, d))


# =====================================================================
# sequence parallelism
# =====================================================================

# this rank's shard of a sequence-parallel forward (``dist.seq.GroupSeq``)
_SEQ_SHARD: contextvars.ContextVar[Optional[GroupSeq]] = contextvars.ContextVar(
    "repro_torch_seq_shard", default=None)


def _seq_chunk(cfg: ModelConfig) -> int:
    """The positions a shard must hold whole multiples of: the recurrent
    scans' chunk; 1 elsewhere."""
    return {"ssm": RWKV_CHUNK, "hybrid": ssd_chunk(cfg)}.get(cfg.family, 1)


def ssd_chunk(cfg: ModelConfig) -> int:
    """The hybrid family's SSD scan chunk."""
    return min(cfg.chunk_size, 128)


class EncDecShards(NamedTuple):
    """The encdec family's shards: the source's (the encoder runs it) and
    the target's (the decoder, the loss and the last logits run it), each
    ``None`` where its sequence stays whole."""
    src: Optional[GroupSeq]
    tgt: Optional[GroupSeq]


def _cut(plan, rows: int, s: int) -> Optional[tuple[GroupSeq, slice]]:
    """This rank's ``GroupSeq`` and positions of a (rows, s) sequence where
    the plan's ``seq`` rule shards it (JAX's divisibility rule), else
    None."""
    ent = plan.resolve(s, "seq")
    if not isinstance(ent, str) or plan.axis_size(ent) == 1:
        return None
    sl = plan.local_slice(plan.spec((rows, s), ("act_batch", "seq"), align="left"),
                          (rows, s), mesh_coord(plan.mesh))[1]
    n = plan.axis_size(ent)
    return GroupSeq(n, plan.mesh.get_local_rank(ent), plan.mesh.get_group(ent), ent), sl


def seq_shard(cfg: ModelConfig,
              batch: dict) -> tuple[Optional[Union[GroupSeq, EncDecShards]], dict]:
    """Under an active plan whose ``seq`` axis resolves to n > 1 ranks for
    the batch's S positions (the vlm family's patch prefix counted in):
    this rank's ``GroupSeq`` and its slice of the batch's ``tokens``,
    ``labels`` and ``mask`` (and of ``vis_embeds``: the prefix lands on
    the first ranks); else ``(None, batch)``. The encdec family cuts
    ``src_embeds`` by the source's length and ``tokens``/``labels``/
    ``mask`` by the target's, each where the plan shards it, and returns
    :class:`EncDecShards` (``None`` where neither is cut). Where the
    plan's batch rows run over ``seq`` (the federated round's intra-client
    data axis), the sequence stays whole. Raises where the port has no
    path: a recurrent shard off its scan's chunk (module docstring)."""
    plan = current_activation_plan()
    if plan is None or plan.axis_size("seq") == 1:
        return None, batch
    view = parallel.current()
    if view is not None and "seq" in view.batch_axes:
        return None, batch
    text_keys = ("tokens", "labels", "mask")
    if cfg.family == "encdec":
        src = batch["src_embeds"]
        cuts = (_cut(plan, src.shape[0], src.shape[1]),
                _cut(plan, *batch["tokens"].shape) if "tokens" in batch else None)
        if cuts == (None, None):
            return None, batch
        out = dict(batch)
        if cuts[0] is not None:
            out["src_embeds"] = src[:, cuts[0][1]]
        if cuts[1] is not None:
            out.update({k: batch[k][:, cuts[1][1]] for k in text_keys if k in batch})
        return EncDecShards(*(None if c is None else c[0] for c in cuts)), out
    tokens = batch["tokens"]
    n_vis = batch["vis_embeds"].shape[1] if cfg.family == "vlm" else 0
    s = n_vis + tokens.shape[1]
    cut = _cut(plan, tokens.shape[0], s)
    if cut is None:
        return None, batch           # not sharded: every rank runs the whole sequence
    shard, sl = cut
    n = shard.n
    if (s // n) % _seq_chunk(cfg):
        raise ValueError(
            f"a sequence-parallel {cfg.family} forward over {n} ranks needs each shard's "
            f"{s // n} positions to be a multiple of its scan's chunk {_seq_chunk(cfg)}; "
            f"got S={s}")
    text = slice(min(max(sl.start - n_vis, 0), s - n_vis), max(sl.stop - n_vis, 0))
    out = {**batch, **{k: batch[k][:, text] for k in text_keys if k in batch}}
    if n_vis:
        out["vis_embeds"] = batch["vis_embeds"][:, min(sl.start, n_vis):min(sl.stop, n_vis)]
    return shard, out


def decoder_shard(shard) -> Optional[GroupSeq]:
    """The shard the decoder, the loss and the last logits run under: a
    :func:`seq_shard` result's, the target's for the encdec family."""
    return shard.tgt if isinstance(shard, EncDecShards) else shard


@contextlib.contextmanager
def _holding(shard: Optional[GroupSeq], sums: Optional[str] = None):
    """``shard`` as the active sequence shard (None: the sequence whole),
    and the view's gradient and loss sums over its axis, or over ``sums``
    where the shard is None (an encdec encoder that runs its whole source
    for a target cut over ``seq``: each rank's gradient is a partial)."""
    token = _SEQ_SHARD.set(shard)
    try:
        with parallel.holding_seq(sums if shard is None else shard.axis):
            yield
    finally:
        _SEQ_SHARD.reset(token)


def _positions(x: torch.Tensor) -> torch.Tensor:
    """The global positions of x's (B, S, ...) rows: ``arange(S)``, or this
    rank's ``idx * S_loc + arange(S_loc)`` in a sequence-parallel forward."""
    shard = _SEQ_SHARD.get()
    start = 0 if shard is None else shard.idx * x.shape[1]
    return torch.arange(start, start + x.shape[1], device=x.device)


def gather_seq(x: torch.Tensor, shard: GroupSeq) -> torch.Tensor:
    """All shards of x (B, S_loc, ...) in sequence order, on every rank."""
    return collectives.all_gather(x, shard.group, shard.axis, dim=1)


def from_last_shard(x: torch.Tensor, shard: Optional[GroupSeq]) -> torch.Tensor:
    """x as the last seq rank holds it (the sequence's last position),
    broadcast to every rank of the group."""
    if shard is not None:
        x = collectives.broadcast(x, shard.n - 1, shard.group, shard.axis)
    return x


def tail_of_sequence(x: torch.Tensor, m: int, shard: Optional[GroupSeq]) -> torch.Tensor:
    """The sequence's last ``m`` positions of x (B, S_loc, ...) on every
    rank (a prefill's cache rows): broadcast from the last rank where its
    shard holds them all, else every shard gathered."""
    if shard is None:
        return x[:, x.shape[1] - m:]
    if m <= x.shape[1]:
        return from_last_shard(x[:, x.shape[1] - m:], shard)
    x = gather_seq(x, shard)
    return x[:, x.shape[1] - m:]


def _ring_path(cfg: ModelConfig, x: torch.Tensor, n: int) -> bool:
    """Whether a sequence-parallel attention of the shard x over S = n
    S_loc positions takes the ring: flash, S above 2,048 and S % (n chunk)
    == 0 (the JAX package's ring test), and x outside autograd (the ring
    has no backward)."""
    s = x.shape[1] * n
    return (cfg.attn_impl == "flash" and s > DENSE_ATTN_MAX_SEQ
            and s % (n * cfg.chunk_size) == 0
            and not (torch.is_grad_enabled() and x.requires_grad))


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int, causal_skip: bool, q_offset: int = 0,
            head_map: Optional[torch.Tensor] = None,
            scale: Optional[float] = None,
            dense_max_seq: int = DENSE_ATTN_MAX_SEQ) -> torch.Tensor:
    """The JAX package's dispatch by the keys' length T: dense at T <=
    ``dense_max_seq`` (2,048) or T off the chunk, else flash
    (``attn_impl="flash"``) or chunked attention; queries at ``q_offset``
    onwards, scores times ``scale`` (default 1/sqrt(hd); the flash kernels
    take only that)."""
    t = k.shape[1]
    if t <= dense_max_seq or t % cfg.chunk_size != 0:
        return layers.dense_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                      head_map=head_map, scale=scale)
    if cfg.attn_impl == "flash":
        if scale is not None:
            raise ValueError("flash attention takes no score scale but 1/sqrt(hd)")
        if head_map is not None:
            k, v = k.index_select(2, head_map), v.index_select(2, head_map)
        return layers.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return layers.chunked_attention(q, k, v, chunk=cfg.chunk_size, causal=causal, window=window,
                                    causal_skip=causal_skip, q_offset=q_offset,
                                    head_map=head_map, scale=scale)


def attention_mode(cfg: ModelConfig, p: dict, *, ring: bool = False) -> tuple[str, dict]:
    """The rank's attention layout (``dist.parallel.heads_mode``) and the
    weights it computes with: under the ring with heads that stay
    replicated, the query and output weights gathered over ``model``; in
    ``"expand"`` mode the replicated wk/wv, whose gradient each rank holds
    a part of (its heads'), summed over ``model`` in backward."""
    mode = parallel.heads_mode(cfg, p["wq"].shape[1], p["wk"].shape[1], ring=ring)
    if mode == "gather":
        p = dict(p, wq=collectives.gather_model(p["wq"], 1),
                 wo=collectives.gather_model(p["wo"], 0))
        mode = "whole"
    elif mode == "expand":         # every rank reads the whole wk/wv for its own heads
        p = dict(p, wk=collectives.copy_to_model(p["wk"]), wv=collectives.copy_to_model(p["wv"]))
    return mode, p


def expand_local_kv(cfg: ModelConfig, mode: str, k: torch.Tensor, v: torch.Tensor,
                    h_local: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``"expand"`` mode: the K/V (B, T, KV, hd) of each of the rank's
    ``h_local`` q heads (B, T, h_local, hd), so the kernels' head map
    ``h // g`` is the identity; else k and v as they are."""
    if mode != "expand":
        return k, v
    idx = parallel.local_kv_index(cfg, h_local, k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _self_attention(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, causal: bool, positions: torch.Tensor,
    causal_skip: bool = False, window_override: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out, k_rope, v) — k/v for optional cache building.
    Short or non-divisible sequences take dense attention, long ones flash
    (``attn_impl="flash"``) or chunked attention, as in the JAX package;
    ``causal_skip`` goes to the chunked path. ``window_override`` replaces
    the config's window (the hybrid family's shared attention).

    In a sequence-parallel forward x is the rank's shard and the returned
    k/v are too. Attention takes the ring (:func:`_ring_path`), or gathers
    K and V over ``seq`` (a reduce-scatter backward) and runs the rank's
    queries at their global positions against the whole sequence, by the
    dispatch of the whole length."""
    window = cfg.sliding_window if window_override is None else window_override
    shard = _SEQ_SHARD.get()
    ring = shard is not None and _ring_path(cfg, x, shard.n)
    mode, p = attention_mode(cfg, p, ring=ring)
    if mode != "whole":
        x = collectives.copy_to_model(x)
    q = layers.apply_rope(_proj_heads(x, p["wq"]), positions, cfg.rope_theta)
    k = layers.apply_rope(_proj_heads(x, p["wk"]), positions, cfg.rope_theta)
    v = _proj_heads(x, p["wv"])
    if ring:
        kq, vq = expand_local_kv(cfg, mode, k, v, q.shape[2])
        o = ring_flash_attention(q, kq, vq, ring=GroupRing(shard.group, shard.axis),
                                 causal=causal, window=window)
    elif shard is not None:            # K/V gathered over seq, then expanded per chunk
        head_map = (parallel.local_kv_index(cfg, q.shape[2], q.device) if mode == "expand"
                    else None)
        kg = collectives.gather_fsdp(k, shard.axis, 1)
        vg = collectives.gather_fsdp(v, shard.axis, 1)
        o = _attend(cfg, q, kg, vg, causal=causal, window=window, causal_skip=causal_skip,
                    q_offset=shard.idx * x.shape[1], head_map=head_map)
    else:
        o = _attend(cfg, q, *expand_local_kv(cfg, mode, k, v, q.shape[2]), causal=causal,
                    window=window, causal_skip=causal_skip)
    out = _merge_heads(o, p["wo"])
    if mode != "whole":
        out = collectives.reduce_from_model(out)
    return out, k, v


def ffn(cfg: ModelConfig, p: dict, y: torch.Tensor, *,
        capacity_factor: Optional[float] = None) -> tuple[torch.Tensor, dict]:
    """The layer's feed-forward of y (B, S, D): the MoE (with its aux
    values) for the moe family, else the SwiGLU (no aux).
    ``capacity_factor`` overrides the config's (decode passes n_experts:
    no drops at S = 1)."""
    if cfg.family == "moe":
        cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
        mp = p["moe"]
        # the routing groups, and so the route's capacity, are the whole
        # sequence's: in a sequence-parallel forward a group may span shards
        shard = _SEQ_SHARD.get()
        s = y.shape[1] * (1 if shard is None else shard.n)
        route = moe.expert_route(cfg.n_experts, mp["wg"].shape[0], s, cfg.top_k, cf)
        if route is None:
            return moe.moe_apply(mp, y, top_k=cfg.top_k, capacity_factor=cf, seq=shard)
        # expert parallelism: every rank routes every token, and the router's
        # and the input's gradients sum the ranks' parts. The route is the
        # JAX package's rule (moe.expert_route): the all-to-all route where
        # the plan puts each group's capacity on the experts' axis (2
        # all-to-alls a routing group forward, 2 more in the backward, and
        # the 2 again in full remat's recompute, which runs each group to its
        # combine), else the rank's experts' slots; either way the partial
        # outputs are summed by 1 all-reduce over model a layer
        mp = dict(mp, router=collectives.copy_to_model(mp["router"]))
        out, aux = moe.moe_apply(mp, collectives.copy_to_model(y), top_k=cfg.top_k,
                                 capacity_factor=cf, route=route, seq=shard)
        return collectives.reduce_from_model(out), aux
    return mlp(cfg, p["mlp"], y), {}


def mlp(cfg: ModelConfig, p: dict, y: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of y (B, S, D) with ``p``'s ``wg``/``wu``/``wd``: whole,
    or the rank's columns between ``copy_to_model`` and
    ``reduce_from_model`` when they are sharded on ``model``."""
    if p["wg"].shape[-1] == cfg.d_ff:
        return layers.swiglu(p, y)
    return collectives.reduce_from_model(layers.swiglu(p, collectives.copy_to_model(y)))


def _dense_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                 causal_skip: bool = False) -> tuple[torch.Tensor, dict]:
    positions = _positions(x)
    h, _, _ = _self_attention(
        cfg, p["attn"], layers.rmsnorm(p["ln1"], x, cfg.norm_eps),
        causal=True, positions=positions, causal_skip=causal_skip,
    )
    x = x + h
    m, aux = ffn(cfg, p, layers.rmsnorm(p["ln2"], x, cfg.norm_eps))
    if cfg.family == "moe":
        m = _name_moe_out(m)
    return x + m, aux


def _forward_dense(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                   causal_skip: bool = False, remat: bool = False,
                   remat_policy: str = "full") -> tuple[torch.Tensor, dict]:
    """The decoder stack of the dense, moe and vlm families; the aux
    values averaged over the layers (none for dense and vlm)."""
    def body(h, lp):
        return _dense_block(cfg, parallel.layer(lp), h, causal_skip=causal_skip)

    step = _remat(body, remat, remat_policy)
    auxs = []
    for lp in unstack(params):
        x, aux = step(x, lp)
        auxs.append(aux)
    return x, {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def _rwkv_block(cfg: ModelConfig, p: dict, x: torch.Tensor, x_tm: torch.Tensor,
                x_cm: torch.Tensor, s0: torch.Tensor, seq=None):
    """One RWKV6 layer over x (B, T, D) from the carries ``x_tm``, ``x_cm``
    (B, D) and the WKV state ``s0``; the chunked WKV when T is a multiple
    of 64 above 1. Returns (x, tm carry, cm carry, state). ``seq`` (a
    ``dist.seq`` transport: the active shard's, or ``LocalSeq(n)``) runs x
    as sequence shards, each on the chunked WKV."""
    t = x.shape[1]
    seq = _SEQ_SHARD.get() if seq is None else seq
    h, tm_carry, s_new = rwkv6.time_mix_apply(
        p["tm"], layers.rmsnorm(p["ln1"], x, cfg.norm_eps), x_tm, s0, cfg.rwkv_heads,
        chunked=t % RWKV_CHUNK == 0 and t > 1, chunk=RWKV_CHUNK, seq=seq,
    )
    x = x + h
    c, cm_carry = rwkv6.channel_mix_apply(p["cm"], layers.rmsnorm(p["ln2"], x, cfg.norm_eps),
                                          x_cm, d_ff=cfg.d_ff, seq=seq)
    return x + c, tm_carry, cm_carry, s_new


def _mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 state: Optional[dict] = None, seq=None) -> tuple[torch.Tensor, dict]:
    """One Mamba2 layer (``seq`` as in :func:`_rwkv_block`)."""
    t = x.shape[1]
    chunk = ssd_chunk(cfg)
    h, new_state = mamba2.mamba2_apply(
        p["mamba"], layers.rmsnorm(p["ln"], x, cfg.norm_eps),
        d_inner=cfg.d_inner, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        state=state, chunk=chunk, chunked=t % chunk == 0 and t > 1,
        seq=_SEQ_SHARD.get() if seq is None else seq,
    )
    return x + h, new_state


def rwkv_heads(cfg: ModelConfig, lp: dict) -> int:
    """The WKV heads a rank runs with layer ``lp``'s time mix as it holds
    it: all of them, or its own under tensor parallelism."""
    return lp["tm"]["wr"].shape[-1] * cfg.rwkv_heads // cfg.d_model


def rwkv_state(cfg: ModelConfig, b: int, device,
               heads: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's zero token-shift carry (B, D) and WKV state (B, H, N, N)
    fp32, of ``heads`` heads (default all)."""
    n = cfg.d_model // cfg.rwkv_heads
    heads = cfg.rwkv_heads if heads is None else heads
    return (torch.zeros((b, cfg.d_model), dtype=cfg.activation_dtype, device=device),
            torch.zeros((b, heads, n, n), dtype=torch.float32, device=device))


def _forward_rwkv(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                  remat: bool = False) -> tuple[torch.Tensor, dict]:
    def body(h, lp):
        lp = parallel.layer(lp)
        x_prev, s0 = rwkv_state(cfg, h.shape[0], h.device, rwkv_heads(cfg, lp))
        return _rwkv_block(cfg, lp, h, x_prev, x_prev, s0)[0]

    step = _remat(body, remat)
    for lp in unstack(params):
        x = step(x, lp)
    return x, {}


def shared_window(cfg: ModelConfig) -> int:
    """The hybrid family's shared-attention window: bounded even without a
    configured one, so long-context serving stays O(window)."""
    return cfg.sliding_window or 4096


def _shared_attn_block(cfg: ModelConfig, shared: dict, h: torch.Tensor,
                       positions: torch.Tensor, *, causal_skip: bool = False,
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hybrid family's shared attention + MLP over h (B, S, D);
    returns (h, k_rope, v)."""
    a, k, v = _self_attention(
        cfg, shared["attn"], layers.rmsnorm(shared["ln"], h, cfg.norm_eps),
        causal=True, positions=positions, causal_skip=causal_skip,
        window_override=shared_window(cfg),
    )
    h = h + a
    return h + mlp(cfg, shared["mlp"], layers.rmsnorm(shared["ln2"], h, cfg.norm_eps)), k, v


def _forward_hybrid(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                    causal_skip: bool = False, remat: bool = False) -> tuple[torch.Tensor, dict]:
    """``n_layers // attn_every`` super-blocks: ``attn_every`` Mamba2
    layers, then the shared attention block; with ``remat`` each
    super-block is recomputed in backward, as the JAX package's scan body."""
    positions = _positions(x)
    shared = params["shared_attn"]

    def body(h, *super_layers):
        for lp in super_layers:
            h, _ = _mamba_block(cfg, parallel.layer(lp), h)
        return _shared_attn_block(cfg, parallel.tree(shared, "shared_attn"), h, positions,
                                  causal_skip=causal_skip)[0]

    step = _remat(body, remat)
    layer_list = unstack(params)
    for j in range(cfg.n_layers // cfg.attn_every):
        x = step(x, *layer_list[j * cfg.attn_every:(j + 1) * cfg.attn_every])
    return x, {}


def _one_device(cfg: ModelConfig, params: Params) -> None:
    """The hybrid_moe family runs on one device: no plan, no DTensor."""
    if cfg.family in PORT_FAMILIES and (current_activation_plan() is not None or any(
            parallel._is_dtensor(t) for t in tree_util.leaves(params))):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family has no sharding rule (dist.sharding) and "
            "no expert-parallel exchange for its expert share; run it on one device, "
            "outside activation_mesh, with plain tensors")


def _hybrid_moe_attention(cfg, p: dict, x: torch.Tensor):
    """GQA self-attention with no position embedding (NoPE) and the
    configured score scale (``attention_multiplier``). Dense while the
    (B, H, S, S) fp32 scores take at most ``HYBRID_MOE_DENSE_BYTES`` (at
    4,096 positions a dozen launches where the chunked path's online
    softmax takes some 4,000 a pass, and about as much memory in
    backward), else chunked."""
    q, k, v = (_proj_heads(x, p[w]) for w in ("wq", "wk", "wv"))
    b, s, h, _ = q.shape
    o = _attend(cfg, q, k, v, causal=True, window=cfg.sliding_window, causal_skip=False,
                scale=cfg.attention_multiplier or None,
                dense_max_seq=math.isqrt(HYBRID_MOE_DENSE_BYTES // (4 * b * h)))
    return _merge_heads(o, p["wo"])


def shared_expert(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The hybrid_moe family's shared SwiGLU expert, on every token."""
    return layers.swiglu(p, x)


def _hybrid_moe_block(cfg, p: dict, x: torch.Tensor, kind: str
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One hybrid_moe layer: x + r mixer(norm(x)), then + r (held experts'
    part + shared expert)(norm(x)), r the residual multiplier. Returns (x,
    the held experts' loads (n,))."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        chunk, t = cfg.chunk_size, h.shape[1]
        a = ranged("mamba_mixer", lambda z: mamba2.mamba2_apply(
            p["mamba"], z, d_inner=cfg.d_inner, d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, chunk=chunk, chunked=t % chunk == 0 and t > 1)[0], h)
    else:
        a = ranged("attention_mixer",
                    lambda z: _hybrid_moe_attention(cfg, p["attn"], z), h)
    x = x + a * cfg.residual_multiplier
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    m, loads = moe.dropless_apply(p["moe"], h, top_k=cfg.top_k, held=cfg.held)
    m = m + ranged("shared_expert", lambda z: shared_expert(p["shared"], z), h)
    return x + m * cfg.residual_multiplier, loads


def _forward_hybrid_moe(cfg, params: Params, x: torch.Tensor, *,
                        remat: bool = False) -> tuple[torch.Tensor, dict]:
    """The layers in ``layer_types`` order, each recomputed in backward with
    ``remat``; aux: the held experts' routed slots and largest load, by
    layer (fp32 counts)."""
    stacks = {kind: iter(unstack(params, top)) for kind, top in
              (("mamba", "mamba_layers"), ("attention", "attn_layers")) if top in params}
    loads = []
    for kind in cfg.kinds:
        step = _remat(lambda h, lp, kind=kind: _hybrid_moe_block(cfg, lp, h, kind), remat)
        x, ld = step(x, next(stacks[kind]))
        loads.append(ld)
    loads = torch.stack(loads)
    return x, {"moe_routed": loads.sum(-1), "moe_max_load": loads.amax(-1)}


def _forward_encoder(cfg: ModelConfig, params: Params, src: torch.Tensor, *,
                     remat: bool = False) -> torch.Tensor:
    """The encdec family's encoder: non-causal self-attention over the
    source frames (the rank's shard under a sequence-parallel forward, at
    its global positions), then ``enc_norm``."""
    positions = _positions(src)

    def body(h, lp):
        lp = parallel.layer(lp, "enc_layers")
        a, _, _ = _self_attention(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            causal=False, positions=positions,
        )
        h = h + a
        return h + mlp(cfg, lp["mlp"], layers.rmsnorm(lp["ln2"], h, cfg.norm_eps))

    step = _remat(body, remat)
    h = src
    for lp in unstack(params, "enc_layers"):
        h = step(h, lp)
    return layers.rmsnorm(parallel.tree(params["enc_norm"], "enc_norm"), h, cfg.norm_eps)


def encode_memory(cfg: ModelConfig, params: Params, src: torch.Tensor,
                  shards: Optional[EncDecShards], *, remat: bool = False) -> torch.Tensor:
    """The encoder's output (B, S_src, D), whole on every rank. The encoder
    runs under the source's shard (its leaves' gradients summed over
    ``seq`` wherever either sequence is cut); where the source is cut, its
    output is all-gathered over ``seq`` once a forward, outside the layer
    bodies (so no recompute gathers it again). Backward of the gather:
    with the target cut too, each rank's gradient of the whole memory is a
    partial (its target positions') and a reduce-scatter sums them; with
    the target whole, every rank's is the same and the rank keeps its
    block."""
    if shards is None:
        return _forward_encoder(cfg, params, src, remat=remat)
    src_shard = shards.src
    with _holding(src_shard, (src_shard or shards.tgt).axis):
        mem = _forward_encoder(cfg, params, src, remat=remat)
    if src_shard is None:
        return mem
    if shards.tgt is not None:
        return collectives.gather_fsdp(mem, src_shard.axis, 1)
    return collectives.gather_replicated(mem, src_shard.axis, 1)


def cross_memory(cfg: ModelConfig, p: dict, mem: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention k/v (B, S_src, KV, hd) of the
    encoder output ``mem``; under tensor parallelism the rank's KV heads
    (the memory enters through ``copy_to_model``: every layer reads it
    for its own heads), or every head for ``"expand"`` mode."""
    mode, p = attention_mode(cfg, p)
    if mode != "whole":
        mem = collectives.copy_to_model(mem)
    return _proj_heads(mem, p["wk"]), _proj_heads(mem, p["wv"])


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, mem_k: torch.Tensor,
                     mem_v: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) attends, without a mask or RoPE, to the encoder's k/v
    (B, S_src, KV, hd) of :func:`cross_memory`; dense attention, as in the
    JAX package. Under tensor parallelism the rank's q heads, then
    ``wo``'s rows and ``reduce_from_model``."""
    mode = parallel.heads_mode(cfg, p["wq"].shape[1], mem_k.shape[2])
    if mode != "whole":
        x = collectives.copy_to_model(x)
    q = _proj_heads(x, p["wq"])
    o = layers.dense_attention(q, *expand_local_kv(cfg, mode, mem_k, mem_v, q.shape[2]),
                               causal=False)
    out = _merge_heads(o, p["wo"])
    return out if mode == "whole" else collectives.reduce_from_model(out)


def _forward_encdec(cfg: ModelConfig, params: Params, src: torch.Tensor,
                    tgt: torch.Tensor, *, remat: bool = False,
                    shards: Optional[EncDecShards] = None) -> tuple[torch.Tensor, dict]:
    """The encoder over ``src``, then the decoder over ``tgt`` with
    cross-attention to the whole memory. Under ``shards`` the caller holds
    the target's shard (:func:`decoder_shard`)."""
    mem = encode_memory(cfg, params, src, shards, remat=remat)
    positions = _positions(tgt)

    def body(h, lp, mem):
        lp = parallel.layer(lp)
        a, _, _ = _self_attention(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            causal=True, positions=positions,
        )
        h = h + a
        xp = lp["xattn"]
        h = h + _cross_attention(cfg, xp, layers.rmsnorm(lp["ln_x"], h, cfg.norm_eps),
                                 *cross_memory(cfg, xp, mem))
        return h + mlp(cfg, lp["mlp"], layers.rmsnorm(lp["ln2"], h, cfg.norm_eps))

    step = _remat(body, remat)
    h = tgt
    for lp in unstack(params):
        h = step(h, lp, mem)
    return h, {}


def embed_inputs(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """The decoder input (B, S, D) of every family but encdec: the
    embedded ``batch["tokens"]``, and for vlm the projected
    ``batch["vis_embeds"]`` (B, n_vis, D) in front of them."""
    dtype = cfg.activation_dtype
    x = layers.embed(embed_table(params), batch["tokens"], dtype)
    if cfg.family == "hybrid_moe":
        x = x * cfg.embedding_multiplier
    if cfg.family == "vlm":
        w = parallel.whole(params["vis_proj"]["w"], ("vis_proj", "w"))
        vis = torch.matmul(batch["vis_embeds"].to(dtype), w.to(dtype))
        x = torch.cat([vis, x], dim=1)
    return x


def lm_head(cfg: ModelConfig, params: Params) -> dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def embed_table(params: Params) -> dict:
    """``params["embed"]`` whole, as the rank uses it (``parallel.whole``)."""
    return {"table": parallel.whole(params["embed"]["table"], ("embed", "table"))}


def head_table(cfg: ModelConfig, params: Params) -> dict:
    """The unembedding table whole, as the rank uses it."""
    top = "embed" if cfg.tie_embeddings else "lm_head"
    return {"table": parallel.whole(params[top]["table"], (top, "table"))}


def final_norm(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    return layers.rmsnorm(parallel.tree(params["final_norm"], "final_norm"), h, cfg.norm_eps)


def forward_logits(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """Last-position logits (B, V) fp32 of ``batch``: ``tokens`` (B, S),
    with ``vis_embeds`` (B, n_vis, D) for vlm, or ``src_embeds``
    (B, S_src, D) and the target ``tokens`` for encdec. Sequence-parallel
    under a seq plan (module docstring): every rank passes the whole batch
    and gets the same logits. Under a model-parallel plan (``params`` as
    DTensors, ``dist.placement``) every rank computes with its shards and
    gets the same logits."""
    _one_device(cfg, params)
    view, params, batch = parallel.enter(cfg, params, batch)
    with parallel.holding(view):
        return _forward_logits(cfg, params, batch)


def _forward_logits(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    shards, batch = seq_shard(cfg, batch)
    shard = decoder_shard(shards)
    with _holding(shard):
        if cfg.family == "encdec":
            src = batch["src_embeds"].to(cfg.activation_dtype)
            tgt = layers.embed(embed_table(params), batch["tokens"], cfg.activation_dtype)
            h, _ = _forward_encdec(cfg, params, src, tgt, shards=shards)
        else:
            h, _ = _decoder_stack(cfg, params, embed_inputs(cfg, params, batch))
    h = final_norm(cfg, params, h[:, -1:, :])
    logits = layers.unembed(head_table(cfg, params), h)[:, 0, :]
    if cfg.family == "hybrid_moe":
        logits = logits / cfg.logits_scaling
    return from_last_shard(logits, shard)


def _decoder_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   **kw) -> tuple[torch.Tensor, dict]:
    """The layers of every family but encdec over the embedded x."""
    if cfg.family == "ssm":
        return _forward_rwkv(cfg, params, x, remat=kw.get("remat", False))
    if cfg.family == "hybrid":
        kw.pop("remat_policy", None)
        return _forward_hybrid(cfg, params, x, **kw)
    if cfg.family == "hybrid_moe":
        return _forward_hybrid_moe(cfg, params, x, remat=kw.get("remat", False))
    return _forward_dense(cfg, params, x, **kw)


# =====================================================================
# training
# =====================================================================

def _ce_chunk(table: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor, logits_scaling: float = 1.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's masked NLL sum and mask sum, fp32: the chunk's logits
    (``layers.unembed``, divided by ``logits_scaling`` where it is not 1),
    logsumexp minus the gold logit."""
    logits = layers.unembed({"table": table}, h)                  # (chunk, V) fp32
    if logits_scaling != 1.0:
        logits = logits / logits_scaling
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def _chunked_ce(cfg: ModelConfig, params: Params, h: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, ce_chunk: int = CE_CHUNK) -> torch.Tensor:
    """Cross-entropy of h (B, S, D) against ``labels`` (B, S) under the
    fp32 ``mask``, without a (B, S, V) logits tensor: ``ce_chunk``
    positions at a time (one chunk when S does not divide), each chunk
    recomputed in backward under grad (``jax.checkpoint(body)`` in the JAX
    package), so no chunk's logits outlive it. A chunk runs one batch row
    at a time: its logits are (chunk, V), where one product over the
    chunk's rows would fold B x chunk positions into one dim (at B x chunk
    = S the dry run's gate reads that dim as the whole sequence). The sums
    add in chunk order, rows within; the loss is their ratio, over at
    least 1. Under a model-parallel plan the table is gathered once, before
    the chunks, and the two sums are summed over the batch's axes and the
    sequence's shards (an encdec target that stays whole: the batch's axes
    only, since every rank holds the same positions)."""
    table = head_table(cfg, params)["table"]
    s = h.shape[1]
    chunk = min(ce_chunk, s)
    if s % max(chunk, 1):
        chunk = s
    step = _remat(_ce_chunk, True)
    scaling = cfg.logits_scaling if cfg.family == "hybrid_moe" else 1.0
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    # a shard with no text positions (the vlm prefix's) runs one empty chunk:
    # the table's gradient, and the collectives in its backward, on every rank
    for c0 in range(0, s, chunk) if s else (0,):
        for r in range(h.shape[0]):
            nll, m = step(table, h[r, c0:c0 + chunk], labels[r, c0:c0 + chunk],
                          mask[r, c0:c0 + chunk], scaling)
            total = total + nll
            denom = denom + m
    total, denom = parallel.batch_sum(total), parallel.batch_sum(denom)
    return total / torch.clamp(denom, min=1.0)


def forward_train(cfg: ModelConfig, params: Params, batch: dict, *,
                  causal_skip: bool = False, remat: bool = True,
                  remat_policy: str = "full") -> tuple[torch.Tensor, dict]:
    """Returns (loss, metrics) of ``batch``: ``tokens``, ``labels`` and
    ``mask`` (B, S), with ``vis_embeds`` (B, n_vis, D) for vlm (the patch
    positions are dropped before the loss) or ``src_embeds`` (B, S_src, D)
    for encdec. ``metrics["loss"]`` is the cross-entropy; the MoE family's
    loss adds ``0.01 lb_loss + 1e-3 z_loss`` and its metrics carry the aux
    values. ``remat`` recomputes each layer in backward (``remat_policy
    "save_moe_out"`` keeps the MoE output); the numbers are the same
    without it. Under a model-parallel plan (``params`` as DTensors) every
    rank passes the global batch, keeps its rows and returns the global
    batch's loss; the gradients of the DTensor leaves come back as DTensors
    with their placements."""
    _one_device(cfg, params)
    view, params, batch = parallel.enter(cfg, params, batch, train=True)
    with parallel.holding(view):
        return _forward_train(cfg, params, batch, causal_skip=causal_skip, remat=remat,
                              remat_policy=remat_policy)


def _forward_train(cfg: ModelConfig, params: Params, batch: dict, *, causal_skip: bool,
                   remat: bool, remat_policy: str) -> tuple[torch.Tensor, dict]:
    dtype = cfg.activation_dtype
    fam = cfg.family
    shards, batch = seq_shard(cfg, batch)
    with _holding(decoder_shard(shards)):
        if fam == "encdec":
            src = batch["src_embeds"].to(dtype)
            tgt = layers.embed(embed_table(params), batch["tokens"], dtype)
            h, aux = _forward_encdec(cfg, params, src, tgt, remat=remat, shards=shards)
        else:
            h, aux = _decoder_stack(cfg, params, embed_inputs(cfg, params, batch),
                                    causal_skip=causal_skip, remat=remat,
                                    remat_policy=remat_policy)
            if fam == "vlm":               # the patch positions this rank holds
                h = h[:, batch["vis_embeds"].shape[1]:, :]
        h = final_norm(cfg, params, h)
        loss = _chunked_ce(cfg, params, h, batch["labels"], batch["mask"].to(torch.float32))
        # each shard's aux values are a mean over its routing groups, or,
        # where groups cross the shards, the whole sequence's on every shard:
        # a mean over seq with an identity backward either way, whose
        # gradient the groups' sums over seq then add up once
        aux = {k: parallel.seq_mean(v) for k, v in aux.items()}
    metrics = {"loss": loss}
    if "lb_loss" in aux:
        loss = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    metrics.update(aux)
    return loss, metrics
