"""Plain float32 reference of a granitemoehybrid (Granite-4.0-H) language
model's loss and gradients, on a share of its experts.

Written from the public ``granitemoehybrid`` equations (Hugging Face
transformers' ``modeling_granitemoehybrid.py``), in plain torch: no
kernels, no cache, no batching beyond the one sequence batch it is given.
It imports nothing of the program under test; the program's parameters
come in as a nested dict of tensors (layout below) and the sizes as a dict
of the published ``config.json`` keys.

A layer (``layer_types[i]``, "mamba" or "attention")::

    h = x + r * mixer(rmsnorm(x))
    out = h + r * (moe(rmsnorm(h)) + shared_mlp(rmsnorm(h)))

with r = ``residual_multiplier``; the embeddings are multiplied by
``embedding_multiplier``, the logits divided by ``logits_scaling``, and the
loss is the mean next-token cross-entropy over every position.

- Mamba-2 mixer (one group): ``in_proj`` to [z, xBC, dt]; a depthwise
  causal conv of width ``mamba_d_conv`` with bias over xBC, then SiLU;
  dt = softplus(dt + dt_bias), A = -exp(A_log); the state-space scan by
  the Mamba-2 paper's chunked "minimal" SSD algorithm (Dao and Gu,
  arXiv:2405.21060, Listing 1) at ``mamba_chunk_size``; y + D x; the gated
  RMSNorm (y * silu(z), then RMSNorm over the inner width); ``out_proj``.
- Attention mixer: grouped-query attention without a position embedding
  (``position_embedding_type`` "nope"), causal, scores times
  ``attention_multiplier``.
- MoE: logits = x W_router over all ``num_local_experts``; the top
  ``num_experts_per_tok`` logits, softmaxed over those k, gate their
  experts (SwiGLU of width ``intermediate_size``: silu(x W_g) * (x W_u)
  W_d). No token is dropped.
- Shared MLP: a SwiGLU of width ``shared_intermediate_size`` on every
  token.

Departures from the published model, each also the program's:

- the expert share: the layer holds experts ``experts_held`` = [lo, hi)
  of the router's outputs, and only their terms enter the sum; what the
  other experts add is left out (an expert-parallel deployment's chip
  computing its own part, with no exchange);
- the vocabulary is whatever rows the embedding table holds (a slice of
  the published one); the logits and the loss are over those rows;
- float32 throughout, TF32 off (:func:`no_tf32`); the release is bf16;
- no auxiliary router loss.

Parameters (the program's tree; stacked leaves lead with the layer's
index among the layers of its kind, in ``layer_types`` order)::

    embed/table (V, D); final_norm/scale (D,)
    mamba_layers/ ln1/scale, ln2/scale (Lm, D)
        mamba/ w_in (Lm, D, 2 Din + 2 N + H), conv (Lm, K, Din + 2 N),
               conv_b (Lm, Din + 2 N), a_log, d_skip, dt_bias (Lm, H),
               norm/scale (Lm, Din), w_out (Lm, Din, D)
        moe/ router (Lm, D, E), wg, wu (Lm, n, D, F), wd (Lm, n, F, D)
        shared/ wg, wu (Lm, D, Fs), wd (Lm, Fs, D)
    attn_layers/ ln1/scale, ln2/scale (La, D)
        attn/ wq (La, D, Hq, hd), wk, wv (La, D, Hkv, hd), wo (La, Hq, hd, D)
        moe/, shared/ as above

The in-projection's columns are [z, x, B, C, dt] and the conv's channels
[x, B, C], as in ``granitemoehybrid``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products and convolutions in full float32."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


def rmsnorm(x, weight, eps):
    var = x.pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * weight


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def layer_params(params: dict, cfg: dict, i: int) -> tuple[str, dict]:
    """Layer i's kind and its leaves (the i-th of its kind's stack)."""
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    kind = kinds[i]
    j = kinds[:i].count(kind)
    stack = params["mamba_layers" if kind == "mamba" else "attn_layers"]

    def pick(tree):
        return {k: pick(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[j]

    return kind, pick(stack)


# ------------------------------------------------------------------ SSD

def segsum(x):
    """(..., T) -> (..., T, T): sum of x over (j, i] at [i, j], -inf above
    the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    x = x.masked_fill(~torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1), 0)
    x_segsum = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), 0)
    return x_segsum.masked_fill(~keep, -torch.inf)


def ssd_minimal(x, a, b, c, block_len):
    """The SSD of x (B, L, H, P) (inputs already times dt), a (B, L, H)
    (A dt), one group's b, c (B, L, N); the chunked "minimal" algorithm.
    Returns y (B, L, H, P)."""
    bsz, seqlen, h, p = x.shape
    nc = seqlen // block_len
    x = x.reshape(bsz, nc, block_len, h, p)
    b = b.reshape(bsz, nc, block_len, -1)
    c = c.reshape(bsz, nc, block_len, -1)
    a = a.reshape(bsz, nc, block_len, h).permute(0, 3, 1, 2)        # (B, H, C, L)
    a_cumsum = torch.cumsum(a, dim=-1)
    # 1. within each chunk (the diagonal blocks)
    decay = torch.exp(segsum(a))                                    # (B, H, C, L, L)
    cb = torch.einsum("bcln,bcsn->bcls", c, b)
    scores = cb[:, None] * decay                                    # (B, H, C, L, S)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, x)
    # 2. each chunk's state from its own inputs
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", b, decay_states, x)
    # 3. the states entering each chunk, across chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cumsum[..., -1], (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states = new_states[:, :-1]
    # 4. each chunk's output from the state entering it
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", c, states, torch.exp(a_cumsum))
    return (y_diag + y_off).reshape(bsz, seqlen, h, p)


# ---------------------------------------------------------------- mixers

def mamba_mixer(p: dict, x, cfg: dict):
    d_state, n_heads, d_head = cfg["mamba_d_state"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    d_inner = n_heads * d_head
    bsz, seqlen, _ = x.shape
    zxbcdt = x @ p["w_in"]
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * d_state, n_heads], dim=-1)
    k = p["conv"].shape[0]
    conv = F.conv1d(xbc.transpose(1, 2), p["conv"].T[:, None, :], p["conv_b"],
                    padding=k - 1, groups=xbc.shape[-1])[..., :seqlen]
    xbc = F.silu(conv.transpose(1, 2))
    xs, b, c = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xs = xs.reshape(bsz, seqlen, n_heads, d_head)
    y = ssd_minimal(xs * dt[..., None], a * dt, b, c, cfg["mamba_chunk_size"])
    y = y + xs * p["d_skip"][:, None]
    y = y.reshape(bsz, seqlen, d_inner) * F.silu(z)
    return rmsnorm(y, p["norm"]["scale"], cfg["rms_norm_eps"]) @ p["w_out"]


def attention_mixer(p: dict, x, cfg: dict):
    bsz, seqlen, d = x.shape
    hq, hkv, hd = p["wq"].shape[1], p["wk"].shape[1], p["wq"].shape[2]
    q = (x @ p["wq"].reshape(d, hq * hd)).reshape(bsz, seqlen, hq, hd).transpose(1, 2)
    k = (x @ p["wk"].reshape(d, hkv * hd)).reshape(bsz, seqlen, hkv, hd).transpose(1, 2)
    v = (x @ p["wv"].reshape(d, hkv * hd)).reshape(bsz, seqlen, hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    scores = (q @ k.transpose(-1, -2)) * cfg["attention_multiplier"]
    causal = torch.ones(seqlen, seqlen, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), dim=-1)
    o = (probs @ v).transpose(1, 2).reshape(bsz, seqlen, hq * hd)
    return o @ p["wo"].reshape(hq * hd, d)


# ------------------------------------------------------------------- MoE

def moe(p: dict, x, cfg: dict, counts: list | None = None):
    """The held experts' part of the top-k MoE of x (B, S, D). ``counts``,
    where given, gets the number of (token, pick) slots that land on the
    held experts."""
    lo, hi = cfg["experts_held"]
    flat = x.reshape(-1, x.shape[-1])
    logits = flat @ p["router"]
    top_logits, top_idx = torch.topk(logits, cfg["num_experts_per_tok"], dim=-1)
    gates = torch.softmax(top_logits, dim=-1)
    if counts is not None:
        counts.append(int(((top_idx >= lo) & (top_idx < hi)).sum()))
    out = torch.zeros_like(flat)
    for e in range(lo, hi):
        tok, slot = torch.nonzero(top_idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(flat[tok], p["wg"][e - lo], p["wu"][e - lo], p["wd"][e - lo])
        out = out.index_add(0, tok, gates[tok, slot, None] * y)
    return out.reshape(x.shape)


# --------------------------------------------------------------- layers

def layer(params: dict, cfg: dict, i: int, x, counts: list | None = None):
    """Layer i of x; ``counts`` as :func:`moe`'s."""
    kind, p = layer_params(params, cfg, i)
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = rmsnorm(x, p["ln1"]["scale"], eps)
    h = mamba_mixer(p["mamba"], h, cfg) if kind == "mamba" else attention_mixer(p["attn"], h, cfg)
    x = x + r * h
    h = rmsnorm(x, p["ln2"]["scale"], eps)
    ffn = moe(p["moe"], h, cfg, counts) + swiglu(h, p["shared"]["wg"], p["shared"]["wu"],
                                          p["shared"]["wd"])
    return x + r * ffn


def embed(params: dict, cfg: dict, tokens):
    return params["embed"]["table"][tokens] * cfg["embedding_multiplier"]


def head_logits(params: dict, cfg: dict, x):
    """The logits of the final hidden states x, over the table's rows."""
    h = rmsnorm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    return (h @ params["embed"]["table"].T) / cfg["logits_scaling"]


def head_loss(params: dict, cfg: dict, x, labels):
    """Mean next-token cross-entropy of the final hidden states x."""
    logits = head_logits(params, cfg, x)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def hidden(params: dict, cfg: dict, tokens):
    """The last layer's output of ``tokens`` (B, S)."""
    x = embed(params, cfg, tokens)
    for i in range(cfg["num_hidden_layers"]):
        x = layer(params, cfg, i, x)
    return x


def loss(params: dict, cfg: dict, tokens, labels):
    return head_loss(params, cfg, hidden(params, cfg, tokens), labels)


def _leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _at(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def loss_and_grads(params: dict, cfg: dict, tokens, labels,
                   counts: list | None = None) -> tuple[torch.Tensor, dict]:
    """The loss and its gradient with respect to every leaf of ``params``,
    computed a layer at a time: the forward keeps each layer's input, then
    each layer's graph is built again from its input, last layer first, and
    differentiated alone, so one layer's activations are alive at a time.
    ``counts`` gets each layer's held slots (:func:`moe`), in layer order."""
    grads = {}
    for path, leaf in _leaves(params):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros_like(leaf)
    n = cfg["num_hidden_layers"]
    with torch.no_grad():
        xs = [embed(params, cfg, tokens)]
        for i in range(n - 1):
            xs.append(layer(params, cfg, i, xs[-1], counts))

    with torch.enable_grad():
        # the head: the final norm and the tied table
        with torch.no_grad():
            x_last = layer(params, cfg, n - 1, xs[-1], counts) if n else xs[0]
        xg = x_last.requires_grad_(True)
        table = params["embed"]["table"].detach().requires_grad_(True)
        scale = params["final_norm"]["scale"].detach().requires_grad_(True)
        out = head_loss({"embed": {"table": table}, "final_norm": {"scale": scale}}, cfg, xg,
                        labels)
        dx, dtable, dscale = torch.autograd.grad(out, (xg, table, scale))
        grads["embed"]["table"] += dtable
        grads["final_norm"]["scale"] += dscale
        kinds = cfg["layer_types"][:n]
        for i in reversed(range(n)):
            top = "mamba_layers" if kinds[i] == "mamba" else "attn_layers"
            j = kinds[:i].count(kinds[i])
            paths = [p for p, _ in _leaves(params[top])]
            leaves = [_at(params[top], p)[j:j + 1].detach().requires_grad_(True) for p in paths]
            sub = {}
            for p, leaf in zip(paths, leaves):
                node = sub
                for k in p[:-1]:
                    node = node.setdefault(k, {})
                node[p[-1]] = leaf
            xg = xs[i].detach().requires_grad_(True)
            one = dict(cfg, layer_types=[kinds[i]], num_hidden_layers=1)
            y = layer({top: sub}, one, 0, xg)
            got = torch.autograd.grad(y, [xg] + leaves, grad_outputs=dx)
            dx = got[0]
            for p, g in zip(paths, got[1:]):
                _at(grads[top], p)[j] += g[0]
        # the embedding lookup
        table = params["embed"]["table"].detach().requires_grad_(True)
        x0 = embed({"embed": {"table": table}}, cfg, tokens)
        grads["embed"]["table"] += torch.autograd.grad(x0, table, grad_outputs=dx)[0]
    return out.detach(), grads
