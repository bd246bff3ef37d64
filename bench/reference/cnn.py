"""The paper's CNNs (Sec. VI) and their local SGD, in plain torch.

Conv k x k 'SAME' + ReLU + 2x2 max-pool per conv layer (one more pool
where ``extra_pool``), flatten in (h, w, c) order, ReLU dense layers, a
linear output; softmax cross-entropy. Parameters are ``{layer: {"w",
"b"}}`` with HWIO kernels and (in, out) matrices; images are NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def forward(m: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x.permute(0, 3, 1, 2)
    for i in range(len(m["conv_channels"])):
        layer = p[f"conv{i}"]
        h = F.conv2d(h, layer["w"].permute(3, 2, 0, 1), layer["b"], padding=m["kernel"] // 2)
        h = F.max_pool2d(torch.relu(h), 2)
    if m["extra_pool"]:
        h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    for j in range(len(m["hidden"])):
        h = torch.relu(h @ p[f"fc{j}"]["w"] + p[f"fc{j}"]["b"])
    return h @ p["out"]["w"] + p["out"]["b"]


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample -log softmax(logits)[y]."""
    return torch.logsumexp(logits, -1) - logits.gather(-1, y[:, None])[:, 0]


def local_sgd(m: dict, p: dict, x: torch.Tensor, y: torch.Tensor, lr: float):
    """``tau`` plain SGD steps for each of S clients from the same ``p``.

    x (S, tau, B, H, W, C), y (S, tau, B) -> (each leaf with a leading S
    axis, (S,) mean of the steps' squared gradient norms, (S,) their
    population variance)."""
    grad = torch.func.grad(lambda q, xb, yb: cross_entropy(forward(m, q, xb), yb).mean())

    def client(xs, ys):
        q, norms = p, []
        for t in range(xs.shape[0]):
            g = grad(q, xs[t], ys[t])
            norms.append(sum(torch.sum(g[k][n] ** 2) for k in sorted(g) for n in sorted(g[k])))
            q = {k: {n: q[k][n] - lr * g[k][n] for n in q[k]} for k in q}
        norms = torch.stack(norms)
        return q, norms.mean(), ((norms - norms.mean()) ** 2).mean()

    return torch.func.vmap(client)(x, y)


def evaluate(m: dict, p: dict, x: torch.Tensor, y: torch.Tensor, block: int = 256):
    """(accuracy, mean cross-entropy) over a labelled set, in blocks."""
    hits, loss = 0.0, 0.0
    for lo in range(0, x.shape[0], block):
        logits = forward(m, p, x[lo: lo + block])
        hits += float((logits.argmax(-1) == y[lo: lo + block]).sum())
        loss += float(cross_entropy(logits, y[lo: lo + block]).sum())
    return hits / x.shape[0], loss / x.shape[0]
