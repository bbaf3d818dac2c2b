"""Plain fp32 reference of the dense decoder the cells run.

Plain PyTorch in float32 with TF32 off (``fp32_matmuls``): no kernel, no
cache, no batching across requests.  It imports nothing of the program; it
reads the configuration file's ``model`` sizes and the weights the
benchmark draws (``weights.draw``), converted to fp32 a layer at a time so
that a 60 GB model fits beside its activations.

The layer, as the port's dense decoder defines it (its departures from
the published models are listed in each configuration file):

    h  = rms_norm(x) * (1 + ln1)            eps from the file
    q, k, v = h Wq + bq, h Wk + bk, h Wv + bv   (biases where the file says)
    rotary positions on q and k, the head dim split in halves, theta 1e4
    attention: causal, over a window where the file says, scale D ** -0.5,
               query head j reads key head j // (Hq / Hkv)
    x  = x + attn Wo
    h2 = rms_norm(x) * (1 + ln2)
    x  = x + (act(h2 Wg) * (h2 Wu)) Wd        gated
         x + act(h2 Wu + bu) Wd + bd          plain
    logits = (rms_norm(x) * (1 + final_norm)) W_head

``quant`` puts a lower precision in place of fp32 for every product's
operands (the control, ``fp8_operands``); ``None`` is the reference.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

F32 = torch.float32


@contextlib.contextmanager
def fp32_matmuls():
    """Products in true fp32: TF32 off for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8_operands(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (rows of an activation, columns of a weight), back in fp32; the
    gradient passes straight through."""
    amax = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = 448.0 / amax
    q = (t.detach() * s).to(torch.float8_e4m3fn).to(F32) / s
    return t + (q - t).detach()


class Model:
    """The sizes of a configuration file's ``model``."""

    def __init__(self, model: dict):
        self.d = model["d_model"]
        self.hq = model["num_heads"]
        self.hkv = model["num_kv_heads"]
        self.hd = model.get("head_dim") or self.d // self.hq
        self.gated = model.get("gated_mlp", True)
        self.act = {"silu": torch.nn.functional.silu,
                    "relu": torch.relu,
                    "gelu": lambda t: torch.nn.functional.gelu(
                        t, approximate="tanh")}[model.get("mlp_act", "silu")]
        self.eps = model.get("norm_eps", 1e-6)
        self.theta = model.get("rope_theta", 10_000.0)
        self.window = (model.get("sliding_window", 0)
                       if model.get("swa_layers") == "all" else 0)


def mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[Callable]):
    if quant is not None:
        x, w = quant(x, -1), quant(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + scale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (..., S, D); positions (S,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=F32,
                                         device=x.device) / half)
    ang = positions.to(F32)[:, None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, q_pos, k_pos, window: int, scale: float):
    """q (B, Hkv, G, bq, D) against k, v (B, Hkv, nk, D)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k) * scale
    ok = k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    s = s.masked_fill(~ok, float("-inf"))
    return torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1), v)


def attention(q, k, v, m: Model, block: int = 512, remat: bool = False):
    """Causal (windowed) attention over positions 0 .. S-1.  q (B, Hq, S,
    D), k, v (B, Hkv, S, D) -> (B, S, Hq D); queries a block at a time
    against the keys the block may see (with ``remat`` each block under
    its own checkpoint, so the backward holds one block's scores)."""
    b, hq, s, d = q.shape
    g = hq // m.hkv
    qg = q.reshape(b, m.hkv, g, s, d)
    pos = torch.arange(s, device=q.device)
    outs = []
    for a in range(0, s, block):
        e = min(a + block, s)
        k0 = max(0, a - m.window + 1) if m.window else 0
        args = (qg[:, :, :, a:e], k[:, :, k0:e], v[:, :, k0:e], pos[a:e],
                pos[k0:e], m.window, d ** -0.5)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if remat else _attend_block(*args))
    out = torch.cat(outs, dim=3).reshape(b, hq, s, d)
    return out.transpose(1, 2).reshape(b, s, hq * d)


def layer(x: torch.Tensor, p: dict, m: Model, quant=None, remat=False):
    """One decoder layer, x (B, S, d) fp32 at positions 0 .. S-1; ``p`` the
    layer's leaves in fp32."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    a = p["attn"]
    h = rms_norm(x, p["ln1"], m.eps)

    def proj(w, bias, heads):
        t = mm(h, a[w], quant)
        if bias in a:
            t = t + a[bias]
        return t.reshape(b, s, heads, m.hd).transpose(1, 2)

    q = rope(proj("w_q", "b_q", m.hq), pos, m.theta)
    k = rope(proj("w_k", "b_k", m.hkv), pos, m.theta)
    v = proj("w_v", "b_v", m.hkv)
    x = x + mm(attention(q, k, v, m, remat=remat), a["w_o"], quant)
    h2 = rms_norm(x, p["ln2"], m.eps)
    f = p["mlp"]
    if m.gated:
        inner = m.act(mm(h2, f["w_gate"], quant)) * mm(h2, f["w_up"], quant)
    else:
        inner = m.act(mm(h2, f["w_up"], quant) + f["b_up"])
    out = mm(inner, f["w_down"], quant)
    if "b_down" in f:
        out = out + f["b_down"]
    return x + out


def to_f32(tree):
    """A copy of a tree of dicts and lists with fp32 leaves."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_f32(v) for v in tree]
    return tree.to(F32, copy=True)


@torch.no_grad()
def sequence_logits(params: dict, model: dict, sequences: list[torch.Tensor],
                    rows: list[torch.Tensor], quant=None
                    ) -> list[torch.Tensor]:
    """Logits of each token sequence (S_i,) at the positions ``rows[i]``,
    layer by layer over all sequences: each layer's weights go to fp32
    once."""
    m = Model(model)
    xs = [params["embed"][t].to(F32)[None] for t in sequences]
    for p in params["layers"]:
        p32 = to_f32(p)
        xs = [layer(x, p32, m, quant) for x in xs]
        del p32
    norm = params["final_norm"].to(F32)
    head = params["lm_head"].to(F32)
    return [mm(rms_norm(x[0, r], norm, m.eps), head, quant)
            for x, r in zip(xs, rows)]


def loss(params32: dict, model: dict, tokens: torch.Tensor,
         labels: torch.Tensor, quant=None, head_rows: int = 4096
         ) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, S) tokens, differentiable, each
    layer under a checkpoint (its attention blocks too) and the head and
    loss a block of rows at a time, so that fp32 activations fit."""
    m = Model(model)
    x = params32["embed"][tokens]
    for p in params32["layers"]:
        x = checkpoint(lambda x, p=p: layer(x, p, m, quant, remat=True), x,
                       use_reentrant=False)
    h = x.reshape(-1, x.shape[-1])
    lab = labels.reshape(-1)

    def block_nll(hb, lb):
        z = mm(rms_norm(hb, params32["final_norm"], m.eps),
               params32["lm_head"], quant)
        return (torch.logsumexp(z, -1)
                - z.gather(-1, lb[:, None].long())[:, 0]).sum()

    total = sum(checkpoint(block_nll, h[i:i + head_rows],
                           lab[i:i + head_rows], use_reentrant=False)
                for i in range(0, h.shape[0], head_rows))
    return total / lab.numel()


def leaf_norms(tensors) -> list[float]:
    """The fp32 norm of each tensor of an iterable, one at a time (a
    generator of differences holds one difference at a time)."""
    norms = torch.stack([torch.linalg.vector_norm(t.detach().to(F32))
                         for t in tensors])
    return [float(v) for v in norms.cpu()]
