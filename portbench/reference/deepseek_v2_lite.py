"""The plain reference of DeepSeek-V2-Lite's decoder, one card's share of
the experts, for the benchmark's check and the port's CPU tests.

Written from the published ``modeling_deepseek.py``
(https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite) in plain PyTorch,
imports nothing of the program under test: each routed expert held is
applied to the tokens a boolean mask picks (a host read per expert),
attention is the textbook causal softmax with an additive mask, the
gradient is ``torch.autograd.grad`` and the Hessian-vector product double
backward, ``grad(g . v)``: a different mode from the program's jvp of its
gradient.  Every function computes in the dtype of the weights.

The parameters are the flat vector ``x`` cut in the order of
:func:`layout`: the nested dict of the configuration's shapes, keys
sorted at every level (the order a pytree trainer flattens a dict in).
A configuration is the benchmark's JSON object: the published keys,
``rope_scaling`` a YaRN group, with ``n_routed_experts`` the experts this
card holds (ids ``0 ..`` that count) and ``router_experts`` the router's
outputs, the published count.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def shapes(cfg: dict) -> dict:
    """The nested dict of every weight's shape."""
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    E, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]

    def ffn(width):
        return {"gate": (H, width), "up": (H, width), "down": (width, H)}
    layers = {}
    for i in range(cfg["num_hidden_layers"]):
        layer = {"attn_norm": (H,), "ffn_norm": (H,),
                 "attn": {"q": (H, nh * (dn + dr)), "kv_a": (H, r + dr),
                          "kv_norm": (r,), "kv_b": (r, nh * (dn + dv)),
                          "o": (nh * dv, H)}}
        if i < cfg["first_k_dense_replace"]:
            layer["mlp"] = ffn(cfg["intermediate_size"])
        else:
            layer["moe"] = {"router": (H, cfg["router_experts"]),
                            "shared": ffn(cfg["n_shared_experts"] * w),
                            "experts": {"gate": (E, H, w), "up": (E, H, w),
                                        "down": (E, w, H)}}
        layers[f"{i:02d}"] = layer
    V = cfg["vocab_size"]
    return {"embed": (V, H), "head": (V, H), "norm": (H,), "layers": layers}


def layout(cfg: dict) -> List[Tuple[str, tuple]]:
    """``(path, shape)`` of each weight in the flat vector's order."""
    out = []

    def walk(tree, path):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], path + (k,))
            else:
                out.append(("/".join(path + (k,)), tuple(tree[k])))
    walk(shapes(cfg), ())
    return out


def size(cfg: dict) -> int:
    return sum(math.prod(s) for _, s in layout(cfg))


def split(x: torch.Tensor, cfg: dict) -> Dict[str, torch.Tensor]:
    """``{path: view of x}``."""
    out, at = {}, 0
    for path, shape in layout(cfg):
        n = math.prod(shape)
        out[path] = x[at:at + n].view(shape)
        at += n
    return out


# -- the decoder --------------------------------------------------------------- #
def rms_norm(x, w, eps):
    var = (x * x).mean(dim=-1, keepdim=True)
    return w * (x / torch.sqrt(var + eps))


def swiglu(x, gate, up, down):
    g = x @ gate
    return (g * torch.sigmoid(g) * (x @ up)) @ down


def _mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_cos_sin(cfg: dict, T: int, device, dtype):
    """``DeepseekV2YarnRotaryEmbedding``'s cos and sin caches, in float32
    as it makes them, cast to ``dtype``."""
    rs = cfg["rope_scaling"]
    d, base, factor = cfg["qk_rope_head_dim"], cfg["rope_theta"], \
        rs["factor"]
    pos = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    freq_extra = 1.0 / (base ** pos)
    freq_inter = 1.0 / (factor * base ** pos)

    def corr(n_rot):
        return (d * math.log(rs["original_max_position_embeddings"]
                             / (n_rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    lin = (torch.arange(d // 2, dtype=torch.float32, device=device) - low) \
        / (high - low)
    mask = 1.0 - torch.clamp(lin, 0, 1)
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    t = torch.arange(T, dtype=torch.float32, device=device)
    freqs = t[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    m = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    return (emb.cos() * m).to(dtype), (emb.sin() * m).to(dtype)


def apply_rope(x, cos, sin):
    """``apply_rotary_pos_emb`` on ``x [..., T, d]``."""
    shape = x.shape
    d = shape[-1]
    x = x.reshape(*shape[:-1], d // 2, 2).transpose(-1, -2).reshape(shape)
    half = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * cos + half * sin


def attention(W, a, cfg, cos, sin):
    """MLA on ``a [T, H]`` (one sequence)."""
    T = a.shape[0]
    nh = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (a @ W["q"]).reshape(T, nh, dn + dr).permute(1, 0, 2)
    ckv = a @ W["kv_a"]
    c, k_pe = ckv[:, :r], ckv[:, r:]
    kv = (rms_norm(c, W["kv_norm"], cfg["rms_norm_eps"]) @ W["kv_b"]) \
        .reshape(T, nh, dn + dv).permute(1, 0, 2)
    q_pe = apply_rope(q[..., dn:], cos, sin)
    k_pe = apply_rope(k_pe, cos, sin)
    rs = cfg["rope_scaling"]
    scale = (dn + dr) ** -0.5 * _mscale(rs["factor"], rs["mscale_all_dim"]) \
        ** 2
    bias = torch.full((T, T), float("-inf"), dtype=a.dtype,
                      device=a.device).triu(1)
    heads = []
    for i in range(nh):
        qi = torch.cat((q[i, :, :dn], q_pe[i]), dim=-1)
        ki = torch.cat((kv[i, :, :dn], k_pe), dim=-1)
        p = torch.softmax(qi @ ki.T * scale + bias, dim=-1)
        heads.append(p @ kv[i, :, dn:])
    return torch.cat(heads, dim=-1) @ W["o"]


def moe(W, x, cfg):
    """The MoE layer on ``x [T, H]``: the held experts by boolean masks."""
    probs = torch.softmax(x @ W["router"], dim=-1)
    weight, chosen = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    weight = weight * cfg.get("routed_scaling_factor", 1.0)
    out = swiglu(x, W["shared/gate"], W["shared/up"], W["shared/down"])
    for e in range(cfg["n_routed_experts"]):
        hit = chosen == e                                   # [T, k]
        rows = hit.any(dim=-1)
        if not bool(rows.any()):
            continue
        we = (weight * hit.to(weight.dtype)).sum(dim=-1)[rows]
        ye = swiglu(x[rows], W["experts/gate"][e], W["experts/up"][e],
                    W["experts/down"][e])
        out = out.index_put((rows.nonzero()[:, 0],),
                            out[rows] + we[:, None] * ye)
    return out


def _sub(P: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in P.items() if k.startswith(prefix)}


def loss(P: dict, ids: torch.Tensor, targets: torch.Tensor,
         cfg: dict) -> torch.Tensor:
    """The mean next-token cross-entropy of the sequences ``ids [b, T]``
    against ``targets [b, T]``; ``P`` as :func:`split` gives it."""
    eps = cfg["rms_norm_eps"]
    T = ids.shape[1]
    dtype, device = P["embed"].dtype, P["embed"].device
    cos, sin = yarn_cos_sin(cfg, T, device, dtype)
    total = 0.0
    for seq, tgt in zip(ids, targets):
        h = P["embed"][seq]
        for i in range(cfg["num_hidden_layers"]):
            L = _sub(P, f"layers/{i:02d}/")
            h = h + attention(_sub(L, "attn/"),
                              rms_norm(h, L["attn_norm"], eps), cfg, cos,
                              sin)
            a = rms_norm(h, L["ffn_norm"], eps)
            if i < cfg["first_k_dense_replace"]:
                h = h + swiglu(a, L["mlp/gate"], L["mlp/up"], L["mlp/down"])
            else:
                h = h + moe(_sub(L, "moe/"), a, cfg)
        logits = rms_norm(h, P["norm"], eps) @ P["head"].T
        logp = torch.log_softmax(logits, dim=-1)
        total = total - logp.gather(1, tgt[:, None]).sum()
    return total / ids.numel()


def _leaves(x, cfg):
    parts = split(x.detach(), cfg)
    return {k: v.clone().requires_grad_(True) for k, v in parts.items()}


def gradient(x, ids, targets, cfg):
    """``d loss / d x``."""
    P = _leaves(x, cfg)
    with torch.enable_grad():
        gs = torch.autograd.grad(loss(P, ids, targets, cfg), list(P.values()))
    return torch.cat([g.reshape(-1) for g in gs])


def hessvec(x, v, ids, targets, cfg):
    """``H v`` by double backward."""
    P = _leaves(x, cfg)
    V = split(v.to(x.dtype), cfg)
    with torch.enable_grad():
        gs = torch.autograd.grad(loss(P, ids, targets, cfg),
                                 list(P.values()), create_graph=True)
        dot = sum((g * V[k]).sum() for k, g in zip(P, gs))
        hs = torch.autograd.grad(dot, list(P.values()))
    return torch.cat([h.reshape(-1) for h in hs])


def bind(cfg: dict, data: dict, dtype):
    """The benchmark's reference model on its data: the gradient on
    iteration ``t``'s minibatch (batch ``t mod num_batches``), the
    Hessian-vector product on round ``r``'s minibatches, taken one at a
    time and averaged (the mean loss of their merged tokens), and the
    full-data loss in float64."""
    ids, tgt = data["ids"], data["targets"]
    B, L = cfg["num_batches"], cfg["bfgs_upd_freq"]
    rounds = B // L

    def grad(x, t):
        return gradient(x.to(dtype), ids[t % B], tgt[t % B], cfg)

    def hv(x, v, r):
        r %= rounds
        acc = None
        for b in range(r * L, (r + 1) * L):
            part = hessvec(x.to(dtype), v, ids[b], tgt[b], cfg)
            acc = part if acc is None else acc + part
        return acc / L

    def full_loss(x):
        P = split(x.to(ids.device).double(), cfg)
        with torch.no_grad():
            return float(sum(loss(P, ids[b], tgt[b], cfg)
                             for b in range(B)) / B)
    return grad, hv, full_loss
