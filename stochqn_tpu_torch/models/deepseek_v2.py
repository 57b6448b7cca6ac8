"""DeepSeek-V2's decoder as a loss over structured parameters, for
:class:`stochqn_tpu_torch.optim_adapter.PytreeTrainer`.

The published ``DeepseekV2ForCausalLM`` (``modeling_deepseek.py`` of
deepseek-ai/DeepSeek-V2-Lite) with no query compression
(``q_lora_rank`` null), in plain torch operations and one hand kernel,
written so that a CUDA graph can capture its gradient and the forward-mode
derivative of that gradient (``torch.func.jvp`` of ``torch.func.grad``).
On a ``[b, T]`` batch of token ids, per layer, with ``h`` the residual
stream and ``N(.)`` RMSNorm ``x / sqrt(mean(x^2) + eps) * w``:

* attention (MLA), on ``a = N(h)``: ``q = a W_q``, per head ``[q_nope
  (qk_nope_head_dim), q_rope (qk_rope_head_dim)]``; ``[c_kv, k_rope] = a
  W_kva`` (``kv_lora_rank`` + rope), ``c_kv = N(c_kv)``; ``[k_nope, v] =
  c_kv W_kvb`` per head; ``k_rope`` shared by the heads.  YaRN RoPE on
  ``q_rope`` and ``k_rope`` after the published reordering of each
  vector's interleaved pairs into halves: ``x cos + rot(x) sin``,
  ``rot([x1, x2]) = [-x2, x1]``, ``inv_freq = f_inter (1 - m) + f_extra m``
  with ``f_extra = theta^(-2i/d)``, ``f_inter = f_extra / factor`` and
  ``m`` one minus the linear ramp between the correction dimensions of
  ``beta_fast`` and ``beta_slow``, the tables scaled by ``mscale(factor,
  mscale) / mscale(factor, mscale_all_dim)``.  Scores ``[q_nope, q_rope]
  . [k_nope, k_rope]`` scaled by ``(nope + rope)^-0.5 mscale(factor,
  mscale_all_dim)^2``, ``mscale(s, m) = 0.1 m ln s + 1``, causal softmax,
  ``o = [softmax V per head] W_o``; ``h += o``;
* a dense layer (the first ``first_k_dense_replace``): ``h += E(N(h))``,
  ``E(x) = (silu(x W_gate) * x W_up) W_down`` of width
  ``intermediate_size``;
* a MoE layer: ``x = N(h)``, ``p = softmax(x W_g)`` over
  ``n_routed_experts``, greedy top ``num_experts_per_tok`` (weights the
  ``p`` there, not renormalised, times ``routed_scaling_factor``);
  ``h += S(x) + sum_{e in top-k, e held} p_e E_e(x)``, ``S`` the
  ``n_shared_experts`` shared experts as one ``E`` of width
  ``n_shared_experts * moe_intermediate_size``, ``E_e`` of width
  ``moe_intermediate_size``.

then ``N(h)``, the untied head over the vocabulary and the mean next-token
cross-entropy.

A card holds ``experts_held`` of the routed experts, ids ``0 ..
experts_held - 1``: one card's share of an expert-parallel deployment.
The router keeps all its outputs and its top-k; an assignment to an
expert this card does not hold adds nothing.  Routing drops no token and
reads nothing on the host: the ``T k`` assignments are sorted by expert
on the device (a stable sort, the absent experts last), each held
expert's count and offset come from a one-hot sum, and a fixed buffer of
``T k`` rows, of which the first ``held`` are live, goes through the
grouped product (:func:`stochqn_tpu_torch.ops.kernels.grouped_mm.
grouped_mm`) for ``W_gate``, ``W_up`` and ``W_down``; the combine is an
``index_add`` weighted by the gate.  Left out: the sequence-level
auxiliary balance loss, a training regulariser outside the layer.

Captured epochs label the forward pass's nodes ``attention``, ``router``,
``experts``, ``shared``, ``dense_ffn`` and ``head``
(:func:`stochqn_tpu_torch.utils.metrics.label`; inside the trainer's
``gradient`` and ``boundary``), and count the tokens routed to each
expert of each MoE layer, held or not, in the device counter
``expert_tokens`` ``[moe layers, n_routed_experts]``.

Parameters are a nested dict (:func:`param_shapes`), each product's
weight stored ``[in, out]``, the embedding and head ``[vocab, hidden]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from stochqn_tpu_torch.ops.kernels.grouped_mm import grouped_mm, plain
from stochqn_tpu_torch.utils import metrics
from stochqn_tpu_torch.utils.metrics import label


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The published configuration's keys that the block reads, and
    ``experts_held``.  Defaults: DeepSeek-V2-Lite's."""

    hidden_size: int = 2048
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    first_k_dense_replace: int = 1
    num_hidden_layers: int = 27
    vocab_size: int = 102400
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    experts_held: int = 64

    @classmethod
    def from_dict(cls, d: dict) -> "DeepseekV2Config":
        """From a published ``config.json``'s keys (``rope_scaling`` a
        YaRN group; ``q_lora_rank`` null, ``topk_method`` greedy and
        ``norm_topk_prob`` false, the only ones the block computes) and
        ``experts_held``; other keys are ignored."""
        if d.get("q_lora_rank") is not None:
            raise ValueError("query compression (q_lora_rank) is not built")
        if d.get("topk_method", "greedy") != "greedy" or \
                d.get("norm_topk_prob", False):
            raise ValueError("only greedy, unnormalised top-k routing")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        rs = d.get("rope_scaling")
        if rs is not None:
            if rs.get("type", "yarn") != "yarn":
                raise ValueError("only YaRN rope scaling is built")
            kw.update(rope_factor=rs["factor"],
                      original_max_position_embeddings=rs[
                          "original_max_position_embeddings"],
                      beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
                      mscale=rs["mscale"],
                      mscale_all_dim=rs["mscale_all_dim"])
        return cls(**kw)

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def softmax_scale(self) -> float:
        d = self.qk_nope_head_dim + self.qk_rope_head_dim
        m = yarn_mscale(self.rope_factor, self.mscale_all_dim)
        return d ** -0.5 * m * m


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def param_shapes(cfg: DeepseekV2Config) -> dict:
    """The parameters' shapes, as the nested dict the loss takes."""
    H, nh = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank

    def mlp(width):
        return {"gate": (H, width), "up": (H, width), "down": (width, H)}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        layer = {"attn": {"q": (H, nh * (dn + dr)), "kv_a": (H, r + dr),
                          "kv_norm": (r,), "kv_b": (r, nh * (dn + dv)),
                          "o": (nh * dv, H)},
                 "attn_norm": (H,), "ffn_norm": (H,)}
        if i < cfg.first_k_dense_replace:
            layer["mlp"] = mlp(cfg.intermediate_size)
        else:
            E, w = cfg.experts_held, cfg.moe_intermediate_size
            layer["moe"] = {
                "router": (H, cfg.n_routed_experts),
                "experts": {"gate": (E, H, w), "up": (E, H, w),
                            "down": (E, w, H)},
                "shared": mlp(cfg.n_shared_experts * w)}
        layers[f"{i:02d}"] = layer
    return {"embed": (cfg.vocab_size, H), "layers": layers,
            "norm": (H,), "head": (cfg.vocab_size, H)}


def init_params(cfg: DeepseekV2Config, generator: Optional[torch.Generator]
                = None, device=None, dtype=torch.float32,
                std: float = 0.02) -> dict:
    """Random weights: normal with ``std`` (the published
    ``initializer_range``), norms' weights one."""
    def make(shape, name):
        if len(shape) == 1 and name.endswith("norm"):
            return torch.ones(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * std

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return make(tree, name)
    return walk(param_shapes(cfg))


# queries a block of the causal softmax: one block's scores are alive at a
# time, and a block's keys end at its last query
QUERY_BLOCK = 1024


# -- pieces ------------------------------------------------------------------ #
def _norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _silu(x):
    """``x sigmoid(x)``: written out, since ``silu``'s backward under
    ``no_grad`` (:class:`_Recomputed`) has no forward-mode rule."""
    return x * torch.sigmoid(x)


def _mlp(p, x):
    return (_silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


def rope_tables(cfg: DeepseekV2Config, T: int, device, dtype):
    """``(cos, sin)`` ``[T, qk_rope_head_dim]`` of YaRN RoPE at positions
    ``0 .. T - 1``, made in float32 on ``device`` (as the published
    module makes its cache) and cast to ``dtype``."""
    d, base, f = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor
    f32 = torch.float32
    idx = torch.arange(0, d, 2, dtype=f32, device=device) / d
    extra = 1.0 / base ** idx
    inter = 1.0 / (f * base ** idx)

    def dim_at(rotations):
        return (d * math.log(cfg.original_max_position_embeddings
                             / (rotations * 2 * math.pi))) \
            / (2 * math.log(base))
    low = max(math.floor(dim_at(cfg.beta_fast)), 0)
    high = min(math.ceil(dim_at(cfg.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=f32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    inv_freq = inter * (1 - keep) + extra * keep
    freqs = torch.outer(torch.arange(T, dtype=f32, device=device), inv_freq)
    emb = torch.cat([freqs, freqs], -1)
    scale = yarn_mscale(f, cfg.mscale) / yarn_mscale(f, cfg.mscale_all_dim)
    return (emb.cos() * scale).to(dtype), (emb.sin() * scale).to(dtype)


def _rope(x, cos, sin):
    """RoPE on ``x [..., T, d]`` after the published reordering of its
    interleaved pairs into halves."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def _attention(p, a, cfg: DeepseekV2Config, cos, sin):
    """MLA on ``a [b, T, H]``; the causal softmax in blocks of
    ``QUERY_BLOCK`` queries, each against the keys up to its last."""
    b, T, _ = a.shape
    nh = cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (a @ p["q"]).view(b, T, nh, dn + dr).transpose(1, 2)
    q_nope, q_rope = q.split([dn, dr], -1)
    c, k_rope = (a @ p["kv_a"]).split([cfg.kv_lora_rank, dr], -1)
    kv = (_norm(c, p["kv_norm"], cfg.rms_norm_eps) @ p["kv_b"]) \
        .view(b, T, nh, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], -1)
    q = torch.cat([q_nope, _rope(q_rope, cos, sin)], -1)
    k_rope = _rope(k_rope.unsqueeze(1), cos, sin).expand(b, nh, T, dr)
    k = torch.cat([k_nope, k_rope], -1)
    blocks = []
    for i in range(0, T, QUERY_BLOCK):
        e = min(i + QUERY_BLOCK, T)
        s = (q[:, :, i:e] @ k[:, :, :e].transpose(-1, -2)) * cfg.softmax_scale
        future = torch.ones(e - i, e, dtype=torch.bool,
                            device=a.device).triu(i + 1)
        probs = torch.softmax(s.masked_fill(future, float("-inf")), -1)
        blocks.append(probs @ v[:, :, :e])
    o = torch.cat(blocks, 2).transpose(1, 2).reshape(b, T, nh * dv)
    return o @ p["o"]


def route(x, router, cfg: DeepseekV2Config):
    """The greedy top-k of ``softmax(x W_g)``: ``(experts [T, k], weights
    [T, k])``, the weights the scores there times
    ``routed_scaling_factor``, best first."""
    scores = torch.softmax(x @ router, -1)
    w, idx = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    return idx, w * cfg.routed_scaling_factor


def _count_routes(layer: int, idx: torch.Tensor,
                  cfg: DeepseekV2Config) -> None:
    """Add this call's assignments to ``expert_tokens[layer]``, on the
    device: outside ``torch.func``'s transforms, which refuse a mutation
    of a tensor made outside them."""
    counter = metrics.device_counter(
        "expert_tokens", (cfg.moe_layers, cfg.n_routed_experts), idx.device)
    flat = plain(idx).reshape(-1)
    with torch._C._DisableFuncTorch():
        counter[layer].index_add_(0, flat, torch.ones_like(flat))


def dispatch(idx: torch.Tensor, w: torch.Tensor, held: int):
    """The assignments ``idx [T, k]`` (weights ``w``) sorted by expert on
    the device, stable, those to experts not held last: ``(tok [T k],
    gate [T k], offsets [held + 1])``, the token and the gate weight of
    each sorted assignment (0 for one not held) and where each held
    expert's rows begin and end.  No host read and no shape that depends
    on the routing."""
    k = idx.shape[1]
    key = torch.where(idx < held, idx, held).reshape(-1)
    order = torch.sort(key, stable=True).indices
    counts = F.one_hot(key, held + 1).sum(0)
    offsets = torch.cat([counts.new_zeros(1), counts[:held].cumsum(0)])
    tok = torch.div(order, k, rounding_mode="floor")
    gate = w.reshape(-1)[order] * (key[order] < held).to(w.dtype)
    return tok, gate, offsets


def _moe(p, x, cfg: DeepseekV2Config, layer: Optional[int]):
    """The MoE layer's output on the flat tokens ``x [T, H]``; its routing
    is added to ``expert_tokens[layer]`` unless ``layer`` is None."""
    T, held = x.shape[0], cfg.experts_held
    with label("router"):
        idx, w = route(x, p["router"], cfg)
        if layer is not None:
            _count_routes(layer, idx, cfg)
        tok, gate, offsets = dispatch(idx, w, held)
    with label("experts"):
        e = p["experts"]
        rows = x.index_select(0, tok)
        hid = _silu(grouped_mm(rows, e["gate"], offsets, T)) \
            * grouped_mm(rows, e["up"], offsets, T)
        out = grouped_mm(hid, e["down"], offsets, T)
        y = torch.zeros_like(x).index_add(0, tok, out * gate[:, None])
    with label("shared"):
        return y + _mlp(p["shared"], x)


def _decoder_layer(cfg: DeepseekV2Config, i: int, spec, count: bool):
    """Layer ``i`` as ``fn(h, cos, sin, *weights) -> h``, its weights the
    leaves of its dict (``spec``); ``count``: whether its routing is
    added to ``expert_tokens`` (a recomputation's is not)."""
    eps = cfg.rms_norm_eps

    def fn(h, cos, sin, *leaves):
        p = tree_unflatten(list(leaves), spec)
        b, T, H = h.shape
        with label("attention"):
            h = h + _attention(p["attn"], _norm(h, p["attn_norm"], eps), cfg,
                               cos, sin)
        if i < cfg.first_k_dense_replace:
            with label("dense_ffn"):
                return h + _mlp(p["mlp"], _norm(h, p["ffn_norm"], eps))
        x = _norm(h, p["ffn_norm"], eps).reshape(b * T, H)
        layer = i - cfg.first_k_dense_replace if count else None
        return h + _moe(p["moe"], x, cfg, layer).view(b, T, H)
    return fn


class _Recomputed(torch.autograd.Function):
    """``fn(*inputs)`` that keeps none of its activations: the forward
    runs without recording, the forward-mode rule and the backward run
    ``fn`` again under ``torch.func.jvp`` and ``torch.func.vjp``.  The
    backward records nothing for a second reverse pass (``no_grad`` at
    its level), so inside a ``torch.func.jvp`` of a gradient each layer's
    work is alive only while that layer's backward runs; reverse over
    reverse is not supported."""

    @staticmethod
    def forward(fn, again, *inputs):
        return fn(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.again = inputs[1]
        ctx.save_for_backward(*inputs[2:])
        ctx.save_for_forward(*inputs[2:])

    @staticmethod
    def backward(ctx, dout):
        with torch.no_grad():
            _, pull = torch.func.vjp(ctx.again, *ctx.saved_tensors)
            return (None, None) + tuple(pull(dout))

    @staticmethod
    def jvp(ctx, _fn, _again, *tangents):
        primals = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, tangents))
        return torch.func.jvp(ctx.again, primals, tangents)[1]


def loss(params: dict, batch, cfg: DeepseekV2Config) -> torch.Tensor:
    """The mean next-token cross-entropy of the batch ``(ids [b, T],
    targets [b, T])`` over the vocabulary.  Each decoder layer keeps only
    its input for the backward pass and recomputes the rest
    (:class:`_Recomputed`)."""
    ids, targets = batch
    b, T = ids.shape
    H, eps = cfg.hidden_size, cfg.rms_norm_eps
    h = params["embed"].index_select(0, ids.reshape(-1)).view(b, T, H)
    cos, sin = rope_tables(cfg, T, h.device, h.dtype)
    for i in range(cfg.num_hidden_layers):
        leaves, spec = tree_flatten(params["layers"][f"{i:02d}"])
        h = _Recomputed.apply(_decoder_layer(cfg, i, spec, True),
                              _decoder_layer(cfg, i, spec, False),
                              h, cos, sin, *leaves)
    with label("head"):
        logits = _norm(h, params["norm"], eps) @ params["head"].T
        return F.cross_entropy(logits.reshape(b * T, -1),
                               targets.reshape(-1))
