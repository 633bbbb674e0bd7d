"""Shared model layers: RMSNorm, split-half RoPE, GQA projection and the
flash-style chunked attention that is the prefill kernel's plain version.

Functions over tensors and a params dict, with the reference's casts:
norms and rotary run in float32 and cast back; attention accumulates in
float32.
"""

from __future__ import annotations

import torch

from .sparse_attention import kv_dequant_f32

Params = dict


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w.to(x.dtype))


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, H, D]; pos [..., S] (broadcastable).  Split-half."""
    d = x.shape[-1]
    ang = pos[..., None].float() * rope_freqs(d, theta, x.device)
    ang = ang[..., None, :]                           # [..., S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      chunk: int = 1024,
                      logit_softcap: float = 0.0) -> torch.Tensor:
    """Flash-style GQA attention in float32, looped over KV chunks.

    q [B, Sq, H, D]; k, v [B, Sk, KV, D] (float or int8 pools);
    H = KV * G and query head h reads KV head h // G.  ``q_offset`` is
    the absolute position of q[0] (chunked prefill).  Fully-masked rows
    give zeros, not NaNs."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    qf = q.float() / (d ** 0.5)
    n_chunks = max(1, -(-sk // chunk))
    while sk % n_chunks:                             # sk need not divide chunk
        n_chunks += 1
    ck = sk // n_chunks
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, sq, h), float("-inf"), device=dev)
    l = torch.zeros((b, sq, h), device=dev)
    acc = torch.zeros((b, sq, h, d), device=dev)
    for c in range(n_chunks):
        c0 = c * ck
        # [B, ck, H, D]: each KV head repeated for its G query heads
        kh = kv_dequant_f32(k[:, c0:c0 + ck]).repeat_interleave(g, dim=2)
        vh = kv_dequant_f32(v[:, c0:c0 + ck]).repeat_interleave(g, dim=2)
        s = torch.einsum("bqhd,bthd->bqht", qf, kh)
        if logit_softcap:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        kpos = c0 + torch.arange(ck, device=dev)
        mask = torch.ones((sq, ck), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        mask4 = mask[None, :, None, :]
        s = torch.where(mask4, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask4, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqht,bthd->bqhd", p, vh)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def gqa_project(x: torch.Tensor, p: Params, cfg):
    """QKV projection with optional bias: [B,S,H,D], [B,S,KV,D] x2."""
    b, s, _ = x.shape
    q = torch.matmul(x, p["wq"].to(x.dtype))
    k = torch.matmul(x, p["wk"].to(x.dtype))
    v = torch.matmul(x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, cfg.n_heads, cfg.hd),
            k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


def attn_out(o: torch.Tensor, p: Params) -> torch.Tensor:
    b, s, h, hd = o.shape
    return torch.matmul(o.reshape(b, s, h * hd), p["wo"].to(o.dtype))
