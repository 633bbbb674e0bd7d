"""Architecture config schema + input-shape cells.

Every assigned architecture is a ``--arch <id>`` selectable ArchConfig; the
four input-shape cells (train_4k / prefill_32k / decode_32k / long_500k)
are ShapeCells.  ``reduced()`` yields the CPU smoke-test variant.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "swiglu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    scale_embed: bool = False        # gemma: embeddings scaled by sqrt(d)
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    # hybrid (recurrentgemma): layer pattern, window for local attention
    pattern: tuple = ()              # e.g. ("rec", "rec", "attn")
    window: int = 0
    rglru_dim: int = 0
    # enc-dec
    n_enc_layers: int = 0
    src_len: int = 3200              # stub frontend output length (audio frames)
    # vlm
    mrope_sections: tuple = ()       # (t, h, w) head_dim/2 split
    n_patches: int = 1024            # stub vision frontend output length
    # NVR sparse-KV decode (the paper's technique)
    sparse_kv: bool = True           # eligible for TopK sparse decode
    kv_page: int = 16                # fuzzy gather granularity (tokens/page)
    kv_topk_pages: int = 64          # pages kept per head
    kv_dtype: str = "bfloat16"       # "int8": quantised KV cache (beyond-paper)
    # numerics
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return replace(
            self,
            n_layers=min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            d_ff_expert=128 if self.d_ff_expert else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 64,
            pattern=self.pattern[:3] if self.pattern else (),
            window=min(self.window, 64) if self.window else 0,
            rglru_dim=128 if self.rglru_dim else 0,
            src_len=64,
            n_patches=16,
            mrope_sections=(8, 4, 4) if self.mrope_sections else (),
            kv_topk_pages=4,
            kv_page=4,
            param_dtype="float32",
        )

    def params_count(self) -> float:
        """Analytic parameter count (for 6ND roofline terms)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, ds, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            per = (d * (2 * di + 2 * ds + nh)    # in_proj (z,x,B,C,dt heads)
                   + self.conv_width * (di + 2 * ds)
                   + di * d + 2 * d)
            return emb + self.n_layers * per
        att = d * (self.n_heads * hd + 2 * self.n_kv_heads * hd) \
            + self.n_heads * hd * d
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        if self.n_experts:
            ffn = self.n_experts * glu * d * (self.d_ff_expert or self.d_ff) \
                + d * self.n_experts
        else:
            ffn = glu * d * self.d_ff
        per = att + ffn + 2 * d
        n_dec = self.n_layers
        total = emb + n_dec * per
        if self.n_enc_layers:
            total += self.n_enc_layers * (att + glu * d * self.d_ff + 2 * d)
            total += n_dec * att  # cross-attention in decoder
        if self.family == "hybrid":
            # recurrent layers replace attention with RG-LRU block
            n_rec = sum(1 for i in range(self.n_layers)
                        if self.pattern[i % len(self.pattern)] == "rec")
            rec_per = d * self.rglru_dim * 2 + self.rglru_dim * d \
                + 3 * self.rglru_dim
            total += n_rec * (rec_per - att)
        return float(total)

    def active_params_count(self) -> float:
        """Activated params per token (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.params_count()
        full = self.params_count()
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        expert_p = self.n_layers * self.n_experts * glu * self.d_model \
            * (self.d_ff_expert or self.d_ff)
        active_p = expert_p * self.top_k / self.n_experts
        return float(full - expert_p + active_p)


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def smoke_shape(kind: str) -> ShapeCell:
    if kind == "train":
        return ShapeCell("smoke_train", 64, 2, "train")
    if kind == "prefill":
        return ShapeCell("smoke_prefill", 64, 2, "prefill")
    return ShapeCell("smoke_decode", 64, 2, "decode")
