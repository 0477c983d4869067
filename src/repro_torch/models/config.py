"""Architecture configuration for the LM substrate.

One ``ArchConfig`` describes any of the 10 assigned architectures (plus the
reduced smoke variants).  The block pattern abstraction lets a single
decoder-only model cover dense / MoE / hybrid (RG-LRU + local attn) / SSM /
VLM-backbone families; whisper uses the enc-dec model over the same layers.

The port's copy of the reference ``models/config.py``, verbatim below
this docstring.  Parameters carry *logical axes* for a later sharding
slice; nothing in this module touches device state.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence


class BlockKind(str, enum.Enum):
    ATTN = "attn"            # global self-attention + MLP
    LOCAL_ATTN = "local"     # sliding-window self-attention + MLP
    RECURRENT = "rglru"      # RG-LRU recurrent block + MLP
    SSM = "ssm"              # mamba2 SSD block (no separate MLP)
    MOE = "moe"              # global self-attention + MoE FFN


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                      # dense | moe | encdec | hybrid | ssm | vlm | audio
    # -- trunk -------------------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # -- variants ----------------------------------------------------------
    mlp: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    pos: str = "rope"                # rope | sinusoidal | none
    # beyond-paper TP lever (§Perf): pad the q-head count to a multiple of
    # the model axis so attention can head-shard (e.g. qwen2 28 -> 32);
    # K/V are repeated to the padded count inside sequence-form attention.
    pad_q_heads: int = 0
    # §Perf lever for GQA + head-TP: the grouped [Hkv, G] attention layout
    # splits the sharded head dim (GSPMD reshards every chunk); repeating
    # K/V to full MHA keeps the head dim intact at a small kv-bytes cost.
    repeat_kv: bool = False
    # §Perf lever: pad the embedding/logits vocab dim up to a multiple of
    # the model axis (whisper 51865 -> 51872) so the CE logits shard;
    # padded ids are masked out of the softmax (exact same loss).
    vocab_pad: int = 0
    rope_theta: float = 10_000.0
    qkv_bias: bool = False           # qwen2-style QKV bias
    attn_bias: bool = False          # whisper-style bias on all projections
    tie_embeddings: bool = False
    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # -- hybrid (recurrentgemma) ---------------------------------------------
    window: int = 0                  # local attention window (0 = global)
    pattern: tuple[str, ...] = ()    # block-kind cycle, e.g. (rglru, rglru, local)
    rglru_conv_width: int = 4
    # -- SSM (mamba2) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # -- enc-dec (whisper) -----------------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 0                 # audio frontend stub: precomputed frames
    # -- modality frontend stubs -------------------------------------------
    n_patches: int = 0               # vlm stub: precomputed patch embeddings
    # -- training/serving knobs ---------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "full"              # full | none
    seq_parallel: bool = True        # shard residual-stream seq dim over model
    q_chunk: int = 1024              # chunked-attention query block
    kv_chunk: int = 1024             # chunked-attention kv block
    logit_chunk: int = 512           # CE loss computed per seq chunk
    accum_for: dict[str, int] = dataclasses.field(default_factory=dict)
    # -- provenance ----------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ API
    def block_kinds(self) -> list[BlockKind]:
        """The per-layer block kind list (len == n_layers)."""
        if self.family == "ssm":
            return [BlockKind.SSM] * self.n_layers
        if self.family == "moe":
            return [BlockKind.MOE] * self.n_layers
        if self.pattern:
            cyc = [BlockKind(p) for p in self.pattern]
            return [cyc[i % len(cyc)] for i in range(self.n_layers)]
        return [BlockKind.ATTN] * self.n_layers

    def is_subquadratic(self) -> bool:
        """True if decode state is O(window/state), not O(seq): long_500k ok."""
        kinds = set(self.block_kinds())
        return BlockKind.ATTN not in kinds and BlockKind.MOE not in kinds

    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def q_heads(self) -> int:
        """Effective (possibly TP-padded) query head count."""
        return self.n_heads + self.pad_q_heads

    def padded_vocab(self) -> int:
        return self.vocab + self.vocab_pad

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline terms)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        qd = self.q_heads() * self.head_dim
        kvd = self.n_kv_heads * self.head_dim
        n_mlp = (3 if self.mlp == "swiglu" else 2) * d * ff

        def attn_params() -> int:
            return d * qd + 2 * d * kvd + qd * d

        total = V * d  # input embedding
        if not self.tie_embeddings:
            total += V * d
        for kind in self.block_kinds():
            if kind in (BlockKind.ATTN, BlockKind.LOCAL_ATTN):
                total += attn_params() + n_mlp + 2 * d
            elif kind == BlockKind.MOE:
                total += attn_params() + 2 * d
                total += self.n_experts * (3 if self.mlp == "swiglu" else 2) * d * ff
                total += d * self.n_experts  # router
            elif kind == BlockKind.RECURRENT:
                di = d  # rglru width = d_model
                total += 2 * d * di + di * d  # in (x,gate branches) + out
                total += self.rglru_conv_width * di + 2 * di * di + di  # conv + gates + lambda
                total += n_mlp + 2 * d
            elif kind == BlockKind.SSM:
                di = self.ssm_expand * d
                nh = di // self.ssm_head_dim
                g = 1  # single B/C group
                zxbcdt = d * (2 * di + 2 * g * self.ssm_state + nh)
                total += zxbcdt + di * d + nh * 2 + di  # in, out, A/dt bias, norm-gate
                total += 2 * d  # norms
        total += d  # final norm
        if self.family == "encdec":
            # encoder layers: self-attn + mlp (+ cross-attn params live in decoder count above)
            enc = self.n_enc_layers * (attn_params() + n_mlp + 2 * d)
            # decoder cross-attention per layer
            enc += self.n_layers * (attn_params() + d)
            total += enc
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D)."""
        if self.n_experts == 0:
            return self.param_count()
        dense_ff = self.n_experts * (3 if self.mlp == "swiglu" else 2) * self.d_model * self.d_ff
        active_ff = self.top_k * (3 if self.mlp == "swiglu" else 2) * self.d_model * self.d_ff
        return self.param_count() - self.n_layers * (dense_ff - active_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """long_500k only for sub-quadratic archs (SSM/hybrid); see DESIGN.md."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic():
        out.append("long_500k")
    return out
