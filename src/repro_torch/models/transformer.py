"""Decoder-only LM for the dense and SSM families: the serving path.

Port of the reference ``models/transformer.py``: token embedding, a loop
over the stacked blocks (the reference's ``lax.scan``), final norm, and
last-position logits.  Two entry points serve a model:

  ``prefill_fn`` — forward over a prompt; returns last-position logits and
                   a decode cache sized ``max_len``
  ``decode_fn``  — one-token serve step against the cache

Block kinds ``ATTN`` and ``SSM`` are ported; ``MOE``, ``RECURRENT`` and
``LOCAL_ATTN`` raise ``NotImplementedError`` (ROADMAP A11), as does the
training entry point ``loss_fn``.  Without the hybrid and enc-dec
families there are no repeating block groups, tail blocks or sinusoidal
positions.  The param and cache trees keep the reference's layout
(stacked ``blocks``/``layers`` with a leading layer dim), so carrying
weights across is a plain map.

In place: ``decode_fn`` writes each layer's new K/V row and SSM state
into the stacked cache it is given (the reference's ``.at[].set`` makes
new arrays) and returns that cache with ``lens`` advanced.  No remat:
serving keeps no activations for a backward pass.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig, BlockKind
from repro_torch.models.layers import (apply_mlp, apply_norm, attention,
                                       attention_spec, decode_attention,
                                       dense, layernorm_spec, mlp_spec,
                                       project_qkv, rmsnorm_spec)
from repro_torch.models.mamba2 import (apply_ssd, dims as ssm_dims,
                                       mamba2_spec, ssd_decode_step)
from repro_torch.models.params import (DTYPES, LeafSpec, check_device,
                                       normal, stacked, tree_leaves,
                                       tree_map)

PORTED = (BlockKind.ATTN, BlockKind.SSM)


def _unported(kind) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {BlockKind(kind).value!r} is not ported yet "
        "(ROADMAP A11): the port serves the dense and ssm families")


# ---------------------------------------------------------------------------
# Specs


def _norm_spec(cfg):
    return rmsnorm_spec(cfg.d_model) if cfg.norm == "rmsnorm" \
        else layernorm_spec(cfg.d_model)


def block_spec(cfg: ArchConfig, kind: BlockKind) -> dict:
    if kind == BlockKind.ATTN:
        return {"ln1": _norm_spec(cfg), "attn": attention_spec(cfg),
                "ln2": _norm_spec(cfg), "mlp": mlp_spec(cfg)}
    if kind == BlockKind.SSM:
        return {"ln": _norm_spec(cfg), "ssm": mamba2_spec(cfg)}
    raise _unported(kind)


def _block_kind(cfg: ArchConfig) -> BlockKind:
    """The one block kind of every layer.  The ported families are
    uniform, so the reference's repeating groups are one block (``b0``)
    and there is no tail; any unported kind raises."""
    kinds = set(cfg.block_kinds())
    for k in kinds:
        if k not in PORTED:
            raise _unported(k)
    (kind,) = kinds
    return kind


def model_spec(cfg: ArchConfig) -> dict:
    spec: dict[str, Any] = {
        "embed": normal((cfg.padded_vocab(), cfg.d_model), ("vocab", "embed"),
                        scale=0.02),
        "blocks": stacked(cfg.n_layers,
                          {"b0": block_spec(cfg, _block_kind(cfg))}),
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        spec["head"] = normal((cfg.d_model, cfg.padded_vocab()),
                              ("embed", "vocab"))
    return spec


# ---------------------------------------------------------------------------
# Block application — prefill sequence form


def _attn_part(p, h, cfg, positions, window):
    x = apply_norm(p["ln1"], h, cfg.norm)
    q, k, v = project_qkv(p["attn"], x, cfg, positions)
    a = attention(q, k, v, cfg, causal=True, window=window)
    B, S = a.shape[:2]
    return h + dense(p["attn"]["o"], a.reshape(B, S, -1)), (k, v)


def apply_block(p: dict, h: torch.Tensor, kind: BlockKind, cfg: ArchConfig,
                positions, collect_cache: bool = False, max_len: int = 0):
    """-> (h', cache_entry) — cache entry only when collect_cache."""
    cache = None
    if kind == BlockKind.ATTN:
        h, (k, v) = _attn_part(p, h, cfg, positions, 0)
        x2 = apply_norm(p["ln2"], h, cfg.norm)
        h = h + apply_mlp(p["mlp"], x2, cfg)
        if collect_cache:
            cache = _attn_cache_from_prefill(k, v, kind, cfg, max_len)
    elif kind == BlockKind.SSM:
        x = apply_norm(p["ln"], h, cfg.norm)
        if collect_cache:
            y, cache = apply_ssd(p["ssm"], x, cfg, return_state=True)
        else:
            y = apply_ssd(p["ssm"], x, cfg)
        h = h + y
    else:
        raise _unported(kind)
    return h, cache


def _attn_cache_from_prefill(k, v, kind, cfg, max_len):
    """Build the decode cache entry from prefill K/V (global attention:
    the ring cache of ``LOCAL_ATTN`` comes with A11)."""
    S = k.shape[1]
    if S < max_len:
        k = F.pad(k, (0, 0, 0, 0, 0, max_len - S))
        v = F.pad(v, (0, 0, 0, 0, 0, max_len - S))
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Block application — decode (one token)


def apply_block_decode(p: dict, h: torch.Tensor, kind: BlockKind,
                       cfg: ArchConfig, cache: dict, lens: torch.Tensor):
    """h [B,1,d]; lens [B] = tokens already in cache. -> (h', cache').

    Attention writes the new K/V row into ``cache``'s tensors in place;
    the SSM step returns a fresh state."""
    if kind == BlockKind.ATTN:
        x = apply_norm(p["ln1"], h, cfg.norm)
        q, k, v = project_qkv(p["attn"], x, cfg, lens[:, None])
        B = h.shape[0]
        rows = torch.arange(B, device=h.device)
        at = lens.long()
        kc, vc = cache["k"], cache["v"]
        kc[rows, at] = k[:, 0].to(kc.dtype)
        vc[rows, at] = v[:, 0].to(vc.dtype)
        S = kc.shape[1]
        valid = torch.arange(S, device=h.device)[None, :] <= at[:, None]
        a = decode_attention(q[:, 0], kc, vc, valid, h.dtype)
        h = h + dense(p["attn"]["o"], a.reshape(B, -1))[:, None, :]
        x2 = apply_norm(p["ln2"], h, cfg.norm)
        h = h + apply_mlp(p["mlp"], x2, cfg)
    elif kind == BlockKind.SSM:
        x = apply_norm(p["ln"], h, cfg.norm)
        y, cache = ssd_decode_step(p["ssm"], x, cfg, cache)
        h = h + y
    else:
        raise _unported(kind)
    return h, cache


# ---------------------------------------------------------------------------
# Cache specs


def block_cache_spec(cfg: ArchConfig, kind: BlockKind, B: int, max_len: int):
    dt = cfg.dtype
    if kind == BlockKind.ATTN:
        sh = (B, max_len, cfg.n_kv_heads, cfg.head_dim)
        ax = ("batch", "cache_seq", None, None)
        return {"k": LeafSpec(sh, ax, "zeros", dtype=dt),
                "v": LeafSpec(sh, ax, "zeros", dtype=dt)}
    if kind == BlockKind.SSM:
        di, nh, hp, N = ssm_dims(cfg)
        ch = di + 2 * N
        return {"ssm": LeafSpec((B, nh, hp, N),
                                ("batch", "heads3", None, None),
                                "zeros", dtype="float32"),
                "conv": LeafSpec((B, 3, ch), ("batch", None, None), "zeros",
                                 dtype=dt)}
    raise _unported(kind)


def cache_spec(cfg: ArchConfig, B: int, max_len: int) -> dict:
    gspec = {"b0": block_cache_spec(cfg, _block_kind(cfg), B, max_len)}
    return {"layers": stacked(cfg.n_layers, gspec),
            "lens": LeafSpec((B,), ("batch",), "zeros", dtype="int32")}


# ---------------------------------------------------------------------------
# Trunk


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda x: x[i], tree)


def _embed_tokens(params, tokens, cfg):
    # gather the rows, then cast: the reference casts the whole table
    # first, which gives the same values
    return params["embed"][tokens.long()].to(DTYPES[cfg.dtype])


def trunk(params: dict, h: torch.Tensor, cfg: ArchConfig, positions,
          collect_cache: bool = False, max_len: int = 0):
    """Run the block stack. -> (h, cache|None); the collected cache is
    stacked per layer, as the reference's scan stacks it."""
    kind = _block_kind(cfg)
    caches = []
    for li in range(cfg.n_layers):
        h, c = apply_block(_layer(params["blocks"], li)["b0"], h, kind, cfg,
                           positions, collect_cache, max_len)
        caches.append({"b0": c})
    if not collect_cache:
        return h, None
    return h, {"layers": tree_map(lambda *xs: torch.stack(xs), caches[0],
                                  *caches[1:])}


def _write_back(dst, src):
    """Copy each leaf of ``src`` into ``dst`` unless it is ``dst`` already
    (the attention rows were written in place)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if s is not d:
            d.copy_(s)


# ---------------------------------------------------------------------------
# Public model API


class DecoderLM:
    """Decoder-only model (pure-function methods over a params tree).

    ``device`` (default ``"cuda"``) is where its params live; the model
    raises at construction when that is CUDA and torch sees no card."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.device = check_device(device)
        _block_kind(cfg)  # refuses unported block kinds early

    # -- params ------------------------------------------------------------
    def spec(self) -> dict:
        return model_spec(self.cfg)

    def head_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def _logits(self, params, h):
        """h [B,d] -> logits [B,vocab] in h's dtype."""
        return (h @ self.head_w(params).to(h.dtype))[:, : self.cfg.vocab]

    # -- forward ------------------------------------------------------------
    def hidden(self, params, tokens, collect_cache: bool = False,
               max_len: int = 0):
        """tokens [B,S] -> (h [B,S,d] after the final norm, cache|None)."""
        cfg = self.cfg
        h = _embed_tokens(params, tokens, cfg)
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        h, cache = trunk(params, h, cfg, positions, collect_cache, max_len)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        return h, cache

    def loss_fn(self, params, batch):
        raise NotImplementedError("training (loss_fn, chunked_ce) is not "
                                  "ported yet (ROADMAP A11)")

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def prefill_fn(self, params, tokens, max_len: int):
        """-> (last-position logits [B,V], cache)."""
        h, cache = self.hidden(params, tokens, collect_cache=True,
                               max_len=max_len)
        logits = self._logits(params, h[:, -1, :])
        cache["lens"] = torch.full((tokens.shape[0],), h.shape[1],
                                   dtype=torch.int32, device=h.device)
        return logits, cache

    @torch.no_grad()
    def decode_fn(self, params, tok: torch.Tensor, cache: dict):
        """tok [B] int -> (logits [B,V], cache'); updates ``cache`` in
        place and returns it with ``lens`` advanced."""
        cfg = self.cfg
        kind = _block_kind(cfg)
        lens = cache["lens"]
        h = _embed_tokens(params, tok[:, None], cfg)
        for li in range(cfg.n_layers):
            gc = _layer(cache["layers"], li)["b0"]
            h, c = apply_block_decode(_layer(params["blocks"], li)["b0"], h,
                                      kind, cfg, gc, lens)
            _write_back(gc, c)
        cache["lens"] = lens + 1
        h = apply_norm(params["final_norm"], h, cfg.norm)
        return self._logits(params, h[:, 0, :]), cache


def cache_max_len(cache) -> int:
    """Static cache capacity (from the stacked attn K buffer)."""
    for leaf in tree_leaves(cache["layers"]):
        if leaf.ndim >= 3:
            return leaf.shape[2]
    return 0
