"""Decoder-only LM for the dense, MoE, SSM, hybrid and VLM families: the
serving path.

Port of the reference ``models/transformer.py``: token embedding (for
the VLM family behind a prefix of precomputed patch embeddings), a loop
over the stacked repeating block groups (the reference's ``lax.scan``)
and then the tail blocks, final norm, and last-position logits.  Two
entry points serve a model:

  ``prefill_fn`` — forward over a prompt (``patches`` [B,P,d] in front
                   of the VLM's tokens); returns last-position logits and
                   a decode cache sized ``max_len``
  ``decode_fn``  — one-token serve step against the cache

Every block kind is ported: ``ATTN``, ``MOE`` (attention, then the
capacity-bounded expert FFN of ``models/moe.py`` in place of the MLP;
its aux loss is dropped, since serving has no loss), ``SSM``,
``RECURRENT`` (RG-LRU) and ``LOCAL_ATTN`` (sliding-window attention with
a ring cache).  The training entry point ``loss_fn`` raises
``NotImplementedError`` (ROADMAP A11.4).  Sinusoidal positions belong to
the enc-dec family (``models/encdec.py``); no config of these families
has them.  The param and cache trees keep the
reference's layout (stacked ``blocks``/``layers`` with a leading group
dim, a ``tail`` list), so carrying weights across is a plain map; the
weights may be held in the float32 store or the 16-bit one
(``models/params.py``), which compute the same bits.

In place: ``decode_fn`` writes each layer's new K/V row (and ring
position) into the cache it is given (the reference's ``.at[].set``
makes new arrays), copies each fresh SSM and RG-LRU state into it, and
returns that cache with ``lens`` advanced.  No remat: serving keeps no
activations for a backward pass.
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
from repro_torch.models.moe import apply_moe, moe_spec
from repro_torch.models.params import (DTYPES, LeafSpec, check_device,
                                       normal, stacked, tree_leaves,
                                       tree_map)
from repro_torch.models.rglru import (apply_rglru, rglru_decode_step,
                                      rglru_spec)

# ---------------------------------------------------------------------------
# Specs


def _norm_spec(cfg):
    return rmsnorm_spec(cfg.d_model) if cfg.norm == "rmsnorm" \
        else layernorm_spec(cfg.d_model)


def block_spec(cfg: ArchConfig, kind: BlockKind) -> dict:
    if kind in (BlockKind.ATTN, BlockKind.LOCAL_ATTN):
        return {"ln1": _norm_spec(cfg), "attn": attention_spec(cfg),
                "ln2": _norm_spec(cfg), "mlp": mlp_spec(cfg)}
    if kind == BlockKind.MOE:
        return {"ln1": _norm_spec(cfg), "attn": attention_spec(cfg),
                "ln2": _norm_spec(cfg), "moe": moe_spec(cfg)}
    if kind == BlockKind.SSM:
        return {"ln": _norm_spec(cfg), "ssm": mamba2_spec(cfg)}
    if kind == BlockKind.RECURRENT:
        return {"ln1": _norm_spec(cfg), "rglru": rglru_spec(cfg),
                "ln2": _norm_spec(cfg), "mlp": mlp_spec(cfg)}
    raise ValueError(kind)


def _layer_groups(cfg: ArchConfig) -> tuple[list[BlockKind], int,
                                            list[BlockKind]]:
    """(group_pattern, n_groups, tail_kinds).  Uniform archs: the group is
    one block and there is no tail."""
    kinds = cfg.block_kinds()
    if cfg.pattern:
        g = [BlockKind(p) for p in cfg.pattern]
        n = len(kinds) // len(g)
        return g, n, kinds[n * len(g):]
    return [kinds[0]], len(kinds), []


def model_spec(cfg: ArchConfig) -> dict:
    group, n_groups, tail = _layer_groups(cfg)
    gspec = {f"b{i}": block_spec(cfg, k) for i, k in enumerate(group)}
    spec: dict[str, Any] = {
        "embed": normal((cfg.padded_vocab(), cfg.d_model), ("vocab", "embed"),
                        scale=0.02, cast=True),
        "blocks": stacked(n_groups, gspec),
        "final_norm": _norm_spec(cfg),
    }
    if tail:
        spec["tail"] = [block_spec(cfg, k) for k in tail]
    if not cfg.tie_embeddings:
        spec["head"] = normal((cfg.d_model, cfg.padded_vocab()),
                              ("embed", "vocab"), cast=True)
    return spec


# ---------------------------------------------------------------------------
# Block application — prefill sequence form


def _attn_part(p, h, cfg, positions, window=0, causal=True):
    """Pre-norm self-attention with its residual -> (h', (k, v))."""
    x = apply_norm(p["ln1"], h, cfg.norm)
    q, k, v = project_qkv(p["attn"], x, cfg, positions)
    a = attention(q, k, v, cfg, causal=causal, window=window)
    B, S = a.shape[:2]
    return h + dense(p["attn"]["o"], a.reshape(B, S, -1)), (k, v)


def apply_block(p: dict, h: torch.Tensor, kind: BlockKind, cfg: ArchConfig,
                positions, collect_cache: bool = False, max_len: int = 0):
    """-> (h', cache_entry) — cache entry only when collect_cache."""
    cache = None
    if kind in (BlockKind.ATTN, BlockKind.LOCAL_ATTN, BlockKind.MOE):
        window = cfg.window if kind == BlockKind.LOCAL_ATTN else 0
        h, (k, v) = _attn_part(p, h, cfg, positions, window)
        h = h + _ffn(p, apply_norm(p["ln2"], h, cfg.norm), kind, cfg)
        if collect_cache:
            cache = _attn_cache_from_prefill(k, v, kind, cfg, max_len)
    elif kind == BlockKind.SSM:
        x = apply_norm(p["ln"], h, cfg.norm)
        if collect_cache:
            y, cache = apply_ssd(p["ssm"], x, cfg, return_state=True)
        else:
            y = apply_ssd(p["ssm"], x, cfg)
        h = h + y
    elif kind == BlockKind.RECURRENT:
        x = apply_norm(p["ln1"], h, cfg.norm)
        if collect_cache:
            y, (hstate, conv) = apply_rglru(p["rglru"], x, cfg,
                                            return_state=True)
            cache = {"h": hstate, "conv": conv}
        else:
            y = apply_rglru(p["rglru"], x, cfg)
        h = h + y
        x2 = apply_norm(p["ln2"], h, cfg.norm)
        h = h + apply_mlp(p["mlp"], x2, cfg)
    else:
        raise ValueError(kind)
    return h, cache


def _ffn(p, x, kind, cfg):
    """The feed-forward half of an attention block: the experts for
    ``MOE`` (aux loss dropped), else the MLP."""
    if kind == BlockKind.MOE:
        return apply_moe(p["moe"], x, cfg)[0]
    return apply_mlp(p["mlp"], x, cfg)


def _attn_cache_from_prefill(k, v, kind, cfg, max_len):
    """Build the decode cache entry from prefill K/V.

    ``LOCAL_ATTN`` keeps a ring of ``W = cfg.window`` slots: the entry
    for absolute position p lives at slot p % W, beside ``pos`` (-1 for
    an empty slot).  A prompt of S >= W leaves its last W positions, a
    rotation of them; a shorter one puts position p at slot p and leaves
    slots S.. empty (zeros, pos -1) — what the reference's scatter of a
    left-padded window leaves, written without its colliding indices."""
    B, S = k.shape[:2]
    if kind == BlockKind.LOCAL_ATTN:
        W = cfg.window
        kr = k.new_zeros((B, W, *k.shape[2:]))
        vr = v.new_zeros((B, W, *v.shape[2:]))
        pos = torch.full((W,), -1, dtype=torch.int32, device=k.device)
        if S >= W:
            pw = torch.arange(S - W, S, device=k.device)
            slots = pw % W
            kr[:, slots], vr[:, slots] = k[:, S - W:], v[:, S - W:]
            pos[slots] = pw.to(torch.int32)
        else:
            kr[:, :S], vr[:, :S] = k, v
            pos[:S] = torch.arange(S, dtype=torch.int32, device=k.device)
        return {"k": kr, "v": vr, "pos": pos.expand(B, W).clone()}
    if S < max_len:
        k = F.pad(k, (0, 0, 0, 0, 0, max_len - S))
        v = F.pad(v, (0, 0, 0, 0, 0, max_len - S))
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Block application — decode (one token)


def attn_decode(p: dict, h: torch.Tensor, kind: BlockKind, cfg: ArchConfig,
                cache: dict, lens: torch.Tensor) -> torch.Tensor:
    """The self-attention half of a decode step with its residual: writes
    the new K/V row (for ``LOCAL_ATTN`` into ring slot ``lens % W``, with
    its position) into ``cache``'s tensors in place and attends over the
    rows it keeps.  h [B,1,d]; lens [B] = tokens already in cache."""
    x = apply_norm(p["ln1"], h, cfg.norm)
    q, k, v = project_qkv(p["attn"], x, cfg, lens[:, None])
    B = h.shape[0]
    rows = torch.arange(B, device=h.device)
    kc, vc = cache["k"], cache["v"]
    if kind == BlockKind.LOCAL_ATTN:
        W = cfg.window
        at = (lens % W).long()
        pc = cache["pos"]
        pc[rows, at] = lens.to(pc.dtype)
        valid = ((pc >= 0) & (pc >= (lens - W + 1)[:, None])
                 & (pc <= lens[:, None]))
    else:
        at = lens.long()
        S = kc.shape[1]
        valid = torch.arange(S, device=h.device)[None, :] <= at[:, None]
    kc[rows, at] = k[:, 0].to(kc.dtype)
    vc[rows, at] = v[:, 0].to(vc.dtype)
    a = decode_attention(q[:, 0], kc, vc, valid, h.dtype)
    return h + dense(p["attn"]["o"], a.reshape(B, -1))[:, None, :]


def apply_block_decode(p: dict, h: torch.Tensor, kind: BlockKind,
                       cfg: ArchConfig, cache: dict, lens: torch.Tensor):
    """h [B,1,d]; lens [B] = tokens already in cache. -> (h', cache').

    Attention writes its K/V row into ``cache`` in place
    (``attn_decode``); the SSM and RG-LRU steps return a fresh state."""
    if kind in (BlockKind.ATTN, BlockKind.LOCAL_ATTN, BlockKind.MOE):
        h = attn_decode(p, h, kind, cfg, cache, lens)
        h = h + _ffn(p, apply_norm(p["ln2"], h, cfg.norm), kind, cfg)
    elif kind == BlockKind.SSM:
        x = apply_norm(p["ln"], h, cfg.norm)
        y, cache = ssd_decode_step(p["ssm"], x, cfg, cache)
        h = h + y
    elif kind == BlockKind.RECURRENT:
        x = apply_norm(p["ln1"], h, cfg.norm)
        y, (hstate, conv) = rglru_decode_step(p["rglru"], x, cfg,
                                              (cache["h"], cache["conv"]))
        cache = {"h": hstate, "conv": conv}
        h = h + y
        x2 = apply_norm(p["ln2"], h, cfg.norm)
        h = h + apply_mlp(p["mlp"], x2, cfg)
    else:
        raise ValueError(kind)
    return h, cache


# ---------------------------------------------------------------------------
# Cache specs


def block_cache_spec(cfg: ArchConfig, kind: BlockKind, B: int, max_len: int):
    dt = cfg.dtype
    if kind in (BlockKind.ATTN, BlockKind.MOE):
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
    if kind == BlockKind.LOCAL_ATTN:
        sh = (B, cfg.window, cfg.n_kv_heads, cfg.head_dim)
        ax = ("batch", None, None, None)
        return {"k": LeafSpec(sh, ax, "zeros", dtype=dt),
                "v": LeafSpec(sh, ax, "zeros", dtype=dt),
                "pos": LeafSpec((B, cfg.window), ("batch", None), "zeros",
                                dtype="int32")}
    if kind == BlockKind.RECURRENT:
        dr = cfg.d_model
        W = cfg.rglru_conv_width
        return {"h": LeafSpec((B, dr), ("batch", "mlp"), "zeros",
                              dtype="float32"),
                "conv": LeafSpec((B, W - 1, dr), ("batch", None, "mlp"),
                                 "zeros", dtype=dt)}
    raise ValueError(kind)


def cache_spec(cfg: ArchConfig, B: int, max_len: int) -> dict:
    group, n_groups, tail = _layer_groups(cfg)
    gspec = {f"b{i}": block_cache_spec(cfg, k, B, max_len)
             for i, k in enumerate(group)}
    out = {"layers": stacked(n_groups, gspec),
           "lens": LeafSpec((B,), ("batch",), "zeros", dtype="int32")}
    if tail:
        out["tail"] = [block_cache_spec(cfg, k, B, max_len) for k in tail]
    return out


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
    """Run the block groups, then the tail. -> (h, cache|None); the
    groups' collected cache is stacked per group, as the reference's scan
    stacks it, and the tail's is a list."""
    group, n_groups, tail = _layer_groups(cfg)
    caches = []
    for gi in range(n_groups):
        gp = _layer(params["blocks"], gi)
        gc = {}
        for i, kind in enumerate(group):
            h, gc[f"b{i}"] = apply_block(gp[f"b{i}"], h, kind, cfg,
                                         positions, collect_cache, max_len)
        caches.append(gc)
    tail_caches = []
    for i, kind in enumerate(tail):
        h, c = apply_block(params["tail"][i], h, kind, cfg, positions,
                           collect_cache, max_len)
        tail_caches.append(c)
    if not collect_cache:
        return h, None
    cache = {"layers": tree_map(lambda *xs: torch.stack(xs), caches[0],
                                *caches[1:])}
    if tail:
        cache["tail"] = tail_caches
    return h, cache


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
    def hidden(self, params, tokens, patches=None,
               collect_cache: bool = False, max_len: int = 0):
        """tokens [B,S] (behind ``patches`` [B,P,d], the VLM's prefix) ->
        (h [B,P+S,d] after the final norm, cache|None); positions run
        over all P + S rows."""
        cfg = self.cfg
        h = _embed_tokens(params, tokens, cfg)
        if patches is not None:
            h = torch.cat([patches.to(h.dtype), h], dim=1)
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        h, cache = trunk(params, h, cfg, positions, collect_cache, max_len)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        return h, cache

    def loss_fn(self, params, batch):
        raise NotImplementedError("training (loss_fn, chunked_ce) is not "
                                  "ported yet (ROADMAP A11.4)")

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def prefill_fn(self, params, tokens, max_len: int, patches=None):
        """-> (last-position logits [B,V], cache); ``lens`` counts the
        patches too."""
        h, cache = self.hidden(params, tokens, patches, collect_cache=True,
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
        group, n_groups, tail = _layer_groups(cfg)
        lens = cache["lens"]
        h = _embed_tokens(params, tok[:, None], cfg)
        for gi in range(n_groups):
            gp = _layer(params["blocks"], gi)
            gcache = _layer(cache["layers"], gi)
            for i, kind in enumerate(group):
                gc = gcache[f"b{i}"]
                h, c = apply_block_decode(gp[f"b{i}"], h, kind, cfg, gc,
                                          lens)
                _write_back(gc, c)
        for i, kind in enumerate(tail):
            gc = cache["tail"][i]
            h, c = apply_block_decode(params["tail"][i], h, kind, cfg, gc,
                                      lens)
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
