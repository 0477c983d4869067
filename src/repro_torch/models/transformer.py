"""Decoder-only LM for the dense, MoE, SSM, hybrid and VLM families.

Port of the reference ``models/transformer.py``: token embedding (for
the VLM family behind a prefix of precomputed patch embeddings), the
sinusoidal table where ``cfg.pos`` asks for it, a loop over the stacked
repeating block groups (the reference's ``lax.scan``) and then the tail
blocks, final norm.  Three entry points:

  ``loss_fn``    — training loss: ``hidden(..., train=True)``, then the
                   seq-chunked cross-entropy ``chunked_ce`` (never the
                   full ``[B,S,V]`` logits) plus MoE's Switch aux loss
  ``prefill_fn`` — forward over a prompt (``patches`` [B,P,d] in front
                   of the VLM's tokens); returns last-position logits and
                   a decode cache sized ``max_len``
  ``decode_fn``  — one-token serve step against the cache

Every block kind is ported: ``ATTN``, ``MOE`` (attention, then the
capacity-bounded expert FFN of ``models/moe.py`` in place of the MLP;
``apply_block`` returns its aux loss and ``trunk`` sums it), ``SSM``,
``RECURRENT`` (RG-LRU) and ``LOCAL_ATTN`` (sliding-window attention with
a ring cache).  The param and cache trees keep the reference's layout
(stacked ``blocks``/``layers`` with a leading group dim, a ``tail``
list), so carrying weights across is a plain map; the weights may be
held in the float32 store or the 16-bit one (``models/params.py``),
which compute the same bits.

Training route (``train=True``, set by ``loss_fn``): each block group is
rematerialized (``layers.remat``, the reference's ``jax.checkpoint`` of
its scan body), attention takes the reference's ``chunked_attention``,
the SSD block its own chunk scan and the RG-LRU block an out-of-place
scan — no hand-written kernel, since none has a backward (the reference
trains through none either).  Serving keeps the kernels.

On a mesh (``build_model(cfg, hints)`` with ``activation_hints`` over a
``launch.mesh.Mesh``): the params are a tree of ``ShardedTensor``s (or
whole tensors) and every entry point runs its mesh form.  The batch
splits into ``R`` row blocks over the data axes and each block runs on
a row of ``M`` devices along ``model`` (``Hints.grid``).  The layer loop
reads one layer's blocks at a time — under ``train`` inside the
group's remat, so the backward reads them again.  Every block kind runs
in the layout the reference gives it through its parameters' logical
axes: ``ATTN``, ``MOE`` and ``LOCAL_ATTN`` attention by head shard
(``layers.attention_tp``, the window passed on; where the query heads
do not split over ``model``, whole on the row's first device,
``layers.head_devices``), the MLP column- then row-parallel
(``mlp_tp``) and MoE its expert-parallel dispatch (``models/moe.py``);
``SSM`` by head shard (``mamba2.ssd_tp``) and ``RECURRENT``'s RG-LRU by
channel shard (``rglru.rglru_tp``), where the model size divides the
heads or the channels (``spec_for`` splits the weights then; where it
does not, it replicates them over ``model`` and the block runs whole on
the row's first device).  The embedding and the serving logits are
vocab-parallel.  Where the config is sequence-parallel
(``Hints.seq_parallel``: train and prefill, ``cfg.seq_parallel`` and
``model`` > 1) the residual between blocks is the reference's
``P(dp, "model", None)``: model index ``j`` holds rows
``split_range(S, M, j)`` (uneven where ``M`` does not divide ``S``; the
reference pads).  The embedding's parts are reduce-scattered onto those
rows, each block all-gathers its normed shards before its
column-parallel products and reduce-scatters its row-parallel partials
back (``layers.psum_scatter_rows``), MoE's expert-parallel dispatch
routes each device's own rows, and a form that runs whole on a row's
first device gathers the shards and hands each device its rows after.
The loss is vocab-parallel (``chunked_ce_tp``, the reference's
``logits`` spec): no device reads the head whole; it reduces the NLL
sums and label counts over the replicas separately (the global mean).
Decode keeps the whole one-token residual.  The prefill cache comes out
in ``spec_for``'s layout of ``cache_spec``: each attention layer's K/V
in ``cache_seq`` blocks over ``model`` (the whole rows of every KV head,
from the devices that projected them; ``max_len`` rounded up to a
multiple of the model size), which ``decode_fn`` attends block by block
and LSE-combines (``attention_decode_tp``); the SSM state by head and
the RG-LRU state by channel, each device's own; the local-attention
ring and the SSM's conv rows replicated over ``model``, one master per
batch block on its row's first device, read where used (the ring by
head shard, ``attention_cached_tp``) and written there once a step.

In place: ``decode_fn`` writes each layer's new K/V row (and ring
position) into the cache it is given (the reference's ``.at[].set``
makes new arrays), copies each fresh SSM and RG-LRU state into it, and
returns that cache with ``lens`` advanced.  No remat when serving: it
keeps no activations for a backward pass.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              ShardedTensor, cache_leaf_spec,
                                              is_sharded, piece, whole)
from repro_torch.models.config import ArchConfig, BlockKind
from repro_torch.models.layers import (NO_HINTS, Hints, apply_mlp,
                                       apply_norm, attention,
                                       attention_cached_tp,
                                       attention_decode_tp, attention_spec,
                                       attention_tp, decode_attention,
                                       dense, gathered_cols, head_devices,
                                       layernorm_spec, mlp_spec, mlp_tp,
                                       project_qkv, remat, rmsnorm_spec,
                                       rope, seq_gather, seq_scatter,
                                       seq_whole, sinusoidal_rows,
                                       sinusoidal_table, split_range)
from repro_torch.models.mamba2 import (apply_ssd, dims as ssm_dims,
                                       mamba2_spec, ssd_decode_step,
                                       ssd_decode_tp, ssd_tp)
from repro_torch.models.moe import apply_moe, moe_ep, moe_spec, uses_ep
from repro_torch.models.params import (DTYPES, LeafSpec, check_device,
                                       normal, stacked, tree_leaves,
                                       tree_map)
from repro_torch.models.rglru import (apply_rglru, rglru_decode_step,
                                      rglru_decode_tp, rglru_spec,
                                      rglru_tp)

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
# Block application — train/prefill sequence form


def _attn_part(p, h, cfg, positions, window=0, causal=True, train=False):
    """Pre-norm self-attention with its residual -> (h', (k, v))."""
    x = apply_norm(p["ln1"], h, cfg.norm)
    q, k, v = project_qkv(p["attn"], x, cfg, positions)
    a = attention(q, k, v, cfg, causal=causal, window=window, train=train)
    B, S = a.shape[:2]
    return h + dense(p["attn"]["o"], a.reshape(B, S, -1)), (k, v)


def apply_block(p: dict, h: torch.Tensor, kind: BlockKind, cfg: ArchConfig,
                positions, collect_cache: bool = False, max_len: int = 0,
                train: bool = False):
    """-> (h', aux, cache_entry): ``aux`` is the MoE block's Switch aux
    loss (a float32 zero for every other kind), the cache entry only when
    collect_cache.  ``train`` takes the training route (module
    docstring)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    cache = None
    if kind in (BlockKind.ATTN, BlockKind.LOCAL_ATTN, BlockKind.MOE):
        window = cfg.window if kind == BlockKind.LOCAL_ATTN else 0
        h, (k, v) = _attn_part(p, h, cfg, positions, window, train=train)
        x2 = apply_norm(p["ln2"], h, cfg.norm)
        if kind == BlockKind.MOE:
            y, aux = apply_moe(p["moe"], x2, cfg)
        else:
            y = apply_mlp(p["mlp"], x2, cfg)
        h = h + y
        if collect_cache:
            cache = _attn_cache_from_prefill(k, v, kind, cfg, max_len)
    elif kind == BlockKind.SSM:
        x = apply_norm(p["ln"], h, cfg.norm)
        if collect_cache:
            y, cache = apply_ssd(p["ssm"], x, cfg, return_state=True,
                                 train=train)
        else:
            y = apply_ssd(p["ssm"], x, cfg, train=train)
        h = h + y
    elif kind == BlockKind.RECURRENT:
        x = apply_norm(p["ln1"], h, cfg.norm)
        if collect_cache:
            y, (hstate, conv) = apply_rglru(p["rglru"], x, cfg,
                                            return_state=True, train=train)
            cache = {"h": hstate, "conv": conv}
        else:
            y = apply_rglru(p["rglru"], x, cfg, train=train)
        h = h + y
        x2 = apply_norm(p["ln2"], h, cfg.norm)
        h = h + apply_mlp(p["mlp"], x2, cfg)
    else:
        raise ValueError(kind)
    return h, aux, cache


def _ffn(p, x, kind, cfg):
    """The feed-forward half of a decode step's attention block: the
    experts for ``MOE`` (its aux loss unused: decoding has no loss), else
    the MLP."""
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


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, one ``unbind`` a leaf (views,
    no copies): under autograd each leaf's layer gradients are stacked
    once, where ``n`` separate ``_layer`` selects would each make a
    zero-filled gradient of the whole stack.  A ``ShardedTensor``'s
    layers are its masters' (the layer dim is never split)."""
    if is_sharded(tree):
        spec = tree.sharding.spec
        assert not spec or spec[0] is None, spec
        sh = NamedSharding(tree.sharding.mesh, P(*spec[1:]))
        parts = [m.unbind(0) for m in tree]
        return [ShardedTensor(sh, tree.shape[1:], [p[i] for p in parts])
                for i in range(n)]
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return list(tree.unbind(0))


def _embed_tokens(params, tokens, cfg):
    # gather the rows, then cast: the reference casts the whole table
    # first, which gives the same values
    return params["embed"][tokens.long()].to(DTYPES[cfg.dtype])


def _add_positional(h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The sinusoidal table over all of ``h``'s positions (the VLM's
    patches included), where ``cfg.pos`` asks for it."""
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_table(h.shape[1], h.shape[-1], h.device).to(
            h.dtype)
    return h


def trunk(params: dict, h: torch.Tensor, cfg: ArchConfig, positions,
          collect_cache: bool = False, max_len: int = 0,
          train: bool = False):
    """Run the block groups, then the tail. -> (h, aux, cache|None): the
    blocks' aux losses summed; the groups' collected cache is stacked per
    group, as the reference's scan stacks it, and the tail's is a list.
    ``train`` rematerializes each group (the reference checkpoints its
    scan body whenever it collects no cache) on the training route."""
    group, n_groups, tail = _layer_groups(cfg)

    def group_body(h, gp):
        aux, gc = torch.zeros((), dtype=torch.float32, device=h.device), {}
        for i, kind in enumerate(group):
            h, a, gc[f"b{i}"] = apply_block(gp[f"b{i}"], h, kind, cfg,
                                            positions, collect_cache,
                                            max_len, train)
            aux = aux + a
        return h, aux, gc

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    for gp in _unstack(params["blocks"], n_groups):
        if train:
            h, a = remat(lambda h, gp: group_body(h, gp)[:2], h, gp)
        else:
            h, a, gc = group_body(h, gp)
            caches.append(gc)
        aux = aux + a
    tail_caches = []
    for i, kind in enumerate(tail):
        h, a, c = apply_block(params["tail"][i], h, kind, cfg, positions,
                              collect_cache, max_len, train)
        aux = aux + a
        tail_caches.append(c)
    if not collect_cache:
        return h, aux, None
    cache = {"layers": tree_map(lambda *xs: torch.stack(xs), caches[0],
                                *caches[1:])}
    if tail:
        cache["tail"] = tail_caches
    return h, aux, cache


# ---------------------------------------------------------------------------
# Loss (chunked CE)


def chunked_ce(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
               chunk: int, n_vocab: int = 0):
    """h [B,S,d] vs labels [B,S] (-1 = ignore) -> (sum_nll float32,
    n_valid int32), each a scalar.

    One chunk of ``chunk`` positions at a time: its logits in float32
    (products of ``h``'s dtype, exact in float32, as the reference's
    ``preferred_element_type``), rematerialized (``remat``) so the
    backward never keeps more than one chunk's logits.  ``n_vocab``: the
    real vocab size; the logits of padded ids (``cfg.vocab_pad``) are
    masked out of the softmax.  S must be a multiple of ``chunk`` (or
    smaller), as the reference asserts."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    w = head_w.to(h.dtype)
    labels = labels.long()

    def body(h_c, l_c):
        return chunk_nll(h_c, w, l_c, n_vocab).sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, S, chunk):
        tot = tot + remat(body, h[:, s:s + chunk], labels[:, s:s + chunk])
    cnt = (labels >= 0).sum().to(torch.int32)
    return tot, cnt


def chunk_nll(h_c: torch.Tensor, w: torch.Tensor, l_c: torch.Tensor,
              n_vocab: int = 0) -> torch.Tensor:
    """One chunk's per-token NLL [B, chunk], float32, 0 where the label
    is -1: h_c [B,chunk,d] against the head ``w`` [d,V] (both in the
    compute type), logits of padded ids (``n_vocab`` on) masked."""
    logits = h_c.float() @ w.float()
    V = logits.shape[-1]
    if n_vocab and n_vocab < V:
        logits = torch.where(torch.arange(V, device=h_c.device) < n_vocab,
                             logits, -math.inf)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          torch.clamp(l_c, min=0)[..., None])[..., 0]
    return torch.where(l_c >= 0, lse - picked, 0.0)


def _head_cols(head, dev, lo: int, hi: int, tied: bool) -> torch.Tensor:
    """Columns ``lo:hi`` of the output head [d, V] on ``dev``: of
    ``head``, or of the tied embedding [V, d] (its rows, transposed)."""
    if tied:
        return piece(head, dev, [(lo, hi)]).T
    return piece(head, dev, [(0, head.shape[0]), (lo, hi)])


def chunk_nll_tp(hs: list, ws: list, ls: list, n_vocab: int, V: int,
                 devs: list) -> list:
    """``chunk_nll`` vocab-parallel over a model row (the reference's
    ``logits`` spec ``P(dp, None, "model")``): ``hs[j]`` the chunk's rows
    [B, c, d], ``ws[j]`` columns ``split_range(V, M, j)`` of the head and
    ``ls[j]`` the labels [B, c], on ``devs[j]``.  Model index ``j``
    computes its logits in float32 (padded ids masked), the row maximum
    is ``pmax``ed (detached: a stabiliser, whose gradient cancels), the
    ``exp`` sums and the label's logit (picked where the label falls in
    the block; -1 falls nowhere) are ``psum``med -> the per-token NLL on
    every device."""
    M = len(devs)
    logits, tops, picks = [], [], []
    for j, (h, w, l) in enumerate(zip(hs, ws, ls)):
        lo, hi = split_range(V, M, j)
        lg = h.float() @ w.float()
        if n_vocab and n_vocab < hi:
            lg = torch.where(torch.arange(lo, hi, device=lg.device)
                             < n_vocab, lg, -math.inf)
        logits.append(lg)
        tops.append(lg.detach().amax(-1))
        t = l - lo
        own = (t >= 0) & (t < hi - lo)
        pk = torch.gather(lg, -1, torch.clamp(t, 0, hi - lo - 1)[..., None])
        picks.append(torch.where(own, pk[..., 0], 0.0))
    top = spmd.pmax(tops, devs)
    sums = spmd.psum([torch.exp(lg - m[..., None]).sum(-1)
                      for lg, m in zip(logits, top)], devs)
    picked = spmd.psum(picks, devs)
    return [torch.where(l >= 0, torch.log(s) + m - pk, 0.0)
            for l, s, m, pk in zip(ls, sums, top, picked)]


def chunked_ce_tp(H: list, head, labels: list, chunk: int, n_vocab: int,
                  devs: list, tied: bool, sp: bool):
    """``chunked_ce`` over a model row, vocab-parallel (``chunk_nll_tp``):
    ``H[j]`` model index ``j``'s final-normed rows on ``devs[j]`` (its
    ``split_range(S, M, j)`` shard with ``sp``, else the whole);
    ``head``: the head [d, V], or with ``tied`` the embedding [V, d] (a
    tensor or ``ShardedTensor``), read a block of columns a device;
    ``labels[j]`` [B, S] on ``devs[j]``.  The chunks are
    ``chunked_ce``'s, each rematerialized (with ``sp`` its rows gathered
    inside).  -> (sum_nll, n_valid) on ``devs[0]``."""
    M = len(devs)
    S = sum(h.shape[1] for h in H) if sp else H[0].shape[1]
    chunk = min(chunk, S)
    assert S % chunk == 0
    V = head.shape[0 if tied else 1]
    dt = H[0].dtype
    ws = [_head_cols(head, d, *split_range(V, M, j), tied).to(dt)
          for j, d in enumerate(devs)]
    ls = [l.long() for l in labels]
    bounds = [split_range(S, M, j) for j in range(M)]

    def body(hs, ls):
        hs, _ = seq_gather(hs, devs, sp)
        return chunk_nll_tp(hs, ws, ls, n_vocab, V, devs)[0].sum()

    tot = torch.zeros((), dtype=torch.float32, device=devs[0])
    for s in range(0, S, chunk):
        if sp:   # each shard's rows of the chunk (some empty)
            hs = [h[:, max(s, lo) - lo:max(min(s + chunk, hi), lo) - lo]
                  for h, (lo, hi) in zip(H, bounds)]
        else:
            hs = [h[:, s:s + chunk] for h in H]
        tot = tot + remat(body, hs, [l[:, s:s + chunk] for l in ls])
    cnt = (ls[0] >= 0).sum().to(torch.int32)
    return tot, cnt


def _write_back(dst, src):
    """Copy each leaf of ``src`` into ``dst`` unless it is ``dst`` already
    (the attention rows were written in place)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if s is not d:
            d.copy_(s)


# ---------------------------------------------------------------------------
# Mesh forms (module docstring).  ``H[r][j]``: batch block ``r``'s
# residual, whole, on ``grid[r, j]`` (one tensor where devices repeat).


def _whole_tree(tree, dev):
    return tree_map(lambda x: whole(x, dev), tree, is_leaf=is_sharded)


def _rows(x, dev, r: int, R: int):
    """Row block ``r`` of ``R`` of ``x`` (a tensor or ``ShardedTensor``)
    on ``dev``."""
    n = x.shape[0] // R
    return piece(x, dev, [(r * n, (r + 1) * n)])


def _sharded_leaf(mesh, spec, shape, masters) -> ShardedTensor:
    return ShardedTensor(NamedSharding(mesh, spec), shape, masters)


def _stack_sharded(trees: list):
    """Per-layer trees of ``ShardedTensor`` -> one tree, each leaf's
    masters stacked over the layers (the layer dim unsplit)."""
    def stack(*xs):
        x0 = xs[0]
        return _sharded_leaf(x0.sharding.mesh, P(None, *x0.sharding.spec),
                             (len(xs), *x0.shape),
                             [torch.stack([x[k] for x in xs])
                              for k in range(len(x0))])
    return tree_map(stack, trees[0], *trees[1:], is_leaf=is_sharded)


def _embed_parts(params, tokens: torch.Tensor, devs) -> list:
    """Vocab-parallel lookup: model index ``j`` reads the tokens in its
    rows of the table, zeros elsewhere (the parts a sum over the row
    adds, one row to zeros: exact)."""
    emb = params["embed"]
    V, M = emb.shape[0], len(devs)
    parts = []
    for j, dev in enumerate(devs):
        lo, hi = split_range(V, M, j)
        t = tokens.to(dev).long() - lo
        ok = (t >= 0) & (t < hi - lo)
        rows = piece(emb, dev, [(lo, hi)])[torch.clamp(t, 0, hi - lo - 1)]
        parts.append(torch.where(ok[..., None], rows, 0.0))
    return parts


def _embed_tp(params, tokens: torch.Tensor, cfg, devs) -> list:
    """``_embed_parts``, ``psum``med -> the embedded rows on every device
    of the row."""
    return [h.to(DTYPES[cfg.dtype])
            for h in spmd.psum(_embed_parts(params, tokens, devs), devs)]


def _embed_seq(params, tokens: torch.Tensor, cfg, devs, patches=None,
               sp: bool = False, positional=None) -> list:
    """The sequence forms' residual before the first block: the embedded
    tokens behind the VLM's ``patches`` (whole, on ``devs[0]``), the
    sinusoidal rows where ``cfg.pos`` asks for them.  ``sp``: model index
    ``j``'s rows ``split_range(S, M, j)`` (the reference's ``residual``
    constraint after the embedding): the prefix and the positional rows
    go into model index 0's part, and the parts, in the compute type,
    are ``psum_scatter``ed along the sequence (each row one nonzero part
    plus those rows: the bits of the single device's sum); else the
    whole rows on every device.  ``positional``: a function adding the
    positional rows to [B, S, d] in its stead (the enc-dec's)."""
    if positional is None:
        def positional(h):
            return _add_positional(h, cfg)
    if not sp:
        hs = _embed_tp(params, tokens, cfg, devs)
        if patches is not None:
            hs = [torch.cat([patches.to(h.device, h.dtype), h], dim=1)
                  for h in hs]
        return [positional(h) for h in hs]
    dt = DTYPES[cfg.dtype]
    parts = [x.to(dt) for x in _embed_parts(params, tokens, devs)]
    if patches is not None:
        pre = patches.to(devs[0], dt)
        parts = [torch.cat([pre if j == 0 else torch.zeros_like(
            pre, device=x.device), x], dim=1) for j, x in enumerate(parts)]
    parts[0] = positional(parts[0])
    return spmd.psum_scatter(parts, 1, devs)


def _logits_tp(model, params, h: torch.Tensor, devs) -> torch.Tensor:
    """h [B,d] on ``devs[0]`` -> logits [B,vocab]: model index ``j``
    computes its columns of the head, gathered along the row."""
    cfg = model.cfg
    V = cfg.padded_vocab()
    M = len(devs)
    parts = []
    for j, dev in enumerate(devs):
        lo, hi = split_range(V, M, j)
        if cfg.tie_embeddings:
            w = piece(params["embed"], dev, [(lo, hi)]).T
        else:
            w = piece(params["head"], dev, [(0, cfg.d_model), (lo, hi)])
        hj = h.to(dev)
        parts.append(hj @ w.to(hj.dtype))
    return spmd.all_gather(parts, -1, devs)[0][:, :cfg.vocab]


def _kv_blocks(kvs: list, dev, lo: int, hi: int, Lb: int):
    """Cache block of positions ``lo..lo+Lb-1`` (the prompt's rows below
    ``hi``), every KV head, on ``dev``: each head range from the first
    device that projected it."""
    out = []
    for which in (0, 1):
        parts, covered = [], 0
        for kv in kvs:
            x, (klo, khi) = kv[which], kv[2]
            if khi <= covered:
                continue
            a = max(covered, klo)
            parts.append(x[:, lo:hi, a - klo:khi - klo].to(dev))
            covered = khi
        blk = torch.cat(parts, 2) if len(parts) > 1 else parts[0]
        out.append(F.pad(blk, (0, 0, 0, 0, 0, Lb - blk.shape[1])))
    return out


def _attn_cache_sharded(kv_rows: list, hints: Hints, grid, max_len: int):
    """One attention layer's prefill K/V -> the cache entry {"k", "v"} as
    ``ShardedTensor``s [B, M * ceil(max_len / M), Hkv, hd]: batch over
    the data axes, ``cache_seq`` over the ``M`` model devices.  Where
    ``M`` does not divide ``max_len`` the last block's rows past it are
    padding that no decode step reaches (their positions are never
    valid)."""
    R, M = grid.shape
    Lb = -(-max_len // M)
    ks, vs = [], []
    S = kv_rows[0][0][0].shape[1]
    for r in range(R):
        for b in range(M):
            k, v = _kv_blocks(kv_rows[r], grid[r, b], b * Lb,
                              min(S, (b + 1) * Lb), Lb)
            ks.append(k)
            vs.append(v)
    Br, _, Hkv, hd = ks[0].shape
    spec = P(hints.dp(), "model")
    shape = (Br * R, M * Lb, Hkv, hd)
    return {"k": _sharded_leaf(hints.mesh, spec, shape, ks),
            "v": _sharded_leaf(hints.mesh, spec, shape, vs)}


def _rows_sharded(entries: list, hints: Hints):
    """Per-replica trees (replica ``r``'s rows on ``grid[r, 0]``) -> one
    tree of ``ShardedTensor``s, batch over the data axes."""
    R = len(entries)
    return tree_map(lambda *xs: _sharded_leaf(
        hints.mesh, P(hints.dp()), (xs[0].shape[0] * R, *xs[0].shape[1:]),
        list(xs)), entries[0], *entries[1:])


def _ffn_sharded(p, X2, kind, cfg, hints, grid, decode: bool = False):
    """The feed-forward half of an attention block over the grid ->
    (per-device outputs, aux); under sequence parallelism (not in a
    decode step) ``X2`` and the outputs are the sequence shards."""
    R, M = grid.shape
    dev0 = grid[0, 0]
    sp = hints.seq_parallel() and not decode
    aux = torch.zeros((), dtype=torch.float32, device=dev0)
    if kind != BlockKind.MOE:
        out = []
        for r in range(R):
            devs = list(grid[r])
            xs, reduce = seq_gather(X2[r], devs, sp)
            out.append(mlp_tp(p["mlp"], xs, cfg, devs, reduce))
        return out, aux
    if not decode and uses_ep(cfg, hints):
        return moe_ep(p["moe"], X2, cfg, hints, grid)
    # the reference's global-shape dispatch: every replica's tokens
    # together (capacity and aux over the whole batch)
    x = torch.cat([seq_gather(X2[r], list(grid[r]), sp)[0][0].to(dev0)
                   for r in range(R)], 0)
    y, aux = apply_moe(_whole_tree(p["moe"], dev0), x, cfg)
    y = y.chunk(R, 0)
    return [seq_scatter(y[r], list(grid[r]), sp) for r in range(R)], aux


def _attn_rows(pa, pn, H, cfg, grid, positions, *, window: int = 0,
               causal: bool = True, train: bool = False, kv_H=None,
               sp: bool = False):
    """Pre-norm attention (weights ``pa``, norm ``pn``) with its residual
    over the grid, by head shard over ``head_devices`` -> (H', each row's
    ``attention_tp`` K/V).  ``kv_H``: the rows a cross-attention's K/V
    come from, whole; ``positions`` (whole) ``None`` where no RoPE reads
    them.  ``sp``: ``H`` holds the sequence shards, each normed on its
    device and gathered along the row (``seq_gather``; where the heads
    run whole on the row's first device the row gathers them all the
    same, as the reference's replicated weights read a gathered
    residual, and each device takes its rows of the output)."""
    R, M = grid.shape
    out, kv_rows = [], []
    for r in range(R):
        devs = list(grid[r])
        tp = head_devices(cfg, devs)
        n = len(tp)
        rows = H[r] if sp else H[r][:n]
        xs, reduce = seq_gather(
            [apply_norm(_whole_tree(pn, d), h, cfg.norm)
             for h, d in zip(rows, devs)], devs[:len(rows)], sp)
        ys, kvs = attention_tp(
            pa, xs[:n], cfg, None if positions is None else positions[r][:n],
            tp, causal=causal, window=window, train=train,
            kv_xs=None if kv_H is None else kv_H[r][:n], reduce=reduce)
        if n < M:
            ys = seq_scatter(ys[0], devs, sp)
        out.append([h + y for h, y in zip(H[r], ys)])
        kv_rows.append(kvs)
    return out, kv_rows


def _mlp_rows(p, H, cfg, grid, sp: bool = False):
    """The pre-norm (``ln2``) MLP with its residual over the grid (``sp``:
    on the sequence shards)."""
    out = []
    for r, row in enumerate(H):
        devs = list(grid[r])
        xs, reduce = seq_gather([apply_norm(_whole_tree(p["ln2"], d), h,
                                            cfg.norm)
                                 for h, d in zip(row, devs)], devs, sp)
        out.append([h + y for h, y in zip(row, mlp_tp(p["mlp"], xs, cfg,
                                                       devs, reduce))])
    return out


def _mixer_tp(kind, cfg, M: int) -> bool:
    """Whether an ``SSM`` or ``RECURRENT`` block runs its sharded form:
    the model size splits its heads or channels (``spec_for`` then splits
    the weights and the state over ``model``)."""
    if M < 2:
        return False
    if kind == BlockKind.SSM:
        return ssm_dims(cfg)[1] % M == 0
    return cfg.d_model % M == 0


def _mixer_forms(kind, p):
    """(the norm, the mixer's params, its sequence form, its decode form)
    of an ``SSM`` or ``RECURRENT`` block."""
    if kind == BlockKind.SSM:
        return p["ln"], p["ssm"], ssd_tp, ssd_decode_tp
    return p["ln1"], p["rglru"], rglru_tp, rglru_decode_tp


def _mixer_cache(states: list, kind, cfg, hints: Hints) -> dict:
    """Each row's per-device mixer states -> the cache entry of
    ``ShardedTensor``s in ``spec_for``'s layout (``block_cache_spec``):
    a leaf split over ``model`` from every device's block in grid order,
    a replicated one from each row's first device."""
    B = sum(next(iter(row[0].values())).shape[0] for row in states)
    out = {}
    for k, s in block_cache_spec(cfg, kind, B, 1).items():
        spec = cache_leaf_spec(s, hints.mesh, hints.dp())
        masters = ([st[k] for row in states for st in row]
                   if "model" in spec else [row[0][k] for row in states])
        out[k] = _sharded_leaf(hints.mesh, spec, s.shape, masters)
    return out


def _mixer_states(cache, r: int, devs: list) -> list:
    """Row ``r``'s per-device mixer states from the cache entry: a leaf
    split over ``model`` gives each device its own master block, a
    replicated one each device its batch rows (read from the row's
    master)."""
    M = len(devs)
    out = [{} for _ in devs]
    for k, x in cache.items():
        for j, dev in enumerate(devs):
            if "model" in x.sharding.spec:
                out[j][k] = x[r * M + j]
            else:
                n = x.shape[0] // len(x)
                out[j][k] = piece(x, dev, [(r * n, (r + 1) * n)])
    return out


def _block_sharded(p, H, kind, cfg, hints, grid, positions,
                   collect_cache: bool, max_len: int, train: bool):
    """One block over the grid -> (H', aux, cache entry | None); under
    sequence parallelism ``H`` holds the sequence shards in and out."""
    R, M = grid.shape
    H = [list(row) for row in H]
    sp = hints.seq_parallel()
    aux = torch.zeros((), dtype=torch.float32, device=grid[0, 0])
    cache = None
    if kind in (BlockKind.ATTN, BlockKind.MOE, BlockKind.LOCAL_ATTN):
        window = cfg.window if kind == BlockKind.LOCAL_ATTN else 0
        H, kv_rows = _attn_rows(p["attn"], p["ln1"], H, cfg, grid,
                                positions, window=window, train=train,
                                sp=sp)
        X2 = [[apply_norm(_whole_tree(p["ln2"], d), h, cfg.norm)
               for h, d in zip(H[r], grid[r])] for r in range(R)]
        ys, aux = _ffn_sharded(p, X2, kind, cfg, hints, grid)
        H = [[h + y for h, y in zip(H[r], ys[r])] for r in range(R)]
        if collect_cache and kind == BlockKind.LOCAL_ATTN:
            S = kv_rows[0][0][0].shape[1]
            cache = _rows_sharded([_attn_cache_from_prefill(
                *_kv_blocks(kv_rows[r], grid[r, 0], 0, S, S), kind, cfg,
                max_len) for r in range(R)], hints)
        elif collect_cache:
            cache = _attn_cache_sharded(kv_rows, hints, grid, max_len)
        return H, aux, cache
    if _mixer_tp(kind, cfg, M):
        ln, mixer, form, _ = _mixer_forms(kind, p)
        states = []
        for r in range(R):
            devs = list(grid[r])
            xs, reduce = seq_gather([apply_norm(_whole_tree(ln, d), h,
                                                cfg.norm)
                                     for h, d in zip(H[r], devs)], devs, sp)
            ys = form(mixer, xs, cfg, devs, return_state=collect_cache,
                      train=train, reduce=reduce)
            if collect_cache:
                ys, st = ys
                states.append(st)
            H[r] = [h + y for h, y in zip(H[r], ys)]
        if kind == BlockKind.RECURRENT:
            H = _mlp_rows(p, H, cfg, grid, sp)
        if collect_cache:
            cache = _mixer_cache(states, kind, cfg, hints)
        return H, aux, cache
    # the model size splits neither the heads nor the channels: the
    # weights are replicated over ``model``, the block runs whole on the
    # row's first device (on the gathered shards under sequence
    # parallelism, each device taking its rows of the output after)
    entries = []
    for r in range(R):
        devs = list(grid[r])
        h, a, c = apply_block(_whole_tree(p, devs[0]),
                              seq_gather(H[r], devs, sp)[0][0], kind, cfg,
                              positions[r][0], collect_cache, max_len,
                              train)
        H[r] = seq_scatter(h, devs, sp)
        aux = aux + a.to(aux.device)
        entries.append(c)
    return H, aux, (_rows_sharded(entries, hints) if collect_cache
                    else None)


def _ring_decode(p, xs, cfg, devs, lens: list, ring: dict, r: int):
    """A ``LOCAL_ATTN`` block's attention for one token on one row: the
    new K/V row (column-parallel, gathered) and its position written into
    the ring's masters (batch block ``r``, on ``devs[0]``), then every
    device reads the ring and attends its heads (``attention_cached_tp``)
    -> the output on every device of ``devs``."""
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    B = xs[0].shape[0]
    k = gathered_cols(p["k"], xs, Hkv * hd, devs)[0].reshape(B, 1, Hkv, hd)
    v = gathered_cols(p["v"], xs, Hkv * hd, devs)[0].reshape(B, 1, Hkv, hd)
    if cfg.pos == "rope":
        k = rope(k, lens[0][:, None], cfg.rope_theta)
    kc, vc, pc = ring["k"][r], ring["v"][r], ring["pos"][r]
    W = cfg.window
    at = (lens[0] % W).long()
    rows = torch.arange(B, device=pc.device)
    pc[rows, at] = lens[0].to(pc.dtype)
    kc[rows, at] = k[:, 0].to(kc.dtype)
    vc[rows, at] = v[:, 0].to(vc.dtype)

    def kv(j, klo, khi):
        dev = devs[j]
        rng = [(r * B, (r + 1) * B), (0, W), (klo, khi)]
        pos = piece(ring["pos"], dev, rng[:1])
        ln = lens[j][:, None]
        return (piece(ring["k"], dev, rng), piece(ring["v"], dev, rng),
                (pos >= 0) & (pos >= ln - W + 1) & (pos <= ln))
    return attention_cached_tp(p, xs, cfg, devs,
                               [ln[:, None] for ln in lens], kv)


def _block_decode_sharded(p, H, kind, cfg, hints, grid, cache, lens):
    """One block's decode step over the grid; writes ``cache`` (this
    layer's ``ShardedTensor`` views) in place -> H'."""
    R, M = grid.shape
    H = [list(row) for row in H]
    if kind in (BlockKind.ATTN, BlockKind.MOE, BlockKind.LOCAL_ATTN):
        for r in range(R):
            devs = list(grid[r])
            xs = [apply_norm(_whole_tree(p["ln1"], d), h, cfg.norm)
                  for h, d in zip(H[r], devs)]
            ls = [lens[r].to(d) for d in devs]
            if kind == BlockKind.LOCAL_ATTN:
                n = len(head_devices(cfg, devs))
                outs = _ring_decode(p["attn"], xs[:n], cfg, devs[:n],
                                    ls[:n], cache, r)
                outs = outs + [outs[0].to(d) for d in devs[n:]]
            else:
                outs = attention_decode_tp(
                    p["attn"], xs, cfg, ls, devs,
                    list(cache["k"][r * M:(r + 1) * M]),
                    list(cache["v"][r * M:(r + 1) * M]))
            H[r] = [h + o for h, o in zip(H[r], outs)]
        X2 = [[apply_norm(_whole_tree(p["ln2"], d), h, cfg.norm)
               for h, d in zip(H[r], grid[r])] for r in range(R)]
        ys, _ = _ffn_sharded(p, X2, kind, cfg, hints, grid, decode=True)
        return [[h + y for h, y in zip(H[r], ys[r])] for r in range(R)]
    if _mixer_tp(kind, cfg, M):
        ln, mixer, _, form = _mixer_forms(kind, p)
        for r in range(R):
            devs = list(grid[r])
            xs = [apply_norm(_whole_tree(ln, d), h, cfg.norm)
                  for h, d in zip(H[r], devs)]
            ys, new = form(mixer, xs, cfg, devs, _mixer_states(cache, r,
                                                               devs))
            for k, x in cache.items():   # into the masters, in place
                if "model" in x.sharding.spec:
                    for j, st in enumerate(new):
                        x[r * M + j].copy_(st[k])
                else:
                    x[r].copy_(new[0][k])
            H[r] = [h + y for h, y in zip(H[r], ys)]
        if kind == BlockKind.RECURRENT:
            H = _mlp_rows(p, H, cfg, grid)
        return H
    for r in range(R):
        devs = list(grid[r])
        cr = tree_map(lambda x: x[r], cache, is_leaf=is_sharded)
        h, c = apply_block_decode(_whole_tree(p, devs[0]), H[r][0], kind,
                                  cfg, cr, lens[r])
        _write_back(cr, c)
        H[r] = [h.to(d) for d in devs]
    return H


def _trunk_sharded(params, H, cfg, hints, grid, positions,
                   collect_cache: bool = False, max_len: int = 0,
                   train: bool = False):
    """``trunk`` over the grid -> (H, aux, cache|None)."""
    group, n_groups, tail = _layer_groups(cfg)

    def group_body(H, gp):
        aux = torch.zeros((), dtype=torch.float32, device=grid[0, 0])
        gc = {}
        for i, kind in enumerate(group):
            H, a, gc[f"b{i}"] = _block_sharded(
                gp[f"b{i}"], H, kind, cfg, hints, grid, positions,
                collect_cache, max_len, train)
            aux = aux + a
        return H, aux, gc

    aux = torch.zeros((), dtype=torch.float32, device=grid[0, 0])
    caches = []
    for gp in _unstack(params["blocks"], n_groups):
        if train:
            H, a = remat(lambda H, gp: group_body(H, gp)[:2], H, gp)
        else:
            H, a, gc = group_body(H, gp)
            caches.append(gc)
        aux = aux + a
    tail_caches = []
    for i, kind in enumerate(tail):
        H, a, c = _block_sharded(params["tail"][i], H, kind, cfg, hints,
                                 grid, positions, collect_cache, max_len,
                                 train)
        aux = aux + a
        tail_caches.append(c)
    if not collect_cache:
        return H, aux, None
    cache = {"layers": _stack_sharded(caches)}
    if tail:
        cache["tail"] = tail_caches
    return H, aux, cache


# ---------------------------------------------------------------------------
# Public model API


class DecoderLM:
    """Decoder-only model (pure-function methods over a params tree).

    ``device`` (default ``"cuda"``) is where its params live; the model
    raises at construction when that is CUDA and torch sees no card.
    ``hints`` with a mesh (``activation_hints``) make every entry point
    run its mesh form (module docstring); the outputs land on the
    grid's first device."""

    def __init__(self, cfg: ArchConfig, hints: Hints = NO_HINTS,
                 device="cuda"):
        self.cfg = cfg
        self.hints = hints
        if hints.sharded:
            self.grid = hints.grid()
            for d in set(hints.mesh.device_list()):
                check_device(d)
            device = self.grid[0, 0]
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
               collect_cache: bool = False, max_len: int = 0,
               train: bool = False):
        """tokens [B,S] (behind ``patches`` [B,P,d], the VLM's prefix) ->
        (h [B,P+S,d] after the final norm, aux (the blocks' summed aux
        loss), cache|None); positions run over all P + S rows.
        ``train``: the training route (module docstring)."""
        cfg = self.cfg
        if self.hints.sharded:
            H, aux, cache = self._hidden_rows(params, tokens, patches,
                                              collect_cache, max_len, train)
            h = torch.cat([seq_whole(row, self.device,
                                     self.hints.seq_parallel())
                           for row in H], 0)
            return h, aux, cache
        h = _embed_tokens(params, tokens, cfg)
        if patches is not None:
            h = torch.cat([patches.to(h.dtype), h], dim=1)
        h = _add_positional(h, cfg)
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        h, aux, cache = trunk(params, h, cfg, positions, collect_cache,
                              max_len, train)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        return h, aux, cache

    def _hidden_rows(self, params, tokens, patches=None,
                     collect_cache: bool = False, max_len: int = 0,
                     train: bool = False):
        """``hidden`` over the grid -> (H: each batch block's final-normed
        rows on every device of its row, aux, cache|None).  ``tokens`` and
        ``patches`` may be whole or ``ShardedTensor``s."""
        cfg, grid = self.cfg, self.grid
        R, M = grid.shape
        H, positions = [], []
        for r in range(R):
            devs = list(grid[r])
            hs = _embed_seq(params, _rows(tokens, devs[0], r, R), cfg, devs,
                            None if patches is None
                            else _rows(patches, devs[0], r, R),
                            self.hints.seq_parallel())
            Br = hs[0].shape[0]
            S = sum(h.shape[1] for h in hs) if self.hints.seq_parallel() \
                else hs[0].shape[1]
            positions.append([torch.arange(S, device=d).expand(Br, S)
                              for d in devs])
            H.append(hs)
        H, aux, cache = _trunk_sharded(params, H, cfg, self.hints, grid,
                                       positions, collect_cache, max_len,
                                       train)
        H = [[apply_norm(_whole_tree(params["final_norm"], d), h, cfg.norm)
              for h, d in zip(row, grid[r])] for r, row in enumerate(H)]
        return H, aux, cache

    def _loss_sharded(self, params, batch):
        """The loss over the grid: each replica's NLL sum and label count
        on its rows (``chunked_ce_tp``: vocab-parallel along the row),
        reduced separately (the global mean)."""
        cfg, grid = self.cfg, self.grid
        R = grid.shape[0]
        H, aux, _ = self._hidden_rows(params, batch["tokens"],
                                      batch.get("patches"), train=True)
        tied = cfg.tie_embeddings
        head = params["embed"] if tied else params["head"]
        tots, cnts = [], []
        for r in range(R):
            devs = list(grid[r])
            labels = [_rows(batch["labels"], d, r, R) for d in devs]
            if "patches" in batch:
                P_ = batch["patches"].shape[1]
                labels = [torch.cat([l.new_full((l.shape[0], P_), -1), l],
                                    dim=1) for l in labels]
            t, c = chunked_ce_tp(H[r], head, labels, cfg.logit_chunk,
                                 cfg.vocab, devs, tied,
                                 self.hints.seq_parallel())
            tots.append(t)
            cnts.append(c)
        tot = spmd.psum(tots, [self.device] * R)[0]
        cnt = spmd.psum(cnts, [self.device] * R)[0]
        loss = tot / torch.clamp(cnt, min=1)
        if cfg.n_experts:
            loss = loss + 0.01 * aux / max(1, cfg.n_layers)
        return loss, {"nll": tot, "tokens": cnt, "aux": aux}

    def loss_fn(self, params, batch):
        """batch: {tokens [B,S], labels [B,S] (-1: no loss), patches?
        [B,P,d]} -> (loss, {"nll", "tokens", "aux"}).  The loss is the
        mean NLL over the labelled tokens (none over the VLM's patch
        positions), plus ``0.01 * aux / n_layers`` for a MoE model."""
        if self.hints.sharded:
            return self._loss_sharded(params, batch)
        cfg = self.cfg
        h, aux, _ = self.hidden(params, batch["tokens"],
                                batch.get("patches"), train=True)
        labels = batch["labels"]
        if "patches" in batch:   # no loss on modality positions
            P = batch["patches"].shape[1]
            labels = torch.cat([labels.new_full((labels.shape[0], P), -1),
                                labels], dim=1)
        tot, cnt = chunked_ce(h, self.head_w(params), labels,
                              cfg.logit_chunk, cfg.vocab)
        loss = tot / torch.clamp(cnt, min=1)
        if cfg.n_experts:
            loss = loss + 0.01 * aux / max(1, cfg.n_layers)
        return loss, {"nll": tot, "tokens": cnt, "aux": aux}

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def prefill_fn(self, params, tokens, max_len: int, patches=None):
        """-> (last-position logits [B,V], cache); ``lens`` counts the
        patches too."""
        if self.hints.sharded:
            return self._prefill_sharded(params, tokens, max_len, patches)
        h, _, cache = self.hidden(params, tokens, patches,
                                  collect_cache=True, max_len=max_len)
        logits = self._logits(params, h[:, -1, :])
        cache["lens"] = torch.full((tokens.shape[0],), h.shape[1],
                                   dtype=torch.int32, device=h.device)
        return logits, cache

    def _prefill_sharded(self, params, tokens, max_len: int, patches):
        grid = self.grid
        R = grid.shape[0]
        H, _, cache = self._hidden_rows(params, tokens, patches,
                                        collect_cache=True, max_len=max_len)
        # the last position: on the last model index's shard under
        # sequence parallelism (never empty: split_range's last block)
        last = -1 if self.hints.seq_parallel() else 0
        logits = torch.cat([_logits_tp(self, params, H[r][last][:, -1, :],
                                       list(grid[r])).to(self.device)
                            for r in range(R)], 0)
        S = sum(h.shape[1] for h in H[0]) if last else H[0][0].shape[1]
        cache["lens"] = _rows_sharded(
            [torch.full((H[r][0].shape[0],), S, dtype=torch.int32,
                        device=grid[r, 0]) for r in range(R)], self.hints)
        return logits, cache

    @torch.no_grad()
    def _decode_sharded(self, params, tok, cache: dict):
        cfg, grid = self.cfg, self.grid
        R, M = grid.shape
        group, n_groups, tail = _layer_groups(cfg)
        lens = list(cache["lens"])
        H = []
        for r in range(R):
            devs = list(grid[r])
            hs = _embed_tp(params, _rows(tok, devs[0], r, R)[:, None], cfg,
                           devs)
            if cfg.pos == "sinusoidal":
                hs = [h + sinusoidal_rows(lens[r].to(h.device), h.shape[-1])[
                    :, None, :].to(h.dtype) for h in hs]
            H.append(hs)
        hints = self.hints
        for gp, gc in zip(_unstack(params["blocks"], n_groups),
                          _unstack(cache["layers"], n_groups)):
            for i, kind in enumerate(group):
                H = _block_decode_sharded(gp[f"b{i}"], H, kind, cfg, hints,
                                          grid, gc[f"b{i}"], lens)
        for i, kind in enumerate(tail):
            H = _block_decode_sharded(params["tail"][i], H, kind, cfg,
                                      hints, grid, cache["tail"][i], lens)
        for m in cache["lens"]:
            m += 1
        logits = []
        for r in range(R):
            devs = list(grid[r])
            h = apply_norm(_whole_tree(params["final_norm"], devs[0]),
                           H[r][0], cfg.norm)
            logits.append(_logits_tp(self, params, h[:, 0, :], devs).to(
                self.device))
        return torch.cat(logits, 0), cache

    @torch.no_grad()
    def decode_fn(self, params, tok: torch.Tensor, cache: dict):
        """tok [B] int -> (logits [B,V], cache'); updates ``cache`` in
        place and returns it with ``lens`` advanced.  A sinusoidal row is
        computed at the device tensor ``lens``: no host sync."""
        if self.hints.sharded:
            return self._decode_sharded(params, tok, cache)
        cfg = self.cfg
        group, n_groups, tail = _layer_groups(cfg)
        lens = cache["lens"]
        h = _embed_tokens(params, tok[:, None], cfg)
        if cfg.pos == "sinusoidal":   # absolute position = lens
            h = h + sinusoidal_rows(lens, h.shape[-1])[:, None, :].to(
                h.dtype)
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
