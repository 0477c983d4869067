"""Encoder-decoder LM (whisper-tiny backbone).

Port of the reference ``models/encdec.py``.  The audio frontend (log-mel
and two convolutions) is a stub there and here: ``frames`` are
precomputed frame embeddings [B, enc_seq, d].  Encoder: non-causal
self-attention and a GELU MLP (layernorm, biased projections).
Decoder: causal self-attention, cross-attention to the encoder output
and a GELU MLP.  Positions are sinusoidal on both sides (the reference
replaces whisper's learned decoder positions with the same table).
The output head is the embedding, transposed.

Entry points: ``loss_fn`` (the decoder's chunked cross-entropy, as
``models/transformer.py``'s), ``encode``, ``prefill_fn(params, tokens,
max_len, frames)`` (last-position logits and a decode cache sized
``max_len``) and ``decode_fn``.  The cache holds each decoder layer's self-attention
K/V (``k``, ``v``: a row per decoded token) and its cross-attention K/V
of the encoder output (``xk``, ``xv``: computed once by the prefill,
static after), stacked over layers, beside ``lens``.  The param and
cache trees keep the reference's layout.

Training route (``train=True``, set by ``loss_fn``): each encoder and
decoder layer is rematerialized (``layers.remat``, the reference's
``jax.checkpoint`` of its scan bodies) and attention takes the
reference's ``chunked_attention``, not the kernel.

On a mesh (``build_model(cfg, hints)``): the layout the reference gives
these layers through their parameters' logical axes.  The batch splits
into ``R`` row blocks over the data axes, each run on a row of ``M``
devices along ``model`` (``Hints.grid``).  The encoder's and the
decoder's self-attention and the cross-attention run by head shard
(``layers.attention_tp``, non-causal, causal, and with K/V projected
from the encoder's output), or whole on the row's first device where
the heads do not split over ``model`` (``layers.head_devices``); the MLP
column- then row-parallel (``mlp_tp``); the embedding and the serving
logits vocab-parallel.  The cache's self-attention K/V are split along
``cache_seq`` over ``model`` (``transformer._attn_cache_sharded``) and a
decode step attends them block by block (``attention_decode_tp``); the
cross-attention's K/V are replicated over ``model`` (one master per
batch block, on its row's first device), each head shard reading its
own KV heads (``attention_cached_tp``).  Under sequence parallelism
(train and prefill) the encoder's and the decoder's residuals hold each
model index's ``split_range`` rows, as ``models/transformer.py``'s do,
and each decoder layer all-gathers the encoder's output once for its
cross-attention's K/V.  The loss is vocab-parallel over the tied
embedding's rows (``transformer.chunked_ce_tp``) and reduces the NLL
sums and label counts over the replicas.

In place: ``decode_fn`` writes each layer's new K/V row into the cache
it is given and returns that cache with ``lens`` advanced.  No remat
when serving: it keeps no activations for a backward pass.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import piece
from repro_torch.models.config import ArchConfig, BlockKind
from repro_torch.models.layers import (NO_HINTS, Hints, apply_mlp,
                                       apply_norm, attention,
                                       attention_cached_tp,
                                       attention_decode_tp, attention_spec,
                                       decode_attention, dense,
                                       head_devices, layernorm_spec,
                                       mlp_spec, remat, seq_gather,
                                       sinusoidal_rows, sinusoidal_table,
                                       split_range)
from repro_torch.models.params import (DTYPES, LeafSpec, check_device,
                                       normal, stacked, tree_map)
from repro_torch.models.transformer import (_attn_cache_from_prefill,
                                            _attn_cache_sharded,
                                            _attn_part, _attn_rows,
                                            _embed_seq, _embed_tokens,
                                            _embed_tp, _kv_blocks, _layer,
                                            _logits_tp, _mlp_rows, _rows,
                                            _rows_sharded, _stack_sharded,
                                            _unstack, _whole_tree,
                                            attn_decode, chunked_ce,
                                            chunked_ce_tp)

# ---------------------------------------------------------------------------
# Specs


def _norm(cfg):
    return layernorm_spec(cfg.d_model)


def _enc_block_spec(cfg):
    return {"ln1": _norm(cfg), "attn": attention_spec(cfg),
            "ln2": _norm(cfg), "mlp": mlp_spec(cfg)}


def _dec_block_spec(cfg):
    return {"ln1": _norm(cfg), "attn": attention_spec(cfg),
            "lnx": _norm(cfg), "xattn": attention_spec(cfg),
            "ln2": _norm(cfg), "mlp": mlp_spec(cfg)}


def encdec_spec(cfg: ArchConfig) -> dict:
    return {
        "embed": normal((cfg.padded_vocab(), cfg.d_model), ("vocab", "embed"),
                        scale=0.02, cast=True),
        "enc_blocks": stacked(cfg.n_enc_layers, _enc_block_spec(cfg)),
        "enc_norm": _norm(cfg),
        "dec_blocks": stacked(cfg.n_layers, _dec_block_spec(cfg)),
        "final_norm": _norm(cfg),
    }  # whisper ties the output head to the embedding


def encdec_cache_spec(cfg: ArchConfig, B: int, max_len: int) -> dict:
    dt = cfg.dtype
    kv = (B, max_len, cfg.n_kv_heads, cfg.head_dim)
    xkv = (B, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    per_layer = {
        "k": LeafSpec(kv, ("batch", "cache_seq", None, None), "zeros",
                      dtype=dt),
        "v": LeafSpec(kv, ("batch", "cache_seq", None, None), "zeros",
                      dtype=dt),
        "xk": LeafSpec(xkv, ("batch", None, None, None), "zeros", dtype=dt),
        "xv": LeafSpec(xkv, ("batch", None, None, None), "zeros", dtype=dt),
    }
    return {"layers": stacked(cfg.n_layers, per_layer),
            "lens": LeafSpec((B,), ("batch",), "zeros", dtype="int32")}


# ---------------------------------------------------------------------------
# Blocks


# whisper's positions are sinusoidal (``cfg.pos``), added to the
# embeddings: the self-attention's ``project_qkv`` applies no RoPE and
# reads no positions (the reference passes ``rope_on=False``)


def _add_positions(h: torch.Tensor) -> torch.Tensor:
    return h + sinusoidal_table(h.shape[1], h.shape[-1], h.device).to(
        h.dtype)


def _xattn(p, h, xk, xv, cfg, train=False):
    """Cross-attention with precomputed K/V from the encoder output."""
    x = apply_norm(p["lnx"], h, cfg.norm)
    B, S, _ = x.shape
    q = dense(p["xattn"]["q"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    a = attention(q, xk, xv, cfg, causal=False, train=train)
    return h + dense(p["xattn"]["o"], a.reshape(B, S, -1))


def _enc_kv(p, enc_out, cfg):
    B, Se, _ = enc_out.shape
    k = dense(p["xattn"]["k"], enc_out).reshape(B, Se, cfg.n_kv_heads,
                                                cfg.head_dim)
    v = dense(p["xattn"]["v"], enc_out).reshape(B, Se, cfg.n_kv_heads,
                                                cfg.head_dim)
    return k, v


def _mlp_part(p, h, cfg):
    return h + apply_mlp(p["mlp"], apply_norm(p["ln2"], h, cfg.norm), cfg)


# ---------------------------------------------------------------------------
# Public model API


class EncDecLM:
    """Encoder-decoder model (pure-function methods over a params tree).

    ``device`` (default ``"cuda"``) is where its params live; the model
    raises at construction when that is CUDA and torch sees no card.
    ``hints`` with a mesh make every entry point run its mesh form
    (module docstring)."""

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

    # -- mesh forms (module docstring) -----------------------------------------
    def _norm_rows(self, pn, H):
        grid = self.grid
        return [[apply_norm(_whole_tree(pn, d), h, self.cfg.norm)
                 for h, d in zip(row, grid[r])] for r, row in enumerate(H)]

    def _encode_rows(self, params, frames, train: bool = False):
        """``encode`` over the grid -> each batch block's encoder output on
        every device of its row (under sequence parallelism each device's
        ``split_range`` rows of it, from its rows of ``frames``)."""
        cfg, grid = self.cfg, self.grid
        R, M = grid.shape
        sp = self.hints.seq_parallel()
        dt = DTYPES[cfg.dtype]
        if sp:
            Se, n = frames.shape[1], frames.shape[0] // R
            H = []
            for r in range(R):
                row = []
                for j, d in enumerate(grid[r]):
                    lo, hi = split_range(Se, M, j)
                    x = piece(frames, d, [(r * n, (r + 1) * n),
                                          (lo, hi)]).to(dt)
                    row.append(x + sinusoidal_rows(
                        torch.arange(lo, hi, device=d), x.shape[-1]).to(dt))
                H.append(row)
        else:
            H = [[_add_positions(_rows(frames, d, r, R).to(dt))
                  for d in grid[r]] for r in range(R)]

        def body(H, bp):
            H, _ = _attn_rows(bp["attn"], bp["ln1"], H, cfg, grid, None,
                              causal=False, train=train, sp=sp)
            return _mlp_rows(bp, H, cfg, grid, sp)

        for bp in _unstack(params["enc_blocks"], cfg.n_enc_layers):
            H = remat(body, H, bp) if train else body(H, bp)
        return self._norm_rows(params["enc_norm"], H)

    def _decoder_rows(self, params, tokens, E, collect_cache: bool = False,
                      max_len: int = 0, train: bool = False):
        """``_decoder_hidden`` over the grid against the encoder rows ``E``
        -> (H after the final norm, the stacked cache layers | None); under
        sequence parallelism ``E`` and ``H`` hold the sequence shards, and
        the cross-attention's K/V source is ``E`` gathered, once a
        layer."""
        cfg, grid, hints = self.cfg, self.grid, self.hints
        R = grid.shape[0]
        sp = hints.seq_parallel()
        H = [_embed_seq(params, _rows(tokens, grid[r, 0], r, R), cfg,
                        list(grid[r]), sp=sp, positional=_add_positions)
             for r in range(R)]

        def body(H, bp):
            kv_H = [seq_gather(E[r], list(grid[r]), sp)[0]
                    for r in range(R)]
            H, kv_self = _attn_rows(bp["attn"], bp["ln1"], H, cfg, grid,
                                    None, train=train, sp=sp)
            H, kv_x = _attn_rows(bp["xattn"], bp["lnx"], H, cfg, grid, None,
                                 causal=False, train=train, kv_H=kv_H,
                                 sp=sp)
            return _mlp_rows(bp, H, cfg, grid, sp), kv_self, kv_x

        caches = []
        for bp in _unstack(params["dec_blocks"], cfg.n_layers):
            if train:
                H = remat(lambda H, bp: body(H, bp)[0], H, bp)
                continue
            H, kv_self, kv_x = body(H, bp)
            if collect_cache:
                Se = kv_x[0][0][0].shape[1]
                c = _attn_cache_sharded(kv_self, hints, grid, max_len)
                c.update(_rows_sharded([dict(zip(("xk", "xv"), _kv_blocks(
                    kv_x[r], grid[r, 0], 0, Se, Se))) for r in range(R)],
                    hints))
                caches.append(c)
        H = self._norm_rows(params["final_norm"], H)
        return H, (_stack_sharded(caches) if collect_cache else None)

    def _loss_rows(self, params, batch):
        cfg, grid = self.cfg, self.grid
        R = grid.shape[0]
        E = self._encode_rows(params, batch["frames"], train=True)
        H, _ = self._decoder_rows(params, batch["tokens"], E, train=True)
        tots, cnts = [], []
        for r in range(R):
            devs = list(grid[r])
            # vocab-parallel over the tied embedding's rows
            t, c = chunked_ce_tp(
                H[r], params["embed"],
                [_rows(batch["labels"], d, r, R) for d in devs],
                cfg.logit_chunk, cfg.vocab, devs, True,
                self.hints.seq_parallel())
            tots.append(t)
            cnts.append(c)
        devs = [self.device] * R
        tot, cnt = spmd.psum(tots, devs)[0], spmd.psum(cnts, devs)[0]
        return tot / torch.clamp(cnt, min=1), {
            "nll": tot, "tokens": cnt,
            "aux": torch.zeros((), dtype=torch.float32, device=self.device)}

    def _prefill_rows(self, params, tokens, max_len, frames):
        grid = self.grid
        R = grid.shape[0]
        E = self._encode_rows(params, frames)
        H, layers = self._decoder_rows(params, tokens, E, True, max_len)
        # the last position: on the last model index's shard under
        # sequence parallelism
        last = -1 if self.hints.seq_parallel() else 0
        logits = torch.cat([_logits_tp(self, params, H[r][last][:, -1, :],
                                       list(grid[r])).to(self.device)
                            for r in range(R)], 0)
        S = tokens.shape[1]
        lens = _rows_sharded([torch.full((H[r][0].shape[0],), S,
                                         dtype=torch.int32,
                                         device=grid[r, 0])
                              for r in range(R)], self.hints)
        return logits, {"layers": layers, "lens": lens}

    def _decode_rows(self, params, tok, cache):
        cfg, grid = self.cfg, self.grid
        R, M = grid.shape
        lens = list(cache["lens"])
        H = []
        for r in range(R):
            hs = _embed_tp(params, _rows(tok, grid[r, 0], r, R)[:, None], cfg,
                           list(grid[r]))
            H.append([h + sinusoidal_rows(lens[r].to(h.device), h.shape[-1])[
                :, None, :].to(h.dtype) for h in hs])
        for bp, c in zip(_unstack(params["dec_blocks"], cfg.n_layers),
                         _unstack(cache["layers"], cfg.n_layers)):
            for r in range(R):
                devs = list(grid[r])
                xs = [apply_norm(_whole_tree(bp["ln1"], d), h, cfg.norm)
                      for h, d in zip(H[r], devs)]
                outs = attention_decode_tp(
                    bp["attn"], xs, cfg, [lens[r].to(d) for d in devs], devs,
                    list(c["k"][r * M:(r + 1) * M]),
                    list(c["v"][r * M:(r + 1) * M]))
                H[r] = [h + o for h, o in zip(H[r], outs)]
                # cross-attention against the static encoder K/V
                tp = head_devices(cfg, devs)
                xs = [apply_norm(_whole_tree(bp["lnx"], d), h, cfg.norm)
                      for h, d in zip(H[r], tp)]
                Br, Se = xs[0].shape[0], c["xk"].shape[1]

                def kv(j, klo, khi):
                    rng = [(r * Br, (r + 1) * Br), (0, Se), (klo, khi)]
                    return (piece(c["xk"], tp[j], rng),
                            piece(c["xv"], tp[j], rng),
                            torch.ones((Br, Se), dtype=torch.bool,
                                       device=tp[j]))
                outs = attention_cached_tp(bp["xattn"], xs, cfg, tp, None, kv)
                outs = outs + [outs[0].to(d) for d in devs[len(tp):]]
                H[r] = [h + o for h, o in zip(H[r], outs)]
            H = _mlp_rows(bp, H, cfg, grid)
        for m in cache["lens"]:
            m += 1
        H = self._norm_rows(params["final_norm"], H)
        return torch.cat([_logits_tp(self, params, H[r][0][:, 0, :],
                                     list(grid[r])).to(self.device)
                          for r in range(R)], 0), cache

    def spec(self) -> dict:
        return encdec_spec(self.cfg)

    def head_w(self, params):
        return params["embed"].T

    def _logits(self, params, h):
        """h [B,d] -> logits [B,vocab] in h's dtype."""
        return (h @ self.head_w(params).to(h.dtype))[:, : self.cfg.vocab]

    # -- encoder -------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor,
               train: bool = False) -> torch.Tensor:
        """frames [B,enc_seq,d] -> encoder output [B,enc_seq,d];
        ``train``: the training route (module docstring)."""
        cfg = self.cfg
        h = _add_positions(frames.to(DTYPES[cfg.dtype]))

        def body(h, bp):
            h, _ = _attn_part(bp, h, cfg, None, causal=False, train=train)
            return _mlp_part(bp, h, cfg)

        for bp in _unstack(params["enc_blocks"], cfg.n_enc_layers):
            h = remat(body, h, bp) if train else body(h, bp)
        return apply_norm(params["enc_norm"], h, cfg.norm)

    # -- decoder (sequence form) -----------------------------------------------
    def _decoder_hidden(self, params, tokens, enc_out,
                        collect_cache: bool = False, max_len: int = 0,
                        train: bool = False):
        """tokens [B,S] against ``enc_out`` -> (h [B,S,d] after the final
        norm, the stacked cache layers | None); ``train``: the training
        route."""
        cfg = self.cfg
        h = _add_positions(_embed_tokens(params, tokens, cfg))

        def body(h, bp):
            h, (k, v) = _attn_part(bp, h, cfg, None, train=train)
            xk, xv = _enc_kv(bp, enc_out, cfg)
            h = _mlp_part(bp, _xattn(bp, h, xk, xv, cfg, train), cfg)
            return h, (k, v, xk, xv)

        caches = []
        for bp in _unstack(params["dec_blocks"], cfg.n_layers):
            if train:
                h = remat(lambda h, bp: body(h, bp)[0], h, bp)
                continue
            h, (k, v, xk, xv) = body(h, bp)
            if collect_cache:
                caches.append({**_attn_cache_from_prefill(
                    k, v, BlockKind.ATTN, cfg, max_len), "xk": xk,
                    "xv": xv})
        h = apply_norm(params["final_norm"], h, cfg.norm)
        if not collect_cache:
            return h, None
        return h, tree_map(lambda *xs: torch.stack(xs), caches[0],
                           *caches[1:])

    # -- training ----------------------------------------------------------------
    def loss_fn(self, params, batch):
        """batch: {frames [B,Se,d], tokens [B,S], labels [B,S] (-1: no
        loss)} -> (loss, {"nll", "tokens", "aux"}): the mean NLL over the
        labelled tokens; ``aux`` is 0 (no experts)."""
        if self.hints.sharded:
            return self._loss_rows(params, batch)
        enc_out = self.encode(params, batch["frames"], train=True)
        h, _ = self._decoder_hidden(params, batch["tokens"], enc_out,
                                    train=True)
        tot, cnt = chunked_ce(h, self.head_w(params), batch["labels"],
                              self.cfg.logit_chunk, self.cfg.vocab)
        loss = tot / torch.clamp(cnt, min=1)
        return loss, {"nll": tot, "tokens": cnt,
                      "aux": torch.zeros((), dtype=torch.float32,
                                         device=h.device)}

    # -- serving ---------------------------------------------------------------

    @torch.no_grad()
    def prefill_fn(self, params, tokens, max_len: int, frames):
        """Encode ``frames`` and run the decoder over ``tokens`` ->
        (last-position logits [B,V], cache)."""
        if self.hints.sharded:
            return self._prefill_rows(params, tokens, max_len, frames)
        enc_out = self.encode(params, frames)
        h, layers = self._decoder_hidden(params, tokens, enc_out,
                                         collect_cache=True,
                                         max_len=max_len)
        lens = torch.full((tokens.shape[0],), tokens.shape[1],
                          dtype=torch.int32, device=h.device)
        return self._logits(params, h[:, -1, :]), {"layers": layers,
                                                   "lens": lens}

    @torch.no_grad()
    def decode_fn(self, params, tok: torch.Tensor, cache: dict):
        """tok [B] int -> (logits [B,V], cache'); writes each layer's K/V
        row at ``lens`` into ``cache`` in place and returns it with
        ``lens`` advanced.  The sinusoidal row is computed at the device
        tensor ``lens``: no host sync."""
        if self.hints.sharded:
            return self._decode_rows(params, tok, cache)
        cfg = self.cfg
        lens = cache["lens"]
        h = _embed_tokens(params, tok[:, None], cfg)
        h = h + sinusoidal_rows(lens, h.shape[-1])[:, None, :].to(h.dtype)
        B = h.shape[0]
        # every encoder frame is valid for the cross-attention
        every = torch.ones(cache["layers"]["xk"].shape[1:3],
                           dtype=torch.bool, device=h.device)
        for i in range(cfg.n_layers):
            bp = _layer(params["dec_blocks"], i)
            c = _layer(cache["layers"], i)
            h = attn_decode(bp, h, BlockKind.ATTN, cfg, c, lens)
            # cross-attention against the static encoder K/V
            x = apply_norm(bp["lnx"], h, cfg.norm)
            qx = dense(bp["xattn"]["q"], x).reshape(B, cfg.n_heads,
                                                    cfg.head_dim)
            ax = decode_attention(qx, c["xk"], c["xv"], every, h.dtype)
            h = h + dense(bp["xattn"]["o"], ax.reshape(B, -1))[:, None, :]
            h = _mlp_part(bp, h, cfg)
        cache["lens"] = lens + 1
        h = apply_norm(params["final_norm"], h, cfg.norm)
        return self._logits(params, h[:, 0, :]), cache
