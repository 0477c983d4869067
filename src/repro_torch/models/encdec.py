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

On a mesh (``build_model(cfg, hints)``): the reference's explicit code
has no sharded form of this family's mixers, so each batch block runs
the whole model on its replica's first device from the gathered
weights (``_replicas``), with the same values; the loss reduces the NLL
sums and label counts over the replicas, and the cache's leaves are
``ShardedTensor``s split over the batch.

In place: ``decode_fn`` writes each layer's new K/V row into the cache
it is given and returns that cache with ``lens`` advanced.  No remat
when serving: it keeps no activations for a backward pass.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              ShardedTensor, is_sharded,
                                              whole)
from repro_torch.models.config import ArchConfig, BlockKind
from repro_torch.models.layers import (NO_HINTS, Hints, apply_mlp,
                                       apply_norm, attention,
                                       attention_spec, decode_attention,
                                       dense, layernorm_spec, mlp_spec,
                                       remat, sinusoidal_rows,
                                       sinusoidal_table)
from repro_torch.models.params import (DTYPES, LeafSpec, check_device,
                                       normal, stacked, tree_map)
from repro_torch.models.transformer import (_attn_cache_from_prefill,
                                            _attn_part, _embed_tokens,
                                            _layer, _rows, _unstack,
                                            attn_decode, chunked_ce)

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
    ``hints`` with a mesh run every entry point on the replicas
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
            self._local = EncDecLM(cfg, device=device)
        self.device = check_device(device)

    def _replicas(self, params, tree):
        """(replica r's gathered params, its rows of ``tree``) for each
        batch block ``r``, on ``grid[r, 0]``."""
        R = self.grid.shape[0]
        for r in range(R):
            dev = self.grid[r, 0]
            yield (tree_map(lambda x: whole(x, dev), params,
                            is_leaf=is_sharded),
                   tree_map(lambda x: _rows(x, dev, r, R), tree,
                            is_leaf=is_sharded))

    def _loss_replicas(self, params, batch):
        tots, cnts = [], []
        for pw, b in self._replicas(params, batch):
            _, met = self._local.loss_fn(pw, b)
            tots.append(met["nll"])
            cnts.append(met["tokens"])
        devs = [self.device] * len(tots)
        tot, cnt = spmd.psum(tots, devs)[0], spmd.psum(cnts, devs)[0]
        return tot / torch.clamp(cnt, min=1), {
            "nll": tot, "tokens": cnt,
            "aux": torch.zeros((), dtype=torch.float32, device=self.device)}

    def _prefill_replicas(self, params, tokens, max_len, frames):
        outs = [self._local.prefill_fn(pw, b["tokens"], max_len,
                                       b["frames"])
                for pw, b in self._replicas(params, {"tokens": tokens,
                                                     "frames": frames})]
        mesh, dp, R = self.hints.mesh, self.hints.dp(), len(outs)

        def layout(*xs):   # stacked leaves [L, Br, ...]; lens [Br]
            at = 0 if xs[0].ndim == 1 else 1
            shape = list(xs[0].shape)
            shape[at] *= R
            spec = P(dp) if at == 0 else P(None, dp)
            return ShardedTensor(NamedSharding(mesh, spec), shape, list(xs))
        cache = tree_map(layout, *[c for _, c in outs])
        return torch.cat([lg.to(self.device) for lg, _ in outs], 0), cache

    def _decode_replicas(self, params, tok, cache):
        logits = []
        for r, (pw, t) in enumerate(self._replicas(params, tok)):
            cr = tree_map(lambda x: x[r], cache, is_leaf=is_sharded)
            lg, cr = self._local.decode_fn(pw, t, cr)
            cache["lens"][r].copy_(cr["lens"])
            logits.append(lg.to(self.device))
        return torch.cat(logits, 0), cache

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
            return self._loss_replicas(params, batch)
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
            return self._prefill_replicas(params, tokens, max_len, frames)
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
            return self._decode_replicas(params, tok, cache)
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
