"""Stock-torch oracle for the flash attention kernel (tests only; the
port's path never calls it): a materialized softmax, independent of the
plain version's tile loop.  Like the reference ``ref.py`` and
``chunked_attention``, the queries sit at the end of the kv range."""

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,Hq,hd]; k,v [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd] (naive softmax)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) / math.sqrt(hd)
    qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= qi - ki < window
    s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)
