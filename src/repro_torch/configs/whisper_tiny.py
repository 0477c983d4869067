"""whisper-tiny [audio]: enc-dec, conv frontend stubbed to precomputed
frames.  4L here means 4 encoder + 4 decoder layers (whisper-tiny layout).
[arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    head_dim=64, d_ff=1536, vocab=51865,
    mlp="gelu", norm="layernorm", pos="sinusoidal",
    attn_bias=True, tie_embeddings=True,
    enc_seq=1500,
    # §Perf it-6: vocab 51865 is not 16-divisible; pad to 51872 so the
    # embedding/logits shard over `model` (padded ids masked in CE)
    vocab_pad=7,
    logit_chunk=256,
    accum_for={"train_4k": 1},
    source="arXiv:2212.04356",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256,
        mlp="gelu", norm="layernorm", pos="sinusoidal",
        attn_bias=True, tie_embeddings=True,
        enc_seq=16, q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
