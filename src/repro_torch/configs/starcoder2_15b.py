"""starcoder2-15b [dense]: GQA, RoPE, biased projections + GELU MLP.
[arXiv:2402.19173; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152,
    attn_bias=True,
    mlp="gelu", norm="layernorm", pos="rope", rope_theta=100_000.0,
    accum_for={"train_4k": 4},
    source="arXiv:2402.19173",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        attn_bias=True,
        mlp="gelu", norm="layernorm", pos="rope",
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
