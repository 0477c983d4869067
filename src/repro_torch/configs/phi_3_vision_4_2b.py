"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend stubbed to
576 precomputed patch embeddings. [hf:microsoft/Phi-3-vision-128k-instruct;
hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
    n_patches=576,
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=10_000.0,
    accum_for={"train_4k": 2},
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi3v-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        n_patches=8,
        mlp="swiglu", norm="rmsnorm", pos="rope",
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
