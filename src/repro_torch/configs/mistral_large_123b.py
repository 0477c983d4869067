"""mistral-large-123b [dense]. [hf:mistralai/Mistral-Large-Instruct-2407;
unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768,
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
    accum_for={"train_4k": 8},
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        mlp="swiglu", norm="rmsnorm", pos="rope",
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
