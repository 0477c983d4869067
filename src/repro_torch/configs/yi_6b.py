"""yi-6b [dense]: llama-architecture GQA. [arXiv:2403.04652; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000,
    # repeat_kv refuted for yi: grouped-GQA handled fine by GSPMD here
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=5_000_000.0,
    accum_for={"train_4k": 2},
    source="arXiv:2403.04652",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="yi-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        mlp="swiglu", norm="rmsnorm", pos="rope",
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
