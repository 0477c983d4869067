"""mamba2-1.3b [ssm]: attention-free SSD (state-space duality), state 128.
[arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    mlp="swiglu", norm="rmsnorm", pos="none", tie_embeddings=True,
    accum_for={"train_4k": 1},
    source="arXiv:2405.21060",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, head_dim=16,
        d_ff=0, vocab=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32,
        mlp="swiglu", norm="rmsnorm", pos="none", tie_embeddings=True,
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
