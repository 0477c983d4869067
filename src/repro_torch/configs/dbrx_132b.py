"""dbrx-132b [moe]: 16 experts top-4, fine-grained GLU experts.
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    n_experts=16, top_k=4,
    mlp="swiglu", norm="layernorm", pos="rope", rope_theta=500_000.0,
    accum_for={"train_4k": 8},
    source="hf:databricks/dbrx-base",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="dbrx-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=256,
        n_experts=4, top_k=2, capacity_factor=4.0,
        mlp="swiglu", norm="layernorm", pos="rope",
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
