"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6,
fine-grained d_ff=1408. [hf:moonshotai/Moonlight-16B-A3B; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6,
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=50_000.0,
    accum_for={"train_4k": 2},
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="moonshot-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab=256,
        n_experts=4, top_k=2, capacity_factor=4.0,
        mlp="swiglu", norm="rmsnorm", pos="rope",
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
