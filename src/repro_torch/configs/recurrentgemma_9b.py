"""recurrentgemma-9b [hybrid]: RG-LRU + local attention 1:2 (two recurrent
blocks per local-attention block), MQA (kv=1), 2048 window.
Adaptation note (DESIGN.md): GeGLU MLP realized as the gated-silu variant.
[arXiv:2402.19427; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    window=2048, pattern=("rglru", "rglru", "local"),
    # §Perf it-9 experiment: SP over model forces cross-shard
    # comms in the RG-LRU associative scan
    seq_parallel=False,
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=10_000.0,
    accum_for={"train_4k": 4},
    source="arXiv:2402.19427",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256,
        window=32, pattern=("rglru", "rglru", "local"),
        mlp="swiglu", norm="rmsnorm", pos="rope",
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
