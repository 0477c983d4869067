"""qwen2-7b [dense]: GQA with QKV bias. [arXiv:2407.10671; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064,
    qkv_bias=True,
    # §Perf lever: 28 q-heads don't divide the 16-way model axis; padding
    # to 32 (+1.3% params) enables attention head-TP (EXPERIMENTS.md §Perf)
    pad_q_heads=4,
    mlp="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
    accum_for={"train_4k": 2},
    source="arXiv:2407.10671",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        qkv_bias=True,
        mlp="swiglu", norm="rmsnorm", pos="rope",
        q_chunk=32, kv_chunk=32, logit_chunk=16,
    )
