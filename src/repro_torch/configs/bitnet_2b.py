"""bitnet-2b — the paper's own evaluation model (BitNet b1.58 2B4T).

30L d_model=2560 20H (GQA kv=5) d_ff=6912 vocab=128256, ReLU² FFN, ternary
weights trained from scratch. [arXiv:2504.12285]
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="bitnet-2b",
    family="dense",
    num_layers=30,
    d_model=2560,
    num_heads=20,
    num_kv_heads=5,
    head_dim=128,
    d_ff=6912,
    vocab_size=128256,
    ffn_kind="relu2",
    rope_theta=500_000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=16, targets=("q", "v")),
)
