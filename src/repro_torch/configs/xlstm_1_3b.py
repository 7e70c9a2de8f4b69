"""xLSTM-1.3B — sLSTM + mLSTM blocks. [arXiv:2405.04517]
A copy of ``repro/configs/xlstm_1_3b.py``.

48L, d_model=2048, 4 heads, vocab=50304. d_ff=0: xLSTM blocks carry
their own up and down projections (proj factor 2 for the mLSTM, 4/3 for
the sLSTM feed-forward). Pattern [m,m,m,s] per 4 layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm_state=64,          # unused by xLSTM math; marks recurrent family
    citation="arXiv:2405.04517",
)
