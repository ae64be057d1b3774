from .base import BaseLayer, fresh_name
from .common import Linear, LayerNorm, RMSNorm, Embedding
from .attention import MultiHeadAttention
from .transformer import TransformerLayer, TransformerFFN
from .moe import (MoELayer, TopKGate, HashGate, KTop1Gate, SAMGate,
                  BalanceGate)
