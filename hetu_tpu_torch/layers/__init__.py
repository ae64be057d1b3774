from .base import BaseLayer, Sequence, Identity, fresh_name
from .common import (Linear, Conv2d, BatchNorm, LayerNorm, RMSNorm,
                     Embedding, MaxPool2d, AvgPool2d, Reshape)
from .attention import MultiHeadAttention
from .transformer import TransformerLayer, TransformerFFN
from .moe import (MoELayer, TopKGate, HashGate, KTop1Gate, SAMGate,
                  BalanceGate)
