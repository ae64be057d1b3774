from .base import SimpleOp, simple_op
from .math import (add_op, sub_op, mul_op, div_op, addbyconst_op,
                   mulbyconst_op, tanh_op, gelu_op, relu_op, sigmoid_op,
                   silu_op)
from .linalg import matmul_op, linear_op, transpose_op
from .transform import array_reshape_op, broadcastto_op, slice_op, concat_op
from .reduce import reduce_mean_op, reduce_sum_op
from .nn import (conv2d_op, conv2d_add_bias_op, conv2d_hwio_op,
                 conv2d_hwio_add_bias_op, conv2d_nhwc_op,
                 conv2d_nhwc_add_bias_op, max_pool2d_op, avg_pool2d_op,
                 global_avg_pool2d_op, BatchNormOp, batch_normalization_op,
                 layer_normalization_op, rms_norm_op, DropoutOp, dropout_op)
from .rotary import rotary_embedding_op, repeat_kv_op
from .embedding import embedding_lookup_op, packed_embedding_lookup_op
from .losses import (softmax_cross_entropy_sparse_op,
                     binarycrossentropywithlogits_op, mse_loss_op)
from .moe import (top_k_gating, hash_gating, layout_transform_op,
                  reverse_layout_transform_op, topk_idx_op, topk_val_op,
                  scatter1d_op, balance_assignment, sam_group_sum)
from .attention import (ScaledDotProductAttentionOp,
                        scaled_dot_product_attention_op)
