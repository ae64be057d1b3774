from .bert import (BertConfig, BertModel, BertForPreTraining,
                   AttentionMaskOp, PositionIdsOp, FirstTokenOp,
                   MaskedSelectOp, MaskedSelectLabelsOp, MaskedMeanOp)
