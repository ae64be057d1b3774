from .bert import (BertConfig, BertModel, BertForPreTraining,
                   AttentionMaskOp, PositionIdsOp, FirstTokenOp,
                   MaskedSelectOp, MaskedSelectLabelsOp, MaskedMeanOp)
from .ctr import (SparseFeatureEmbedding, WDL, DeepFM, DCN, DLRM,
                  FMSecondOrderOp, CrossLayerOp, DLRMInteractionOp,
                  make_wdl_scorer)
