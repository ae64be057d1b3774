from .bert import (BertConfig, BertModel, BertForPreTraining,
                   AttentionMaskOp, PositionIdsOp, FirstTokenOp,
                   MaskedSelectOp, MaskedSelectLabelsOp, MaskedMeanOp)
from .ctr import (SparseFeatureEmbedding, WDL, DeepFM, DCN, DLRM,
                  FMSecondOrderOp, CrossLayerOp, DLRMInteractionOp,
                  make_wdl_scorer)
from .gpt import GPTConfig, GPT_CONFIGS, GPTModel, GPTLMHeadModel
from .llama import (LlamaConfig, LLAMA_CONFIGS, LlamaMLP, LlamaDecoderLayer,
                    LlamaModel, LlamaForCausalLM, BaichuanForCausalLM)
from .resnet import BasicBlock, ResNet, resnet18, resnet34
