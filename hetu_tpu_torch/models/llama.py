"""Llama / Baichuan decoder LMs (port of ``hetu_tpu/models/llama.py``).

RMSNorm pre-norm blocks, a SwiGLU FFN, rotary position embeddings and
optional grouped-query attention; no learned position table.  Variable
names are the JAX package's, so ``Executor.load_params`` carries its
weights across unchanged.  Under an executor mesh with a ``cp`` axis the
attention lowers to ring (or Ulysses) attention, with RoPE applied to the
global sequence before it (slice F1).

Later slices raise here, naming themselves (ROADMAP.md): MoE FFNs
(``num_experts``) and ALiBi positions (Baichuan-13B) with the rest of
slice C, ``pipeline_stages`` with slice F's pipeline parallelism.
"""

from __future__ import annotations

from .. import initializers as init
from ..graph.node import scoped_init
from ..layers import Embedding, Linear, RMSNorm
from ..layers.base import BaseLayer
from ..layers.attention import MultiHeadAttention
from ..ops import (array_reshape_op, matmul_op, silu_op,
                   softmax_cross_entropy_sparse_op)
from .bert import MaskedMeanOp


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096, num_layers=32,
                 num_heads=32, num_kv_heads=None, intermediate_size=11008,
                 seq_len=2048, rope_theta=10000.0, rms_eps=1e-5,
                 position_embedding="rope", tie_embeddings=False,
                 num_experts=None, moe_k=2, moe_capacity_factor=2.0,
                 moe_aux_coeff=0.01, ep_axis=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.intermediate_size = intermediate_size
        self.seq_len = seq_len
        self.rope_theta = rope_theta
        self.rms_eps = rms_eps
        assert position_embedding in ("rope", "alibi")
        assert hidden_size % num_heads == 0, (hidden_size, num_heads)
        if position_embedding == "rope":
            # rotate_half pairs dimensions: an odd head_dim would broadcast
            # the tables to the wrong width downstream
            assert (hidden_size // num_heads) % 2 == 0, (
                f"RoPE needs an even head_dim; got "
                f"{hidden_size // num_heads} (hidden {hidden_size}, "
                f"heads {num_heads})")
        self.position_embedding = position_embedding
        self.tie_embeddings = tie_embeddings
        self.num_experts = num_experts
        self.moe_k = moe_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_coeff = moe_aux_coeff
        self.ep_axis = ep_axis


# published shapes (the JAX package's, from the reference's configs)
LLAMA_CONFIGS = {
    "llama-7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     intermediate_size=11008),
    "llama-13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                      intermediate_size=13824),
    "llama-30b": dict(hidden_size=6656, num_layers=60, num_heads=52,
                      intermediate_size=17920),
    # llama3-style GQA shape
    "llama3-8b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                      num_kv_heads=8, intermediate_size=14336,
                      vocab_size=128256, rope_theta=500000.0),
    # GQA shapes of the Mistral family (sliding-window attention not
    # modeled; full causal within seq_len)
    "mistral-7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                       num_kv_heads=8, intermediate_size=14336,
                       vocab_size=32000),
    # moe_capacity_factor = E/k: the no-drop point Mixtral parity needs
    "mixtral-8x7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                         num_kv_heads=8, intermediate_size=14336,
                         vocab_size=32000, num_experts=8, moe_k=2,
                         moe_capacity_factor=4.0),
    # reference models/baichuan: 7B is rope, 13B is alibi
    "baichuan-7b": dict(vocab_size=64000, hidden_size=4096, num_layers=32,
                        num_heads=32, intermediate_size=11008),
    "baichuan-13b": dict(vocab_size=64000, hidden_size=5120, num_layers=40,
                         num_heads=40, intermediate_size=13696,
                         position_embedding="alibi"),
}


def _no_pipeline(pipeline_stages):
    if pipeline_stages:
        raise NotImplementedError(
            "pipeline_stages arrives with slice F (pipeline parallelism) of "
            "the port (ROADMAP.md)")


class LlamaMLP(BaseLayer):
    """SwiGLU: down(silu(gate(x)) * up(x)) (HF LlamaMLP semantics); the
    down projection is named ``_out``, as in the JAX package."""

    def __init__(self, hidden_size, intermediate_size, name):
        self.gate = Linear(hidden_size, intermediate_size, bias=False,
                           name=f"{name}_gate")
        self.up = Linear(hidden_size, intermediate_size, bias=False,
                         name=f"{name}_up")
        self.down = Linear(intermediate_size, hidden_size, bias=False,
                           name=f"{name}_out")

    def __call__(self, x):
        return self.down(silu_op(self.gate(x)) * self.up(x))


class LlamaDecoderLayer(BaseLayer):
    def __init__(self, config, name):
        c = config
        if c.position_embedding == "alibi":
            raise NotImplementedError(
                "ALiBi positions (Baichuan-13B) arrive with the rest of slice "
                "C of the port (ROADMAP.md)")
        if c.num_experts:
            raise NotImplementedError(
                "MoE-Llama (num_experts) arrives with the rest of slice C of "
                "the port (ROADMAP.md)")
        self.attn = MultiHeadAttention(
            c.hidden_size, c.num_heads, sequence_length=c.seq_len,
            causal_mask=True, num_kv_heads=c.num_kv_heads,
            rope_theta=c.rope_theta, bias=False, name=f"{name}_attn")
        self.mlp = LlamaMLP(c.hidden_size, c.intermediate_size,
                            name=f"{name}_mlp")
        self.input_norm = RMSNorm(c.hidden_size, eps=c.rms_eps,
                                  name=f"{name}_input_norm")
        self.post_norm = RMSNorm(c.hidden_size, eps=c.rms_eps,
                                 name=f"{name}_post_norm")

    def __call__(self, x, seq_len=None):
        a_in = self.input_norm(x)
        x = x + self.attn(a_in, a_in, a_in, seq_len=seq_len)
        return x + self.mlp(self.post_norm(x))


class LlamaModel:
    @scoped_init
    def __init__(self, config, name="llama", pipeline_stages=None):
        _no_pipeline(pipeline_stages)
        c = config
        self.config = c
        self.embed = Embedding(c.vocab_size, c.hidden_size,
                               initializer=init.normal(0.0, 0.02),
                               name=f"{name}_embed")
        self.layers = [LlamaDecoderLayer(c, name=f"{name}_layer{i}")
                       for i in range(c.num_layers)]
        self.norm = RMSNorm(c.hidden_size, eps=c.rms_eps,
                            name=f"{name}_norm")

    def __call__(self, input_ids):
        x = self.embed(input_ids)
        for layer in self.layers:
            x = layer(x, seq_len=self.config.seq_len)
        return self.norm(x)


class LlamaForCausalLM:
    @scoped_init
    def __init__(self, config, name="llama", pipeline_stages=None):
        _no_pipeline(pipeline_stages)
        self.model = LlamaModel(config, name=name)
        self.config = config
        self.lm_head = (None if config.tie_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               bias=False, initializer=init.normal(0.0, 0.02),
                               name=f"{name}_lm_head"))

    def __call__(self, input_ids):
        h = self.model(input_ids)
        h = array_reshape_op(h, output_shape=(-1, self.config.hidden_size))
        if self.lm_head is None:
            return matmul_op(h, self.model.embed.weight, trans_B=True)
        return self.lm_head(h)

    def loss(self, input_ids, labels):
        """labels: [B, S] next-token ids with -1 at ignored positions
        (the caller shifts them)."""
        logits = self(input_ids)
        flat = array_reshape_op(labels, output_shape=(-1,))
        ce = softmax_cross_entropy_sparse_op(logits, flat, ignored_index=-1)
        return MaskedMeanOp(ce, flat)


def BaichuanForCausalLM(config, name="baichuan", pipeline_stages=None):
    """The Baichuan family is the Llama architecture with its own vocab
    and (for 13B) ALiBi positions: config-level variants."""
    return LlamaForCausalLM(config, name=name,
                            pipeline_stages=pipeline_stages)
