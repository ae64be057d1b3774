"""CTR models (port of ``hetu_tpu/models/ctr.py``): Wide&Deep, DeepFM,
DCN and DLRM over one shared sparse-feature table, standard or packed.

Variable names and layouts match the JAX package, so its params carry
across by name (weights.py); a packed table is [p_rows, 128] in both.  The
parameter-server table (``ps_embedding=``) arrives with slice B2 and the
serving scorer ``make_wdl_scorer`` with slice D2 (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.node import Op, VariableOp, scoped_init
from .. import initializers as init
from ..layers import Linear, fresh_name
from ..ops import (array_reshape_op, concat_op, relu_op, embedding_lookup_op,
                   packed_embedding_lookup_op, reduce_sum_op, reduce_mean_op,
                   binarycrossentropywithlogits_op)
from ..ops.kernels.sparse_densify import pack_factor, packed_rows, pack_table


def _no_ps(ps_embedding):
    if ps_embedding is not None:
        raise NotImplementedError(
            "ps_embedding (the parameter-server table and its cache) "
            "arrives with slice B2 of the port (ROADMAP.md)")


class SparseFeatureEmbedding:
    """One shared table over hashed/offset sparse slots: ids [B, F] ->
    [B, F, D].

    ``packed=True`` (or "auto") stores the table as ``[num_rows/q, 128]``
    with q = 128/dim logical rows per line (ops/kernels/sparse_densify.py):
    its gradient is written by the ``pack_write`` kernel and the dense
    optimizer updates the packed table whole.  Same math, different
    storage: ``host_table``/``load_rows`` exchange standard [num_rows, dim]
    weights."""

    def __init__(self, num_embeddings, dim, num_fields, name="sparse_emb",
                 packed=False):
        if packed == "auto":
            packed = pack_factor(dim) > 0
        if packed and not pack_factor(dim):
            raise ValueError(f"embedding dim {dim} does not pack into "
                             "128 lanes (needs dim | 128)")
        self.packed = bool(packed)
        self.num_embeddings = num_embeddings
        self.dim = dim
        self.num_fields = num_fields
        if self.packed:
            self.table = VariableOp(
                fresh_name(f"{name}_packed"),
                (packed_rows(num_embeddings, dim), 128),
                init.normal(0.0, 0.01))
        else:
            self.table = VariableOp(fresh_name(name), (num_embeddings, dim),
                                    init.normal(0.0, 0.01))

    def __call__(self, ids):
        if self.packed:
            return packed_embedding_lookup_op(self.table, ids, self.dim)
        return embedding_lookup_op(self.table, ids)  # [B, F, D]

    def host_table(self, params):
        """Standard [num_rows, dim] numpy copy of the table from an
        executor's params (unpacks the packed layout); the executor's
        steps update the table in place and leave the copy as it was."""
        w = params[self.table.name].detach().to("cpu", copy=True).numpy()
        if not self.packed:
            return w
        return w.reshape(-1, self.dim)[:self.num_embeddings]

    def load_rows(self, params, weights):
        """Install standard [num_rows, dim] weights into an executor's
        params, on the device of the table they replace (packed when the
        table is packed), written into that table when it has their shape
        (a captured step keeps reading it)."""
        old = params.get(self.table.name)
        w = torch.as_tensor(np.asarray(weights, np.float32))
        if self.packed:
            w = pack_table(w)
        if old is not None and old.shape == w.shape and old.dtype == w.dtype:
            with torch.no_grad():
                old.copy_(w)
        else:
            params[self.table.name] = w.to(
                old.device if old is not None else "cpu")


class WDL:
    """Wide & Deep (reference wdl_criteo: 13 dense + 26 sparse slots)."""

    @scoped_init
    def __init__(self, num_embeddings, embedding_dim=16, num_sparse=26,
                 num_dense=13, hidden=(256, 256, 256), name="wdl",
                 ps_embedding=None, packed_embedding=False):
        _no_ps(ps_embedding)
        self.emb = SparseFeatureEmbedding(
            num_embeddings, embedding_dim, num_sparse, name=f"{name}_emb",
            packed=packed_embedding)
        # wide part: linear over dense features
        self.wide = Linear(num_dense, 1, name=f"{name}_wide")
        dims = [num_sparse * embedding_dim + num_dense] + list(hidden)
        self.deep = [Linear(dims[i], dims[i + 1], name=f"{name}_deep{i}")
                     for i in range(len(hidden))]
        self.out = Linear(dims[-1], 1, name=f"{name}_out")
        self.num_sparse = num_sparse
        self.embedding_dim = embedding_dim

    def __call__(self, dense, sparse_ids):
        e = self.emb(sparse_ids)
        flat = array_reshape_op(
            e, output_shape=(-1, self.num_sparse * self.embedding_dim))
        x = concat_op(flat, dense, axis=1)
        for layer in self.deep:
            x = relu_op(layer(x))
        logit = self.out(x) + self.wide(dense)
        return array_reshape_op(logit, output_shape=(-1,))

    def loss(self, dense, sparse_ids, labels):
        return reduce_mean_op(binarycrossentropywithlogits_op(
            self(dense, sparse_ids), labels))


class FMSecondOrderOp(Op):
    """0.5 * ((sum_f e)^2 - sum_f e^2) summed over dim -> [B]."""

    def _compute(self, input_vals, ctx):
        (e,) = input_vals  # [B, F, D]
        s = e.sum(dim=1)
        s2 = (e * e).sum(dim=1)
        return 0.5 * (s * s - s2).sum(dim=-1)


class DeepFM:
    """DeepFM (reference dfm_criteo)."""

    @scoped_init
    def __init__(self, num_embeddings, embedding_dim=16, num_sparse=26,
                 num_dense=13, hidden=(256, 256), name="dfm",
                 ps_embedding=None, packed_embedding=False):
        _no_ps(ps_embedding)
        self.emb = SparseFeatureEmbedding(
            num_embeddings, embedding_dim, num_sparse, name=f"{name}_emb",
            packed=packed_embedding)
        self.first_order = VariableOp(f"{name}_fo", (num_embeddings, 1),
                                      init.normal(0.0, 0.01))
        dims = [num_sparse * embedding_dim + num_dense] + list(hidden)
        self.deep = [Linear(dims[i], dims[i + 1], name=f"{name}_deep{i}")
                     for i in range(len(hidden))]
        self.out = Linear(dims[-1], 1, name=f"{name}_out")
        self.num_sparse = num_sparse
        self.embedding_dim = embedding_dim

    def __call__(self, dense, sparse_ids):
        e = self.emb(sparse_ids)                                 # [B, F, D]
        fo = embedding_lookup_op(self.first_order, sparse_ids)  # [B, F, 1]
        fo = reduce_sum_op(
            array_reshape_op(fo, output_shape=(-1, self.num_sparse)),
            axes=1)                                              # [B]
        so = FMSecondOrderOp(e)                                  # [B]
        flat = array_reshape_op(
            e, output_shape=(-1, self.num_sparse * self.embedding_dim))
        x = concat_op(flat, dense, axis=1)
        for layer in self.deep:
            x = relu_op(layer(x))
        deep_out = array_reshape_op(self.out(x), output_shape=(-1,))
        return fo + so + deep_out

    def loss(self, dense, sparse_ids, labels):
        return reduce_mean_op(binarycrossentropywithlogits_op(
            self(dense, sparse_ids), labels))


class CrossLayerOp(Op):
    """DCN cross: x0 * (x·w) + b + x (reference dcn_criteo cross_layer)."""

    def _compute(self, input_vals, ctx):
        x0, x, w, b = input_vals
        xw = torch.einsum("bd,d->b", x, w)
        return x0 * xw[:, None] + b + x


class DCN:
    """Deep & Cross Network."""

    @scoped_init
    def __init__(self, num_embeddings, embedding_dim=16, num_sparse=26,
                 num_dense=13, num_cross=3, hidden=(256, 256), name="dcn",
                 ps_embedding=None, packed_embedding=False):
        _no_ps(ps_embedding)
        self.emb = SparseFeatureEmbedding(
            num_embeddings, embedding_dim, num_sparse, name=f"{name}_emb",
            packed=packed_embedding)
        d = num_sparse * embedding_dim + num_dense
        self.cross_w = [VariableOp(f"{name}_cw{i}", (d,),
                                   init.normal(0.0, 0.01))
                        for i in range(num_cross)]
        self.cross_b = [VariableOp(f"{name}_cb{i}", (d,), init.zeros())
                        for i in range(num_cross)]
        dims = [d] + list(hidden)
        self.deep = [Linear(dims[i], dims[i + 1], name=f"{name}_deep{i}")
                     for i in range(len(hidden))]
        self.out = Linear(d + dims[-1], 1, name=f"{name}_out")
        self.num_sparse = num_sparse
        self.embedding_dim = embedding_dim

    def __call__(self, dense, sparse_ids):
        e = self.emb(sparse_ids)
        flat = array_reshape_op(
            e, output_shape=(-1, self.num_sparse * self.embedding_dim))
        x0 = concat_op(flat, dense, axis=1)
        x = x0
        for w, b in zip(self.cross_w, self.cross_b):
            x = CrossLayerOp(x0, x, w, b)
        h = x0
        for layer in self.deep:
            h = relu_op(layer(h))
        both = concat_op(x, h, axis=1)
        return array_reshape_op(self.out(both), output_shape=(-1,))

    def loss(self, dense, sparse_ids, labels):
        return reduce_mean_op(binarycrossentropywithlogits_op(
            self(dense, sparse_ids), labels))


class DLRMInteractionOp(Op):
    """Pairwise dot interactions (DLRM): [B,F,D] -> [B, F*(F-1)/2], the
    upper triangle in row-major order."""

    def _compute(self, input_vals, ctx):
        (e,) = input_vals
        z = torch.einsum("bfd,bgd->bfg", e, e)
        f = e.shape[1]
        iu, ju = torch.triu_indices(f, f, offset=1, device=e.device)
        return z[:, iu, ju]


class DLRM:
    @scoped_init
    def __init__(self, num_embeddings, embedding_dim=16, num_sparse=26,
                 num_dense=13, bottom=(512, 256), top=(512, 256),
                 name="dlrm", ps_embedding=None, packed_embedding=False):
        _no_ps(ps_embedding)
        self.emb = SparseFeatureEmbedding(
            num_embeddings, embedding_dim, num_sparse, name=f"{name}_emb",
            packed=packed_embedding)
        bd = [num_dense] + list(bottom) + [embedding_dim]
        self.bottom = [Linear(bd[i], bd[i + 1], name=f"{name}_bot{i}")
                       for i in range(len(bd) - 1)]
        f = num_sparse + 1
        td = [f * (f - 1) // 2 + embedding_dim] + list(top)
        self.top = [Linear(td[i], td[i + 1], name=f"{name}_top{i}")
                    for i in range(len(td) - 1)]
        self.out = Linear(td[-1], 1, name=f"{name}_out")
        self.num_sparse = num_sparse
        self.embedding_dim = embedding_dim

    def __call__(self, dense, sparse_ids):
        x = dense
        for layer in self.bottom:
            x = relu_op(layer(x))
        e = self.emb(sparse_ids)  # [B, F, D]
        xe = array_reshape_op(x, output_shape=(-1, 1, self.embedding_dim))
        all_e = concat_op(xe, e, axis=1)
        inter = DLRMInteractionOp(all_e)
        h = concat_op(inter, x, axis=1)
        for layer in self.top:
            h = relu_op(layer(h))
        return array_reshape_op(self.out(h), output_shape=(-1,))

    def loss(self, dense, sparse_ids, labels):
        return reduce_mean_op(binarycrossentropywithlogits_op(
            self(dense, sparse_ids), labels))


def make_wdl_scorer(model):
    """The serving scorer over pre-gathered rows (serving/embedding/ in
    the JAX package) arrives with slice D2 (the embedding server) of the
    port."""
    raise NotImplementedError(
        "make_wdl_scorer (the embedding server's scorer) arrives with "
        "slice D2 (the embedding server) of the port (ROADMAP.md)")
