"""The CTR models (models/ctr.py) through both packages' Executors on the
CPU: WDL, DeepFM, DCN and DLRM, each with a packed and a standard table.

Each model is built at a small size (5,000 rows, dim 16, 26 sparse and 13
dense fields, narrow hidden layers) with each package's graph API, as
``examples/ctr/train_ctr.py``'s ``build()`` does:
``Executor({"train": [loss, AdamOptimizer(0.01).minimize(loss)],
"predict": [logit]})``.  The JAX executor's params carry across with
``Executor.load_params`` (weights.params_from_jax; a packed table stays
[p_rows, 128]).  Both run 3 train steps on the same numpy batches, f32
throughout.  On the CPU the JAX packed path runs its jnp composition and
the port's runs ``pack_write_plain``.

Tolerances: losses rtol 1e-5 (the same f32 arithmetic, with the products'
and the mean's sums in another order).  Each param's change over the 3
steps (param minus its init) is held to JAX's change within 1e-4,
relative, in the 2-norm: a bound on the params alone would be too loose,
since Adam moves an entry by ~lr = 0.01 a step whatever its gradient's
size, so a param left unchanged reads 1 here and an update of the wrong
sign 2.  The predict logits: rtol 1e-5, atol 1e-6 (the same arithmetic).
"""

import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.models.ctr as jctr
import hetu_tpu_torch as pt
import hetu_tpu_torch.models.ctr as pctr

ROWS, B, F, NDENSE, DIM = 5000, 32, 26, 13, 16
SIZES = {"WDL": {"hidden": (32, 32, 32)},
         "DeepFM": {"hidden": (32, 32)},
         "DCN": {"hidden": (32, 32), "num_cross": 3},
         "DLRM": {"bottom": (32,), "top": (32,)}}


def _build(pkg, ctr, model_name, packed):
    dense = pkg.placeholder_op("dense", (B, NDENSE))
    sparse = pkg.placeholder_op("sparse", (B, F), dtype=np.int32)
    labels = pkg.placeholder_op("labels", (B,))
    model = getattr(ctr, model_name)(ROWS, embedding_dim=DIM, num_sparse=F,
                                     num_dense=NDENSE,
                                     packed_embedding=packed,
                                     **SIZES[model_name])
    loss = model.loss(dense, sparse, labels)
    logit = model(dense, sparse)
    train_op = pkg.AdamOptimizer(learning_rate=0.01).minimize(loss)
    return model, {"train": [loss, train_op], "predict": [logit]}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"dense": rng.standard_normal((B, NDENSE)).astype(np.float32),
            "sparse": rng.integers(0, ROWS, (B, F)).astype(np.int32),
            "labels": rng.integers(0, 2, B).astype(np.float32)}


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "rows"])
@pytest.mark.parametrize("model_name", list(SIZES))
def test_ctr_train_matches_jax(model_name, packed):
    jmodel, jnodes = _build(jt, jctr, model_name, packed)
    tmodel, tnodes = _build(pt, pctr, model_name, packed)
    jex = jt.Executor(jnodes)
    tex = pt.Executor(tnodes, device="cpu")
    tex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    table = tex.params[tmodel.emb.table.name]
    assert tuple(table.shape) == ((ROWS // 8, 128) if packed
                                  else (ROWS, DIM))
    init = {k: v.clone() for k, v in tex.params.items()}

    feed = _batch(0)
    want = jex.run("predict", feed_dict=feed, convert_to_numpy_ret_vals=True)
    got = tex.run("predict", feed_dict=feed, convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert all(torch.equal(tex.params[k], v) for k, v in init.items())
    assert not tex.subexecutor["predict"].training
    assert tex.subexecutor["train"].training

    for step in range(3):
        feed = _batch(step + 1)
        want = jex.run("train", feed_dict=feed,
                       convert_to_numpy_ret_vals=True)
        got = tex.run("train", feed_dict=feed, convert_to_numpy_ret_vals=True)
        assert got[1] is None and np.isfinite(got[0])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, before in init.items():
        after = tex.params[name].numpy()
        ref = np.asarray(jex.params[name])
        change = np.linalg.norm(ref - before.numpy())
        assert change > 0, name
        err = np.linalg.norm(after - ref) / change
        assert err <= 1e-4, (name, err)

    # predict after training reads the trained params and changes none
    trained = {k: v.clone() for k, v in tex.params.items()}
    want = jex.run("predict", feed_dict=feed, convert_to_numpy_ret_vals=True)
    got = tex.run("predict", feed_dict=feed, convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert all(torch.equal(tex.params[k], v) for k, v in trained.items())


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "rows"])
def test_host_table_and_load_rows_roundtrip(packed):
    rows = 1001  # a partly used tail line when packed
    w = np.random.default_rng(3).standard_normal((rows, DIM)).astype(
        np.float32)
    with pt.name_scope():
        temb = pctr.SparseFeatureEmbedding(rows, DIM, F, packed=packed)
    with jt.name_scope():
        jemb = jctr.SparseFeatureEmbedding(rows, DIM, F, packed=packed)
    assert temb.table.name == jemb.table.name
    assert temb.table.shape == jemb.table.shape
    tparams, jparams = {}, {}
    temb.load_rows(tparams, w)
    jemb.load_rows(jparams, w)
    np.testing.assert_array_equal(tparams[temb.table.name].numpy(),
                                  np.asarray(jparams[jemb.table.name]))
    np.testing.assert_array_equal(temb.host_table(tparams), w)
    # load_rows keeps the device of the table it replaces
    tparams[temb.table.name] = torch.zeros(temb.table.shape, device="meta")
    temb.load_rows(tparams, w)
    assert tparams[temb.table.name].device.type == "meta"


def test_ctr_later_slices_raise():
    with pytest.raises(NotImplementedError, match="slice B2"):
        pctr.WDL(ROWS, ps_embedding=object())
    with pytest.raises(NotImplementedError, match="slice D2"):
        pctr.make_wdl_scorer(pctr.WDL(ROWS))
    with pytest.raises(ValueError, match="128 lanes"):
        pctr.WDL(ROWS, embedding_dim=24, packed_embedding=True)
