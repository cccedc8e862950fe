"""The port's model forward and checkpoint format against the JAX package.

One JAX parameter set crosses to the port through ``params_from_jax`` (the
``.npz`` tree-path keys of gnnome_tpu/train/checkpoint.py); the same graph
and features, made with numpy from a seed, go through both forwards. The
JAX side runs its ``xla`` backend on the CPU. Logits must agree to 1e-4:
each of the layers sums in f32 in another order than XLA, and BatchNorm
and the residuals carry those ulp-level differences through the stack.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.core.graph import build_graph as jax_build_graph
from gnnome_tpu.core.graph import pad_features as jax_pad_features
from gnnome_tpu.core.graph import prepare_edge_features as jax_prepare
from gnnome_tpu.evaluation import metrics as jax_metrics
from gnnome_tpu.models.model import init_model_params as jax_init
from gnnome_tpu.models.model import model_forward as jax_forward
from gnnome_tpu.train.checkpoint import _flatten
from gnnome_tpu.train.checkpoint import load_params as jax_load_params
from gnnome_tpu_torch.config import Config, ModelConfig
from gnnome_tpu_torch.core.graph import build_graph, pad_features, prepare_edge_features
from gnnome_tpu_torch.evaluation import metrics
from gnnome_tpu_torch.models.model import count_params, init_model_params, model_forward
from gnnome_tpu_torch.train.checkpoint import (
    flatten_params,
    iter_leaves,
    load_params,
    params_from_jax,
    save_params,
)

ROOT = Path(__file__).resolve().parent.parent


def _inputs(rng, n=200, e=1100, nb_pos_enc=4):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.minimum(src + rng.integers(1, 30, e), n - 1).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    e_feat = rng.standard_normal((len(src), 2)).astype(np.float32)
    pe = rng.standard_normal((n, nb_pos_enc + 2)).astype(np.float32)
    return src, dst, n, e_feat, pe


@pytest.mark.parametrize("d,batch_norm", [(32, True), (128, True), (32, False)])
def test_model_forward_matches_jax(d, batch_norm):
    rng = np.random.default_rng(d)
    src, dst, n, e_feat, pe = _inputs(rng)
    kw = dict(hidden_features=d, num_gnn_layers=3, nb_pos_enc=4,
              hidden_edge_scores=16, batch_norm=batch_norm)
    jparams = jax_init(jax.random.PRNGKey(1), JaxModelConfig(**kw))
    params = params_from_jax(_flatten(jparams), device="cpu")

    jg = jax_build_graph(src, dst, n)
    want = jax_forward(jparams, jg, jax_prepare(jg, e_feat),
                       jnp.asarray(jax_pad_features(pe, jg.n_nodes_padded)),
                       batch_norm=batch_norm, backend="xla")
    want = np.asarray(want)[: jg.n_edges]
    # the port's graph is unpadded; the same real edges in the same order
    g = build_graph(src, dst, n, device="cpu")
    got = model_forward(params, g, prepare_edge_features(g, e_feat),
                        torch.from_numpy(pe), batch_norm=batch_norm)
    assert got.shape == (g.n_edges,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert count_params(params) == sum(a.size for a in _flatten(jparams).values())


def test_padding_does_not_change_logits():
    rng = np.random.default_rng(2)
    src, dst, n, e_feat, pe = _inputs(rng)
    params = init_model_params(torch.Generator().manual_seed(0),
                               ModelConfig(hidden_features=16, num_gnn_layers=2,
                                           nb_pos_enc=4), device="cpu")
    plain = build_graph(src, dst, n, device="cpu")
    padded = build_graph(src, dst, n, node_pad_multiple=128, edge_pad_multiple=512,
                         device="cpu")
    a = model_forward(params, plain, prepare_edge_features(plain, e_feat), torch.from_numpy(pe))
    b = model_forward(params, padded, prepare_edge_features(padded, e_feat),
                      torch.from_numpy(pad_features(pe, padded.n_nodes_padded)))
    torch.testing.assert_close(b[: padded.n_edges], a, rtol=1e-5, atol=1e-5)


def test_init_matches_jax_tree():
    cfg = ModelConfig(hidden_features=24, num_gnn_layers=2, nb_pos_enc=6)
    ours = {k: tuple(v.shape) for k, v in iter_leaves(
        init_model_params(torch.Generator().manual_seed(0), cfg, device="cpu"))}
    theirs = {k: v.shape for k, v in _flatten(
        jax_init(jax.random.PRNGKey(0), JaxModelConfig(**vars(cfg)))).items()}
    assert ours == theirs


def test_load_shipped_weights_consumes_every_key():
    path = ROOT / "pretrained" / "model_hardfull40.npz"
    cfg = Config()
    template = init_model_params(torch.Generator().manual_seed(0), cfg.model, device="cpu")
    params = load_params(str(path), template)
    with np.load(path) as z:
        files = {k: z[k] for k in z.files}
    loaded = flatten_params(params)
    assert set(loaded) == set(files) and len(files) == 16 * 16 + 10
    for k, v in files.items():
        np.testing.assert_array_equal(loaded[k], v)
    # a template of another size, or a file with a leaf missing, is refused
    small = init_model_params(torch.Generator().manual_seed(0),
                              ModelConfig(num_gnn_layers=15), device="cpu")
    with pytest.raises(KeyError):
        load_params(str(path), small)
    wide = init_model_params(torch.Generator().manual_seed(0),
                             ModelConfig(hidden_features=128), device="cpu")
    with pytest.raises(ValueError):
        load_params(str(path), wide)


def test_saved_params_load_in_jax(tmp_path):
    cfg = ModelConfig(hidden_features=16, num_gnn_layers=2, nb_pos_enc=4)
    params = init_model_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    save_params(str(tmp_path / "p.npz"), params)
    back = jax_load_params(str(tmp_path / "p.npz"),
                           jax_init(jax.random.PRNGKey(0), JaxModelConfig(**vars(cfg))))
    for k, v in _flatten(back).items():
        np.testing.assert_array_equal(v, flatten_params(params)[k])


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(500) * 3).astype(np.float32)
    labels = (rng.random(500) < 0.6).astype(np.float32)
    mask = rng.random(500) < 0.9
    counts = metrics.confusion_counts(torch.from_numpy(logits), torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    jcounts = jax_metrics.confusion_counts(jnp.asarray(logits), jnp.asarray(labels),
                                           jnp.asarray(mask))
    assert {k: float(v) for k, v in counts.items()} == \
        {k: float(v) for k, v in jcounts.items()}
    for compat in (False, True):
        assert metrics.classification_metrics(counts, compat) == pytest.approx(
            jax_metrics.classification_metrics(jcounts, compat))
    loss = metrics.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(mask), pos_weight=2.5)
    jloss = jax_metrics.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                        jnp.asarray(mask), pos_weight=2.5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
