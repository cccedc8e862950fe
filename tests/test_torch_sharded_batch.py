"""The port's sharded host batch (``gnnome_tpu_torch/parallel/sharded.py``
``prepare_batch``, ``halo_comm_bytes``, ``shard_batch``) against the JAX
package's, on the 8-device CPU mesh of ``tests/conftest.py``: no
processes, no process group (a ``Mesh(data, graph)`` layout is enough).

Every array the port keeps must equal JAX's element for element, default
padding included; the TPU-only fields JAX adds (band plans, streaming
plans, reverse-unsorted bounds) are the ones the port leaves out.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gnnome_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gnnome_tpu.parallel.sharded import halo_comm_bytes as jax_halo_comm_bytes
from gnnome_tpu.parallel.sharded import prepare_batch as jax_prepare_batch
from gnnome_tpu_torch.core.graph import PAD_SEGMENT
from gnnome_tpu_torch.parallel.mesh import Mesh
from gnnome_tpu_torch.parallel.sharded import (
    EdgeShard, halo_comm_bytes, prepare_batch, shard_batch)
from test_halo import chain_sample as jax_chain_sample
from test_sharded import make_chain_sample as jax_make_chain_sample
from test_sharded import make_sample as jax_make_sample

JAX_ONLY = {"key_w0", "ref_w0", "ref_order_w0", "ref_inv_w0", "ref_expand_w0",
            "canon_lo", "canon_hi", "key_stream", "ref_stream"}


def port_sample(jsample):
    """The JAX sample's graph and features as a port ``GraphSample``
    (canonical order in, canonical order out; both graphs pad alike)."""
    from gnnome_tpu_torch.core.graph import build_graph
    from gnnome_tpu_torch.data.dataset import GraphSample

    jg = jsample.graph
    e = jg.n_edges
    src, dst = np.asarray(jg.src)[:e], np.asarray(jg.dst)[:e]
    g = build_graph(src, dst, jg.n_nodes, node_pad_multiple=jg.n_nodes_padded,
                    edge_pad_multiple=jg.n_edges_padded, device="cpu")
    assert np.array_equal(g.src.numpy(), np.asarray(jg.src))

    def t(x):
        return torch.from_numpy(np.array(x))

    return GraphSample(idx=jsample.idx, graph=g, e_feat=t(jsample.e_feat), pe=t(jsample.pe),
                       y=t(jsample.y), prefix_length=None, read_length=None,
                       overlap_length=None, overlap_similarity=None, src=src, dst=dst)


def _samples(kind, data):
    rng = np.random.default_rng(7)
    if kind == "random":
        # nodes past 512·(P − 1) so that most shards own nodes
        return [jax_make_sample(rng, n=3000 + 500 * i, e=12000 + 2000 * i, idx=i)
                for i in range(data)]
    return [jax_make_chain_sample(rng, n=4096, skips=2048, idx=i) for i in range(data)]


MESHES = [(1, 2), (1, 4), (1, 8), (2, 2)]


@pytest.mark.parametrize("kind", ["random", "chain"])
@pytest.mark.parametrize("data,graph", MESHES)
def test_prepare_batch_matches_jax(kind, data, graph):
    jsamples = _samples(kind, data)
    jmesh = jax_make_mesh(data=data, graph=graph, devices=jax.devices()[: data * graph])
    want = jax_prepare_batch(jsamples, jmesh)
    got = prepare_batch([port_sample(s) for s in jsamples], Mesh(data, graph))
    np.testing.assert_array_equal(got.node_mask, np.asarray(want.node_mask))
    np.testing.assert_array_equal(got.pe, np.asarray(want.pe))
    kept = [f.name for f in dataclasses.fields(EdgeShard)]
    jax_fields = {f.name for f in dataclasses.fields(type(want.fwd))
                  if not f.metadata.get("static")}
    assert jax_fields - set(kept) == JAX_ONLY
    for name in kept:
        w = np.asarray(getattr(want.fwd, name))
        g = getattr(got.fwd, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert halo_comm_bytes(got) == jax_halo_comm_bytes(want)
    assert halo_comm_bytes(got, hidden=64, dtype_bytes=4) == \
        jax_halo_comm_bytes(want, hidden=64, dtype_bytes=4)


@pytest.mark.parametrize("data,graph", MESHES)
def test_shard_batch_csrs(data, graph):
    """Each rank's device slice: the local identity CSR over ``key_local``,
    the ref CSR over the combined table, and the send CSR, whose key in
    canonical order is ``send_idx`` with PAD_SEGMENT on unused slots."""
    got = prepare_batch([port_sample(s) for s in _samples("random", data)],
                        Mesh(data, graph))
    n_local = got.n_nodes_padded // graph
    for rank in range(data * graph):
        b, p = divmod(rank, graph)
        shard = shard_batch(got, Mesh(data, graph, rank, torch.device("cpu")))
        f = got.fwd
        assert shard.n_local == n_local and shard.n_halo == f.send_idx.shape[-1]
        assert shard.n_real == int(f.mask[b, p].sum())
        assert shard.n_real_graph == int(f.mask[b].sum())
        assert f.mask[b, p, : shard.n_real].all()  # real edges lead the bucket
        key = f.key_local[b, p]
        np.testing.assert_array_equal(shard.key.numpy(), np.where(key < n_local, key, 0))
        assert shard.by_key.identity and shard.by_key.offsets.shape[0] == n_local + 1
        assert shard.by_ref.offsets.shape[0] == n_local + shard.n_halo + 1
        ref_key = shard.by_ref.key.numpy()
        np.testing.assert_array_equal(ref_key[: shard.n_real], f.ref[b, p, : shard.n_real])
        assert (ref_key[shard.n_real:] == PAD_SEGMENT).all()
        np.testing.assert_array_equal(
            shard.by_ref.segment_ids.numpy(), ref_key[shard.by_ref.order.numpy()])
        send_key = shard.by_send.key.numpy()
        live = send_key < n_local
        np.testing.assert_array_equal(send_key[live], f.send_idx[b, p][live])
        assert (send_key[~live] == PAD_SEGMENT).all()
        np.testing.assert_array_equal(
            shard.by_send.segment_ids.numpy(), send_key[shard.by_send.order.numpy()])
        np.testing.assert_array_equal(
            shard.node_mask.numpy(), got.node_mask[b, p * n_local: (p + 1) * n_local])


def test_halo_comm_proportional_to_cut_not_n():
    """Doubling N of a chain graph leaves the halo buffer unchanged (the cut
    is constant), while the all-gather design it replaced scales ∝ N
    (the port's ``tests/test_halo.py`` counterpart)."""
    rng = np.random.default_rng(0)
    small = prepare_batch([port_sample(jax_chain_sample(rng, 20_000))], Mesh(1, 8))
    big = prepare_batch([port_sample(jax_chain_sample(rng, 40_000))], Mesh(1, 8))
    b_small, b_big = halo_comm_bytes(small), halo_comm_bytes(big)
    assert b_small["halo_rows"] == b_big["halo_rows"]
    assert b_big["all_gather_bytes_per_layer"] >= 1.9 * b_small["all_gather_bytes_per_layer"]
    assert b_small["halo_bytes_per_layer"] * 10 < b_small["all_gather_bytes_per_layer"]


def test_prepare_batch_refuses_a_batch_off_the_data_axis():
    with pytest.raises(ValueError, match="data-axis size"):
        prepare_batch([port_sample(s) for s in _samples("random", 1)], Mesh(2, 2))
