"""A whole run on the CPU, past the harness's look for a card, at full
widths on small graphs: sound, it is correct; with the timed path broken
underneath it is not. One test a fault each cell can have: a step that
returns its state unchanged, half of the batch left out (the mean over the
rest), a piece that is not its node set's subgraph, an answer altered where
it is produced. (No cell spans chips, so none can leave an exchange out.)"""
import pytest
import torch

from benchmark import run
from conftest import load_spec

TRAIN = ["bn-f32.train-full", "ln-f32.train-full", "bn-bf16.train-full", "bn-f32.train-cluster"]


def small(cell):
    spec = load_spec(cell)
    spec["traffic"].update(n_nodes=2000, n_edges=12000)
    if "cluster" in cell:
        spec["traffic"]["train"] = {"num_parts_train": 16, "batch_size_train": 4,
                                    "cluster_jitter": 4}
    return spec


def run_small(cell, seed=2**31 + 7):
    return run.run_cell(small(cell), seed, 0.5, False, device="cpu")


# The ClusterGCN cell's sound run is held on the card at pieces of its own
# size (test_bench_card.py): in pieces of a few hundred nodes, Adam's sign
# decisions on near-zero gradient elements move the median leaf's change
# past the limit set for pieces of 10-15k nodes.
@pytest.mark.parametrize("cell", ["bn-f32.train-full", "ln-f32.train-full",
                                  "bn-bf16.train-full", "bn-f32.assemble"])
def test_sound_run_is_correct(cell):
    result = run_small(cell)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result = run_small(cell)
    assert not result["correct"]
    change = next(v for k, v in result["compared"].items() if k.startswith("change_gap"))
    assert change["value"] == pytest.approx(1.0, abs=0.01)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from gnnome_tpu_torch.train import loop

    bce = loop.bce_with_logits

    def half(logits, y, mask, pos_weight):
        kept = mask.clone()
        real = torch.nonzero(kept)[:, 0]
        kept[real[len(real) // 2:]] = False
        return bce(logits, y, kept, pos_weight)

    monkeypatch.setattr(loop, "bce_with_logits", half)
    result = run_small(cell)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["compared"].values())


def test_piece_not_its_subgraph(monkeypatch):
    from gnnome_tpu_torch.train import cluster

    induced = cluster.induced_subgraph

    def short(sample, node_ids):
        src, dst, edge_ids, nodes = induced(sample, node_ids)
        return src[:-1], dst[:-1], edge_ids[:-1], nodes

    monkeypatch.setattr(cluster, "induced_subgraph", short)
    result = run_small("bn-f32.train-cluster")
    assert not result["correct"] and result["compared"]["piece_faults"]["value"] > 0


def test_walk_altered(monkeypatch):
    from gnnome_tpu_torch.decode import greedy

    contigs = greedy.get_contigs

    def altered(*args, **kw):
        walks = contigs(*args, **kw)
        return [walks[0][::-1]] + walks[1:]

    monkeypatch.setattr(greedy, "get_contigs", altered)
    result = run_small("bn-f32.assemble")
    assert not result["correct"] and result["compared"]["walks_differ"]["value"] >= 1


def test_score_altered(monkeypatch):
    from gnnome_tpu_torch.decode import inference

    score = inference.score_graph

    def altered(*args, **kw):
        logits = score(*args, **kw).clone()
        logits[0] += 0.5
        return logits

    monkeypatch.setattr(inference, "score_graph", altered)
    result = run_small("bn-f32.assemble")
    assert not result["correct"]
    assert result["compared"]["logit_gap"]["value"] >= 0.4
