"""Model FLOPs of the GatedGCN edge classifier, from its shapes.

Only the matrix products count, at 2 operations a multiply-add, over the
real nodes ``N`` and edges ``E``: per layer five node products
``2 N D^2`` (A1, A2, A3, B1, B2) and one edge product ``2 E D^2`` (B3);
the node encoder ``2 N (PE + 2) D``, the edge encoder
``2 E (2 H_e + H_e D)``, and the score head ``2 (2 N D S + E D S + E S)``
with ``S`` its hidden width. A training step is three forwards' worth (the
backward takes the product with each input and with each weight); the
recompute of a checkpointed layer is not counted, being no model FLOP.
"""


def forward_flops(model: dict, n: int, e: int) -> int:
    d, k = model["hidden_features"], model["nb_pos_enc"]
    he, s = model["hidden_edge_features"], model["hidden_edge_scores"]
    layers = model["num_gnn_layers"] * (5 * 2 * n * d * d + 2 * e * d * d)
    encoders = 2 * n * (k + 2) * d + 2 * e * (model["edge_features"] * he + he * d)
    head = 2 * (2 * n * d * s + e * d * s + e * s)
    return layers + encoders + head


def step_flops(model: dict, n: int, e: int) -> int:
    return 3 * forward_flops(model, n, e)
